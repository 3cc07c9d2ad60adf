from fava_tpu_torch.pipeline.pipeline import (
    PIPELINE_CHECKPOINT_NAME,
    PIPELINE_SETTINGS_NAME,
    AnalysisNotPortedError,
    Pipeline,
    PipelineSettingsError,
    main,
)

__all__ = [
    "AnalysisNotPortedError",
    "Pipeline",
    "PipelineSettingsError",
    "main",
    "PIPELINE_CHECKPOINT_NAME",
    "PIPELINE_SETTINGS_NAME",
]
