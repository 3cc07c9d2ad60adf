from fava_tpu_torch.pipeline.pipeline import (
    PIPELINE_CHECKPOINT_NAME,
    PIPELINE_SETTINGS_NAME,
    Pipeline,
    PipelineSettingsError,
    main,
)

__all__ = [
    "Pipeline",
    "PipelineSettingsError",
    "main",
    "PIPELINE_CHECKPOINT_NAME",
    "PIPELINE_SETTINGS_NAME",
]
