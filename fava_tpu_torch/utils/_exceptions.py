"""Framework exceptions (reference: fava/util/_exceptions.py:6-21)."""

from typing import Any

_cls_name = "Model"


class NotCallableError(Exception):
    def __init__(self, callable_name: Any):
        super().__init__(f"< {callable_name} > is not a callable function or class.")


class InvalidMeshError(Exception):
    def __init__(self, mesh_cls: str):
        super().__init__(
            f"Unknown mesh class < {mesh_cls} >. If you implemented this mesh class, "
            f"did you register it with the @{_cls_name}.register_mesh decorator?"
        )


class InvalidAnalysisError(Exception):
    def __init__(self, analysis_attr: str):
        super().__init__(
            f"Unknown analysis method < {analysis_attr} >. If you implemented this method, "
            f"did you register it with the @{_cls_name}.register_analysis decorator?"
        )
