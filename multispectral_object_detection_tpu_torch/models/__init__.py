from .model import DetectionModel, build_model  # noqa: F401
from .parser import ModelSpec, parse_model_config  # noqa: F401
