from .config import Config, compose, load_yaml
from .envfile import load_dotenv
from .log import get_logger
from .paths import get_icv_cpk_path, get_inference_paths

__all__ = [
    "Config",
    "compose",
    "load_yaml",
    "load_dotenv",
    "get_logger",
    "get_icv_cpk_path",
    "get_inference_paths",
]
