from .base import config_fingerprint
from .registry import get_config, list_archs, register

__all__ = ["config_fingerprint", "get_config", "list_archs", "register"]
