from .registry import get_config, list_archs, register

__all__ = ["get_config", "list_archs", "register"]
