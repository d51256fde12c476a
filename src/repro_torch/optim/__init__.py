from .adamw import adamw_init, adamw_update
from .schedule import sgdr_schedule

__all__ = ["adamw_init", "adamw_update", "sgdr_schedule"]
