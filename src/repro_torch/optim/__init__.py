from .adamw import adamw_init, adamw_update
from .grad_compress import make_ef_int8_compressor
from .schedule import sgdr_schedule

__all__ = ["adamw_init", "adamw_update", "make_ef_int8_compressor",
           "sgdr_schedule"]
