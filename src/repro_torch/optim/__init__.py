from .adamw import adamw_init, adamw_init_spec, adamw_update
from .grad_compress import make_ef_int8_compressor, psum_int8
from .schedule import sgdr_schedule

__all__ = ["adamw_init", "adamw_init_spec", "adamw_update",
           "make_ef_int8_compressor", "psum_int8", "sgdr_schedule"]
