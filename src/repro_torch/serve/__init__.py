from .engine import DEFAULT_BUCKETS, LUTServeEngine, make_forward_fn
from .metrics import ServeMetrics
from .registry import ServeBundle, bundle_from_training

__all__ = ["DEFAULT_BUCKETS", "LUTServeEngine", "ServeBundle",
           "ServeMetrics", "bundle_from_training", "make_forward_fn"]
