from .pipeline import device_dataset
from .synthetic import jsc_synthetic

__all__ = ["device_dataset", "jsc_synthetic"]
