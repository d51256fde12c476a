from .pipeline import (clear_device_datasets, device_dataset,
                       device_dataset_stats)
from .synthetic import (jsc_synthetic, mnist_pooled, mnist_synthetic,
                        two_semicircles)

__all__ = ["clear_device_datasets", "device_dataset", "device_dataset_stats",
           "jsc_synthetic", "mnist_pooled", "mnist_synthetic",
           "two_semicircles"]
