from .pipeline import (ShardedLoader, clear_device_datasets, device_dataset,
                       device_dataset_stats, lm_batch_fn)
from .synthetic import (jsc_synthetic, mnist_pooled, mnist_synthetic,
                        token_stream, two_semicircles)

__all__ = ["ShardedLoader", "clear_device_datasets", "device_dataset",
           "device_dataset_stats", "jsc_synthetic", "lm_batch_fn",
           "mnist_pooled", "mnist_synthetic", "token_stream",
           "two_semicircles"]
