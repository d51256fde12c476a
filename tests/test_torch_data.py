"""Port parity: the synthetic datasets (``repro_torch.data.synthetic``,
numpy copies of ``repro.data.synthetic``) give the reference's arrays
bit for bit, and the device-resident cache counts and clears what it
holds."""
import numpy as np
import pytest
import torch

from repro.data import synthetic as JD
from repro_torch.data import (clear_device_datasets, device_dataset,
                              device_dataset_stats, mnist_pooled, synthetic)

torch.set_num_threads(1)


@pytest.mark.parametrize("n", [64, 301])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", ["two_semicircles", "jsc_synthetic",
                                  "mnist_synthetic", "mnist_pooled"])
def test_generators_equal_reference(name, seed, n):
    got = getattr(synthetic, name)(n, seed=seed)
    want = getattr(JD, name)(n, seed=seed)
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_device_dataset_stats_and_clear():
    clear_device_datasets()
    assert device_dataset_stats() == {"entries": 0, "bytes": 0}
    x, y = device_dataset(mnist_pooled, 32, seed=0, device="cpu")
    x2, _ = device_dataset(mnist_pooled, 32, seed=0, device="cpu")
    assert x2 is x and x.shape == (32, 196) and y.dtype == torch.int32
    assert device_dataset_stats() == {"entries": 1,
                                      "bytes": 32 * 196 * 4 + 32 * 4}
    clear_device_datasets()
    assert device_dataset_stats()["entries"] == 0
    assert device_dataset(mnist_pooled, 32, seed=0, device="cpu")[0] \
        is not x
    clear_device_datasets()
