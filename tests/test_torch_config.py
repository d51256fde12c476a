"""Port parity: configs, code enumeration and the packed-word format.

The port (``repro_torch``) keeps its own copies of the JAX package's
config classes and integer helpers; these must agree field for field
and bit for bit on every chain geometry.
"""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import lut_infer as JLI
from repro.core import truth_table as JTT
from repro_torch.config import get_config, list_archs
from repro_torch.core import lut_infer as LI
from repro_torch.core import truth_table as TT

import torch

# Small shapes: one intra-op thread keeps these tests from loading the
# CPU that the other test workers share.
torch.set_num_threads(1)

GEOMETRIES = [(m, v) for m in ("neuralut_hdr_5l", "neuralut_jsc_2l",
                               "neuralut_jsc_5l")
              for v in ("full", "reduced")]


@pytest.mark.parametrize("config_mod,variant", GEOMETRIES)
def test_config_fields_agree(config_mod, variant):
    jcfg = getattr(importlib.import_module(f"repro.configs.{config_mod}"),
                   variant)()
    arch = config_mod.replace("_", "-")
    pcfg = get_config(arch, reduced=variant == "reduced")
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    for i in range(jcfg.num_layers):
        assert pcfg.table_size(i) == jcfg.table_size(i)
        assert pcfg.layer_in_bits(i) == jcfg.layer_in_bits(i)
        assert pcfg.layer_fan_in(i) == jcfg.layer_fan_in(i)
    assert arch in list_archs()


@pytest.mark.parametrize("beta,fan_in", [(2, 6), (3, 3), (4, 3), (7, 2)])
def test_enumerate_codes_and_pack_index_agree(beta, fan_in):
    codes = TT.enumerate_codes(beta, fan_in)
    assert np.array_equal(codes, JTT.enumerate_codes(beta, fan_in))
    addr = LI.pack_index(torch.as_tensor(codes), beta).numpy()
    j_addr = np.asarray(JLI.pack_index(jnp.asarray(codes), beta))
    assert np.array_equal(addr, j_addr)
    assert np.array_equal(addr, np.arange(2 ** (beta * fan_in)))
    assert np.array_equal(LI.shift_weights(beta, fan_in),
                          JLI.shift_weights(beta, fan_in))


@pytest.mark.parametrize("beta,T", [(2, 64), (3, 512), (4, 4096), (7, 256)])
def test_pack_tables_same_words(beta, T):
    rng = np.random.default_rng(beta)
    t = rng.integers(0, 2 ** beta, (6, T)).astype(np.uint16)
    words = LI.pack_tables(t, beta)
    assert LI.packed_slots(beta) == JLI.packed_slots(beta)
    assert words.dtype == np.int32
    assert np.array_equal(words, JLI.pack_tables(t, beta))
    dev_words = LI.pack_tables_torch(torch.as_tensor(t.astype(np.int32)),
                                     beta).numpy()
    assert np.array_equal(dev_words, words)
    assert np.array_equal(LI.unpack_tables(words, beta),
                          JLI.unpack_tables(words, beta))
    assert np.array_equal(LI.unpack_tables(words, beta), t)
