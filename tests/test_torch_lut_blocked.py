"""Port parity of the blocked CPU cascade
(``repro_torch.kernels.ref.lut_cascade_blocked``) against the
reference's ``repro.kernels.ref.lut_cascade_blocked`` and the port's
plain ``lut_cascade_ref``: bit for bit, on the reduced chain geometries
(``neuralut_hdr_5l``, ``neuralut_jsc_2l``, ``neuralut_jsc_5l``) and DAG
geometries (``polylut_add_jsc_2l``, ``polylut_add_jsc_5l``), with random
tables and connectivity, at batch sizes that the tile divides and does
not, and with a tile larger than the batch.
"""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import nl_config as JNC
from repro.kernels import lut_cascade as JLC
from repro.kernels import ref as JREF
from repro_torch.bridge import statics_from_numpy
from repro_torch.config import get_config
from repro_torch.kernels.lut_cascade import (cascade_meta, cascade_tables,
                                             graph_cascade_meta,
                                             graph_cascade_tables)
from repro_torch.kernels.ref import (_blocked_carrier, as_schedule,
                                     lut_cascade_blocked, lut_cascade_ref)

torch.set_num_threads(1)

CHAINS = ["neuralut_hdr_5l", "neuralut_jsc_2l", "neuralut_jsc_5l"]
GRAPHS = ["polylut_add_jsc_2l", "polylut_add_jsc_5l"]
# (batch, tile): a tile that divides the batch, one that does not, one
# larger than the batch
SIZES = [(256, 64), (1000, 96), (37, 512)]


def _chain(mod, seed):
    """(port operands, reference operands, codes) of a random chain."""
    jcfg = getattr(importlib.import_module(f"repro.configs.{mod}"),
                   "reduced")()
    pcfg = get_config(mod.replace("_", "-"), reduced=True)
    rng = np.random.default_rng(seed)
    statics, tables, w = [], [], jcfg.in_features
    for i, o in enumerate(jcfg.layer_widths):
        statics.append({"conn": rng.integers(
            0, w, (o, jcfg.layer_fan_in(i))).astype(np.int32)})
        tables.append(rng.integers(0, 2 ** jcfg.beta, (o, jcfg.table_size(i))
                                   ).astype(np.uint16))
        w = o
    port = ([torch.as_tensor(s["conn"]) for s in
             statics_from_numpy(pcfg, statics)],
            [torch.as_tensor(p) for p in cascade_tables(pcfg, tables)],
            cascade_meta(pcfg))
    ref = ([jnp.asarray(m) for m in JLC.build_shift_mats(jcfg, statics)],
           [jnp.asarray(t) for t in JLC.cascade_tables(jcfg, tables)],
           jcfg.beta, None)
    return port, ref, lambda b: rng.integers(
        0, 2 ** jcfg.layer_in_bits(0), (b, jcfg.in_features)).astype(np.int32)


def _graph(mod, seed):
    pcfg = get_config(mod.replace("_", "-"), reduced=True)
    d = dataclasses.asdict(pcfg)
    d["nodes"] = tuple(JNC.LUTNodeSpec(**nd) for nd in d["nodes"])
    jcfg = JNC.LUTGraphConfig(**d)
    rng = np.random.default_rng(seed)
    statics, tables = [], []
    for i, nd in enumerate(pcfg.nodes):
        statics.append({"conns": [
            rng.integers(0, pcfg.node_in_width(i), (nd.width, nd.fan_in)
                         ).astype(np.int32) for _ in range(nd.arity)]})
        tables.append([rng.integers(0, 2 ** pcfg.beta,
                                    (nd.width, pcfg.table_size(i))
                                    ).astype(np.uint16)
                       for _ in range(nd.arity)])
    port = ([torch.as_tensor(c) for s in statics for c in s["conns"]],
            [torch.as_tensor(t) for t in graph_cascade_tables(pcfg, tables)],
            graph_cascade_meta(pcfg))
    ref = ([jnp.asarray(m) for m in JLC.build_graph_shift_mats(jcfg,
                                                                statics)],
           [jnp.asarray(t) for t in JLC.graph_cascade_tables(jcfg, tables)],
           pcfg.beta, JLC.graph_cascade_meta(jcfg))
    return port, ref, lambda b: rng.integers(
        0, 2 ** pcfg.node_in_bits(0), (b, pcfg.in_features)).astype(np.int32)


@pytest.mark.parametrize("b,block_b", SIZES)
@pytest.mark.parametrize("mod", CHAINS + GRAPHS)
def test_blocked_equals_the_reference_and_the_plain_cascade(mod, b, block_b):
    port, ref, codes_of = (_graph if mod in GRAPHS else _chain)(mod, seed=3)
    codes = codes_of(b)
    want = np.asarray(JREF.lut_cascade_blocked(
        jnp.asarray(codes), ref[0], ref[1], ref[2], schedule=ref[3],
        block_b=block_b))
    ct = torch.as_tensor(codes)
    got = lut_cascade_blocked(ct, *port, block_b=block_b)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(got, lut_cascade_ref(ct, *port))


@pytest.mark.parametrize("mod", CHAINS + GRAPHS)
def test_carrier_is_the_reference_choice(mod):
    """int16 for every paper geometry, as the reference's plan picks."""
    from repro.core.lut_infer import packed_slots
    port, (mats, packed, beta, meta), _ = (
        _graph if mod in GRAPHS else _chain)(mod, seed=0)
    if meta is None:     # the chain schedule, as the reference derives it
        sb = packed_slots(beta).bit_length() - 1
        ref_sched = tuple(((i,), 1, int(pt.shape[1]).bit_length() - 1, sb,
                           beta) for i, pt in enumerate(packed))
    else:
        ref_sched = JLC.as_schedule(meta)
    _, carrier = JREF._blocked_plan(mats, ref_sched)
    want = {jnp.int16: torch.int16, jnp.int32: torch.int32}[carrier]
    assert _blocked_carrier(as_schedule(port[2])) == want == torch.int16
