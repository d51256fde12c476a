"""Port parity for LUT graphs (PolyLUT-Add adder trees and DAGs).

The port's graph model, conversion, integer oracle, plain DAG cascade and
serving path against the JAX package on the same inputs:

* the ``polylut_add_*`` configs agree field for field;
* ``graph_apply`` matches the reference's to 1e-5 (eval forward and the
  training-mode BN state);
* ``convert_graph_packed`` matches the reference's tables up to +-1
  rounding-boundary flips (at most two per model, as
  tests/test_torch_convert.py) and equals the port's own quantized
  forward exactly;
* the plain DAG cascade and ``graph_lut_forward`` are bit-identical to
  the reference's ``graph_lut_forward`` and its Pallas ``lut_cascade``
  (interpret mode) on a diamond and on random DAGs;
* the program the kernel copies into shared memory (node descriptors,
  16-bit code positions) keeps every buffer until its last reader (an
  emulation of the kernel's walk over that program);
* serving a converted graph equals the reference's ``predict``.

The CUDA kernel itself runs only on the card (``chip_smoke.py``).
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lut_infer as JLI
from repro.core import model as JM
from repro.core import nl_config as JNC
from repro.core import truth_table as JTT
from repro.kernels import lut_cascade as JLC
from repro_torch import bridge
from repro_torch.config import get_config, list_archs
from repro_torch.core import lut_infer as LI
from repro_torch.core import model as M
from repro_torch.core import quant as Q
from repro_torch.core import truth_table as TT
from repro_torch.core.exec_plan import plan_cascade_exec, plan_subnet_exec
from repro_torch.core.nl_config import (INPUT, LUTGraphConfig, LUTNodeSpec,
                                        UnsupportedTopology)
from repro_torch.kernels.lut_cascade import (DESC_WORDS, MAX_ARITY,
                                             MAX_SHARED_BYTES,
                                             CascadeOperands, cascade_meta,
                                             cascade_tables,
                                             graph_cascade_meta,
                                             graph_cascade_tables,
                                             lut_cascade)
from repro_torch.kernels.ref import as_schedule, lut_cascade_ref
from repro_torch.serve import LUTServeEngine, bundle_from_training
from repro_torch.serve.engine import make_forward_fn

# Small shapes: one intra-op thread keeps these tests from loading the
# CPU that the other test workers share.
torch.set_num_threads(1)

POLYLUT = ["polylut_add_jsc_2l", "polylut_add_jsc_5l"]
TOL = dict(atol=1e-5, rtol=1e-5)
ALLOWED_FLIPS = 2


def _cfgs(mod, variant="reduced"):
    jcfg = getattr(importlib.import_module(f"repro.configs.{mod}"),
                   variant)()
    return jcfg, get_config(mod.replace("_", "-"),
                            reduced=variant == "reduced")


def _numpy_model(jcfg, seed):
    """Seeded numpy (params, state) in the JAX package's graph tree
    layout (``graph_spec``): random sub-network weights, quantizer
    scales near their init, a non-trivial BN state per branch."""
    rng = np.random.default_rng(seed)
    spec_p, spec_s = JM.model_spec(jcfg)

    def leaf(path, sds):
        name = jax.tree_util.keystr(path)
        if "log_s" in name:
            base = 0.25 if "in_quant" in name else 2 / 7
            return np.log(base * rng.uniform(0.8, 1.25, sds.shape)
                          ).astype(np.float32)
        if sds.ndim >= 2:
            return (rng.normal(0, 1, sds.shape) / np.sqrt(sds.shape[-2])
                    ).astype(np.float32)
        if name.endswith("['var']"):
            return rng.uniform(0.5, 2.0, sds.shape).astype(np.float32)
        if name.endswith("['g']"):
            return rng.normal(1, 0.1, sds.shape).astype(np.float32)
        return rng.normal(0, 0.3, sds.shape).astype(np.float32)

    def fill(tree):
        return jax.tree_util.tree_map_with_path(
            leaf, tree, is_leaf=lambda x: isinstance(x, jax.ShapeDtypeStruct))
    return fill(spec_p), fill(spec_s)


def _models(mod, seed):
    """A seeded graph model in both packages with one connectivity."""
    jcfg, pcfg = _cfgs(mod)
    statics = JM.model_static(jcfg)
    params_np, state_np = _numpy_model(jcfg, seed)
    p, s = bridge.params_from_numpy(pcfg, params_np, state_np,
                                    device="cpu")
    st = bridge.statics_from_numpy(pcfg, statics)
    return ((jcfg, jax.tree.map(jnp.asarray, params_np),
             jax.tree.map(jnp.asarray, state_np), statics),
            (pcfg, p, s, st))


def _x(n, seed=0):
    return np.random.default_rng(seed).normal(0, 1, (n, 16)
                                              ).astype(np.float32)


# ---------------------------------------------------------------------------
# configs and the model


@pytest.mark.parametrize("variant", ["full", "reduced"])
@pytest.mark.parametrize("mod", POLYLUT)
def test_polylut_configs_agree(mod, variant):
    jcfg, pcfg = _cfgs(mod, variant)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jcfg)
    assert not pcfg.is_chain
    for i in range(jcfg.num_layers):
        assert pcfg.node_sources(i) == jcfg.node_sources(i)
        assert pcfg.node_in_bits(i) == jcfg.node_in_bits(i)
        assert pcfg.node_in_width(i) == jcfg.node_in_width(i)
        assert pcfg.table_size(i) == jcfg.table_size(i)
    assert mod.replace("_", "-") in list_archs()


@pytest.mark.parametrize("mod", POLYLUT)
def test_graph_apply_matches_jax(mod):
    (jcfg, jp, js, jst), (pcfg, p, s, st) = _models(mod, seed=1)
    x = _x(200)
    jpre, jvals, _ = JM.model_apply(jcfg, jp, js, jst, jnp.asarray(x),
                                    train=False)
    pre, vals, _ = M.model_apply(pcfg, p, s, st, torch.as_tensor(x))
    np.testing.assert_allclose(pre.numpy(), np.asarray(jpre), **TOL)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), **TOL)
    # training mode: batch statistics and every branch's new BN state
    _, _, jnew = JM.model_apply(jcfg, jp, js, jst, jnp.asarray(x),
                                train=True)
    _, _, new = M.model_apply(pcfg, p, s, st, torch.as_tensor(x),
                              train=True)
    want = jax.tree.leaves(jax.tree.map(np.asarray, jnew))
    got = jax.tree.leaves(bridge.params_to_numpy(new))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **TOL)


def test_graph_init_and_statics():
    pcfg = get_config("polylut-add-jsc-5l")
    p, s = M.model_init(pcfg, torch.Generator().manual_seed(0),
                        device="cpu")
    st = M.model_static(pcfg)
    c = 2 ** (pcfg.beta - 1) - 1
    for i, nd in enumerate(pcfg.nodes):
        assert len(st[i]["conns"]) == nd.arity
        for conn in st[i]["conns"]:
            assert conn.shape == (nd.width, nd.fan_in)
            assert 0 <= conn.min() and conn.max() < pcfg.node_in_width(i)
        torch.testing.assert_close(
            p["layers"][i]["quant"]["log_s"],
            torch.full((nd.width,), float(np.log(2 * np.sqrt(nd.arity) / c))))
        if nd.arity > 1:
            assert len(p["layers"][i]["fn"]) == len(s["layers"][i]["bn"]) \
                == nd.arity
    # a chain graph draws the chain's parameters from the same generator
    ccfg = get_config("neuralut-jsc-5l", reduced=True)
    pc, _ = M.model_init(ccfg, torch.Generator().manual_seed(3),
                         device="cpu")
    pg, _ = M.model_init(ccfg.graph(), torch.Generator().manual_seed(3),
                         device="cpu")
    for a, b in zip(jax.tree.leaves(bridge.params_to_numpy(pc)),
                    jax.tree.leaves(bridge.params_to_numpy(pg))):
        assert np.array_equal(a, b)
    # the poly kind's statics carry the reference's monomial exponents
    jcfg, _ = _cfgs("polylut_add_jsc_5l", "full")
    want = JM.model_static(dataclasses.replace(jcfg, kind="poly"))
    got = M.model_static(dataclasses.replace(pcfg, kind="poly"))
    for w, g in zip(want, got):
        assert len(g["conns"]) == len(w["conns"])
        assert np.array_equal(g["exps"], w["exps"])


# ---------------------------------------------------------------------------
# conversion


@pytest.mark.parametrize("mod", POLYLUT)
def test_graph_tables_match_jax_convert(mod):
    (jcfg, jp, js, jst), (pcfg, p, s, st) = _models(mod, seed=4)
    want, want_packed = JTT.convert_packed(jcfg, jp, js, jst)
    tables, packed = TT.convert_packed(pcfg, p, s, st)
    assert [len(t) for t in tables] == [nd.arity for nd in pcfg.nodes]
    flips = 0
    for i, (node, jnode) in enumerate(zip(tables, want)):
        for a, (t, w) in enumerate(zip(node, jnode)):
            w = np.asarray(w)
            assert t.shape == w.shape and t.dtype == np.uint16
            d = np.abs(t.astype(np.int32) - w.astype(np.int32))
            assert d.max() <= 1, f"node {i} branch {a}: not a flip"
            flips += int((d != 0).sum())
            assert np.array_equal(packed[i][a], LI.pack_tables(t, pcfg.beta))
    assert flips <= ALLOWED_FLIPS, f"{flips} flips"
    if flips == 0:
        for node, jnode in zip(packed, want_packed):
            for w, jw in zip(node, jnode):
                assert np.array_equal(w, np.asarray(jw))
    assert [[t.shape for t in n] for n in TT.convert(pcfg, p, s, st)] \
        == [[t.shape for t in n] for n in tables]


@pytest.mark.parametrize("mod", POLYLUT)
def test_graph_tables_equal_own_eval_branch_on_every_code(mod, monkeypatch):
    """Feed each neuron of each branch every code combination through
    the port's eval branch (pool gather -> sub-network -> BN -> shared
    quantizer), the neuron's sources set to the dequantized codes."""
    _, (pcfg, p, s, st) = _models(mod, seed=5)
    monkeypatch.setattr(TT, "SWEEP_BATCH", 512)  # chunked sweep
    tables = TT.convert(pcfg, p, s, st)
    plan = plan_subnet_exec(pcfg, purpose="eval", device="cpu")
    for i, nd in enumerate(pcfg.nodes):
        bits, f = pcfg.node_in_bits(i), nd.fan_in
        codes = torch.as_tensor(TT.enumerate_codes(bits, f))  # (T, F)
        t, o, pool_w = codes.shape[0], nd.width, pcfg.node_in_width(i)
        scale = torch.cat([torch.exp(
            p["in_quant"]["log_s"] if b == 0
            else p["layers"][b - 1]["quant"]["log_s"])
            for b in pcfg.node_sources(i)])
        lp, ls = p["layers"][i], s["layers"][i]
        for a, (fn, bn_p, bn_s) in enumerate(
                M.node_branch_params(nd, lp, ls)):
            conn = torch.as_tensor(st[i]["conns"][a]).long()  # (O, F)
            pool = torch.zeros(o * t, pool_w)
            rows = torch.arange(o * t)
            for j in range(f):
                cols = conn[:, j].repeat_interleave(t)
                pool[rows, cols] = ((codes[:, j].repeat(o)
                                     - 2 ** (bits - 1)).float()
                                    * scale[cols])
            pre, _ = Q.bn_apply(bn_p, bn_s, plan.apply(fn, pool[:, conn]),
                                train=False)
            got = Q.quant_codes(lp["quant"], pre, pcfg.beta)  # (O*T, O)
            own = got.reshape(o, t, o)[torch.arange(o), :, torch.arange(o)]
            assert np.array_equal(own.numpy(),
                                  tables[i][a].astype(np.int32)), (i, a)


@pytest.mark.parametrize("mod", POLYLUT)
def test_graph_lut_path_equals_quantized_forward(mod):
    """End to end on data: the graph oracle over the port's tables gives
    the codes of the port's quantized eval forward, bit for bit."""
    _, (pcfg, p, s, st) = _models(mod, seed=6)
    tables = TT.convert(pcfg, p, s, st)
    x = torch.as_tensor(_x(300, seed=2))
    pre, vals, _ = M.model_apply(pcfg, p, s, st, x)
    want = Q.quant_codes(p["layers"][-1]["quant"], pre, pcfg.beta)
    got = LI.graph_lut_forward(pcfg, tables, st, LI.input_codes(pcfg, p, x))
    assert torch.equal(got, want)
    assert torch.equal(LI.predict(pcfg, p, tables, st, x),
                       torch.argmax(vals, dim=-1))


# ---------------------------------------------------------------------------
# the plain DAG cascade against the reference's oracle and Pallas kernel


def _to_jax(cfg: LUTGraphConfig):
    d = dataclasses.asdict(cfg)
    d["nodes"] = tuple(JNC.LUTNodeSpec(**nd) for nd in d["nodes"])
    return JNC.LUTGraphConfig(**d)


def _random_net(cfg, seed):
    """Random per-node branch (tables, statics) with cfg's geometry."""
    rng = np.random.default_rng(seed)
    statics, tables = [], []
    for i, nd in enumerate(cfg.nodes):
        statics.append({"conns": [
            rng.integers(0, cfg.node_in_width(i), (nd.width, nd.fan_in)
                         ).astype(np.int32) for _ in range(nd.arity)]})
        tables.append([rng.integers(0, 2 ** cfg.beta,
                                    (nd.width, cfg.table_size(i))
                                    ).astype(np.uint16)
                       for _ in range(nd.arity)])
    return tables, statics


def _codes(cfg, b, seed):
    return np.random.default_rng(seed).integers(
        0, 2 ** cfg.node_in_bits(0), (b, cfg.in_features)).astype(np.int32)


def _ops(cfg, tables, statics):
    return CascadeOperands(
        [torch.as_tensor(c) for s in statics for c in s["conns"]],
        [torch.as_tensor(t) for t in graph_cascade_tables(cfg, tables)],
        graph_cascade_meta(cfg), cfg.in_features)


def _emulate_kernel(ops: CascadeOperands, codes: np.ndarray) -> np.ndarray:
    """The CUDA kernel's walk in numpy, one row at a time, over the
    program it copies into shared memory (``ops.prog``): the node
    descriptors, then the column area, each branch's (O, round4(F))
    16-bit positions in a row's code array.  The array starts with the
    row's input codes; every branch reads its codes through its
    positions, and each node stores into its output positions or, the
    last one, the output."""
    b = codes.shape[0]
    nn = len(ops.schedule)
    prog = ops.prog.numpy()
    assert prog.size % 2 == 0          # whole 16-byte copies
    desc = prog[:nn * DESC_WORDS].reshape(nn, DESC_WORDS)
    assert np.array_equal(desc, ops.desc.numpy())
    area = prog[nn * DESC_WORDS:].view(np.uint16)   # little-endian
    tables = {p.data_ptr(): p.numpy().view(np.uint32).astype(np.int64)
              for p in ops.packed}
    out = np.zeros((b, ops.out_width), np.int64)
    for r in range(b):
        row = np.full(ops.pitch, -1, np.int64)  # -1: never written
        row[:ops.in_width] = codes[r]
        for d in desc:
            o, f, in_bits, words, sb, beta, arity, out_col, magic = (
                int(v) for v in d[:9])
            # the kernel's row of item idx: umulhi(idx, magic), exact for
            # every item of a tile the wrapper launches (rows * O^2 <=
            # 2^32)
            idx = np.arange(max(1, min(32, (1 << 32) // o ** 2)) * o,
                            dtype=np.uint64)
            assert np.array_equal(idx * np.uint64(magic) >> np.uint64(32)
                                  if magic else idx, idx // np.uint64(o))
            f4 = -(-f // 4) * 4
            total = 0
            for a in range(arity):
                off = int(d[9 + a])
                assert off % 4 == 0     # 8-byte aligned neuron rows
                pos = area[off:off + o * f4].reshape(o, f4).astype(np.int64)
                assert (pos < ops.pitch).all()
                v = row[pos[:, :f]]
                assert (v >= 0).all(), "a branch read an unwritten column"
                addr = np.zeros(o, np.int64)
                for j in range(f):
                    addr = (addr << in_bits) + v[:, j]
                table = tables[int(d[9 + MAX_ARITY + a])]
                assert table.shape == (o, words)
                word = table[np.arange(o), addr >> sb]
                total = total + ((word >> (beta * (addr & ((1 << sb) - 1))))
                                 & ((1 << beta) - 1))
            if out_col < 0:
                out[r] = total
            else:
                assert out_col >= ops.in_width
                row[out_col:out_col + o] = total
    return out.astype(np.int32)


def _check_dag(cfg, seed, b=9, block_b=4):
    """Oracle, plain cascade, the wrapper's CPU path, the kernel's column
    walk and the reference's oracle and Pallas kernel, bit for bit."""
    jcfg = _to_jax(cfg)
    tables, statics = _random_net(cfg, seed)
    codes = _codes(cfg, b, seed + 1)
    want = np.asarray(JLI.graph_lut_forward(jcfg, tables, statics,
                                            jnp.asarray(codes)))
    kern = np.asarray(JLC.lut_cascade(
        jnp.asarray(codes),
        [jnp.asarray(m) for m in JLC.build_graph_shift_mats(jcfg, statics)],
        [jnp.asarray(t) for t in JLC.graph_cascade_tables(jcfg, tables)],
        JLC.graph_cascade_meta(jcfg), block_b=block_b, interpret=True))
    assert np.array_equal(kern, want)
    ct = torch.as_tensor(codes)
    assert np.array_equal(
        LI.graph_lut_forward(cfg, tables, statics, ct).numpy(), want)
    ops = _ops(cfg, tables, statics)
    plain = lut_cascade_ref(ct, ops.conns, ops.packed, ops.schedule)
    assert plain.dtype == torch.int32
    assert np.array_equal(plain.numpy(), want)
    assert np.array_equal(lut_cascade(ct, ops).numpy(), want)
    assert np.array_equal(_emulate_kernel(ops, codes), want)
    return ops


def _node(name, width=4, fan_in=2, inputs=(INPUT,), arity=1):
    return LUTNodeSpec(name=name, width=width, fan_in=fan_in,
                       inputs=inputs, arity=arity)


def _random_dag_cfg(rng) -> LUTGraphConfig:
    """The reference's random DAG (tests/test_lut_graph.py): a rank of
    mid nodes over the input (same arity), then a classifier that
    concatenates a nonempty subset of them."""
    beta = int(rng.integers(2, 4))
    arity = int(rng.choice([1, 2, 4]))
    n_mid = int(rng.integers(1, 3))
    mids = [_node(f"m{j}", width=int(rng.integers(2, 5)), arity=arity)
            for j in range(n_mid)]
    picked = sorted(rng.choice(n_mid, size=int(rng.integers(1, n_mid + 1)),
                               replace=False).tolist())
    cls = _node("cls", width=3, inputs=tuple(f"m{j}" for j in picked))
    return LUTGraphConfig(name="dag-prop", in_features=5, num_classes=3,
                          beta=beta, nodes=tuple(mids) + (cls,),
                          kind="linear")


def _deep_dag_cfg(rng) -> LUTGraphConfig:
    """A deeper random DAG: each node reads one to three earlier buffers
    of equal bit width (the input among them), arity 1 or 2, so buffers
    die at different nodes and their columns are reused."""
    beta = int(rng.integers(2, 4))
    bits, names, nodes = {INPUT: beta}, [INPUT], []
    n = int(rng.integers(3, 8))
    for j in range(n):
        last = j == n - 1
        arity = 1 if last else int(rng.choice([1, 2]))
        first = names[int(rng.integers(len(names)))]
        same = [m for m in names if bits[m] == bits[first] and m != first]
        extra = rng.choice(same, size=int(rng.integers(0, min(2, len(same))
                                                       + 1)),
                           replace=False).tolist() if same else []
        nodes.append(_node(f"n{j}", width=3 if last
                           else int(rng.integers(2, 7)),
                           inputs=(first,) + tuple(extra), arity=arity))
        bits[f"n{j}"] = beta + arity.bit_length() - 1
        names.append(f"n{j}")
    return LUTGraphConfig(name="dag-deep", in_features=5, num_classes=3,
                          beta=beta, nodes=tuple(nodes), kind="linear")


def test_diamond_dag_bit_exact():
    """Two arity-2 nodes over the input, a classifier concatenating
    both: b must read the input (not a's codes) and a's codes must live
    until the classifier."""
    cfg = LUTGraphConfig(
        name="diamond", in_features=6, num_classes=4, beta=2,
        nodes=(_node("a", arity=2), _node("b", width=3, arity=2),
               _node("c", inputs=("a", "b"))), kind="linear")
    ops = _check_dag(cfg, seed=7, b=13)
    assert ops.out_cols == [0, 4, -1] and ops.stride == 7
    # branches of a and b read input columns, c's read the nodes' columns
    assert ops.pitch == 6 + 7
    assert all(ops.cols[k].max() < 6 for k in range(4))
    assert ops.cols[4].min() >= 6


def test_random_dag_bit_exact_property():
    try:
        from hypothesis import given, settings, strategies as st
    except ImportError:  # fixed draws through the same checker
        for seed in range(8):
            _check_dag(_random_dag_cfg(np.random.default_rng(seed)), seed)
        return

    @settings(max_examples=10, deadline=None)
    @given(seed=st.integers(0, 2 ** 16))
    def prop(seed):
        _check_dag(_random_dag_cfg(np.random.default_rng(seed)), seed)
    prop()


@pytest.mark.parametrize("seed", range(6))
def test_deep_random_dag_bit_exact(seed):
    cfg = _deep_dag_cfg(np.random.default_rng(100 + seed))
    _check_dag(cfg, seed)


def test_polylut_full_operands_column_walk():
    """Full polylut-add-jsc-5l operands: the plain cascade and the
    kernel's column walk equal the oracle; one input and two 64-wide
    slices alternate as in a chain."""
    cfg = get_config("polylut-add-jsc-5l")
    tables, statics = _random_net(cfg, seed=11)
    codes = _codes(cfg, 3, seed=12)
    ops = _ops(cfg, tables, statics)
    want = LI.graph_lut_forward(cfg, tables, statics, torch.as_tensor(codes))
    assert torch.equal(lut_cascade(torch.as_tensor(codes), ops), want)
    assert np.array_equal(_emulate_kernel(ops, codes), want.numpy())
    assert ops.out_cols == [0, 64, 0, -1] and ops.stride == 128
    assert sum(p.numel() * 4 for p in ops.packed) == 3_489_792


# ---------------------------------------------------------------------------
# chains as graphs, operand checks


@pytest.mark.parametrize("mod", ["neuralut_jsc_2l", "neuralut_jsc_5l"])
def test_chain_graph_equals_chain(mod):
    """A chain written as a graph: the same schedule, operands, columns,
    launch geometry and output as the chain; and the same tables."""
    pcfg = get_config(mod.replace("_", "-"), reduced=True)
    g = pcfg.graph()
    assert graph_cascade_meta(g) == as_schedule(cascade_meta(pcfg))
    assert plan_cascade_exec(g) == plan_cascade_exec(pcfg)
    rng = np.random.default_rng(5)
    tables, statics = [], []
    w_prev = pcfg.in_features
    for i, o in enumerate(pcfg.layer_widths):
        statics.append({"conn": rng.integers(0, w_prev, (
            o, pcfg.layer_fan_in(i))).astype(np.int32)})
        tables.append(rng.integers(0, 2 ** pcfg.beta, (
            o, pcfg.table_size(i))).astype(np.uint16))
        w_prev = o
    gtables = [[t] for t in tables]
    gstatics = [{"conns": [s["conn"]]} for s in statics]
    chain_pt = cascade_tables(pcfg, tables)
    graph_pt = graph_cascade_tables(g, gtables)
    assert all(np.array_equal(a, b) for a, b in zip(chain_pt, graph_pt))
    conns = [torch.as_tensor(s["conn"]) for s in statics]
    oc = CascadeOperands(conns, [torch.as_tensor(p) for p in chain_pt],
                         cascade_meta(pcfg), pcfg.in_features)
    og = _ops(g, gtables, gstatics)
    assert oc.schedule == og.schedule and oc.stride == og.stride
    assert torch.equal(oc.desc[:, :9], og.desc[:, :9])  # the geometry
    assert all(torch.equal(a, b) for a, b in zip(oc.cols, og.cols))
    codes = _codes(g, 40, seed=6)
    want = LI.lut_forward(pcfg, tables, statics, torch.as_tensor(codes))
    assert torch.equal(lut_cascade(torch.as_tensor(codes), og), want)
    assert np.array_equal(_emulate_kernel(oc, codes), want.numpy())
    # conversion: the graph's tables are the chain's
    p, s = M.model_init(pcfg, torch.Generator().manual_seed(1),
                        device="cpu")
    cst = [{"conn": c.numpy()} for c in conns]
    gst = [{"conns": [c.numpy()]} for c in conns]
    for a, b in zip(TT.convert(pcfg, p, s, cst), TT.convert(g, p, s, gst)):
        assert np.array_equal(a, b[0])


def test_cascade_operands_reject_bad_graphs():
    cfg = LUTGraphConfig(
        name="diamond", in_features=6, num_classes=4, beta=2,
        nodes=(_node("a", arity=2), _node("b", width=3, arity=2),
               _node("c", inputs=("a", "b"))), kind="linear")
    tables, statics = _random_net(cfg, seed=1)
    conns = [torch.as_tensor(c) for s in statics for c in s["conns"]]
    pts = [torch.as_tensor(t) for t in graph_cascade_tables(cfg, tables)]
    sched = list(graph_cascade_meta(cfg))
    CascadeOperands(conns, pts, sched, 6)

    def bad(match, **kw):
        args = dict(conns=conns, packed_tables=pts, schedule=sched,
                    in_width=6)
        args.update(kw)
        with pytest.raises(ValueError, match=match):
            CascadeOperands(**args)

    def node(i, **kw):
        f = dict(zip(("srcs", "arity", "in_bits", "wb", "sb", "beta"),
                     sched[i]))
        f.update(kw)
        return sched[:i] + [tuple(f.values())] + sched[i + 1:]
    # a source that is not the input or an earlier node
    bad("reads buffer 3", schedule=node(2, srcs=(1, 3)))
    # sources of unequal bit width: the input (2 bits) beside a (3 bits)
    bad("holds 2-bit codes", schedule=node(2, srcs=(0, 1)))
    bad("holds 3-bit codes", schedule=node(2, srcs=(1,), in_bits=2))
    # the classifier's conn indexes past the 7 concatenated channels
    bad("outside the 7 source codes",
        conns=conns[:4] + [torch.full_like(conns[4], 7)])
    bad("branches of geometry disagree", conns=conns[:-1])
    bad("packed table", packed_tables=pts[:1] + [pts[1][:2]] + pts[2:])
    bad("not a power of two", schedule=node(1, arity=3),
        conns=conns[:4] + conns[3:], packed_tables=pts[:4] + pts[3:])
    # two branches of 16-bit codes sum to 17 bits: no room in a uint16
    c2 = torch.zeros((4, 2), dtype=torch.int32)
    p8 = torch.zeros((4, 8), dtype=torch.int32)
    bad("sum to 17 bits", conns=[c2] * 3, packed_tables=[p8] * 3,
        schedule=[((0,), 2, 2, 3, 1, 16), ((1,), 1, 17, 33, 1, 16)])
    # a row of intermediate codes larger than a block's shared memory
    big = LUTGraphConfig(
        name="big", in_features=4, num_classes=2, beta=2,
        nodes=(_node("a", width=60000), _node("b", width=60000),
               _node("c", width=2, inputs=("a", "b"))), kind="linear")
    bt, bs = _random_net(big, seed=2)
    with pytest.raises(ValueError, match="shared memory"):
        _ops(big, bt, bs)
    # too many nodes for the kernel's argument block
    many = LUTGraphConfig(
        name="many", in_features=4, num_classes=2, beta=2,
        nodes=tuple(_node(f"n{j}", width=2,
                          inputs=(INPUT if j == 0 else f"n{j - 1}",))
                    for j in range(17)), kind="linear")
    mt, ms = _random_net(many, seed=3)
    with pytest.raises(ValueError, match="kernel maximum"):
        _ops(many, mt, ms)


def test_cascade_operands_reject_columns_beyond_shared_memory():
    """Two 14,000-wide nodes: a row of their codes fits in a block's
    shared memory, their 16-bit code columns (4 per neuron) with it do
    not."""
    wide = LUTGraphConfig(
        name="wide", in_features=4, num_classes=2, beta=2,
        nodes=(_node("a", width=14000, fan_in=3),
               _node("b", width=14000, fan_in=3, inputs=("a",)),
               _node("c", width=2, inputs=("b",))), kind="linear")
    wt, ws = _random_net(wide, seed=4)
    row = 2 * (4 + 2 * 14000)
    assert row < MAX_SHARED_BYTES < row + 2 * 2 * 14000 * 4
    with pytest.raises(ValueError, match="program.*shared memory"):
        _ops(wide, wt, ws)


# ---------------------------------------------------------------------------
# serving


def test_graph_serving_equals_jax_predict():
    (jcfg, jp, js, jst), (pcfg, p, s, st) = _models("polylut_add_jsc_5l",
                                                    seed=7)
    tables, packed = JTT.convert_packed(jcfg, jp, js, jst)
    tables = [[np.asarray(t) for t in node] for node in tables]
    bundle = bundle_from_training(pcfg, p, tables, st,
                                  packed_tables=[[np.asarray(w) for w in n]
                                                 for n in packed])
    assert bundle.topology[0] == "dag"
    assert len(bundle.packed_tables) == sum(nd.arity for nd in pcfg.nodes)
    x = _x(700, seed=3)
    want = np.asarray(JLI.predict(jcfg, jp, tables, jst, jnp.asarray(x)))
    fwd = make_forward_fn(bundle, device="cpu")
    assert np.array_equal(fwd(x).numpy(), want)
    sizes = [1, 5, 64, 300, 17, 256, 57]
    offs = np.cumsum([0] + sizes)
    with LUTServeEngine(bundle, device="cpu", max_wait_ms=1.0) as eng:
        eng.warmup()
        got = [f.result(timeout=60) for f in
               [eng.submit(x[a:b]) for a, b in zip(offs[:-1], offs[1:])]]
    assert np.array_equal(np.concatenate(got), want)
    # a bundle prepacked from the unpacked tables serves the same
    again = bundle_from_training(pcfg, p, tables, st).prepack()
    for a, b in zip(again.packed_tables, bundle.packed_tables):
        assert np.array_equal(a, b)
    with pytest.raises(UnsupportedTopology):
        LUTServeEngine(bundle, fused=False, device="cpu")
