"""The model axis's split ops (``repro_torch.sharding.tensor_parallel``),
in the layers that use them, over gloo processes on the CPU against the
unsplit layer on one process: values and gradients.

Cases (float32, inputs drawn with numpy from a seed):

* attention, ``wq``/``wk``/``wv`` split by columns and ``wo`` by rows:
  kv heads dividing the model axis (4 heads, 2 kv; plain and
  ``fused_qkv``); one kv head (``wk``/``wv`` split across head_dim, the
  kv head gathered from its owners); 6 heads over 3 kv heads, which the
  axis does not divide (a rank's query heads read two kv heads); a
  sliding window over several query chunks; M-RoPE;
* the dense FFN (plain and fused gate/up);
* the vocabulary-parallel embedding: tied (the rank's vocabulary rows,
  summed over the axis) and untied (its d_model columns, gathered);
* the vocabulary-parallel loss (``lm.chunked_ce_loss``), tied and
  untied heads;
* the MoE FFN under expert parallelism (``w_gate``/``w_up``/``w_down``
  by experts, the router whole), dense and capacity dispatch, with 16
  experts (routed experts on both ranks) and with reduced
  qwen2-moe-a2.7b's 6 padded to 16 (at 1x2 rank 1 holds only inert
  experts and still joins every sum); under ``sharding="tp"`` (each
  expert's units); with shared experts (by units, summed with the
  routed part once; units the axis does not divide stay whole and are
  added after it); the objective adds the aux loss, so the router's
  gradient, whole on every model rank, is held too;
* MLA, ``wq``/``w_uk``/``w_uv`` by columns (heads) and ``wo`` by rows,
  ``w_dkv``/``w_kr`` whole (their gradient whole on every model rank);
* Mamba by channels (``w_in``, ``conv_w``, ``w_dt`` by columns;
  ``conv_b``, ``dt_bias``, ``d_skip`` by channel; ``w_x``, ``a_log``,
  ``w_out`` by rows), over several scan chunks: ``w_in`` is [x | z]
  joined, so at a model axis of two rank 0's block of its columns is
  all of x and rank 1's all of z, regathered by the layer;
* whisper's encoder block (non-causal self-attention and the FFN split,
  the layer norms whole) and its cross attention (the decoder's states
  and the encoder's both entering the column split, so the encoder
  states' gradient is held too), with kv heads dividing the axis and
  with one kv head.

Each runs at 1x2 and at 2x2, where each data rank takes half the rows:
the one-process reference runs the layer on the same row blocks, and
the weights' gradients are summed over the blocks (the mesh step
averages them).  Held to rtol 1e-5, atol 1e-6 x the largest element of
each array (float32 sums split in two, as the mesh step's); a weight
kept whole over the model axis is held on every model rank.  The wide
encoder block and cross attention are held bit for bit as well: their
split sums its cut products in float64 (``tp.wide``) and rounds them
once, as the whole layer does.  Mamba, wide too, is held at the
tolerance: the sums that its split does not cut (over the state in the
readout, over the tokens in its weights' gradients) run in float32, in
an order that the kernels may pick by the number of channels.  Under a
layout whose model axis has one rank every layer is the plain one bit
for bit and no collective runs.  The model axis's collectives of an
MoE and an MLA + MoE block at (1, 2), forward and backward with and
without the recompute, are counted through a ``CountingMesh`` on the
meta device; a jamba stack's too, whose Mamba layers each all-gather
``w_in`` over the model axis.
"""
import dataclasses
import os
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

TIMEOUT_S = 150
B, S, D = 4, 32, 48
VOCAB = 64
TOL = dict(rtol=1e-5)
ATOL = 1e-6


def _acfg(heads, kv, *, rope="rope", window=0):
    from repro_torch.config.base import AttentionConfig
    return AttentionConfig(num_heads=heads, num_kv_heads=kv, head_dim=8,
                           rope_kind=rope, window=window,
                           mrope_sections=(2, 1, 1) if rope == "mrope"
                           else ())


def _moecfg(experts=16, top_k=2, shared=0, shared_ff=24, sharding="auto"):
    from repro_torch.config import get_config
    from repro_torch.config.base import MoEConfig
    if experts is None:       # reduced qwen2-moe-a2.7b's: 6, padded to 16
        return get_config("qwen2-moe-a2.7b", reduced=True).moe
    return MoEConfig(num_experts=experts, top_k=top_k, num_shared=shared,
                     d_ff_expert=16, d_ff_shared=shared_ff,
                     sharding=sharding)


def _mlacfg():
    from repro_torch.config.base import AttentionConfig
    return AttentionConfig(kind="mla", num_heads=4, num_kv_heads=4,
                           head_dim=8, kv_lora_rank=16, rope_head_dim=4,
                           nope_head_dim=8)


def _ssmcfg():
    from repro_torch.config.base import SSMConfig
    return SSMConfig(d_state=8, d_conv=4, expand=2)


def _edcfg():
    """Reduced whisper at the file's widths (4 heads of 8, float32)."""
    from repro_torch.config import get_config
    return dataclasses.replace(get_config("whisper-small", reduced=True),
                               d_model=D, d_ff=80, dtype="float32",
                               attention=_acfg(4, 4, rope="none"))


def _nest(p):
    """{"part.leaf": t} -> {"part": {"leaf": t}}."""
    out = {}
    for k, v in p.items():
        part, leaf = k.split(".")
        out.setdefault(part, {})[leaf] = v
    return out


def _mcfg(tied):
    from repro_torch.config import get_config
    return dataclasses.replace(get_config("llama3-8b", reduced=True),
                               d_model=D, vocab_size=VOCAB,
                               tie_embeddings=tied, dtype="float32")


# name: (kind, settings); "split" names each weight's dim over "model"
CASES = {
    "attn_kv2": ("attn", dict(heads=4, kv=2)),
    "attn_kv2_fused": ("attn", dict(heads=4, kv=2, fused=True)),
    "attn_kv1": ("attn", dict(heads=4, kv=1)),
    "attn_kv3_of_6": ("attn", dict(heads=6, kv=3)),
    "attn_window": ("attn", dict(heads=4, kv=2, window=6, q_chunk=8)),
    "attn_mrope": ("attn", dict(heads=4, kv=1, rope="mrope")),
    "mlp": ("mlp", dict(fused=False)),
    "mlp_fused": ("mlp", dict(fused=True)),
    "embed_tied": ("embed", dict(tied=True)),
    "embed_untied": ("embed", dict(tied=False)),
    "loss_tied": ("loss", dict(tied=True)),
    "loss_untied": ("loss", dict(tied=False)),
}
# the experts and MLA's heads, seeded after the cases above
LATER = {
    "moe_ep16": ("moe", dict()),
    "moe_ep16_capacity": ("moe", dict(dispatch="sparse_capacity")),
    "moe_padded": ("moe", dict(experts=None)),
    "moe_padded_capacity": ("moe", dict(experts=None,
                                        dispatch="sparse_capacity")),
    "moe_tp": ("moe", dict(experts=4, shared=1, sharding="tp")),
    "moe_shared": ("moe", dict(top_k=4, shared=2)),
    # shared units the axis does not divide stay whole beside the
    # split experts, added after the experts' sum
    "moe_shared_whole": ("moe", dict(shared=1, shared_ff=25)),
    "mla": ("mla", dict()),
    # Mamba's channels, whisper's encoder block and cross attention
    "mamba": ("mamba", dict()),
    "enc_block": ("enc", dict()),
    "cross": ("cross", dict(heads=4, kv=2)),
    "cross_kv1": ("cross", dict(heads=4, kv=1)),
}
# wide cases whose sums the split leaves whole do not follow the width:
# split bit for bit
WIDE = ("enc_block", "cross", "cross_kv1")
# the inputs whose gradients are held, per kind
INPUTS = {"attn": ("x",), "mlp": ("x",), "loss": ("x",), "moe": ("x",),
          "mla": ("x",), "mamba": ("x",), "enc": ("x",),
          "cross": ("x", "enc")}
T_ENC = 20      # the encoder states' length beside the decoder's S
SEEDS = {n: i for i, n in enumerate(sorted(CASES) + list(LATER))}
CASES.update(LATER)


def _draw(name):
    """(whole weights, inputs, each weight's model-split dim) as numpy."""
    kind, kw = CASES[name]
    rng = np.random.default_rng(SEEDS[name])

    def w(*shape):
        return (rng.normal(0, 1, shape) / np.sqrt(shape[0])).astype(
            np.float32)

    ins = {"x": rng.normal(0, 1, (B, S, D)).astype(np.float32),
           "r": rng.normal(0, 1, (B, S, D)).astype(np.float32)}
    if kind == "attn":
        a = _acfg(kw["heads"], kw["kv"], rope=kw.get("rope", "rope"))
        ws = {"wq": w(D, a.q_dim), "wk": w(D, a.kv_dim),
              "wv": w(D, a.kv_dim), "wo": w(a.q_dim, D)}
        split = {"wq": 1, "wk": 1, "wv": 1, "wo": 0}
        if kw.get("rope") == "mrope":
            ins["positions"] = rng.integers(0, S, (B, S, 3)).astype(np.int32)
    elif kind == "mlp":
        ws = {"w_gate": w(D, 80), "w_up": w(D, 80), "w_down": w(80, D)}
        split = {"w_gate": 1, "w_up": 1, "w_down": 0}
    elif kind == "moe":
        from repro_torch.models.layers.moe import moe_spec
        m = _moecfg(**{k: v for k, v in kw.items() if k != "dispatch"})
        ws = {k: w(*t.shape[-2:]) if len(t.shape) == 2 else np.stack(
            [w(*t.shape[1:]) for _ in range(t.shape[0])])
            for k, t in moe_spec(m, D, torch.float32).items()}
        tp_ = m.sharding == "tp"
        sh = m.d_ff_shared % 2 == 0
        split = {"router": None, "w_gate": 2 if tp_ else 0,
                 "w_up": 2 if tp_ else 0, "w_down": 1 if tp_ else 0,
                 "ws_gate": 1 if sh else None, "ws_up": 1 if sh else None,
                 "ws_down": 0 if sh else None}
    elif kind == "mla":
        from repro_torch.models.layers.mla import mla_spec
        ws = {k: w(*t.shape)
              for k, t in mla_spec(_mlacfg(), D, torch.float32).items()}
        split = {"wq": 1, "w_uk": 1, "w_uv": 1, "wo": 0, "w_dkv": None,
                 "w_kr": None}
    elif kind == "mamba":
        from repro_torch.models.layers.mamba import mamba_spec
        ws = {k: w(*t.shape) if len(t.shape) == 2 else
              rng.normal(0, 0.5, t.shape).astype(np.float32)
              for k, t in mamba_spec(_ssmcfg(), D, torch.float32).items()}
        ws["a_log"] = np.log(rng.uniform(0.5, 4.0, ws["a_log"].shape)
                             ).astype(np.float32)
        split = {"w_in": 1, "conv_w": 1, "conv_b": 0, "w_x": 0, "w_dt": 1,
                 "dt_bias": 0, "a_log": 0, "d_skip": 0, "w_out": 0}
    elif kind == "enc":
        from repro_torch.models.encdec import _enc_block_spec
        ws, split = {}, {}
        for part, leaves in _enc_block_spec(_edcfg(), torch.float32).items():
            for k, t in leaves.items():
                if part.startswith("ln"):
                    ws[f"{part}.{k}"] = rng.normal(
                        1.0 if k == "g" else 0.0, 0.1, t.shape).astype(
                            np.float32)
                    split[f"{part}.{k}"] = None
                else:
                    ws[f"{part}.{k}"] = w(*t.shape)
                    split[f"{part}.{k}"] = 0 if k in ("wo", "w_down") else 1
    elif kind == "cross":
        a = _acfg(kw["heads"], kw["kv"], rope="none")
        ws = {"wq": w(D, a.q_dim), "wk": w(D, a.kv_dim),
              "wv": w(D, a.kv_dim), "wo": w(a.q_dim, D)}
        split = {"wq": 1, "wk": 1, "wv": 1, "wo": 0}
        ins["enc"] = rng.normal(0, 1, (B, T_ENC, D)).astype(np.float32)
    else:
        tied = kw["tied"]
        ws = {"embed": w(VOCAB, D)}
        split = {"embed": 0 if tied or kind == "loss" else 1}
        if kind == "loss" and not tied:
            ws, split = {"lm_head": w(D, VOCAB)}, {"lm_head": 1}
        ins["tokens"] = rng.integers(0, VOCAB, (B, S)).astype(np.int64)
        labels = rng.integers(0, VOCAB, (B, S)).astype(np.int64)
        labels[:, -3:] = -1          # masked positions
        ins["labels"] = labels
    return ws, ins, split


def _layer(name, p, ins):
    """The layer of case ``name`` on params ``p`` and one row block of
    the inputs -> (its output, the scalar whose gradients are held)."""
    from repro_torch.models import lm
    from repro_torch.models.layers.attention import apply_attention
    from repro_torch.models.layers.common import apply_mlp
    kind, kw = CASES[name]
    if kind == "attn":
        a = _acfg(kw["heads"], kw["kv"], rope=kw.get("rope", "rope"),
                  window=kw.get("window", 0))
        out = apply_attention(p, a, ins["x"], window=a.window,
                              positions=ins.get("positions"),
                              q_chunk=kw.get("q_chunk", 512),
                              fused_qkv=kw.get("fused", False))
    elif kind == "mlp":
        out = apply_mlp(p, ins["x"], "silu", fused=kw["fused"],
                        split=p["w_down"].shape[0] != 80)
    elif kind == "moe":
        from repro_torch.models.layers.moe import apply_moe
        m = _moecfg(**{k: v for k, v in kw.items() if k != "dispatch"})
        out, aux = apply_moe(p, m, ins["x"], torch.nn.functional.silu,
                             dispatch=kw.get("dispatch", "dense"))
        return out, torch.sum(out * ins["r"]) + aux
    elif kind == "mla":
        from repro_torch.models.layers.mla import apply_mla
        out = apply_mla(p, _mlacfg(), ins["x"], q_chunk=16)
    elif kind == "mamba":
        from repro_torch.models.layers.mamba import apply_mamba
        out = apply_mamba(p, _ssmcfg(), ins["x"], chunk=8)
    elif kind == "enc":
        from repro_torch.models.encdec import _enc_block
        out = _enc_block(_edcfg(), _nest(p), ins["x"], q_chunk=16)
    elif kind == "cross":
        from repro_torch.models.layers.attention import apply_cross_attention
        out = apply_cross_attention(p, _acfg(kw["heads"], kw["kv"],
                                             rope="none"),
                                    ins["x"], ins["enc"], q_chunk=8)
    elif kind == "embed":
        out = lm.embed_tokens(_mcfg(kw["tied"]), p, ins["tokens"])
    else:
        out = lm.chunked_ce_loss(_mcfg(kw["tied"]), p, ins["x"],
                                 ins["labels"])
        return out, out
    return out, torch.sum(out * ins["r"])


def _blocks(ins, n, i):
    return {k: torch.as_tensor(v[i * (B // n):(i + 1) * (B // n)])
            for k, v in ins.items()}


def _run(name, p, ins, n_data, data_index):
    """(output, gradients of the params and of the INPUTS) on one row
    block."""
    p = {k: v.detach().requires_grad_(True) for k, v in p.items()}
    rows = _blocks(ins, n_data, data_index)
    held = INPUTS.get(CASES[name][0], ())
    for k in held:
        rows[k].requires_grad_(True)
    out, obj = _layer(name, p, rows)
    grads = torch.autograd.grad(obj, list(p.values())
                                + [rows[k] for k in held])
    return out.detach(), dict(zip(list(p) + list(held), grads))


def _reference(name):
    """The unsplit layer on one process, per row block of the data
    ranks: {n_data: (outputs, {input: its gradient per block}, weight
    gradients summed)}."""
    ws, ins, _ = _draw(name)
    held = INPUTS.get(CASES[name][0], ())
    out = {}
    for n in (1, 2):
        outs, dins, wg = [], {k: [] for k in held}, {}
        for i in range(n):
            o, g = _run(name, {k: torch.as_tensor(v) for k, v in ws.items()},
                        ins, n, i)
            outs.append(o.numpy())
            for k in held:
                dins[k].append(g[k].numpy())
            for k in ws:
                wg[k] = wg.get(k, 0) + g[k].numpy()
        out[n] = (outs, dins, wg)
    return out


def _worker(rank, world, init, out_dir):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import tensor_parallel as tp
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, world_size=world,
                            rank=rank)
    try:
        shape = (1, 2) if world == 2 else (2, 2)
        mesh = make_host_mesh(shape, device="cpu")
        m, r = mesh.size("model"), mesh.index("model")
        n_data, di = mesh.size("data"), mesh.index("data")
        res = {}
        for name in CASES:
            ws, ins, split = _draw(name)
            p = {}
            for k, v in ws.items():
                d = split[k]
                if d is None:            # whole over the model axis
                    p[k] = torch.as_tensor(v)
                    continue
                size = v.shape[d] // m
                p[k] = torch.as_tensor(v).narrow(d, r * size, size).clone()
            with tp.step_layout(mesh, None):
                out, g = _run(name, p, ins, n_data, di)
            res[f"{name}/out"] = torch.stack(mesh.all_gather(out, "data"))
            for k in INPUTS.get(CASES[name][0], ()):
                res[f"{name}/d{k}"] = torch.stack(mesh.all_gather(g[k],
                                                                  "data"))
            for k in ws:
                parts = mesh.all_gather(g[k], "model")
                if split[k] is None:     # every model rank's, stacked
                    whole = torch.stack(parts)
                else:
                    whole = torch.cat(parts, dim=split[k])
                res[f"{name}/{k}"] = mesh.all_reduce(whole, "sum", "data")
        res.update(_decode_split(mesh))
        if rank == 0:
            np.savez(os.path.join(out_dir, "res.npz"),
                     **{k: v.numpy() for k, v in res.items()})
    finally:
        dist.destroy_process_group()


def _spawn(world, tmp_path):
    import torch.multiprocessing as mp
    pctx = mp.start_processes(
        _worker, args=(world, f"file://{tmp_path}/rdzv", str(tmp_path)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.time() + TIMEOUT_S
    while not pctx.join(timeout=max(1.0, deadline - time.time())):
        if time.time() > deadline:
            for p in pctx.processes:
                p.kill()
            pytest.fail(f"{world} ranks did not finish in {TIMEOUT_S} s")
    return dict(np.load(tmp_path / "res.npz"))


@pytest.fixture(scope="module")
def split_runs(tmp_path_factory):
    return {w: _spawn(w, tmp_path_factory.mktemp(f"tp{w}")) for w in (2, 4)}


def _close(got, want, what):
    np.testing.assert_allclose(got, want, **TOL,
                               atol=ATOL * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
@pytest.mark.parametrize("name", list(CASES))
def test_split_layer_equals_the_whole_layer(name, mesh, split_runs):
    world, n_data = (2, 1) if mesh == "1x2" else (4, 2)
    got = split_runs[world]
    outs, dins, wg = _reference(name)[n_data]
    for i in range(n_data):
        _close(got[f"{name}/out"][i], outs[i], f"{name} output block {i}")
        for k, blocks in dins.items():
            _close(got[f"{name}/d{k}"][i], blocks[i],
                   f"{name} d{k} block {i}")
    _, _, split = _draw(name)
    for k, w in wg.items():
        if split[k] is None:             # the same on every model rank
            for i, g in enumerate(got[f"{name}/{k}"]):
                _close(g, w, f"{name} grad {k} on model rank {i}")
        else:
            _close(got[f"{name}/{k}"], w, f"{name} grad {k}")


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
@pytest.mark.parametrize("name", WIDE)
def test_wide_split_layer_is_the_whole_layer_bit_for_bit(name, mesh,
                                                         split_runs):
    world, n_data = (2, 1) if mesh == "1x2" else (4, 2)
    got = split_runs[world]
    outs, dins, wg = _reference(name)[n_data]
    for i in range(n_data):
        np.testing.assert_array_equal(got[f"{name}/out"][i], outs[i])
        for k, blocks in dins.items():
            np.testing.assert_array_equal(got[f"{name}/d{k}"][i], blocks[i],
                                          err_msg=f"d{k} block {i}")
    _, _, split = _draw(name)
    for k, w in wg.items():
        for g in (got[f"{name}/{k}"] if split[k] is None
                  else [got[f"{name}/{k}"]]):
            np.testing.assert_array_equal(g, w, err_msg=f"grad {k}")


def test_one_rank_on_the_model_axis_is_the_plain_layer():
    """Under a (2, 1) layout (no process group: a CountingMesh whose
    collectives would be recorded) every case is the plain layer, bit
    for bit, and the model axis moves nothing."""
    from repro_torch.config import MeshConfig
    from repro_torch.roofline.counter import CountingMesh
    from repro_torch.sharding import tensor_parallel as tp
    mesh = CountingMesh(MeshConfig((2, 1), ("data", "model")),
                        device="cpu")
    for name in CASES:
        ws, ins, _ = _draw(name)
        p = {k: torch.as_tensor(v) for k, v in ws.items()}
        want = _run(name, p, ins, 1, 0)
        with tp.step_layout(mesh, None):
            got = _run(name, p, ins, 1, 0)
        assert torch.equal(got[0], want[0]), name
        for k in want[1]:
            assert torch.equal(got[1][k], want[1][k]), (name, k)
    assert mesh.plan == []


# (forward, backward without the recompute, the recompute's own) model
# axis all-reduces of one block at (1, 2): every block sums its mixer's
# and its FFN's output once (g); the backward sums the input gradient of
# attention (f on x), of MLA (f on x, on the latent and on the rope key),
# of a dense FFN (f on x) and of an MoE (f on the experts' input and on
# the gates); the recompute reruns the mixer's sums only, since the
# FFN's output (the dense FFN's down projection, the MoE's kept combine
# and shared projection) is not recomputed.  A Mamba mixer sums two in
# the forward and in the recompute (its rows' part of (dt, B, C), g,
# and its output, g) and three in the backward (f on x, f on (dt, B, C)
# and the gradient of its regathered ``w_in``), so a Mamba + dense
# block is (3, 4, 2) and a Mamba + MoE block (3, 5, 2)
BLOCK_COLLECTIVES = {
    "qwen2-moe-a2.7b": [(2, 3, 1), (2, 3, 1)],           # attn + MoE
    "deepseek-v2-lite-16b": [(2, 4, 1), (2, 5, 1)],      # MLA + dense, MoE
    # Mamba + dense, Mamba + MoE, attn + dense, Mamba + MoE
    "jamba-v0.1-52b": [(3, 4, 2), (3, 5, 2), (2, 2, 1), (3, 5, 2)],
}
# the model axis's all-gathers of a stack at (1, 2): one per Mamba layer
# (its ``w_in`` whole, the only weight regathered over the axis),
# rerun by the recompute
BLOCK_GATHERS = {"jamba-v0.1-52b": 3}


@pytest.mark.parametrize("arch", sorted(BLOCK_COLLECTIVES))
def test_model_axis_collectives_of_a_block(arch):
    """Reduced ``arch``'s blocks (float32) forward and backward over a
    (1, 2) ``CountingMesh`` on the meta device, remat "none" and
    "full": the all-reduces over the model axis are BLOCK_COLLECTIVES';
    no gather but BLOCK_GATHERS' of each Mamba layer's ``w_in``, whole
    (every other weight is the rank's block or whole there)."""
    from repro_torch.config import MeshConfig, get_config
    from repro_torch.models import api, lm
    from repro_torch.models.layers.common import zeros_from_spec
    from repro_torch.roofline.counter import CountingMesh
    from repro_torch.sharding import ctx
    from repro_torch.sharding import tensor_parallel as tp
    from repro_torch.sharding.partition import named, param_partition
    from repro_torch.sharding.spmd import shard_tree
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="float32")
    want = BLOCK_COLLECTIVES[arch]
    gathers = BLOCK_GATHERS.get(arch, 0)
    d, di = cfg.d_model, cfg.ssm.expand * cfg.d_model if cfg.ssm else 0
    for remat in ("none", "full"):
        mesh = CountingMesh(MeshConfig((1, 2), ("data", "model")))
        spec = api.param_spec(cfg)
        psh = named(mesh, param_partition(cfg, spec, mesh.config))
        params = tree_map(lambda t: t.requires_grad_(True), shard_tree(
            zeros_from_spec(spec, device="meta"), psh))
        x = torch.zeros((2, 8, cfg.d_model), device="meta",
                        requires_grad=True)
        with ctx.active_mesh(mesh, data_axes=mesh.data_axes), \
                tp.step_layout(mesh, psh):
            out, aux = lm.apply_stack(cfg, params, x, remat=remat)
            n_fwd = len(mesh.plan)
            (out.sum() + aux).backward()
        ops = [op for op, _, _ in mesh.plan]
        assert set(ops) <= {"all-reduce", "all-gather"}, mesh.plan
        fwd, bwd = ops[:n_fwd], ops[n_fwd:]
        assert fwd.count("all-reduce") == sum(f for f, _, _ in want), (
            remat, mesh.plan)
        n_bwd = sum(b + (r if remat == "full" else 0) for _, b, r in want)
        assert bwd.count("all-reduce") == n_bwd, (remat, mesh.plan)
        assert fwd.count("all-gather") == gathers, (remat, mesh.plan)
        assert bwd.count("all-gather") == (
            gathers if remat == "full" else 0), (remat, mesh.plan)
        for op, nbytes, _ in mesh.plan:
            if op == "all-gather":          # w_in whole, float32
                assert nbytes == d * 2 * di * 4, mesh.plan


# --- decode: one token against a cache, per layout --------------------

# name: (kind, settings); appended after the cases above, so their seeds
# are unchanged.  The cache's split over "model" follows
# cache_partition: (i) by kv heads where they divide the axis, (ii) by
# head_dim where only it divides (the rope'd new token whole, the
# scores' parts summed), (iii) whole (whisper's caches: the rank's query
# heads read their kv heads from it, the new K/V gathered whole)
DECODE = {
    "dec_attn_kv2": ("attn", dict(heads=4, kv=2, cache={"k": 2, "v": 2})),
    "dec_attn_kv1": ("attn", dict(heads=4, kv=1, cache={"k": 3, "v": 3})),
    "dec_attn_window": ("attn", dict(heads=4, kv=2, window=6,
                                     cache={"k": 2, "v": 2})),
    "dec_attn_kv1_window": ("attn", dict(heads=4, kv=1, window=6,
                                         cache={"k": 3, "v": 3})),
    "dec_attn_whole_cache": ("attn", dict(heads=4, kv=2, cache={})),
    # a rank's 3 query heads read kv heads 0, 0, 1 (or 1, 2, 2)
    "dec_attn_kv3_of_6_whole_cache": ("attn", dict(heads=6, kv=3,
                                                   cache={})),
    "dec_mla": ("mla", dict(cache={})),
    "dec_mamba": ("mamba", dict(cache={"h": 1, "conv": 2})),
    "dec_cross": ("cross", dict(heads=4, kv=2, cache={})),
    "dec_cross_kv1": ("cross", dict(heads=4, kv=1, cache={})),
}
SEEDS.update({n: len(SEEDS) + i for i, n in enumerate(DECODE)})
T_CACHE, POS0, DEC_STEPS = 12, 9, 3     # positions 9-11: a ring of 6 wraps


def _draw_decode(name):
    """(whole weights, their model-split dims, the cache, the cache's
    model-split dims, the STEPS inputs (steps, B, 1, D)) as numpy."""
    kind, kw = DECODE[name]
    rng = np.random.default_rng(SEEDS[name])

    def w(*shape):
        return (rng.normal(0, 1, shape) / np.sqrt(shape[0])).astype(
            np.float32)

    def n(*shape, sd=1.0):
        return rng.normal(0, sd, shape).astype(np.float32)

    if kind in ("attn", "cross"):
        a = _acfg(kw["heads"], kw["kv"],
                  rope="rope" if kind == "attn" else "none")
        ws = {"wq": w(D, a.q_dim), "wk": w(D, a.kv_dim),
              "wv": w(D, a.kv_dim), "wo": w(a.q_dim, D)}
        split = {"wq": 1, "wk": 1, "wv": 1, "wo": 0}
        t = kw.get("window") or (T_CACHE if kind == "attn" else T_ENC)
        cache = {"k": n(B, t, a.num_kv_heads, a.head_dim),
                 "v": n(B, t, a.num_kv_heads, a.head_dim)}
    elif kind == "mla":
        from repro_torch.models.layers.mla import mla_spec
        m = _mlacfg()
        ws = {k: w(*t.shape)
              for k, t in mla_spec(m, D, torch.float32).items()}
        split = {"wq": 1, "w_uk": 1, "w_uv": 1, "wo": 0, "w_dkv": None,
                 "w_kr": None}
        cache = {"c_kv": n(B, T_CACHE, m.kv_lora_rank),
                 "k_rope": n(B, T_CACHE, m.rope_head_dim)}
    else:
        from repro_torch.models.layers.mamba import mamba_spec
        c = _ssmcfg()
        ws = {k: w(*t.shape) if len(t.shape) == 2 else
              rng.normal(0, 0.5, t.shape).astype(np.float32)
              for k, t in mamba_spec(c, D, torch.float32).items()}
        ws["a_log"] = np.log(rng.uniform(0.5, 4.0, ws["a_log"].shape)
                             ).astype(np.float32)
        split = {"w_in": 1, "conv_w": 1, "conv_b": 0, "w_x": 0, "w_dt": 1,
                 "dt_bias": 0, "a_log": 0, "d_skip": 0, "w_out": 0}
        di = c.expand * D
        cache = {"h": n(B, di, c.d_state, sd=0.5),
                 "conv": n(B, c.d_conv - 1, di)}
    return ws, split, cache, kw["cache"], n(DEC_STEPS, B, 1, D)


def _decode_layer(name, p, cache, xs):
    """DEC_STEPS tokens of case ``name`` from position POS0: (outputs
    (steps, B, 1, D), the last cache)."""
    from repro_torch.models.layers import attention, mamba, mla
    kind, kw = DECODE[name]
    outs = []
    with torch.no_grad():
        for i, x in enumerate(xs):
            pos = torch.tensor(POS0 + i, dtype=torch.int32)
            if kind == "attn":
                o, cache = attention.decode_attention(
                    p, _acfg(kw["heads"], kw["kv"]), x, cache, pos,
                    window=kw.get("window", 0))
            elif kind == "cross":
                o = attention.decode_cross_attention(
                    p, _acfg(kw["heads"], kw["kv"], rope="none"), x, cache)
            elif kind == "mla":
                o, cache = mla.decode_mla(p, _mlacfg(), x, cache, pos)
            else:
                o, cache = mamba.decode_mamba(p, _ssmcfg(), x, cache)
            outs.append(o)
    return torch.stack(outs), cache


def _decode_split(mesh):
    """Every decode case on this rank's model block of the weights and
    of the cache and its rows: its outputs stacked over the data ranks
    and its last cache gathered whole."""
    from repro_torch.sharding import tensor_parallel as tp
    m, r = mesh.size("model"), mesh.index("model")
    n_data, di = mesh.size("data"), mesh.index("data")

    def block(v, d, size, i):
        return torch.as_tensor(v).narrow(d, i * size, size).clone()

    res = {}
    for name in DECODE:
        ws, split, cache, csplit, xs = _draw_decode(name)
        p = {k: torch.as_tensor(v) if split[k] is None else
             block(v, split[k], v.shape[split[k]] // m, r)
             for k, v in ws.items()}
        rows = B // n_data
        c = {k: block(v, 0, rows, di) for k, v in cache.items()}
        c = {k: v if k not in csplit else
             v.narrow(csplit[k], r * (v.shape[csplit[k]] // m),
                      v.shape[csplit[k]] // m).clone()
             for k, v in c.items()}
        with tp.step_layout(mesh, None):
            out, new = _decode_layer(name, p, c,
                                     torch.as_tensor(xs)[:, di * rows:
                                                         (di + 1) * rows])
        res[f"{name}/out"] = torch.cat(mesh.all_gather(out, "data"), dim=1)
        for k, v in new.items():
            if k in csplit:
                v = torch.cat(mesh.all_gather(v, "model"), dim=csplit[k])
            res[f"{name}/cache.{k}"] = torch.cat(mesh.all_gather(v, "data"))
    return res


def _decode_reference(name, n_data):
    """The whole layer on one process, per row block of ``n_data`` data
    ranks: (outputs (steps, B, 1, D), {leaf: the last cache})."""
    ws, _, cache, _, xs = _draw_decode(name)
    p = {k: torch.as_tensor(v) for k, v in ws.items()}
    rows = B // n_data
    outs, caches = [], []
    for i in range(n_data):
        sl = slice(i * rows, (i + 1) * rows)
        o, c = _decode_layer(name, p,
                             {k: torch.as_tensor(v[sl])
                              for k, v in cache.items()},
                             torch.as_tensor(xs[:, sl]))
        outs.append(o)
        caches.append(c)
    return (torch.cat(outs, dim=1).numpy(),
            {k: torch.cat([c[k] for c in caches]).numpy()
             for k in caches[0]})


@pytest.mark.parametrize("mesh", ["1x2", "2x2"])
@pytest.mark.parametrize("name", list(DECODE))
def test_split_decode_equals_the_whole_layer(name, mesh, split_runs):
    """DEC_STEPS decode tokens of each case at 1x2 and 2x2 against the
    whole layer: the outputs and the last cache (each rank's block
    gathered) at the file's limits."""
    world, n_data = (2, 1) if mesh == "1x2" else (4, 2)
    got = split_runs[world]
    out, cache = _decode_reference(name, n_data)
    _close(got[f"{name}/out"], out, f"{name} outputs")
    for k, v in cache.items():
        _close(got[f"{name}/cache.{k}"], v, f"{name} cache {k}")


def test_one_rank_on_the_model_axis_is_the_plain_decode_layer():
    """Under a (2, 1) layout (a CountingMesh, no process group) every
    decode case is the plain layer bit for bit and the model axis moves
    nothing."""
    from repro_torch.config import MeshConfig
    from repro_torch.roofline.counter import CountingMesh
    from repro_torch.sharding import tensor_parallel as tp
    mesh = CountingMesh(MeshConfig((2, 1), ("data", "model")),
                        device="cpu")
    for name in DECODE:
        ws, _, cache, _, xs = _draw_decode(name)
        args = ({k: torch.as_tensor(v) for k, v in ws.items()},
                {k: torch.as_tensor(v) for k, v in cache.items()},
                torch.as_tensor(xs))
        want = _decode_layer(name, *args)
        with tp.step_layout(mesh, None):
            got = _decode_layer(name, *args)
        assert torch.equal(got[0], want[0]), name
        for k in want[1]:
            assert torch.equal(got[1][k], want[1][k]), (name, k)
    assert mesh.plan == []


# (all-reduces, all-gathers) over the model axis of one decode step at
# (1, 2), per block and outside the blocks.  A dense FFN or an MoE sums
# its output once (g; the MoE's routed and shared parts together).
# Attention with the cache by kv heads (i) and MLA (its latent cache off
# the axis) sum their output once; attention with the cache by head_dim
# (ii) gathers the new token's q, k and v (one gather of the three),
# sums the scores' parts, gathers p @ v's head_dim blocks and sums its
# output: (2, 2); with the cache whole (iii: whisper's self attention)
# it gathers the new k and v and sums its output: (1, 1); whisper's
# cross attention sums its output.  A Mamba layer sums its rows' part of
# (dt, B, C) and its output and regathers ``w_in``: (2, 1).  Outside
# the blocks an untied embedding gathers its columns and a tied one sums
# its vocabulary rows; the head's vocabulary blocks of the logits are
# gathered.
DECODE_COLLECTIVES = {
    # untied; attn (i) + MoE, twice
    "qwen2-moe-a2.7b": ([(2, 0), (2, 0)], (0, 2)),
    # untied; MLA + dense (the prefix), MLA + MoE
    "deepseek-v2-lite-16b": ([(2, 0), (2, 0)], (0, 2)),
    # untied; Mamba + dense, Mamba + MoE, attn (i) + dense, Mamba + MoE
    "jamba-v0.1-52b": ([(3, 1), (3, 1), (2, 0), (3, 1)], (0, 2)),
    # tied; attn (ii) + dense, three times
    "granite-34b": ([(3, 2)] * 3, (1, 1)),
    # untied; self (iii) + cross + dense, twice
    "whisper-small": ([(3, 1)] * 2, (0, 2)),
}


@pytest.mark.parametrize("arch", sorted(DECODE_COLLECTIVES))
def test_model_axis_collectives_of_a_decode_step(arch):
    """One decode step of reduced ``arch`` (float32) through
    ``make_mesh_serve_step`` over a (1, 2) ``CountingMesh`` on the meta
    device: its model-axis all-reduces and all-gathers are
    DECODE_COLLECTIVES' sums, and no all-gather moves a param but
    jamba's ``w_in`` (its float32 bytes)."""
    from repro_torch.config import MeshConfig, ShapeConfig, get_config
    from repro_torch.models import api
    from repro_torch.models.layers.common import zeros_from_spec
    from repro_torch.roofline.counter import CountingMesh
    from repro_torch.sharding.partition import (cache_partition, named,
                                                param_partition)
    from repro_torch.sharding.spmd import make_mesh_serve_step, shard_tree
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              dtype="float32")
    mesh = CountingMesh(MeshConfig((1, 2), ("data", "model")))
    shape = ShapeConfig("d", "decode", 16, 4)
    spec = api.param_spec(cfg)
    psh = named(mesh, param_partition(cfg, spec, mesh.config))
    sspec = api.decode_state_spec(cfg, 4, 16)
    csh = named(mesh, cache_partition(cfg, shape, mesh.config, sspec))
    step = make_mesh_serve_step(cfg, mesh, psh, csh, shape)
    step(shard_tree(zeros_from_spec(spec, device="meta"), psh),
         shard_tree(zeros_from_spec(sspec, device="meta"), csh),
         torch.zeros((4, 1), dtype=torch.int32, device="meta"))
    blocks, top = DECODE_COLLECTIVES[arch]
    ops = [op for op, _, _ in mesh.plan]
    assert set(ops) <= {"all-reduce", "all-gather"}, mesh.plan
    assert ops.count("all-reduce") == sum(a for a, _ in blocks) + top[0], (
        mesh.plan)
    assert ops.count("all-gather") == sum(g for _, g in blocks) + top[1], (
        mesh.plan)
    if cfg.ssm is not None:
        di = cfg.ssm.expand * cfg.d_model
        w_in = [b for op, b, _ in mesh.plan
                if op == "all-gather" and b == cfg.d_model * 2 * di * 4]
        assert len(w_in) == sum(s.mixer == "mamba"
                                for s in cfg.layer_specs()), mesh.plan

