"""The meta counter's training-step FLOPs against the reference's HLO
count (``repro.roofline.hlo.analyze_hlo`` of the jitted step, compiled,
one device), on the reduced MoE, MLA + MoE, xLSTM and jamba archs of
the reference's dry run at 4 rows x 64 tokens, remat ``full`` (the
other six archs, and remat ``none``, in
tests/test_torch_roofline_flops_dense.py).

The two steps differ by named terms only, each a formula of the config
(``T`` = rows x tokens, ``E`` the padded experts):

* ``moe_outer`` (+2 T d E per MoE layer) and ``mamba_outer`` (+2 T DI N
  per Mamba layer): the backward of ``einsum("etd,te->td")`` (the MoE
  combine) and of ``einsum("bsdn,bsn->bsd")`` (Mamba's readout) take,
  for one operand, an outer product, which PyTorch runs as a batched
  matmul of contraction 1 (counted) and XLA as a multiply (not a dot):
  the same arithmetic;
* ``mlstm_last_state`` (-2 x 2 B H W dh^2 per mLSTM layer, remat full):
  the reference's scan over chunks updates the matrix state after the
  last chunk too, in the forward and the recompute; nothing reads it,
  and the port does not compute it;
* ``slstm_h0_grad`` (-2 B H 4dh dh per sLSTM layer): the reference's
  scan takes the gradient of its first step's recurrent input, the
  constant zero state; the port's autograd does not.

An untied embedding's backward (a sum of the gradient's rows by token
id) and the MoE layer's recompute (which stops before the routed
combine) add no dot, as the reference's scatter and remat add none.
"""
import pytest
import torch

from repro.config import ShapeConfig as JShape
from repro.config import TrainConfig as JTrain
from repro.config import get_config as j_get_config
from repro.models import api as JA
from repro.optim.adamw import adamw_init_spec as j_adamw_init_spec
from repro.roofline.hlo import analyze_hlo
from repro.train.step import make_serve_step as j_make_serve_step
from repro.train.step import make_train_step as j_make_train_step

from repro_torch.config import ShapeConfig, TrainConfig, get_config
from repro_torch.models import api
from repro_torch.models.layers.moe import padded_num_experts
from repro_torch.optim.adamw import adamw_init_spec
from repro_torch.roofline import count_step
from repro_torch.train.step import make_serve_step, make_train_step
from repro_torch.tree import tree_map

LM_ARCHS = (
    "deepseek-v2-lite-16b", "qwen2-moe-a2.7b", "xlstm-350m",
    "jamba-v0.1-52b", "whisper-small", "qwen2-vl-72b", "granite-34b",
    "gemma3-12b", "llama3-8b", "yi-9b",
)
B, S = 4, 64
MLSTM_CHUNK = 128      # apply_mlstm's chunk


def ref_flops(arch, kind, remat="full"):
    import jax
    cfg = j_get_config(arch, reduced=True)
    shape = JShape("cell", kind, S, B)
    spec = JA.param_spec(cfg)
    ins = JA.input_specs(cfg, shape)
    if kind == "train":
        low = jax.jit(j_make_train_step(cfg, JTrain(remat=remat))).lower(
            spec, j_adamw_init_spec(spec), ins)
    else:
        low = jax.jit(j_make_serve_step(cfg)).lower(spec, ins["state"],
                                                    ins["token"])
    return analyze_hlo(low.compile().as_text(), num_partitions=1).dot_flops


def _meta(tree):
    return tree_map(lambda s: None if s is None else torch.empty(
        s.shape, dtype=s.dtype, device="meta"), tree)


def port_flops(arch, kind, remat="full"):
    cfg = get_config(arch, reduced=True)
    spec = api.param_spec(cfg)
    ins = api.input_specs(cfg, ShapeConfig("cell", kind, S, B))
    if kind == "train":
        step = make_train_step(cfg, TrainConfig(remat=remat))
        args = (_meta(spec), _meta(adamw_init_spec(spec)), _meta(ins))
    else:
        step = make_serve_step(cfg)
        args = (_meta(spec), _meta(ins["state"]), _meta(ins["token"]))
    return count_step(step, *args).dot_flops


def terms(arch, remat="full"):
    """The named terms (port minus reference) of a training step, by
    formula (the module's docstring)."""
    cfg = get_config(arch, reduced=True)
    t, d, out = B * S, cfg.d_model, {}

    def add(name, v):
        out[name] = out.get(name, 0) + v

    for spec in cfg.layer_specs():
        if spec.ffn == "moe":
            e = padded_num_experts(cfg.moe, 16)
            add("moe_outer", 2 * t * d * e)
        if spec.mixer == "mamba":
            add("mamba_outer", 2 * t * cfg.ssm.expand * d * cfg.ssm.d_state)
        if spec.mixer == "mlstm" and remat == "full":
            h = cfg.ssm.num_heads
            dh = int(cfg.ssm.proj_factor * d) // h
            add("mlstm_last_state",
                -2 * (2 * B * h * min(MLSTM_CHUNK, S) * dh * dh))
        if spec.mixer == "slstm":
            h = cfg.ssm.num_heads
            dh = d // h
            add("slstm_h0_grad", -2 * B * h * 4 * dh * dh)
    return out


def check_train(arch, remat):
    named = terms(arch, remat)
    assert port_flops(arch, "train", remat) - ref_flops(arch, "train",
                                                        remat) == \
        sum(named.values()), named
    return named


# the archs with named terms past the embedding's (MoE, Mamba, xLSTM);
# the others are in test_torch_roofline_flops_dense.py (one JAX compile
# each: ~7 s)
@pytest.mark.parametrize("arch", LM_ARCHS[:4])
def test_train_flops_equal_the_reference_up_to_named_terms(arch):
    assert check_train(arch, "full")
