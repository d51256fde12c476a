"""The meta counter's training-step FLOPs against the reference's HLO
count on the other reduced LM archs (whisper, the VLM and the
decoder-only ones) at 4 x 64, remat ``full`` and, for llama3-8b,
``none``: equal, no named term (the terms are named in
tests/test_torch_roofline_flops.py)."""
import pytest

from test_torch_roofline_flops import LM_ARCHS, check_train


@pytest.mark.parametrize("arch", LM_ARCHS[4:])
def test_train_flops_equal_the_reference_up_to_the_embedding(arch):
    assert check_train(arch, "full") == {}


def test_train_flops_without_remat():
    assert check_train("llama3-8b", "none") == {}
