"""The meta counter's decode-step FLOPs equal the reference's HLO count
(``analyze_hlo`` of the jitted serve step, compiled, one device) on the
ten reduced LM archs at 4 rows with a 64-token context: no named term
applies to decode."""
import pytest

from test_torch_roofline_flops import LM_ARCHS, port_flops, ref_flops


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_decode_flops_equal_the_reference(arch):
    assert port_flops(arch, "decode") == ref_flops(arch, "decode")
