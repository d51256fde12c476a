"""Port parity: the FPGA cost model (``repro_torch.core.cost_model``, a
copy of ``repro.core.cost_model``) gives the reference's estimates
field for field, as exact floats, on every registered config (full and
reduced, chains and LUT graphs) and every point of the paper's Pareto
grid; ``PAPER_TABLE3``, ``K_SIMPLIFY`` and ``rom_cost`` agree too."""
import dataclasses

import pytest

from repro.config import get_config as j_get_config
from repro.core import cost_model as JCM
from repro.sweep import paper_sweep_points as j_paper_points
from repro_torch.config import get_config, list_archs
from repro_torch.core import cost_model as CM
from repro_torch.sweep import paper_sweep_points


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", list_archs())
def test_estimate_equals_reference_on_registered_configs(arch, reduced):
    a = CM.estimate(get_config(arch, reduced=reduced))
    b = JCM.estimate(j_get_config(arch, reduced=reduced))
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


def test_estimate_equals_reference_on_paper_points():
    port, ref = paper_sweep_points(), j_paper_points()
    assert len(port) == len(ref) == 6
    for a, b in zip(port, ref):
        ea, eb = CM.estimate(a.cfg), JCM.estimate(b.cfg)
        assert dataclasses.asdict(ea) == dataclasses.asdict(eb), a.name
        assert ea.layers == a.cfg.num_layers and ea.luts > 0


def test_tables_and_rom_cost_equal_reference():
    assert CM.PAPER_TABLE3 == JCM.PAPER_TABLE3
    assert CM.K_SIMPLIFY == JCM.K_SIMPLIFY
    assert [CM.rom_cost(n) for n in range(1, 21)] == \
        [JCM.rom_cost(n) for n in range(1, 21)]
