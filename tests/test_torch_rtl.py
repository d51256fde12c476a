"""Port parity: Verilog RTL emission (``repro_torch.core.rtl`` against
``repro.core.rtl``), mirroring tests/test_core_rtl.py.

* Byte-identical files: on the same tables and connectivity (random,
  from a fixed numpy rng, handed to both packages), every file the port
  writes equals the reference's, for every chain config, reduced and
  full width (at full width by streamed SHA-256: jsc-5l writes ~100 MB).
* The port's own tables: converted by the port (the toy model of
  tests/test_core_rtl.py and reduced jsc-5l), every ROM re-simulated
  equals its table, and the whole emitted circuit, walked through its
  wiring and re-simulated ROMs, equals ``lut_infer.lut_forward``.
* Wiring: slot 0 of a neuron's address at the MSB.
* Graphs: a degenerate-chain ``LUTGraphConfig`` is unwrapped to its
  chain's files; the PolyLUT-Add DAGs are refused.
"""
import hashlib
import importlib
import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import rtl as JRTL
from repro_torch.config import get_config
from repro_torch.core import lut_infer as LI
from repro_torch.core import model as M
from repro_torch.core import rtl
from repro_torch.core import truth_table as TT
from repro_torch.core.nl_config import NeuraLUTConfig, UnsupportedTopology

torch.set_num_threads(1)

CHAINS = ["neuralut_hdr_5l", "neuralut_jsc_2l", "neuralut_jsc_5l"]


def _toy():
    """tests/test_core_rtl.py's toy model, initialized and converted by
    the port."""
    cfg = NeuraLUTConfig(name="rtl-toy", in_features=4, layer_widths=(6, 3),
                         num_classes=3, beta=2, fan_in=3, kind="subnet",
                         depth=2, width=4, skip=2)
    return (cfg,) + _converted(cfg)


def _converted(cfg):
    statics = M.model_static(cfg)
    params, state = M.model_init(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    return statics, TT.convert(cfg, params, state, statics)


def _random_net(cfg, seed):
    """Random tables and connectivity of ``cfg``'s shapes (numpy)."""
    rng = np.random.default_rng(seed)
    tables, statics, w = [], [], cfg.in_features
    for i, o in enumerate(cfg.layer_widths):
        statics.append({"conn": rng.integers(0, w, (o, cfg.layer_fan_in(i)))})
        tables.append(rng.integers(0, 2 ** cfg.beta, (o, cfg.table_size(i)))
                      .astype(np.uint16))
        w = o
    return tables, statics


def _sha(path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 22), b""):
            h.update(chunk)
    return h.hexdigest()


def _same_files(got, want):
    assert [Path(p).name for p in got] == [Path(p).name for p in want]
    for a, b in zip(got, want):
        assert _sha(a) == _sha(b), f"{Path(a).name} differs"


@pytest.mark.parametrize("variant", ["reduced", "full"])
@pytest.mark.parametrize("mod", CHAINS)
def test_rtl_files_byte_identical_to_reference(mod, variant, tmp_path):
    cfg = get_config(mod.replace("_", "-"), reduced=variant == "reduced")
    jcfg = getattr(importlib.import_module(f"repro.configs.{mod}"),
                   variant)()
    tables, statics = _random_net(cfg, seed=len(cfg.name))
    # the port's inputs in the port's own forms: int32 tensors of tables
    # and of connectivity
    port_tables = [torch.as_tensor(t.astype(np.int32)) for t in tables]
    port_statics = [{"conn": torch.as_tensor(s["conn"])} for s in statics]
    got = rtl.generate_top(cfg, port_tables, port_statics,
                           str(tmp_path / "port"))
    want = JRTL.generate_top(jcfg, tables, statics, str(tmp_path / "ref"))
    assert len(got) == cfg.num_layers + 1
    _same_files(got, want)
    shutil.rmtree(tmp_path)


def test_rtl_toy_byte_identical_to_reference(tmp_path):
    cfg, statics, tables = _toy()
    got = rtl.generate_top(cfg, tables, statics, str(tmp_path / "port"))
    want = JRTL.generate_top(cfg, tables, [{"conn": np.asarray(s["conn"])}
                                           for s in statics],
                             str(tmp_path / "ref"))
    _same_files(got, want)
    for i, t in enumerate(tables):
        conn = np.asarray(statics[i]["conn"])
        assert rtl.generate_layer(cfg, i, t, torch.as_tensor(conn)) \
            == JRTL.generate_layer(cfg, i, t, conn)


def _wiring(text: str, idx: int, beta_in: int):
    """Each neuron's source columns, slot 0 first, read back from the
    layer module's address concatenations."""
    rows = {}
    for n, sel in re.findall(rf"rom_l{idx}_n(\d+) u\d+ \(\.clk\(clk\), "
                             r"\.addr\(\{([^}]*)\}\)", text):
        rows[int(n)] = [int(lo) // beta_in for lo in
                        re.findall(r"in_bus\[\d+:(\d+)\]", sel)]
    return np.array([rows[n] for n in range(len(rows))])


def _simulate_circuit(cfg, paths, codes: np.ndarray) -> np.ndarray:
    """Walk input codes through the emitted circuit: each layer's wiring
    as the Verilog states it, each ROM re-simulated from its text."""
    c = codes
    for i in range(cfg.num_layers):
        text = Path(paths[i]).read_text()
        conn = _wiring(text, i, cfg.layer_in_bits(i))
        t = cfg.table_size(i)
        roms = [rtl.simulate_verilog_rom(text, f"rom_l{i}_n{n}",
                                         np.arange(t))
                for n in range(conn.shape[0])]
        addr = LI.pack_index(torch.as_tensor(c[:, conn]),
                             cfg.layer_in_bits(i)).numpy()
        c = np.stack([roms[n][addr[:, n]] for n in range(len(roms))], 1)
    return c


@pytest.mark.parametrize("which", ["toy", "neuralut_jsc_5l-reduced"])
def test_rtl_port_tables_resimulate_to_lut_forward(which, tmp_path):
    if which == "toy":
        cfg, statics, tables = _toy()
    else:
        cfg = get_config("neuralut-jsc-5l", reduced=True)
        statics, tables = _converted(cfg)
    paths = rtl.generate_top(cfg, tables, statics, str(tmp_path))
    assert len(paths) == cfg.num_layers + 1
    for li, tbl in enumerate(tables):
        txt = Path(paths[li]).read_text()
        for n in range(tbl.shape[0]):
            sim = rtl.simulate_verilog_rom(txt, f"rom_l{li}_n{n}",
                                           np.arange(tbl.shape[1]))
            assert (sim == tbl[n]).all(), (li, n)
        assert np.array_equal(_wiring(txt, li, cfg.layer_in_bits(li)),
                              np.asarray(statics[li]["conn"]))
    codes = np.random.default_rng(1).integers(
        0, 2 ** cfg.layer_in_bits(0), (64, cfg.in_features))
    want = LI.lut_forward(cfg, tables, statics, torch.as_tensor(codes))
    assert np.array_equal(_simulate_circuit(cfg, paths, codes),
                          want.numpy())


def test_rtl_top_structure(tmp_path):
    cfg, statics, tables = _toy()
    paths = rtl.generate_top(cfg, tables, statics, str(tmp_path))
    top = open(paths[-1]).read()
    assert "module neuralut_top" in top
    assert top.count("layer0 l0") == 1 and top.count("layer1 l1") == 1
    assert f"input [{cfg.beta * cfg.in_features - 1}:0] in_bus" in top
    assert f"output [{cfg.beta * cfg.layer_widths[-1] - 1}:0] out_bus" in top


def test_rom_addressing_matches_connectivity():
    """The concatenated-select wiring puts slot 0 at the MSB."""
    cfg, statics, tables = _toy()
    conn = np.asarray(statics[0]["conn"])
    txt = rtl.generate_layer(cfg, 0, tables[0], statics[0]["conn"])
    for n in range(conn.shape[0]):
        line = [ln for ln in txt.splitlines()
                if f"rom_l0_n{n} u{n}" in ln][0]
        sels = line.split("{")[1].split("}")[0].split(", ")
        for j, sel in enumerate(sels):
            hi = cfg.beta * (conn[n, j] + 1) - 1
            assert sel.startswith(f"in_bus[{hi}:"), (n, j, sel)


def test_rtl_hex_width_from_beta_not_dtype():
    cfg, statics, tables = _toy()
    a = rtl.generate_layer(cfg, 1, tables[1].astype(np.uint16),
                           statics[1]["conn"])
    b = rtl.generate_layer(cfg, 1, torch.as_tensor(
        tables[1].astype(np.int32)), np.asarray(statics[1]["conn"]))
    assert a == b and f"data <= {cfg.beta}'h" in a


def test_rtl_degenerate_chain_graph_unwrapped(tmp_path):
    cfg = get_config("neuralut-jsc-2l", reduced=True)
    tables, statics = _random_net(cfg, seed=3)
    chain = rtl.generate_top(cfg, tables, statics, str(tmp_path / "chain"))
    graph = rtl.generate_top(cfg.graph(), [[t] for t in tables],
                             [{"conns": [torch.as_tensor(s["conn"])]}
                              for s in statics], str(tmp_path / "graph"))
    _same_files(graph, chain)


@pytest.mark.parametrize("arch", ["polylut-add-jsc-2l", "polylut-add-jsc-5l"])
def test_rtl_refuses_lut_dag(arch, tmp_path):
    cfg = get_config(arch, reduced=True)
    statics = M.model_static(cfg)
    tables = [[np.zeros((nd.width, cfg.table_size(i)), np.uint16)
               for _ in range(nd.arity)] for i, nd in enumerate(cfg.nodes)]
    with pytest.raises(UnsupportedTopology, match="DAG"):
        rtl.generate_top(cfg, tables, statics, str(tmp_path))
    assert not any(tmp_path.iterdir())
