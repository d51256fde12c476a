"""Port parity: the on-disk ``TableRegistry``.  A bundle saved by either
package loads in the other bit-identical — the same npz keys, arrays,
manifest ``meta`` (config, fingerprint, topology, integrity digests) —
for a chain, a LUT graph and a ``poly`` chain; and the port's registry
refuses, quarantines and probes corrupted versions as the reference's
does.  The bundles are seeded with numpy (random tables, connectivity
and quantizer scales at reduced geometries): lookup semantics do not
depend on how the tables were produced."""
import dataclasses
import importlib
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import config_fingerprint as j_fingerprint
from repro.core import lut_infer as JLI
from repro.runtime.chaos import ChaosInjected as JChaosInjected
from repro.serve import BundleIntegrityError as JBundleIntegrityError
from repro.serve import ServeBundle as JServeBundle
from repro.serve import TableRegistry as JTableRegistry
from repro_torch.config import config_fingerprint, get_config
from repro_torch.core import lut_infer as LI
from repro_torch.core.nl_config import is_graph_config
from repro_torch.runtime.chaos import ChaosHarness, ChaosInjected
from repro_torch.serve import (BundleIntegrityError, IntegrityProbe,
                               LUTServeEngine, ServeBundle, TableRegistry)

# Small shapes: one intra-op thread keeps these tests from loading the
# CPU that the other test workers share.
torch.set_num_threads(1)

# (arch, JAX config module, kind): a chain, a LUT graph, a poly chain.
CASES = [("neuralut-jsc-2l", "neuralut_jsc_2l", "subnet"),
         ("polylut-add-jsc-2l", "polylut_add_jsc_2l", "subnet"),
         ("neuralut-jsc-2l", "neuralut_jsc_2l", "poly")]
IDS = ["chain", "graph", "poly"]


def configs(arch, mod, kind="subnet", reduced=True):
    """(port config, JAX config) of one geometry, equal field for
    field; ``kind="poly"`` makes it a degree-2 PolyLUT model."""
    jmod = importlib.import_module(f"repro.configs.{mod}")
    jcfg = jmod.reduced() if reduced else jmod.full()
    pcfg = get_config(arch, reduced=reduced)
    if kind != "subnet":
        jcfg = dataclasses.replace(jcfg, kind=kind, degree=2)
        pcfg = dataclasses.replace(pcfg, kind=kind, degree=2)
    return pcfg, jcfg


def random_net(cfg, seed):
    """numpy (tables, statics, in_log_s, layer_log_s) of cfg's geometry,
    chain or graph: uint16 tables, int32 connectivity, float32 scales."""
    rng = np.random.default_rng(seed)
    tables, statics, outs = [], [], []
    if is_graph_config(cfg):
        widths = [cfg.in_features]
        for i, nd in enumerate(cfg.nodes):
            pool = sum(widths[s] for s in cfg.node_sources(i))
            statics.append({"conns": [
                rng.integers(0, pool, (nd.width, nd.fan_in)).astype(np.int32)
                for _ in range(nd.arity)]})
            tables.append([rng.integers(0, 2 ** cfg.beta, (
                nd.width, cfg.table_size(i))).astype(np.uint16)
                for _ in range(nd.arity)])
            widths.append(nd.width)
            outs.append(nd.width)
    else:
        w = cfg.in_features
        for i, o in enumerate(cfg.layer_widths):
            statics.append({"conn": rng.integers(
                0, w, (o, cfg.layer_fan_in(i))).astype(np.int32)})
            tables.append(rng.integers(0, 2 ** cfg.beta, (
                o, cfg.table_size(i))).astype(np.uint16))
            w = o
            outs.append(o)
    in_log_s = rng.normal(0, 0.3, cfg.in_features).astype(np.float32)
    layer_log_s = [rng.normal(0, 0.3, o).astype(np.float32) for o in outs]
    return tables, statics, in_log_s, layer_log_s


def _copy(tree):
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_copy(v) for v in tree]
    return np.array(tree, copy=True)


def bundles(pcfg, jcfg, seed, meta=None):
    """A port and a JAX ServeBundle of the same random network."""
    tables, statics, in_s, layer_s = random_net(pcfg, seed)
    if pcfg.kind == "poly":
        from repro.core.subnet import monomial_exponents
        statics = [{**s, "exps": monomial_exponents(
            pcfg.layer_fan_in(i), pcfg.degree)} for i, s in enumerate(statics)]
    pb = ServeBundle(cfg=pcfg, tables=_copy(tables), statics=_copy(statics),
                     in_log_s=in_s.copy(), layer_log_s=_copy(layer_s),
                     meta=dict(meta or {}))
    jb = JServeBundle(cfg=jcfg, tables=_copy(tables), statics=_copy(statics),
                      in_log_s=in_s.copy(), layer_log_s=_copy(layer_s),
                      meta=dict(meta or {}))
    return pb, jb


def jax_predict(jb, x):
    return np.asarray(JLI.predict(jb.cfg, jb.serve_params(), jb.tables,
                                  jb.statics, jnp.asarray(x)))


def port_predict(pb, x):
    return LI.predict(pb.cfg, pb.serve_params(torch.device("cpu")),
                      pb.tables, pb.statics, torch.as_tensor(x)).numpy()


def flat(b):
    """Every array of a bundle in (node, branch) order, by part."""
    def nodes(v):
        return [a for n in v for a in (n if isinstance(n, list) else [n])]
    conns = [c for s in b.statics
             for c in (s["conns"] if "conns" in s else [s["conn"]])]
    return {"tables": nodes(b.tables), "conn": [np.asarray(c) for c in conns],
            "in_log_s": [b.in_log_s], "layer_log_s": list(b.layer_log_s)}


def assert_same_arrays(a, b):
    fa, fb = flat(a), flat(b)
    for part in fa:
        assert len(fa[part]) == len(fb[part]), part
        for x, y in zip(fa[part], fb[part]):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape, part
            assert np.array_equal(x, y), part


def shard(root, name, version=0):
    return root / name / f"step_{version:010d}" / "shard_0.npz"


def manifest(root, name, version=0):
    return json.loads((root / name / f"step_{version:010d}" /
                       "manifest.json").read_text())


def corrupt(root, name, version):
    """Flip 64 bytes in the middle of a stored shard."""
    p = shard(root, name, version)
    raw = bytearray(p.read_bytes())
    mid = len(raw) // 2
    for i in range(mid, min(mid + 64, len(raw))):
        raw[i] ^= 0xFF
    p.write_bytes(bytes(raw))


X = np.random.default_rng(11).normal(0, 1, (40, 16)).astype(np.float32)


@pytest.mark.parametrize("arch,mod,kind", CASES, ids=IDS)
def test_jax_save_port_load(tmp_path, arch, mod, kind):
    pcfg, jcfg = configs(arch, mod, kind)
    pb, jb = bundles(pcfg, jcfg, 1, meta={"train_acc_q": 0.5})
    JTableRegistry(tmp_path).save("m", jb)
    loaded = TableRegistry(tmp_path).load("m")
    assert dataclasses.asdict(loaded.cfg) == dataclasses.asdict(pcfg)
    assert config_fingerprint(loaded.cfg) == j_fingerprint(jcfg)
    assert_same_arrays(loaded, pb)
    assert loaded.meta["train_acc_q"] == 0.5
    assert loaded.schema_version == jb.schema_version
    assert loaded.geometry_key == jb.geometry_key
    if kind == "poly":
        for a, b in zip(loaded.statics, jb.statics):
            assert np.array_equal(a["exps"], b["exps"])
    jb.prepack()
    for a, b in zip(loaded.packed_tables, jb.packed_tables):
        assert np.array_equal(a, b)
    assert loaded.num_table_bytes == jb.num_table_bytes
    assert loaded.num_packed_table_bytes == jb.num_packed_table_bytes
    np.testing.assert_array_equal(port_predict(loaded, X), jax_predict(jb, X))


@pytest.mark.parametrize("arch,mod,kind", CASES, ids=IDS)
def test_port_save_jax_load(tmp_path, arch, mod, kind):
    pcfg, jcfg = configs(arch, mod, kind)
    pb, jb = bundles(pcfg, jcfg, 2, meta={"train_acc_q": 0.25})
    TableRegistry(tmp_path).save("m", pb)
    loaded = JTableRegistry(tmp_path).load("m")
    assert loaded.cfg == jcfg
    assert_same_arrays(loaded, jb)
    assert loaded.meta["train_acc_q"] == 0.25
    if kind == "poly":
        for a, b in zip(loaded.statics, pb.statics):
            assert np.array_equal(a["exps"], b["exps"])
    np.testing.assert_array_equal(jax_predict(loaded, X), port_predict(pb, X))


@pytest.mark.parametrize("arch,mod,kind", CASES, ids=IDS)
def test_files_of_both_packages_are_identical(tmp_path, arch, mod, kind):
    """The same bundle saved by each package: equal npz keys and arrays,
    and an equal manifest — config, fingerprint, topology, the integrity
    digests, even the tree structure string."""
    pcfg, jcfg = configs(arch, mod, kind)
    pb, jb = bundles(pcfg, jcfg, 3, meta={"train_acc_q": 0.125,
                                          "note": "x"})
    TableRegistry(tmp_path / "p").save("m", pb)
    JTableRegistry(tmp_path / "j").save("m", jb)
    with np.load(shard(tmp_path / "p", "m")) as a, \
            np.load(shard(tmp_path / "j", "m")) as b:
        assert sorted(a.files) == sorted(b.files)
        assert "tables/#0" in a.files and "in_log_s" in a.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    mp, mj = manifest(tmp_path / "p", "m"), manifest(tmp_path / "j", "m")
    assert mp == mj
    assert mp["meta"]["fingerprint"] == j_fingerprint(jcfg)
    assert mp["meta"]["integrity"]["arrays"]


@pytest.mark.parametrize("arch,mod,kind", CASES, ids=IDS)
def test_versions_detail_equal_across_packages(tmp_path, arch, mod, kind):
    pcfg, jcfg = configs(arch, mod, kind)
    pb, jb = bundles(pcfg, jcfg, 4)
    preg, jreg = TableRegistry(tmp_path / "p"), JTableRegistry(tmp_path / "j")
    for v in (0, 3):
        preg.save("m", pb, version=v)
        jreg.save("m", jb, version=v)
    assert preg.versions("m") == jreg.versions("m") == [0, 3]
    detail = preg.versions("m", detail=True)
    assert detail == jreg.versions("m", detail=True)
    assert detail[0]["schema_version"] == (2 if is_graph_config(pcfg) else 1)
    assert detail[0]["topology"][0] == ("dag" if is_graph_config(pcfg)
                                        else "chain")
    assert preg.versions("absent") == [] and not preg.has("absent")
    assert preg.list_models() == ["m"] and preg.has("m")


@pytest.mark.parametrize("saver", ["port", "jax"])
@pytest.mark.parametrize("arch,mod,kind", CASES[:2], ids=IDS[:2])
def test_corrupted_byte_refused_by_both_packages(tmp_path, saver, arch,
                                                  mod, kind):
    pcfg, jcfg = configs(arch, mod, kind)
    pb, jb = bundles(pcfg, jcfg, 5)
    (TableRegistry if saver == "port" else JTableRegistry)(
        tmp_path).save("m", pb if saver == "port" else jb)
    corrupt(tmp_path, "m", 0)
    preg, jreg = TableRegistry(tmp_path), JTableRegistry(tmp_path)
    assert not preg.verify("m")["ok"] and not jreg.verify("m")["ok"]
    with pytest.raises(BundleIntegrityError):
        preg.load("m")
    with pytest.raises(BundleIntegrityError):
        preg.load("m", verify=False)      # the opt-out still traps reads
    with pytest.raises(JBundleIntegrityError):
        jreg.load("m")


def test_one_flipped_table_byte_names_the_array(tmp_path):
    """Flip one byte of a table's values inside the npz member: the
    zip's CRC and the digest both catch it, and the report names it."""
    import zipfile
    pcfg, jcfg = configs(*CASES[0])
    pb, _ = bundles(pcfg, jcfg, 6)
    reg = TableRegistry(tmp_path)
    reg.save("m", pb)
    p = shard(tmp_path, "m")
    with zipfile.ZipFile(p) as z:
        info = z.getinfo("tables/#1.npy")
    raw = bytearray(p.read_bytes())
    h = info.header_offset
    n = int.from_bytes(raw[h + 26:h + 28], "little")
    e = int.from_bytes(raw[h + 28:h + 30], "little")
    raw[h + 30 + n + e + info.compress_size - 1] ^= 0x01
    p.write_bytes(bytes(raw))
    report = reg.verify("m")
    assert not report["ok"] and report["bad"] == ["tables/#1"]
    with pytest.raises(BundleIntegrityError, match="tables/#1"):
        reg.load("m")


def test_quarantine_falls_back_to_intact_version(tmp_path):
    pcfg, jcfg = configs(*CASES[0])
    pb, jb = bundles(pcfg, jcfg, 7)
    reg = TableRegistry(tmp_path)
    reg.save("m", pb, version=1)
    reg.save("m", pb, version=2)
    corrupt(tmp_path, "m", 2)
    dst = reg.quarantine("m", 2)
    assert dst.name == "quarantined_step_0000000002" and dst.is_dir()
    assert reg.versions("m") == [1]
    assert JTableRegistry(tmp_path).versions("m") == [1]
    loaded = reg.load("m")
    with LUTServeEngine(loaded, device="cpu") as eng:
        np.testing.assert_array_equal(eng.predict(X), jax_predict(jb, X))
    with pytest.raises(FileNotFoundError):
        reg.quarantine("m", 999)


def test_integrity_probe_quarantines_corrupt_bundle(tmp_path):
    pcfg, jcfg = configs(*CASES[1])
    pb, _ = bundles(pcfg, jcfg, 8)
    reg = TableRegistry(tmp_path)
    reg.save("m", pb, version=1)
    reg.save("m", pb, version=2)
    reg.save("other", pb, version=0)
    corrupt(tmp_path, "m", 2)
    seen = []
    probe = IntegrityProbe(reg, on_corrupt=lambda n, v, r:
                           seen.append((n, v)))
    found = probe.run_once()
    assert [(r["name"], r["version"]) for r in found] == [("m", 2)]
    assert seen == [("m", 2)]
    assert reg.versions("m") == [1] and reg.versions("other") == [0]
    assert probe.run_once() == []             # converged
    assert probe.status()["sweeps"] == 2
    probe.start()
    assert probe.status()["running"]
    probe.stop(timeout=30)
    assert not probe.status()["running"]


def test_probe_survives_raising_hook_and_missing_model(tmp_path):
    pcfg, jcfg = configs(*CASES[0])
    pb, _ = bundles(pcfg, jcfg, 9)
    reg = TableRegistry(tmp_path)
    reg.save("m", pb)
    corrupt(tmp_path, "m", 0)

    def hook(*_):
        raise RuntimeError("alerting is down")
    probe = IntegrityProbe(reg, names=["m", "absent"], on_corrupt=hook,
                           auto_quarantine=False)
    assert [r["version"] for r in probe.run_once()] == [0]
    assert reg.versions("m") == [0]           # not quarantined
    assert reg.verify("absent")["ok"] is False


def test_registry_load_chaos_site(tmp_path):
    pcfg, jcfg = configs(*CASES[0])
    pb, _ = bundles(pcfg, jcfg, 10)
    chaos = ChaosHarness(schedule={"registry.load": [0]})
    reg = TableRegistry(tmp_path, chaos=chaos)
    reg.save("m", pb)
    with pytest.raises(ChaosInjected):
        reg.load("m")
    assert reg.load("m") is not None          # one-shot schedule index
    assert chaos.fired("registry.load") == [0]
    # the reference's registry fires at the same call of the same site
    jchaos = __import__("repro.runtime.chaos", fromlist=["x"]).ChaosHarness(
        schedule={"registry.load": [0]})
    jreg = JTableRegistry(tmp_path, chaos=jchaos)
    with pytest.raises(JChaosInjected):
        jreg.load("m")
    assert jreg.load("m") is not None


def test_legacy_bundles_without_integrity_still_load(tmp_path):
    pcfg, jcfg = configs(*CASES[0])
    pb, _ = bundles(pcfg, jcfg, 11)
    reg = TableRegistry(tmp_path)
    reg.save("m", pb)
    mpath = tmp_path / "m" / "step_0000000000" / "manifest.json"
    m = json.loads(mpath.read_text())
    del m["meta"]["integrity"]
    del m["meta"]["topology"]
    mpath.write_text(json.dumps(m))
    report = reg.verify("m")
    assert report["ok"] and report["legacy"] and report["checked"] == 0
    assert reg.versions("m", detail=True)[0]["topology"] == \
        ["chain", list(pcfg.layer_widths)]
    assert_same_arrays(reg.load("m"), pb)


def test_meta_of_numpy_scalars_and_tuples_round_trips(tmp_path):
    """Meta values JSON cannot write as they are (numpy scalars, tuples,
    a 0-d tensor) are stored as JSON writes them back, so the manifest
    digest still verifies on load."""
    pcfg, jcfg = configs(*CASES[0])
    pb, _ = bundles(pcfg, jcfg, 12, meta={
        "acc": np.float32(0.75), "steps": np.int64(3), "pair": (1, 2),
        "t": torch.tensor(2.5)})
    reg = TableRegistry(tmp_path)
    reg.save("m", pb)
    assert reg.verify("m")["ok"]
    meta = reg.load("m").meta
    assert meta["acc"] == 0.75 and meta["steps"] == 3
    assert meta["pair"] == [1, 2] and meta["t"] == 2.5
    assert JTableRegistry(tmp_path).load("m").meta["acc"] == 0.75


def test_tampered_manifest_meta_is_refused(tmp_path):
    pcfg, jcfg = configs(*CASES[0])
    pb, _ = bundles(pcfg, jcfg, 13, meta={"train_acc_q": 0.5})
    reg = TableRegistry(tmp_path)
    reg.save("m", pb)
    mpath = tmp_path / "m" / "step_0000000000" / "manifest.json"
    m = json.loads(mpath.read_text())
    m["meta"]["train_acc_q"] = 0.99
    mpath.write_text(json.dumps(m))
    assert reg.verify("m")["bad"] == ["manifest_digest"]
    with pytest.raises(BundleIntegrityError, match="manifest_digest"):
        reg.load("m")


def test_missing_versions_and_sharded_load(tmp_path):
    reg = TableRegistry(tmp_path)
    with pytest.raises(FileNotFoundError):
        reg.load("nope")
    assert reg.verify("nope")["bad"] == ["no committed version"]
    with pytest.raises(FileNotFoundError):
        reg.load("nope", shard_replicas=2)


def test_full_width_chain_round_trip(tmp_path):
    """The full neuralut-jsc-5l geometry (paper Table II widths) saved
    by the port loads in the reference bit-identical."""
    pcfg, jcfg = configs("neuralut-jsc-5l", "neuralut_jsc_5l",
                         reduced=False)
    pb, jb = bundles(pcfg, jcfg, 14)
    TableRegistry(tmp_path).save(pcfg.name, pb)
    loaded = JTableRegistry(tmp_path).load(pcfg.name)
    assert_same_arrays(loaded, jb)
    assert loaded.geometry_key == pb.geometry_key
