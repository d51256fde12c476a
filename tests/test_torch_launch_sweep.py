"""The port's sweep CLI (``python -m repro_torch.launch.sweep``) on the
CPU at tiny size: the paper grid's code path end to end — plan, group
training, conversion of every point's best seed, bundles saved to a
registry, loaded back verified and served (the CLI itself checks every
served prediction against ``lut_infer.predict``); the test serves the
saved bundles again and checks the JSONL stream."""
import json

import numpy as np
import pytest
import torch

from repro_torch.core import lut_infer as LI
from repro_torch.core import model as M
from repro_torch.data import device_dataset, mnist_pooled
from repro_torch.launch import sweep as launch_sweep
from repro_torch.serve import LUTServeEngine, TableRegistry

torch.set_num_threads(1)

ARGS = ["--seeds", "1", "--epochs", "1", "--n-train", "512", "--n-test",
        "256", "--device", "cpu"]


def test_cli_sweeps_saves_and_serves(tmp_path, capsys):
    reg_dir, track = tmp_path / "reg", tmp_path / "sweep.jsonl"
    out = launch_sweep.main(ARGS + ["--registry", str(reg_dir), "--track",
                                    str(track), "--quiet"])
    text = capsys.readouterr().out
    res = out["result"]
    assert "6 points / 4 group runs on 1 device(s)" in text
    assert [g.group.num_units for g in res.groups] == [2, 1, 1, 2]
    assert out["mismatches"] == {p.name: 0 for p in res.points}
    rows = [json.loads(ln) for ln in track.read_text().splitlines()]
    assert [r["_step"] for r in rows] == list(range(6))
    assert [r["point"] for r in rows] == [p.name for p in res.points]
    reg = TableRegistry(reg_dir)
    assert sorted(reg.list_models()) == sorted(p.name for p in res.points)
    xte, _ = device_dataset(mnist_pooled, 256, seed=1, device="cpu")
    for p in res.points:
        bundle = reg.load(p.name)
        assert bundle.meta["tag"] == p.point.tag
        assert bundle.meta["sweep_err"] == pytest.approx(p.err)
        with LUTServeEngine(bundle, device="cpu") as eng:
            served = eng.predict(xte.numpy())
        want = LI.predict(p.point.cfg, p.params, p.packed[0],
                          M.model_static(p.point.cfg), xte).numpy()
        np.testing.assert_array_equal(served, want)


def test_cli_resumes_from_its_journal(tmp_path, capsys):
    argv = ARGS + ["--resume", str(tmp_path / "j")]
    first = launch_sweep.main(argv)["result"]
    second = launch_sweep.main(argv)["result"]
    assert "4 group(s) replayed from journal" in capsys.readouterr().out
    for a, b in zip(first.points, second.points):
        assert a.err == b.err


def test_cli_refuses_several_cards():
    with pytest.raises(NotImplementedError, match="Queue A item 3"):
        launch_sweep.main(ARGS + ["--devices", "2", "--quiet"])
