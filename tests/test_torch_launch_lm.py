"""The LM entry points of the port on the CPU at their smallest size:
``launch.train`` for an LM arch (with and without ``--ckpt-dir``, with
``--compress-grads`` and ``--grad-accum``, resuming from the directory),
``launch.serve --mode lm`` and ``examples/lm_train_torch.py``; the MoE
and MLA + MoE archs through both launchers; the VLM through
``launch.serve``; the messages of what the launcher refuses (whisper's
frames; ``--mesh multi`` and a mesh shape whose device count is not the
number of processes); and CUDA as the default device."""
import os
import runpy
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.tree import tree_leaves

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
LM = ["--arch", "lm-100m", "--reduced", "--steps", "3", "--device", "cpu",
      "--global-batch", "4", "--seq-len", "32", "--log-every", "1"]


def test_launch_train_lm_runs_and_loss_falls(capsys):
    out = launch_train.main(LM + ["--steps", "6", "--lr", "3e-3"])
    text = capsys.readouterr().out
    assert "mesh (1, 1) devices=1 (cpu)" in text and "step 6 loss=" in text
    assert "lm train summary" in text and "tokens/s" in text
    assert out["steps"] == 6 and len(out["losses"]) == 6
    assert out["last_loss"] < out["first_loss"]
    assert out["peak_mem_gib"] is None   # no device memory on the CPU


@pytest.mark.parametrize("extra", [[], ["--compress-grads"],
                                   ["--grad-accum", "2"]])
def test_launch_train_lm_with_checkpoints_resumes(tmp_path, capsys, extra):
    ck = ["--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    out = launch_train.main(LM + ck + extra)
    text = capsys.readouterr().out
    assert "done at step 3 restarts=0" in text and out["steps"] == 3
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_0000000002", "step_0000000003"]
    # a second run resumes from the directory's latest step
    again = launch_train.main(LM + ck + extra + ["--steps", "5"])
    text = capsys.readouterr().out
    assert "resumed from step 3" in text and again["steps"] == 2
    # and ends where an uninterrupted run ends, bit for bit; with
    # --compress-grads the error-feedback residual lives outside the
    # checkpoint (as the reference's does) and starts again from zero
    whole = launch_train.main(LM + extra + ["--steps", "5"])
    capsys.readouterr()
    same = [torch.equal(a, b) for a, b in zip(tree_leaves(again["carry"]),
                                              tree_leaves(whole["carry"]))]
    assert all(same) != ("--compress-grads" in extra)


@pytest.mark.parametrize("argv,match", [
    (["--arch", "whisper-small"], "frames"),
    (["--mesh", "multi"], r"\(2, 16, 16\) .* needs 512 processes; the "
                          "world has 1"),
    (["--mesh-shape", "2x4"], r"\(2, 4\) .* needs 8 processes; the world "
                              "has 1"),
])
def test_launch_train_refuses_what_is_not_ported(argv, match, capsys):
    """A mesh needs one process per device: one process refuses the
    2x16x16 pod and a 2x4 mesh, naming the shape and the world size
    (tests/test_torch_mesh_train.py runs meshes over processes);
    whisper-small's loss needs frames that the launcher's batches lack
    (as the reference's launcher's do).  Each is refused with a
    ValueError before any step."""
    with pytest.raises(ValueError, match=match) as e:
        launch_train.main(LM + argv)
    if match == "frames":
        assert "lm_batch_fn" in str(e.value)
    assert "step " not in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v2-lite-16b"])
def test_launch_train_and_serve_moe_archs(arch, capsys):
    """The MoE (qwen2) and MLA + MoE (deepseek) archs train through
    launch.train (loss falling, the aux loss in the step's metrics) and
    decode through launch.serve --mode lm."""
    out = launch_train.main(["--arch", arch] + LM[2:]
                            + ["--steps", "6", "--lr", "3e-3"])
    assert out["steps"] == 6 and out["last_loss"] < out["first_loss"]
    assert out["carry"][0]["blocks"][0]["ffn"]["w_gate"].shape[1] == 16
    text = capsys.readouterr().out
    assert f"{arch}-reduced" in text and "lm train summary" in text
    served = launch_serve.main(["--mode", "lm", "--arch", arch, "--device",
                                "cpu", "--requests", "4", "--batch", "2"])
    assert served["steps"] == 4 and served["last_tokens"].shape == (2, 1)


def test_launch_train_unknown_arch():
    with pytest.raises(SystemExit, match="unknown"):
        launch_train.main(["--arch", "gpt-5", "--device", "cpu"])


def test_serve_lm(capsys):
    out = launch_serve.main(["--mode", "lm", "--device", "cpu",
                             "--requests", "6", "--batch", "4"])
    text = capsys.readouterr().out
    assert "decoded 6 steps x batch 4:" in text and "tok/s" in text
    assert out["steps"] == 6 and out["last_tokens"].shape == (4, 1)
    # the VLM decodes too (text only: 1-D positions on all 3 sections)
    vlm = launch_serve.main(["--mode", "lm", "--arch", "qwen2-vl-72b",
                             "--device", "cpu", "--requests", "3",
                             "--batch", "2"])
    assert vlm["steps"] == 3 and vlm["last_tokens"].shape == (2, 1)
    with pytest.raises(SystemExit, match="unknown"):
        launch_serve.main(["--mode", "lm", "--arch", "neuralut-jsc-2l",
                           "--device", "cpu"])


def test_lm_entry_points_need_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA"):
        launch_train.main(["--arch", "lm-100m", "--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="no CUDA"):
        launch_serve.main(["--mode", "lm", "--requests", "1"])


def test_lm_train_example(tmp_path, capsys):
    main = runpy.run_path(str(ROOT / "examples" / "lm_train_torch.py"))["main"]
    argv = ["--steps", "4", "--batch", "2", "--seq", "32", "--device", "cpu",
            "--ckpt", str(tmp_path)]
    out = main(argv)
    text = capsys.readouterr().out
    assert "trained to step 4 in" in text and "restarts=0" in text
    assert out["step"] == 4 and out["start"] == 0
    # the checkpoint of the last step is there: a rerun resumes at once
    out = main(argv)
    assert "resumed from checkpoint at step 4" in capsys.readouterr().out


def test_launch_train_lm_as_a_process():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-m", "repro_torch.launch.train"]
                       + LM, cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert "lm train summary" in p.stdout
