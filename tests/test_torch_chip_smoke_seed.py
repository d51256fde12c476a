"""``chip_smoke.py`` fixes the string-hash seed of its run: with no
``PYTHONHASHSEED`` set it chooses one, sets it and re-executes itself
once (``os.execv``, stubbed here); the re-executed run finds it set,
does not execute again and prints it on its first line, so that a
failing run can be replayed with ``PYTHONHASHSEED=<n> python3
chip_smoke.py``.  Every failure message names the seed."""
import importlib.util
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
C = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(C)


class _Exec(Exception):
    pass


def test_reexec_sets_and_prints_the_seed_once(monkeypatch, capsys):
    calls = []

    def execv(path, argv):
        calls.append((path, list(argv)))
        raise _Exec   # execv does not return

    monkeypatch.setattr(C.os, "execv", execv)
    monkeypatch.delenv("PYTHONHASHSEED", raising=False)
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(_Exec):
        C.main()
    seed = C.os.environ["PYTHONHASHSEED"]
    assert seed.isdigit() and 1 <= int(seed) < 2 ** 32
    assert calls == [(sys.executable, [sys.executable,
                                       str(ROOT / "chip_smoke.py")])]
    assert capsys.readouterr().out == ""   # nothing before the exec
    # the re-executed process: the seed is set, so no second exec; it
    # prints the seed first and then stops here for want of a card
    assert C.main() == 2
    assert len(calls) == 1
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith(f"PYTHONHASHSEED={seed} ") and \
        f"PYTHONHASHSEED={seed} python3 chip_smoke.py" in out[0]
    assert sum("PYTHONHASHSEED" in line for line in out) == 1
    with pytest.raises(RuntimeError, match=f"PYTHONHASHSEED={seed}"):
        C.require(False, "planted")


def test_a_given_seed_is_kept(monkeypatch, capsys):
    monkeypatch.setattr(C.os, "execv", lambda *a: pytest.fail("re-exec"))
    monkeypatch.setenv("PYTHONHASHSEED", "164")
    monkeypatch.setattr(sys, "argv", ["chip_smoke.py"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert C.main() == 2
    assert capsys.readouterr().out.startswith("PYTHONHASHSEED=164 ")
    with pytest.raises(RuntimeError, match="PYTHONHASHSEED=164"):
        C._close(torch.zeros(2), torch.ones(2), 0.0, 0.0, "planted")
