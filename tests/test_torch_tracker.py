"""The port's streaming trackers (``repro_torch.runtime.tracker``),
mirroring the reference's ``tests/test_sweep.py`` tracker tests: the
callback, composite and JSONL trackers, ``finish()`` semantics, and the
same JSONL lines as the reference's ``JsonlTracker``."""
import io
import json

import pytest

from repro.runtime import tracker as JT
from repro_torch.runtime.tracker import (CallbackTracker, CompositeTracker,
                                         JsonlTracker, NoopTracker,
                                         PrintTracker, Tracker)


def test_callback_and_composite_trackers():
    seen = []
    t = CallbackTracker(lambda m, step, summary: seen.append(
        (m, step, summary)))
    comp = CompositeTracker([t, NoopTracker()])
    with comp:
        comp.log_metrics({"a": 1}, step=3)
        comp.log_summary({"done": True})
    assert seen == [({"a": 1}, 3, False), ({"done": True}, None, True)]
    assert comp.finished and all(c.finished for c in comp.trackers)
    with pytest.raises(RuntimeError):
        comp.log_metrics({"late": 1})
    with pytest.raises(RuntimeError):
        comp.log_summary({"late": 1})
    comp.finish()  # idempotent


def test_jsonl_tracker_lines_equal_the_reference(tmp_path):
    lines = []
    for mod, name in ((JT, "ref.jsonl"), (None, "port.jsonl")):
        path = tmp_path / name
        cls = JsonlTracker if mod is None else mod.JsonlTracker
        with cls(str(path)) as t:
            t.log_metrics({"err": 0.5, "point": "p"}, step=0)
            t.log_metrics({"err": 0.25})
            t.log_summary({"total_s": 1.0})
        lines.append(path.read_text())
    assert lines[0] == lines[1]
    rows = [json.loads(ln) for ln in lines[1].splitlines()]
    assert rows[0]["err"] == 0.5 and rows[0]["_step"] == 0
    assert "_step" not in rows[1]
    assert rows[2]["total_s"] == 1.0 and rows[2]["_summary"] is True


def test_print_tracker_and_base_class():
    buf = io.StringIO()
    with PrintTracker(buf) as t:
        t.log_metrics({"a": 1, "b": "x"}, step=2)
        t.log_metrics({"c": 3})
        t.log_summary({"n": 4})
    assert buf.getvalue().splitlines() == [
        "[track step 2] a=1 b=x", "[track metrics] c=3",
        "[track summary] n=4"]
    with pytest.raises(NotImplementedError):
        Tracker().log_metrics({"a": 1})
