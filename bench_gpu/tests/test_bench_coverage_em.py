"""The coverage EM's reader, `coverage_em_s`, on hand-built trace files: None
where the program opens no `coverage_fit.em` span, as the parent's does not,
else the spans' seconds summed per job and averaged over the window's jobs."""
from __future__ import annotations

import json

import pytest

from bench_gpu import harness


def _trace(path, spans):
    """A job whose trace holds `spans`, (detail, seconds, parent id) each."""
    events = [{"name": d, "ph": "X", "ts": 0, "dur": int(s * 1e6), "pid": 1, "tid": 1,
               "args": {"detail": d, "id": i + 1, "parent": p}}
              for i, (d, s, p) in enumerate(spans)]
    path.mkdir()
    (path / "spades_time_trace.json").write_text(json.dumps({"traceEvents": events}))
    return {"out": str(path), "stage_times": []}


def test_coverage_em_s_on_hand_built_trace_files(tmp_path):
    read = harness.Bench(harness.ROOT).module("metrics", "coverage_em_s").read
    # no trace file
    assert read({"jobs": [{"out": str(tmp_path / "none"), "stage_times": []}]}) is None
    # the parent's shape: the stage's span and none of the EM
    old = _trace(tmp_path / "old", [("spades", 9.0, None), ("k21", 4.0, 1),
                                    ("ec_threshold_finder", 2.0, 2)])
    assert read({"jobs": [old]}) is None
    # one fit per K under the stage, and one under error correction
    job = _trace(tmp_path / "new", [("spades", 9.0, None), ("hammer.coverage", 1.0, 1),
                                    ("coverage_fit.em", 0.125, 2),
                                    ("k21", 4.0, 1), ("ec_threshold_finder", 2.0, 4),
                                    ("coverage_fit.em", 0.25, 5),
                                    ("k77", 5.0, 1), ("ec_threshold_finder", 1.0, 7),
                                    ("coverage_fit.em", 0.5, 8)])
    assert read({"jobs": [job]}) == pytest.approx(0.875)
    # a job without the span counts 0 in the window's mean
    assert read({"jobs": [job, old]}) == pytest.approx(0.875 / 2)
