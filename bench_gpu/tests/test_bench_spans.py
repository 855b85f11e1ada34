"""The readers of the program's own spans (`bench_gpu/spans.py` and the
metrics that use it) on a traced CPU run of each tiny cell, and on a trace
file of the shape the program wrote before its spans had ids."""
from __future__ import annotations

import json

import pytest

from bench_gpu import harness, spans

SEED = 2**31 + 1414
NEW = {"isolate.asm": ("parse_s", "pack_s", "unspanned_s", "residue_pass_s"),
       "isolate.ec": ("ec_cluster_s",)}


@pytest.fixture
def seen(monkeypatch):
    """Each job's spans as the readers saw them, by output directory (the
    directories are gone when the run returns)."""
    got = {}
    inner = spans.job_spans

    def job_spans(job):
        got[job["out"]] = inner(job)
        return got[job["out"]]

    monkeypatch.setattr(spans, "job_spans", job_spans)
    return got


@pytest.mark.parametrize("workload", sorted(NEW))
def test_traced_run_reports_the_span_metrics(tiny_root, seen, workload):
    res = harness.run(workload, SEED, 1, True, device="cpu", root=tiny_root,
                      log=lambda m: None)
    assert res["correct"] is True, res["checks"]
    m = {n: v["value"] for n, v in res["metrics"].items()}
    assert set(NEW[workload]) <= set(m)
    # the metrics the cell had before are all still there
    assert {e["name"] for e in harness.Bench(tiny_root).metrics_of(workload, True)} - {
        "b1_roofline_pct", "device_idle_pct"} == set(m)
    jobs = [s for s in seen.values() if s is not None]
    assert len(jobs) == res["attempted"] and all(jobs)
    if workload == "isolate.ec":
        assert m["ec_cluster_s"] > 0
        assert m["ec_cluster_s"] < m["ec_s"]
        return
    assert m["parse_s"] > 0 and m["pack_s"] > 0 and m["unspanned_s"] >= 0
    assert m["residue_pass_s"] >= 0
    # the CLI's named steps and what no step names lie inside what the
    # benchmark's outside reckoning (wall - stage timers - error correction)
    # calls the CLI's time
    named = sum(s["s"] for job in jobs for s in job
                if s["detail"] in ("cli.ec_write", "cli.checkpoint")) / len(jobs)
    assert m["parse_s"] + m["pack_s"] + m["unspanned_s"] + named <= 1.05 * m["cli_io_s"]


def test_readers_return_none_without_the_programs_spans(tmp_path):
    old = tmp_path / "old"
    old.mkdir()
    # a file of the earlier shape: stage scopes with a detail and no ids
    (old / spans.FILE).write_text(json.dumps({"traceEvents": [
        {"name": "Construction", "ph": "X", "ts": 10, "dur": 2_000_000, "pid": 1, "tid": 1,
         "args": {"detail": "construction"}}], "displayTimeUnit": "ms"}))
    none = tmp_path / "none"
    none.mkdir()
    bench = harness.Bench(harness.ROOT)
    for names in NEW.values():
        for name in names:
            reader = bench.module("metrics", name)
            for job in (old, none):
                assert reader.read({"jobs": [{"out": str(job)}]}) is None, (name, job)
