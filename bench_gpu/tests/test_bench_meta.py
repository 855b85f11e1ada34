"""The `meta.asm` cell: its generator against the program's, a traced CPU
run of the cell at the warm-up's size, and its span and stage readers on
hand-built trace files."""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import pytest

from bench_gpu import harness
from bench_gpu.gen import community

SEED = 2**31 + 1616
NEW = ("simplification_s.meta", "flanking_s", "second_phase_s")
# the CPU run's sizes: the card's warm-up sample, and a smaller warm-up
SMALL = {"sizes_nt": [20000, 15000, 10000, 6000]}
SMALL_WARMUP = {"sizes_nt": [8000, 7000, 6000, 6000]}
# the small community's limit where it differs from the card's: its eight
# genome ends, thinly covered, weigh 20 times what they do in 1 Mb (sound
# reading on the CPU 20,671 ppm)
SMALL_LIMITS = {"genome_kmers_missing_ppm": 100000}


@pytest.fixture
def meta_root(tmp_path):
    """A checkout of BENCHMARK.json and the benchmark's folder, with the
    community cut to SMALL."""
    root = str(tmp_path / "checkout")
    os.makedirs(root)
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(harness.ROOT, "bench_gpu"), os.path.join(root, "bench_gpu"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    path = os.path.join(root, "bench_gpu", "configs", "meta-mock4.json")
    with open(path) as fh:
        cfg = json.load(fh)
    cfg["params"].update(SMALL)
    cfg["warmup"] = SMALL_WARMUP
    with open(path, "w") as fh:
        json.dump(cfg, fh)
    path = os.path.join(root, "bench_gpu", "limits", "meta.asm.json")
    with open(path) as fh:
        limits = {**json.load(fh), **SMALL_LIMITS}
    with open(path, "w") as fh:
        json.dump(limits, fh)
    return root


@pytest.mark.parametrize("seed", [7, 2**31 + 5])
def test_community_equals_the_programs_generator(seed):
    from spades_tpu_torch.tools import synthetic

    params = harness.Bench(harness.ROOT).config("meta-mock4")["params"]
    params = {**params, "sizes_nt": [9000, 8000, 7000, 6000], "coverages": [30, 20, 10, 5]}
    got = community.make(params, seed)
    again = community.make(params, seed)
    genomes, r1, r2, _origin = synthetic.make_community(
        params["sizes_nt"], params["coverages"], params["read_length"], params["error_rate"],
        seed, shared=params["shared_nt"], insert_mean=params["insert_mean"],
        insert_sd=params["insert_sd"])
    for a, b in ((got["r1"], r1), (got["r2"], r2), (again["r1"], r1), (again["r2"], r2)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert len(got["genomes"]) == 4
    for a, b in zip(got["genomes"], genomes):
        assert np.array_equal(a, b)
    # the first two genomes share a segment of `shared_nt`
    g0, g1 = got["genomes"][:2]
    k = 64
    first = {g0[i:i + k].tobytes() for i in range(len(g0) - k + 1)}
    shared = sum(g1[i:i + k].tobytes() in first for i in range(len(g1) - k + 1))
    assert shared >= params["shared_nt"] - k + 1


def test_traced_cpu_run_is_correct_and_reports_the_meta_metrics(meta_root):
    from spades_tpu_torch.graph import simplify

    res = harness.run("meta.asm", SEED, 1, True, device="cpu", root=meta_root,
                      log=lambda m: None)
    assert res["correct"] is True, res["checks"]
    m = {n: v["value"] for n, v in res["metrics"].items()}
    assert set(m) == set(NEW)
    assert m["simplification_s.meta"] > m["flanking_s"] > 0
    assert m["second_phase_s"] > 0
    assert simplify.ENGINE_RUNS["numpy"] > 0
    untraced = harness.run("meta.asm", SEED, 1, False, device="cpu", root=meta_root,
                           log=lambda m: None)
    assert untraced["correct"] is True
    # no card: no device peak
    assert {"job_s", "peak_host_gib", "setup_s"} == set(untraced["metrics"])
    assert untraced["metrics"]["job_s"]["value"] > m["simplification_s.meta"]


def _trace(path, spans):
    events = [{"name": d, "ph": "X", "ts": 0, "dur": int(s * 1e6), "pid": 1, "tid": 1,
               "args": {"detail": d, "id": i + 1, "parent": p}}
              for i, (d, s, p) in enumerate(spans)]
    path.mkdir()
    (path / "spades_time_trace.json").write_text(json.dumps({"traceEvents": events}))
    return {"out": str(path), "stage_times": []}


def test_readers_on_hand_built_trace_files(tmp_path):
    bench = harness.Bench(harness.ROOT)
    read = {n: bench.module("metrics", n).read for n in NEW}
    # no trace file, no stage times: every reader returns None
    bare = {"jobs": [{"out": str(tmp_path / "none"), "stage_times": []}]}
    assert {n: r(bare) for n, r in read.items()} == dict.fromkeys(NEW)
    # the parent's shape: spans with ids and no flanking span
    old = _trace(tmp_path / "old", [("spades", 9.0, None), ("k77", 5.0, 1),
                                    ("simplification", 2.0, 2)])
    assert read["flanking_s"]({"jobs": [old]}) is None
    job = _trace(tmp_path / "new", [("spades", 9.0, None), ("k21", 4.0, 1),
                                    ("simplification", 2.0, 2),
                                    ("simplification.flanking", 0.25, 3),
                                    ("simplification.flanking", 0.5, 3),
                                    ("k77", 5.0, 1), ("simplification", 3.0, 6),
                                    ("simplification.flanking", 0.125, 7),
                                    ("simplification.loop", 1.0, 7)])
    job["stage_times"] = [[21, "raw_simplification", 1.5], [21, "simplification", 2.0],
                          [77, "simplification", 3.0], [77, "pair_info_count", 7.0],
                          [77, "pair_info_count_preliminary", 1.0],
                          [77, "distance_estimation_preliminary", 0.5],
                          [77, "repeat_resolving_preliminary", 0.25],
                          [77, "second_phase_setup", 0.125], [77, "repeat_resolving", 9.0]]
    rec = {"jobs": [job, old]}
    assert read["flanking_s"](rec) == pytest.approx(0.875 / 2)
    assert read["simplification_s.meta"](rec) == pytest.approx(6.5 / 2)
    assert read["second_phase_s"](rec) == pytest.approx(1.875 / 2)
