"""A new configuration, traffic mix and per-layer metric are taken up as new
files plus new BENCHMARK.json entries, with no existing file edited; the
result line carries the contract's keys."""
from __future__ import annotations

import hashlib
import json
import os

from bench_gpu import harness

SEED = 2**31 + 977


def _digests(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            if "__pycache__" not in path:
                with open(path, "rb") as fh:
                    out[os.path.relpath(path, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def _add(root, rel, obj):
    path = os.path.join(root, rel)
    assert not os.path.exists(path), rel
    with open(path, "w") as fh:
        fh.write(obj if isinstance(obj, str) else json.dumps(obj))


def test_new_files_and_entries_are_found_by_name(tiny_root):
    root = tiny_root
    bench_json = os.path.join(root, "BENCHMARK.json")
    before = _digests(root)
    with open(os.path.join(root, "bench_gpu", "configs", "isolate-ecoli.json")) as fh:
        cfg = json.load(fh)
    cfg.update(name="isolate-small", warmup={"genome_nt": 15000})
    cfg["params"].update(genome_nt=30000)
    _add(root, "bench_gpu/configs/isolate-small.json", cfg)
    _add(root, "bench_gpu/traffic/asm-two-k.json",
         {"about": "two K only", "argv": ["--only-assembler", "-k", "21,33"],
          "checks": ["k1_graph", "contigs"], "first_k": 21})
    _add(root, "bench_gpu/limits/small.two-k.json",
         {"k1_kmers_off": 0, "k1_cov_off": 0, "contig_kmers_absent_ppm": 1e5})
    _add(root, "bench_gpu/metrics/k_passes.py",
         '"""k_passes: distinct K per job."""\n\n\ndef read(rec):\n'
         '    return sum(len({k for k, _i, _s in j["stage_times"]}) for j in rec["jobs"])'
         ' / len(rec["jobs"])\n')
    with open(bench_json) as fh:
        spec = json.load(fh)
    spec["configs"].append({"name": "isolate-small", "source": "https://github.com/ablab/spades",
                            "file": "bench_gpu/configs/isolate-small.json",
                            "reduced": cfg["reduced"], "why": "a test"})
    spec["workloads"].append({"name": "small.two-k", "config": "isolate-small",
                              "traffic": "asm-two-k", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "k_passes", "unit": "K", "better": "lower",
                              "source": "program_span", "layer": "runner", "moves": "job_s",
                              "workloads": ["small.two-k"]})
    next(m for m in spec["end_to_end"] if m["name"] == "job_s")["workloads"].append("small.two-k")
    with open(bench_json, "w") as fh:
        json.dump(spec, fh)
    after = _digests(root)
    changed = {p for p in before if before[p] != after.get(p)}
    assert changed == {"BENCHMARK.json"}

    res = harness.run("small.two-k", SEED, 1, True, device="cpu", root=root, log=lambda m: None)
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1, res["checks"]
    assert res["metrics"]["k_passes"] == {"value": 2.0, "unit": "K"}
    # the other per-layer metrics list their cells: a new cell inherits none
    assert set(res["metrics"]) == {"k_passes"}
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert set(res["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}


def test_untraced_line(tiny_root):
    res = harness.run("isolate.ec", SEED, 1, False, device="cpu", root=tiny_root,
                      log=lambda m: None)
    assert res["correct"] is True
    # no card: no device peak; the cell's job time is per layer (`job_s.ec`)
    assert set(res["metrics"]) == {"peak_host_gib", "setup_s"}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert set(res["checks"]) == {"ec_wrong_bases_ppm"}
    assert res["checks"]["ec_wrong_bases_ppm"]["value"] <= res["checks"]["ec_wrong_bases_ppm"]["limit"]
    json.dumps(res)
