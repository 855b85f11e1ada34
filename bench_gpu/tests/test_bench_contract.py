"""BENCHMARK.json and the benchmark's files against the contract's rules:
names, units, keys, the files each name points to, and the import check."""
from __future__ import annotations

import ast
import json
import os
import re

import pytest

from bench_gpu import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expansion")


@pytest.fixture(scope="module")
def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_command_and_paths(spec):
    assert 1 <= len(spec["paths"]) <= 16
    for p in spec["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and not p.startswith("/")
        assert ".." not in p.split("/") and os.path.isdir(os.path.join(ROOT, p))
    assert 1 <= len(spec["command"]) <= 32 and all(_one_line(w) for w in spec["command"])
    for word in spec["command"]:
        assert not word.startswith("/") and ".." not in word.split("/")
        if "/" in word:
            assert any(word.startswith(p + "/") for p in spec["paths"])


def test_every_name_and_unit(spec):
    names = {}
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = [e["name"] for e in spec[group]]
        assert len(seen) == len(set(seen))
        names[group] = set(seen)
        for e in spec[group]:
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    assert not (names["end_to_end"] & names["per_layer"])
    for w in spec["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for c in spec["configs"]:
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])


def test_entry_keys(spec):
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _one_line(c["source"]) and _one_line(c["why"])
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _one_line(w["why"])
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and _one_line(m["layer"])
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}


def test_cells_report_what_they_must(spec):
    cells = {w["name"] for w in spec["workloads"]}
    e2e = [m for m in spec["end_to_end"]]
    assert "setup_s" in {m["name"] for m in e2e}
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        mine = [m["name"] for m in e2e if cell in m.get("workloads", cells)]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(cell in m.get("workloads", cells) for m in spec["per_layer"])
    for m in spec["per_layer"]:
        for cell in m.get("workloads", cells):
            moved = next(e for e in e2e if e["name"] == m["moves"])
            assert cell in moved.get("workloads", cells), (m["name"], cell)
    four = sum(w["chips"] == 4 for w in spec["workloads"])
    assert four <= max(1, len(cells) // 4)


def test_run_seconds_fits_the_check(spec):
    rs = spec["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_files_found_by_name(spec):
    bench = harness.Bench(ROOT)
    files = [c["file"] for c in spec["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in spec["workloads"]}
    assert used == {c["name"] for c in spec["configs"]}
    for c in spec["configs"]:
        assert any(c["file"].startswith(p + "/") for p in spec["paths"])
        cfg = bench.config(c["name"])
        assert cfg["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert key in cfg["params"] and not WIDTH.search(key)
        assert hasattr(bench.module("gen", cfg["generator"]), "make")
    for w in spec["workloads"]:
        mix = bench.traffic(w["traffic"])
        checks = [bench.module("reference", n) for n in mix["checks"]]
        assert all(hasattr(c, "readings") for c in checks)
        limits = bench.limits(w["name"])
        assert limits and all(v >= 0 for v in limits.values())
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert hasattr(bench.module("metrics", m["name"]), "read")


def test_layer_names_agree(spec):
    """Metrics of one layer give it letter for letter: one layer per module."""
    by_layer = {}
    for m in spec["per_layer"]:
        by_layer.setdefault(m["layer"].split(" (")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_layer.values())


def test_forbidden_modules_by_whole_top_level_name():
    names = ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "spades_tpu",
             "spades_tpu.ops.count", "spades_tpu_torch", "spades_tpu_torch.ops", "jaxtyping",
             "numpy", "bench_gpu.harness"]
    assert harness.forbidden_modules(names) == [
        "flax.linen", "jax", "jax.numpy", "jaxlib.xla_client", "spades_tpu", "spades_tpu.ops.count"]


def test_no_file_imports_jax_and_the_reference_imports_no_program():
    bench_dir = os.path.join(ROOT, "bench_gpu")
    for dirpath, _dirs, files in os.walk(bench_dir):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            with open(path) as fh:
                tree = ast.parse(fh.read())
            tops = set()
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    tops |= {a.name.split(".")[0] for a in node.names}
                elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                    tops.add(node.module.split(".")[0])
            assert not tops & set(harness.FORBIDDEN), path
            if os.sep + "reference" + os.sep in path:
                assert "spades_tpu_torch" not in tops and "torch" not in tops, path


def test_reference_modules_hold_nothing_of_the_program():
    bench = harness.Bench(ROOT)
    for name in ("kmers", "k1_graph", "contigs", "corrected"):
        bench.module("reference", name)
    assert harness.reference_imports_program() == []
