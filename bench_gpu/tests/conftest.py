"""Fixtures of the benchmark's tests.  They run on the CPU at a tiny size;
those marked `gpu` need the card and decide so inside the test body.

    python -m pytest -q bench_gpu/tests            # CPU
    python -m pytest -q -m gpu bench_gpu/tests     # on the card
"""
from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the sizes of the CPU runs: a 40 kb isolate at the cell's depth
TINY = {"isolate-ecoli": ({"genome_nt": 40000}, {"genome_nt": 20000})}
# limits of those tiny cells where they differ from the card's: the 40 kb
# genome is more than half planted repeat copies, and its two thinly covered
# ends weigh 30 times what they do in 1.26 Mb (sound readings on the CPU
# 15,967-26,979 ppm; every second contig left unwritten 419,464-467,802)
TINY_LIMITS = {"isolate.asm": {"genome_kmers_missing_ppm": 100000}}


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA card (skips without one)")


def copy_bench(dest: str) -> str:
    """A checkout holding only BENCHMARK.json and the benchmark's folder."""
    os.makedirs(dest, exist_ok=True)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), dest)
    shutil.copytree(os.path.join(ROOT, "bench_gpu"), os.path.join(dest, "bench_gpu"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark whose configurations are cut to TINY."""
    root = copy_bench(str(tmp_path / "checkout"))
    for name, (params, warmup) in TINY.items():
        path = os.path.join(root, "bench_gpu", "configs", f"{name}.json")
        with open(path) as fh:
            cfg = json.load(fh)
        cfg["params"].update(params)
        cfg["warmup"] = warmup
        with open(path, "w") as fh:
            json.dump(cfg, fh)
    for cell, limits in TINY_LIMITS.items():
        path = os.path.join(root, "bench_gpu", "limits", f"{cell}.json")
        with open(path) as fh:
            merged = {**json.load(fh), **limits}
        with open(path, "w") as fh:
            json.dump(merged, fh)
    return root


@pytest.fixture
def card():
    """Skip unless a CUDA card is there (decided in the test, not at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
