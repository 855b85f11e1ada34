"""Time the canonical-windows CUDA kernel under other tuning constants.

    python -m spades_tpu_torch.tools.kernel_bench [--also OTHER.cu] [--iters N] [--rounds N]

Builds `csrc/canonical_windows.cu` once per entry of VARIANTS, each with the
`-D` overrides of the source's tuning constants (tile size, tile alignment,
blocks per SM, plain instead of streaming stores), all builds started
together.  At every main-path shape of `tools/kernel_shapes.py` each build is
held against the plain PyTorch version (tolerance 0) and timed with CUDA
events, in turns within one process, so the variants are compared on one card
in one call.  The first variant is the build every caller runs.  `--also`
names another source of the kernel with the same C interface (an earlier
commit's, say), built with its own constants and timed in the same turns.

Prints one JSON record per line; the card's `nvidia-smi` name and power limit
stand in the first.  Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import torch

from ..core import kmers as K
from ..ops import cuda_kernels as CK
from . import kernel_shapes as KS

VARIANTS = (
    ("as shipped", ()),
    ("tiles of 4096 windows", ("-DSPADES_TILE_WINDOWS=4096",)),
    ("tiles of 65536 windows", ("-DSPADES_TILE_WINDOWS=65536",)),
    ("tile height any even number", ("-DSPADES_TILE_ALIGN=2",)),
    ("2 blocks per SM", ("-DSPADES_BLOCKS_PER_SM=2",)),
    ("4 blocks per SM", ("-DSPADES_BLOCKS_PER_SM=4",)),
    ("8 blocks per SM", ("-DSPADES_BLOCKS_PER_SM=8",)),
    ("plain stores", ("-DSPADES_PLAIN_STORES",)),
)


def build_variants(outdir: str, variants):
    """One nvcc per (name, defines, source), all at once; returns the loaded
    libraries."""
    procs = []
    for i, (_, defines, source) in enumerate(variants):
        so = os.path.join(outdir, f"variant{i}.so")
        procs.append((so, subprocess.Popen(
            [CK._nvcc(), *CK.NVCC_FLAGS, *defines, "-o", so, source],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = []
    for so, proc in procs:
        log = proc.communicate(timeout=600)[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {so}:\n{log}")
        lib = ctypes.CDLL(so)
        lib.spades_canonical_windows.restype = ctypes.c_int
        lib.spades_canonical_windows.argtypes = CK.C_ARGTYPES
        libs.append(lib)
    return libs


def launch(lib, pc, pn, lengths, L: int, k: int, strand: bool):
    """`ops/cuda_kernels.py:canonical_window_keys` on one variant's library."""
    R, P = pc.shape[0], L - k + 1
    keys = torch.empty((K.key_planes(k), R * P), dtype=torch.int64, device=pc.device)
    valid = torch.empty((R, P), dtype=torch.bool, device=pc.device)
    was_rc = torch.empty((R, P), dtype=torch.bool, device=pc.device) if strand else None
    rc = lib.spades_canonical_windows(
        pc.data_ptr(), pn.data_ptr(), lengths.data_ptr(), keys.data_ptr(), valid.data_ptr(),
        was_rc.data_ptr() if strand else None, R, L, k,
        torch.cuda.current_stream(pc.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"canonical_windows kernel launch failed ({rc})")
    return (keys, valid, was_rc) if strand else (keys, valid)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--also", help="another source of the kernel to time beside it")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device is available", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    variants = [(name, defines, CK._SRC) for name, defines in VARIANTS]
    if args.also:
        variants.append((args.also, (), args.also))
    names = [v[0] for v in variants]
    with tempfile.TemporaryDirectory(prefix="kernel_bench_") as outdir:
        libs = build_variants(outdir, variants)
        print(json.dumps({"card": card, "variants": names}), flush=True)
        for name, R, L, k, strand, read_len in KS.MAIN_SHAPES:
            pc, pn, ln, L = KS.random_packed(7, R, L, k, read_len, n_rate=0.0)
            targs = [torch.from_numpy(a).to(dev) for a in (pc, pn, ln)]
            ref = CK.canonical_window_keys_plain(*targs, L, k, strand=strand)
            for variant, lib in zip(names, libs):
                err = KS.max_abs_err(launch(lib, *targs, L, k, strand), ref)
                if err:
                    raise SystemExit(f"{name}, {variant}: differs from the plain version ({err})")
            del ref
            bound_ms, bound_by = KS.canonical_windows_bound(R, L, k, strand)
            rec = {"shape": name, "R": R, "L": L, "k": k, "strand": strand,
                   "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": 0,
                   "ms": {variant: [] for variant in names}}
            for _ in range(args.rounds):
                for variant, lib in zip(names, libs):
                    rec["ms"][variant].append(KS.time_ms(
                        lambda: launch(lib, *targs, L, k, strand), dev, args.iters))
            print(json.dumps(rec), flush=True)
            del targs
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
