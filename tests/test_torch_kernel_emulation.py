"""The canonical-windows CUDA kernel, compiled as host code and run on the CPU.

`spades_tpu_torch/csrc/canonical_windows.cu` builds only where nvcc is, but
its tiling, staging offsets, flat window indices, bit logic and store paths
are plain C++.  `csrc/emulation/` replaces the CUDA names the source uses by
host stand-ins (a block is a group of host threads), so the same source runs
here behind the same C interface and is held against the kernel's plain
PyTorch version: tolerance 0, with and without the strand plane.
"""
import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from spades_tpu_torch.core.reads import ReadBatch
from spades_tpu_torch.ops import cuda_kernels as CK

CSRC = pathlib.Path(CK.__file__).resolve().parent.parent / "csrc"
SLACK = 64   # bytes around every array, filled with a pattern that must not matter
# the kernel's own tuning constants, and small odd tiles walked by one block
BUILDS = ((), ("-DSPADES_TILE_WINDOWS=512", "-DSPADES_TILE_ALIGN=1", "-DSPADES_BLOCKS_PER_SM=1"))


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("emu")
    libs = []
    for i, defines in enumerate(BUILDS):
        so = out / f"libcanonical_windows_emulated{i}.so"
        subprocess.run(
            ["g++", "-std=c++17", "-O1", "-shared", "-fPIC", "-pthread", *defines,
             "-I", str(CSRC / "emulation"), "-o", str(so),
             str(CSRC / "emulation" / "emulate_canonical_windows.cpp")],
            check=True, capture_output=True, text=True, timeout=300)
        lib = ctypes.CDLL(str(so))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.spades_canonical_windows.restype = ci
        lib.spades_canonical_windows.argtypes = [vp] * 6 + [ci] * 3 + [vp]
        libs.append(lib)
    return libs


def _shifted(a: np.ndarray, shift: int) -> np.ndarray:
    """A contiguous copy of `a` that starts `shift` bytes past a 16-byte line,
    with slack on both sides."""
    raw = np.zeros(a.nbytes + 2 * SLACK + 16, np.uint8)
    raw[:] = 0xA5                       # what lies around a tile must not matter
    base = (-raw.ctypes.data) % 16 + SLACK - SLACK % 16 + shift
    view = raw[base : base + a.nbytes].view(a.dtype).reshape(a.shape)
    view[...] = a
    return view


def _batch(seed, R, L, k, n_rate):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (R, L)).astype(np.uint8)
    lengths = rng.integers(max(k - 3, 0), L + 1, R).astype(np.int32)
    lengths[: max(R // 4, 1)] = L
    n_mask = rng.random((R, L)) < n_rate
    pos = np.arange(L)[None, :]
    codes[pos >= lengths[:, None]] = 0
    n_mask &= pos < lengths[:, None]
    return ReadBatch(codes=codes, lengths=lengths, n_mask=n_mask).packed()


def _run(lib, pc, pn, ln, L, k, strand, shift=0):
    R = pc.shape[0]
    P = L - k + 1
    nk = (((k + 15) // 16) + 1) // 2
    pc, pn = _shifted(pc, shift), _shifted(pn, (shift * 7) % 16)
    ln = _shifted(ln, (shift % 4) * 4)
    keys = _shifted(np.zeros((nk, R * P), np.int64), 0)
    valid = _shifted(np.full((R, P), 7, np.uint8), 0)
    was_rc = _shifted(np.full((R, P), 7, np.uint8), 0) if strand else None
    rc = lib.spades_canonical_windows(
        pc.ctypes.data, pn.ctypes.data, ln.ctypes.data, keys.ctypes.data,
        valid.ctypes.data, was_rc.ctypes.data if strand else None, R, L, k, None)
    assert rc == 0
    return keys, valid, was_rc


CASES = [
    # k, R, L, n_rate, shift
    (13, 37, 64, 0.03, 0),      # W=1, odd R*P; tiles of 9 reads: the scalar store path
    (21, 40, 152, 0.03, 5),     # W=2, misaligned rows
    (22, 64, 152, 0.0, 0),      # the counting shape, no N
    (33, 33, 97, 0.05, 11),     # W=3 (odd), ragged last tile, odd R
    (55, 48, 152, 0.02, 3),     # the mapper's k
    (56, 30, 256, 0.02, 0),     # the width of a ReadBatch of short reads
    (64, 16, 100, 0.02, 9),     # m = 16: a full last word
    (65, 16, 100, 0.02, 1),     # m = 1
    (128, 12, 200, 0.01, 7),    # W=8
    (31, 9, 31, 0.02, 13),      # P = 1: every pair of windows spans two reads
]


@pytest.mark.parametrize("strand", [False, True])
@pytest.mark.parametrize("case", CASES, ids=[f"k{c[0]}-R{c[1]}-L{c[2]}" for c in CASES])
def test_emulated_kernel_matches_plain(emulated, case, strand):
    k, R, L, n_rate, shift = case
    pc, pn, ln, L = _batch(1000 * k + R, R, L, k, n_rate)
    ref = CK.canonical_window_keys_plain(torch.from_numpy(pc), torch.from_numpy(pn),
                                         torch.from_numpy(ln), L, k, strand=True)
    for lib in emulated:
        keys, valid, was_rc = _run(lib, pc, pn, ln, L, k, strand, shift)
        assert np.array_equal(keys, ref[0].numpy())
        assert np.array_equal(valid, ref[1].numpy().astype(np.uint8))
        if strand:
            assert np.array_equal(was_rc, ref[2].numpy().astype(np.uint8))
    assert ref[1].any() and not ref[1].all()


def test_emulated_kernel_rejects_bad_shapes(emulated):
    pc, pn, ln, L = _batch(1, 8, 64, 21, 0.0)
    for bad_k, bad_L in ((0, L), (129, 200), (21, 20)):
        rc = emulated[0].spades_canonical_windows(
            pc.ctypes.data, pn.ctypes.data, ln.ctypes.data, None, None, None,
            8, bad_L, bad_k, None)
        assert rc != 0
