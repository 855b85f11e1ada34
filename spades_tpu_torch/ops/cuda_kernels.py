"""Hand-written CUDA kernels of the port, their builds and their wrappers.

`canonical_window_keys` is the port's counterpart of the Pallas TPU kernel
`spades_tpu/ops/pallas_kernels.py:_extract_kernel` (launched there by
`canonical_windows_planar`).  Its CUDA source, `csrc/canonical_windows.cu`,
is compiled by nvcc for sm_90a into `spades_tpu_torch/_build/` at first use
and bound with ctypes.  On a CPU tensor the wrapper computes the kernel's
plain PyTorch version; on a CUDA tensor it launches the kernel or raises.
`build` compiles every source of `csrc/` (the coverage EM's,
`csrc/coverage_em.cu`, wrapped by `ops/coverage_em.py`, too) in one nvcc
call into one library, so that a run's set-up pays for one build.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import tempfile

import torch

from ..core import kmers as K

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "canonical_windows.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
EM_SRC = os.path.join(_PKG, "csrc", "coverage_em.cu")
SOURCES = (_SRC, EM_SRC)
_SO = os.path.join(BUILD_DIR, "libspades_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# spades_canonical_windows(pc, pn, lengths, keys, valid, strand, R, L, k, stream)
C_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
# spades_coverage_em(cov, n, init (8 host doubles), out, stream)
EM_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_double),
               ctypes.c_void_p, ctypes.c_void_p]

_lib = None         # the library of every source in SOURCES, loaded by `build`
build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def build() -> str:
    """Compile csrc/canonical_windows.cu and csrc/coverage_em.cu in one nvcc
    call into one library (when it is missing or older than either source)
    and load it.  Returns the path of the library."""
    global _lib, build_log
    if _lib is not None:
        return _SO
    os.makedirs(BUILD_DIR, exist_ok=True)
    # one build at a time (the ranks of a multi-process run start together);
    # each builds to a private name, then renames: a concurrent loader never
    # sees a half-written library
    with open(os.path.join(BUILD_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < max(map(os.path.getmtime, SOURCES)):
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *SOURCES],
                                     capture_output=True, text=True, timeout=600)
                build_log = res.stdout + res.stderr
                if res.returncode != 0:
                    raise RuntimeError(f"nvcc failed on {SOURCES}:\n{build_log}")
                os.replace(tmp, _SO)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
    lib = ctypes.CDLL(_SO)
    lib.spades_canonical_windows.restype = ctypes.c_int
    lib.spades_canonical_windows.argtypes = C_ARGTYPES
    lib.spades_cuda_error_string.restype = ctypes.c_char_p
    lib.spades_cuda_error_string.argtypes = [ctypes.c_int]
    lib.spades_coverage_em.restype = ctypes.c_int
    lib.spades_coverage_em.argtypes = EM_ARGTYPES
    lib.spades_coverage_em_error_string.restype = ctypes.c_char_p
    lib.spades_coverage_em_error_string.argtypes = [ctypes.c_int]
    _lib = lib
    return _SO


def canonical_window_keys_plain(pc: torch.Tensor, pn: torch.Tensor,
                                lengths: torch.Tensor, L: int, k: int,
                                strand: bool = False):
    """Plain PyTorch version of the canonical_windows kernel: unpack the
    wire format, take the canonical windows, fold them into sort keys."""
    from .count import unpack_batch_device

    codes, n_mask = unpack_batch_device(pc, pn, L)
    canon, valid, use_rc = K.canonical_windows_strand(codes, lengths, n_mask, k)
    keys = K.canon_to_keys(canon, valid)
    return (keys, valid, use_rc & valid) if strand else (keys, valid)


def canonical_window_keys(pc: torch.Tensor, pn: torch.Tensor,
                          lengths: torch.Tensor, L: int, k: int,
                          strand: bool = False):
    """Canonical k-mer keys of every window of a packed read batch.

    pc (R, ceil(L/4)) uint8, pn (R, ceil(L/8)) uint8, lengths (R,) int32,
    all on one device.  Returns (keys (ceil(W/2), R*P) int64, valid (R, P)
    bool), P = L - k + 1, in the key layout of core/kmers.py; invalid
    windows hold INT64_MAX in every plane.  With strand=True it returns
    (keys, valid, was_rc): was_rc (R, P) bool is True where the window is
    valid and its canonical form is its reverse complement, the third
    output of `core/kmers.py:canonical_windows_strand` masked by `valid`.
    The kernel reads its inputs from the 16-byte line that holds their first
    byte: they must lie in allocations that start on such a line, as those
    of torch's and every CUDA allocator do.
    Counterpart of `spades_tpu/ops/pallas_kernels.py:_extract_kernel`."""
    R = pc.shape[0]
    if not 1 <= k <= 128 or L < k:
        raise ValueError(f"need 1 <= k <= 128 and k <= L, got k={k}, L={L}")
    if pc.dtype != torch.uint8 or pn.dtype != torch.uint8 or lengths.dtype != torch.int32:
        raise TypeError("pc and pn must be uint8 and lengths int32")
    if pc.shape != (R, (L + 3) // 4) or pn.shape != (R, (L + 7) // 8) or lengths.shape != (R,):
        raise ValueError(
            f"shapes {tuple(pc.shape)}, {tuple(pn.shape)}, {tuple(lengths.shape)} "
            f"do not match R={R}, L={L}"
        )
    if not (pc.device == pn.device == lengths.device):
        raise ValueError("pc, pn and lengths must be on one device")
    if pc.device.type == "cpu":
        return canonical_window_keys_plain(pc, pn, lengths, L, k, strand)
    if pc.device.type != "cuda":
        raise ValueError(f"unsupported device {pc.device}")
    if not (pc.is_contiguous() and pn.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("pc, pn and lengths must be contiguous")
    build()
    P = L - k + 1
    keys = torch.empty((K.key_planes(k), R * P), dtype=torch.int64, device=pc.device)
    valid = torch.empty((R, P), dtype=torch.bool, device=pc.device)
    was_rc = torch.empty((R, P), dtype=torch.bool, device=pc.device) if strand else None
    if R > 0:
        with torch.cuda.device(pc.device):
            stream = torch.cuda.current_stream(pc.device).cuda_stream
            rc = _lib.spades_canonical_windows(
                pc.data_ptr(), pn.data_ptr(), lengths.data_ptr(), keys.data_ptr(),
                valid.data_ptr(), was_rc.data_ptr() if strand else None, R, L, k, stream,
            )
        if rc != 0:
            msg = _lib.spades_cuda_error_string(rc).decode()
            raise RuntimeError(f"canonical_windows kernel launch failed: {msg} ({rc})")
        canonical_window_keys.launches += 1
        if canonical_window_keys.launch_shapes is not None:
            canonical_window_keys.launch_shapes[(R, L, k, strand)] += 1
    return (keys, valid, was_rc) if strand else (keys, valid)


canonical_window_keys.launches = 0
# set to a `collections.Counter` to have every launch counted by its
# (R, L, k, strand) as well: how a run learns which shapes a path gave the kernel
canonical_window_keys.launch_shapes = None
