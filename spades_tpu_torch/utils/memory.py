"""Memory budgeting: host RLIMIT cap + usage introspection + device HBM stats.

Capability mirror of SPAdes `src/common/utils/memory_limit.cpp:34-120`
(`limit_memory` via RLIMIT_AS, `get_memory_limit`, `get_free_memory`,
`get_used_memory`): the reference turns overruns into std::bad_alloc and
sizes its sort buffers from the budget.  Device memory comes from
`torch.cuda.mem_get_info` and `torch.cuda.memory_stats` of each visible
card, so batch sizes can be derived from both host and device budgets.
Unlike the JAX package, which reports a device whose statistics fail as
empty, a failing call raises here: no error hides the card.
"""
from __future__ import annotations

import logging
import resource

log = logging.getLogger("spades_tpu_torch.memory")


def limit_memory(limit_bytes: int) -> None:
    """Cap host address space (limit_memory, memory_limit.cpp:34-56).

    Overruns then raise MemoryError — the Python analog of bad_alloc."""
    soft, hard = resource.getrlimit(resource.RLIMIT_AS)
    new_hard = hard if hard != resource.RLIM_INFINITY and hard < limit_bytes else limit_bytes
    try:
        resource.setrlimit(resource.RLIMIT_AS, (limit_bytes, new_hard))
        log.info("memory limit set to %.1f GiB", limit_bytes / 2**30)
    except (ValueError, OSError) as e:  # pragma: no cover - permission dependent
        log.warning("could not set memory limit: %s", e)


def get_memory_limit() -> int | None:
    """Current RLIMIT_AS soft limit in bytes, None if unlimited."""
    soft, _ = resource.getrlimit(resource.RLIMIT_AS)
    return None if soft == resource.RLIM_INFINITY else soft


def get_used_memory() -> int:
    """Peak RSS of this process in bytes (get_used_memory analog)."""
    kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return kb * 1024


def get_free_memory() -> int | None:
    """Available host memory in bytes from /proc/meminfo (get_free_memory)."""
    try:
        with open("/proc/meminfo") as fh:
            for line in fh:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:  # pragma: no cover
        pass
    return None


def get_device_memory_stats(device=None) -> list[dict]:
    """Per-device memory: `bytes_in_use` (torch's allocated bytes),
    `bytes_limit` (the card's total) and `bytes_free` (free on the card)
    for every visible CUDA card; with `device="cpu"` one entry with None
    values, as the JAX package's CPU backend gives.  device: None means the
    CUDA card (see `resolve_device`)."""
    import torch

    from .. import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        return [{"device": "cpu", "bytes_in_use": None, "bytes_limit": None,
                 "bytes_free": None}]
    out = []
    for i in range(torch.cuda.device_count()):
        free, total = torch.cuda.mem_get_info(i)
        stats = torch.cuda.memory_stats(i)
        out.append(
            {
                "device": f"cuda:{i} {torch.cuda.get_device_name(i)}",
                "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
                "bytes_limit": int(total),
                "bytes_free": int(free),
            }
        )
    return out


def suggest_batch_size(
    read_length: int, k: int, hbm_budget_bytes: int = 8 << 30, words_per_kmer: int = 2
) -> int:
    """Reads per device batch so the counting sort working set fits the
    device budget — the analog of the reference's 512 MB/thread sort-buffer
    sizing (`kmer_splitter.hpp:95-99`)."""
    windows = max(read_length - k + 1, 1)
    # sort working set ~ 4x the input planes (sorted copy + carried flags)
    bytes_per_read = windows * words_per_kmer * 4 * 4
    return max(1024, int(hbm_budget_bytes / max(bytes_per_read, 1)))
