"""Multi-process runs on `torch.distributed`: process setup, host-sliced
input, the collectives of the sharded paths, and the multi-process sharded
count.

Counterpart of `spades_tpu.parallel.distributed` (hpcSPAdes' partask MPI
runtime, `hpcspades/mpi/pipeline/partask_mpi.hpp:1135-1404`).  Where the
JAX package joins the jax coordination service and shards over a device mesh
(axis "d"), the port runs one process per GPU and joins a process group:

* `init_distributed` starts the group (NCCL for CUDA runs, gloo for the CPU,
  or the backend the caller names) and pins the process to its card,
  `process_id % torch.cuda.device_count()`, before anything is allocated;
* `resolve_group` is the counterpart of the JAX package's `mesh=` default:
  an explicit group, else the default group when one is initialized with
  more than one process, else None (the single-device path);
* `process_read_slice` gives each process its contiguous share of an input;
* `exchange_rows`, `gather_rows` and `all_reduce_sum` are the collectives of
  the sharded paths (the `all_to_all`, the gather of per-shard results and
  the `psum` of the JAX shard bodies).  Shapes may differ between ranks:
  row counts are exchanged first, so no rank pads to a common capacity.

Both backends take the tensors where they lie: NCCL the card's, gloo the
CPU's and, in the torch the card's machine runs, the card's too (gloo's
`all_to_all_single`, `all_gather_into_tensor` and `all_reduce` on CUDA
tensors, probed there), so the port copies nothing around a collective.
The tests and two ranks sharing one card run gloo.  A failed init or
collective raises; nothing carries on alone.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.distributed as dist

# bytes this process handed to other ranks through the collectives below:
# an exchange's rows bound for another rank, a gather's block once per other
# rank, a reduction's tensor once per other rank
EXCHANGED = {"bytes": 0, "collectives": 0}


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    device=None,
) -> None:
    """Join the process group of a multi-process run (idempotent).

    Arguments default to the SPADES_COORDINATOR / SPADES_NUM_PROCESSES /
    SPADES_PROCESS_ID environment (the mpiexec rank-environment analog).
    With one process this does nothing.  The coordinator is `host:port`
    (rank 0 listens there: `tcp://host:port`) or a full init method such as
    `file:///shared/path`.  backend: None takes NCCL when `device` resolves
    to a CUDA card and gloo on the CPU; gloo may be asked for with CUDA
    tensors (several ranks on one card, which NCCL refuses).  On a CUDA
    run each process first makes card `process_id % device_count()` its
    current device."""
    if num_processes is None:
        num_processes = int(os.environ.get("SPADES_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return
    if coordinator_address is None:
        coordinator_address = os.environ.get("SPADES_COORDINATOR")
    if not coordinator_address:
        raise ValueError(
            f"{num_processes} processes need a coordinator address "
            "(--coordinator host:port or SPADES_COORDINATOR)")
    if process_id is None:
        if "SPADES_PROCESS_ID" not in os.environ:
            raise ValueError("a multi-process run needs its process id "
                             "(--process-id or SPADES_PROCESS_ID)")
        process_id = int(os.environ["SPADES_PROCESS_ID"])
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is outside [0, {num_processes})")
    if dist.is_initialized():
        if dist.get_world_size() != num_processes or dist.get_rank() != process_id:
            raise RuntimeError("a different process group is already initialized")
        return
    start_group(coordinator_address, num_processes, process_id, backend, device)


def start_group(address: str, world_size: int, rank: int, backend: str | None = None,
                device=None) -> None:
    """Initialize the default process group at any world size (one
    included): the card `rank % device_count()` becomes current first on a
    CUDA run; backend None is NCCL there and gloo on the CPU; `address` is
    `host:port` or an init method with its scheme."""
    from .. import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    init_method = address if "://" in address else "tcp://" + address
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def global_group():
    """The group of every process of the run (the counterpart of the JAX
    package's `global_mesh`); raises when no group is initialized."""
    return require_group(None, "global_group")


def resolve_group(group=None):
    """The group a sharded path runs over, or None for the single-device
    path: `group` when given (any world size, one included), else the
    default group when it is initialized with more than one process."""
    if group is not None:
        return group
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return dist.group.WORLD
    return None


def require_group(group=None, what: str = "this path"):
    """`group` when given, else the default group, which must be
    initialized (any world size, one included)."""
    if group is not None:
        return group
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(f"{what} needs a process group (init_distributed, or group=)")
    return dist.group.WORLD


def rank_and_size(group) -> tuple[int, int]:
    return dist.get_rank(group), dist.get_world_size(group)


def process_read_slice(
    n_items: int,
    process_id: int | None = None,
    num_processes: int | None = None,
    weights: list[int] | None = None,
) -> tuple[int, int]:
    """Contiguous [lo, hi) slice of a globally ordered input owned by this
    process, weighted as partask's thread-weighted splitter
    (`partask_mpi.hpp:1296-1374`).  The weight is 1 per process, since a
    process holds one card; the defaults are the default group's rank and
    size (0 and 1 without one)."""
    if num_processes is None or process_id is None:
        inited = dist.is_available() and dist.is_initialized()
        if num_processes is None:
            num_processes = dist.get_world_size() if inited else 1
        if process_id is None:
            process_id = dist.get_rank() if inited else 0
    if weights is None:
        weights = [1] * num_processes
    total_w = sum(weights)
    bounds = np.floor(
        np.cumsum([0] + list(weights)) / total_w * n_items
    ).astype(int)
    return int(bounds[process_id]), int(bounds[process_id + 1])


def _all_gather_equal(block: torch.Tensor, group) -> torch.Tensor:
    """All ranks' equal-shape blocks, stacked in rank order on dim 0."""
    world = dist.get_world_size(group)
    block = block.contiguous()
    out = block.new_empty((world * block.shape[0],) + tuple(block.shape[1:]))
    dist.all_gather_into_tensor(out, block, group=group)
    EXCHANGED["bytes"] += block.numel() * block.element_size() * (world - 1)
    EXCHANGED["collectives"] += 1
    return out


def all_gather_sizes(n: int, group, device) -> list[int]:
    """Every rank's `n`, in rank order."""
    got = _all_gather_equal(torch.tensor([n], dtype=torch.int64, device=device), group)
    return [int(x) for x in got.tolist()]


def gather_rows(rows: torch.Tensor, group, sizes: list[int] | None = None) -> torch.Tensor:
    """Concatenate every rank's rows (dim 0) in rank order, on every rank.
    Ranks may hold different row counts (`sizes`, exchanged when not
    given): each block is padded to the largest before the gather."""
    if sizes is None:
        sizes = all_gather_sizes(rows.shape[0], group, rows.device)
    top = max(sizes)
    block = rows.new_zeros((top,) + tuple(rows.shape[1:]))
    block[: rows.shape[0]] = rows
    out = _all_gather_equal(block, group)
    return torch.cat([out[r * top : r * top + n] for r, n in enumerate(sizes)])


def exchange_rows(rows: torch.Tensor, dest: torch.Tensor, group) -> torch.Tensor:
    """Send each row (dim 0) to rank `dest[i]`; returns the rows this rank
    received, grouped by sender in rank order, each sender's rows in their
    order here.  The per-destination row counts go first (one exchange of
    `world` int64s), then one uneven `all_to_all_single`."""
    world = dist.get_world_size(group)
    me = dist.get_rank(group)
    order = torch.sort(dest, stable=True).indices
    send = rows[order].contiguous()
    counts = torch.bincount(dest, minlength=world).to(torch.int64)
    recv_counts = torch.empty_like(counts)
    dist.all_to_all_single(recv_counts, counts, group=group)
    send_sizes, recv_sizes = counts.tolist(), recv_counts.tolist()
    out = send.new_empty((sum(recv_sizes),) + tuple(send.shape[1:]))
    dist.all_to_all_single(out, send, output_split_sizes=recv_sizes,
                           input_split_sizes=send_sizes, group=group)
    row_bytes = math.prod(send.shape[1:]) * send.element_size()
    EXCHANGED["bytes"] += (sum(send_sizes) - send_sizes[me]) * row_bytes + 8 * (world - 1)
    EXCHANGED["collectives"] += 2
    return out


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Elementwise sum of `t` over the group (exact for integer tensors)."""
    world = dist.get_world_size(group)
    out = t.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    EXCHANGED["bytes"] += out.numel() * out.element_size() * (world - 1)
    EXCHANGED["collectives"] += 1
    return out


def count_kmers_sharded_multihost(batch, k: int, group=None, device=None):
    """Multi-process sharded counting: every process passes its LOCAL batch
    (shapes may differ between processes), the k-mers route to their owner
    ranks, and every process returns the identical global KmerCounts (the
    reference's master merge + SyncWorld broadcast, `partask_mpi.hpp:1294-1374`,
    `mpi_stage.cpp:43-66`)."""
    from .sharded_count import count_kmers_sharded

    return count_kmers_sharded(batch, k, group=group, device=device)
