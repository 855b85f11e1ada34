"""Multi-GPU dry runs: the sharded paths on a few ranks against their
single-device oracles.

    dryrun_multigpu(world_size, device, backend)   # ranks of one pool
    dryrun_multihost(n_processes, device, backend) # separate processes

The counterparts of the JAX package's `__graft_entry__.py:dryrun_multichip`
(an n-device mesh in one process) and `dryrun_multihost`: here a rank is a
process, as PyTorch runs one per GPU.  `RankPool` starts `world` processes
once (spawned, each pinned to card `rank % device_count()` on a CUDA run,
with one torch thread) and runs any importable function on every rank; the
rank tasks below are what the dry runs and the multi-process tests hold
against the JAX package.  A task that fails on any rank, or does not answer
within the pool's timeout, ends the pool and raises.
"""
from __future__ import annotations

import os
import queue
import socket
import traceback

import numpy as np


def free_port() -> int:
    """A free TCP port on localhost (bind port 0, as the JAX dry run does)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, device, backend, address, tasks, results):
    import torch
    import torch.distributed as dist

    from .distributed import start_group

    torch.set_num_threads(1)
    try:
        start_group(address, world, rank, backend, device)
    except Exception:          # reported to the pool, which raises it
        results.put((rank, False, traceback.format_exc()))
        return
    while True:
        task = tasks.get()
        if task is None:
            break
        fn, args, kwargs = task
        if kwargs.get("group") == "world":
            kwargs = dict(kwargs, group=dist.group.WORLD)
        try:
            results.put((rank, True, fn(*args, **kwargs)))
        except Exception:      # reported to the pool, which ends every rank
            results.put((rank, False, traceback.format_exc()))
            break
    dist.destroy_process_group()


class RankPool:
    """`world` rank processes of one process group, started once.

    device: "cpu" or "cuda", None the card (`resolve_device`); backend:
    None is NCCL on CUDA and gloo on the CPU; address: an init method (`file://...`, `tcp://...`) or
    `host:port`, default a free localhost port.  `run(fn, *args, **kw)`
    calls fn on every rank and returns the results in rank order; a keyword
    `group="world"` reaches fn as the pool's group (any world size)."""

    def __init__(self, world: int, device=None, backend: str | None = None,
                 address: str | None = None, timeout_s: float = 600):
        import torch.multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.world = world
        self.timeout_s = timeout_s
        address = address or f"localhost:{free_port()}"
        self._tasks = [ctx.Queue() for _ in range(world)]
        self._results = ctx.Queue()
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True,
                        args=(r, world, device, backend, address,
                              self._tasks[r], self._results))
            for r in range(world)
        ]
        for p in self._procs:
            p.start()

    def run(self, fn, *args, **kwargs) -> list:
        if self._procs is None:
            raise RuntimeError("the rank pool is closed")
        for q in self._tasks:
            q.put((fn, args, kwargs))
        out = [None] * self.world
        for _ in range(self.world):
            try:
                rank, ok, val = self._results.get(timeout=self.timeout_s)
            except queue.Empty:
                self.close(kill=True)
                raise TimeoutError(f"a rank did not answer within {self.timeout_s} s") from None
            if not ok:
                self.close(kill=True)
                raise RuntimeError(f"rank {rank} failed:\n{val}")
            out[rank] = val
        return out

    def close(self, kill: bool = False) -> None:
        if self._procs is None:
            return
        if not kill:
            for q in self._tasks:
                q.put(None)
        for p in self._procs:
            p.join(timeout=0 if kill else 60)
            if p.is_alive():
                p.kill()
                p.join()
        self._procs = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close(kill=exc[0] is not None)


# ---------------------------------------------------------------------------
# rank tasks: each rank takes its `process_read_slice` share of the reads
# ---------------------------------------------------------------------------

def _share(seqs, rank: int, world: int):
    from ..core.reads import ReadBatch
    from .distributed import process_read_slice

    lo, hi = process_read_slice(len(seqs), rank, world)
    return ReadBatch.from_sequences(seqs[lo:hi])


def count_task(seqs, k: int, device=None, group=None):
    """The sharded count of every rank's share of `seqs`: (global
    KmerCounts, this rank's owned (words, counts)), host arrays."""
    from ..core import kmers as K
    from .distributed import rank_and_size, require_group
    from .sharded_count import ShardedCounter

    grp = require_group(group, "count_task")
    rank, world = rank_and_size(grp)
    counter = ShardedCounter(k, grp, device)
    counter.push(_share(seqs, rank, world))
    keys, counts = counter.shard()
    shard = (K.keys_to_words(keys.T.contiguous().cpu().numpy(), K.kmer_words(k)),
             counts.cpu().numpy())
    return counter.finish(), shard


def extension_task(seqs, k: int, device=None, group=None):
    """The sharded extension masks of every rank's share of `seqs`:
    (ExtensionIndex, this rank's owned (words, masks))."""
    from ..core import kmers as K
    from .distributed import rank_and_size, require_group
    from .sharded_extension import extension_masks_sharded, extension_shard

    grp = require_group(group, "extension_task")
    rank, world = rank_and_size(grp)
    batch = _share(seqs, rank, world)
    keys, masks = extension_shard(batch, k, grp, device)
    shard = (K.keys_to_words(keys.T.contiguous().cpu().numpy(), K.kmer_words(k)),
             masks.cpu().numpy())
    return extension_masks_sharded(batch, k, grp, device), shard


def condense_task(seqs, k: int, device=None, group=None):
    """Condense from the sharded outputs: the sharded (k+1)-mer count and
    extension masks of every rank's share -> the graph's edge sequences."""
    from ..ops.condense import condense
    from .distributed import rank_and_size, require_group
    from .sharded_count import count_kmers_sharded
    from .sharded_extension import extension_masks_sharded

    grp = require_group(group, "condense_task")
    rank, world = rank_and_size(grp)
    batch = _share(seqs, rank, world)
    g = condense(extension_masks_sharded(batch, k, grp, device),
                 count_kmers_sharded(batch, k + 1, grp, device), device=device)
    return sorted(g.edge_seq(int(e)) for e in g.canonical_edge_ids())


def graph_task(seqs, k: int, device=None, group=None, **kw):
    """`construct_graph` of the whole `seqs` under the group: its (k+1)-mer
    counts and graph arrays, host arrays."""
    from ..pipeline.construction import construct_graph

    res = construct_graph(seqs, k, device=device, group=group, **kw)
    g = res.graph
    return {"words": res.p1_counts.words, "counts": res.p1_counts.counts,
            **{f: getattr(g, f) for f in GRAPH_FIELDS},
            "exchanged_bytes": res.timings.get("exchanged_bytes", 0)}


GRAPH_FIELDS = ("e_start", "e_end", "e_conj", "e_off", "e_len", "e_cov", "seq_pool",
                "v_conj", "alive")


def mapping_task(index, g, seqs, tips, device=None, group=None):
    """Group mapping, votes and hits of `seqs` on `g` (every rank holds the
    same index): `map_reads_sharded`'s (edge, start, votes), the engine's
    `map_store` of the same reads, the (pool, 4) votes and the hits."""
    from ..alignment.mapper import MappingEngine
    from ..core.reads import ReadBatch, ReadStore
    from .sharded_mapping import hit_filter_store, map_reads_sharded, position_votes_sharded

    store = ReadStore.build(seqs, chunk_reads=256)
    engine = MappingEngine(g, index=index, device=device, group=group)
    return (map_reads_sharded(index, g, ReadBatch.from_sequences(seqs), device, group=group),
            engine.map_store(store, force_device=True),
            position_votes_sharded(index, g, store=store, device=device, group=group),
            hit_filter_store(store, tips, index.k, device=device, group=group))


def gap_task(g, paired, device=None, group=None):
    """The string path of `close_gaps` on a copy of `g` under the group:
    (gaps closed, the closed graph's arrays), host arrays."""
    import copy

    from ..alignment.gap_closer import close_gaps
    from .distributed import require_group

    g = copy.deepcopy(g)
    closed = close_gaps(g, paired, device=device, group=require_group(group, "gap_task"))
    return closed, {f: getattr(g, f) for f in GRAPH_FIELDS}


# ---------------------------------------------------------------------------
# the dry runs
# ---------------------------------------------------------------------------

def _random_reads(rng, n: int, length: int) -> list[str]:
    return ["".join("ACGT"[i] for i in rng.integers(0, 4, length)) for _ in range(n)]


def dryrun_multigpu(world_size: int, device=None, backend: str | None = None) -> dict:
    """Sharded count, extension masks, condense, distance clustering and
    gap closing on `world_size` ranks, each against its single-device
    oracle (the count against `count_sequences`, the masks against
    `build_extension_index`, condense from the sharded outputs against
    `construct_graph`, `estimate_simple_sharded` against the host
    `estimate_simple` within rtol 1e-5, and `close_gaps` under the group
    against `close_gaps` alone).  Raises on any difference; returns what
    was checked."""
    from ..alignment.gap_closer import close_gaps
    from ..core import dna
    from ..ops.count import count_sequences
    from ..ops.extension import build_extension_index
    from ..paired.distance_estimation import estimate_simple
    from ..paired.paired_info import PairedIndex
    from ..pipeline.construction import construct_graph
    from .sharded_de import estimate_simple_sharded

    rng = np.random.default_rng(1)
    k, ek = 15, 13
    reads = _random_reads(rng, 4 * world_size + 3, 48)
    ref = count_sequences(reads, k, device=device)
    ref_ei = build_extension_index(count_sequences(reads, ek + 1, device=device))
    g_host = construct_graph(reads, ek, device=device).graph
    ref_edges = sorted(g_host.edge_seq(int(e)) for e in g_host.canonical_edge_ids())
    # distance clustering: the JAX dry run's random pair table
    ne = 40
    de_e1 = np.sort(rng.integers(0, 20, ne))
    de_e2, de_d = rng.integers(0, 20, ne), rng.integers(50, 300, ne)
    o = np.lexsort((de_d, de_e2, de_e1))
    pi = PairedIndex(de_e1[o], de_e2[o], de_d[o], rng.integers(1, 5, ne).astype(float)[o])
    ref_de = estimate_simple(pi)
    oh = np.lexsort((ref_de.dist, ref_de.e2, ref_de.e1))
    # gap closing: two tiled fragments of a genome that overlap by 12 nt
    # (less than k) and pairs across the gap
    gen = "".join("ACGT"[i] for i in rng.integers(0, 4, 700))
    greads = ([gen[s : s + 80] for s in range(0, 271, 5)]
              + [gen[s : s + 80] for s in range(338, 621, 5)])
    g_gap = construct_graph(greads, 21, device=device).graph
    paired = [([gen[s : s + 70] for s in range(150, 470, 5)],
               [dna.revcomp_str(gen[s + 150 : s + 220]) for s in range(150, 470, 5)])]
    g_ref = construct_graph(greads, 21, device=device).graph
    ref_closed = close_gaps(g_ref, paired, device=device)
    with RankPool(world_size, device, backend) as pool:
        counts = pool.run(count_task, reads, k, device, group="world")
        exts = pool.run(extension_task, reads, ek, device, group="world")
        edges = pool.run(condense_task, reads, ek, device, group="world")
        des = pool.run(estimate_simple_sharded, pi, group="world", device=device)
        gaps = pool.run(gap_task, g_gap, paired, device, group="world")
    for r in range(world_size):
        kc, _shard = counts[r]
        assert np.array_equal(kc.words, ref.words) and np.array_equal(kc.counts, ref.counts), \
            f"rank {r}: sharded count differs from count_sequences"
        assert kc.total == sum(len(s) - k + 1 for s in reads)
        ei, _ = exts[r]
        for f in ("kmers", "in_mask", "out_mask"):
            assert np.array_equal(getattr(ei, f), getattr(ref_ei, f)), \
                f"rank {r}: sharded extension {f} differs from build_extension_index"
        assert edges[r] == ref_edges, f"rank {r}: condense from sharded outputs differs"
        assert np.array_equal(des[r].e1, ref_de.e1[oh]) and np.array_equal(
            des[r].e2, ref_de.e2[oh]), f"rank {r}: sharded distance clusters differ"
        assert np.allclose(des[r].dist, ref_de.dist[oh], rtol=1e-5) and np.allclose(
            des[r].weight, ref_de.weight[oh], rtol=1e-5), \
            f"rank {r}: sharded distance estimates differ beyond rtol 1e-5"
        closed, arrays = gaps[r]
        assert closed == ref_closed and all(
            np.array_equal(arrays[f], getattr(g_ref, f)) for f in GRAPH_FIELDS), \
            f"rank {r}: close_gaps under the group differs"
    shard_rows = [int(counts[r][1][0].shape[0]) for r in range(world_size)]
    assert sum(shard_rows) == ref.num_unique
    return {"world_size": world_size, "device": device, "backend": backend,
            "unique": ref.num_unique, "shard_rows": shard_rows,
            "ext_kmers": int(ref_ei.num_kmers), "edges": len(ref_edges),
            "de_clusters": int(ref_de.e1.size), "gaps_closed": ref_closed}


def dryrun_multihost(n_processes: int = 2, device=None, backend: str | None = None,
                     timeout_s: float = 600) -> str:
    """Cross-process collectives through the CLI: `n_processes` runs of
    `python -m spades_tpu_torch.parallel.multihost_dryrun`, process 0
    checking the count against the host oracle.  Returns process 0's
    output; raises unless every process exits 0 and process 0 printed
    MULTIHOST_OK."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    port = free_port()
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "spades_tpu_torch.parallel.multihost_dryrun",
           "--num-processes", str(n_processes), "--coordinator", f"localhost:{port}"]
    if device is not None:
        cmd += ["--device", str(device)]
    if backend:
        cmd += ["--backend", backend]
    procs = [subprocess.Popen(cmd + ["--process-id", str(pid)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env, cwd=root)
             for pid in range(n_processes)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout_s)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"process {pid} exited with {p.returncode}:\n{out[-2000:]}")
    if "MULTIHOST_OK" not in outs[0]:
        raise RuntimeError(f"process 0 did not confirm the count:\n{outs[0][-2000:]}")
    return outs[0]
