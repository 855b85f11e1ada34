"""BayesHammer-equivalent read error correction, on PyTorch.

Capability mirror of `spades-hammer` (`src/projects/hammer/main.cpp:65-245`):
an iterative loop of (1) k-mer counting (fixed k=21 in SPAdes), (2)
Hamming-distance clustering of the counted k-mers, (3) center selection and
solid ("good") k-mer marking against the coverage model, (4) read correction
by per-position consensus of the solid cluster centers covering each
position (`read_corrector.cpp`).  With PHRED qualities the quality-weighted
machinery runs too (`kmer_cluster.cpp`, `expander.cpp`; see hammer/bayes.py).

Device/host split, as in the JAX package's `spades_tpu/hammer/hammer.py`:
counting is the device counting engine (ops/count); the per-pass window maps
come from the canonical-windows kernel with its strand plane and a device
search of the counted table (`build_window_maps`); the quality sum, the
solid-set expansion and the vote (`_vote_correct_batch`: every read window
gathers its cluster center's bases and adds one-hot votes onto a (reads,
positions, 4) tally, then a majority argmax rewrites the read) run on the
device; the clustering and the Bayesian subclustering are host numpy.  Each
device program has a plain numpy version in its module (`*_plain`).
"""
from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from .. import resolve_device
from ..core import kmers as K
from ..core.reads import ReadBatch, batch_iter
from ..graph.coverage_model import fit_coverage_model
from ..ops.count import count_sequences, searchsorted_rows
from ..utils import timetracer
from .clustering import cluster_kmers

log = logging.getLogger("spades_tpu_torch.hammer")


@dataclass
class HammerConfig:
    k: int = 21
    tau: int = 1
    n_iters: int = 1
    batch_size: int = 8192
    # minimum multiplicity for a center to be trusted when the coverage model
    # can't produce a bound (tiny inputs); the model bound wins when available
    min_solid_count: int = 3
    # a position is rewritten only when the winning base holds a clear
    # majority of the votes (read_corrector.cpp consensus discipline)
    majority: float = 0.5
    # quality-aware path (hammer/bayes.py) switches
    use_quality: bool = True
    subcluster_max_members: int = 64
    expander_rounds: int = 8


@dataclass
class HammerStats:
    reads_total: int = 0
    reads_changed: int = 0
    bases_changed: int = 0
    solid_kmers: int = 0
    unique_kmers: int = 0
    clusters: int = 0


def _cluster_centers(counts_words: np.ndarray, counts: np.ndarray, labels: np.ndarray):
    """Per-cluster center (max-count member) and total count."""
    n_clusters = int(labels.max()) + 1 if labels.size else 0
    # argmax count per cluster via sort by (label, -count)
    order = np.lexsort((-counts, labels))
    lab_sorted = labels[order]
    first = np.concatenate([[True], lab_sorted[1:] != lab_sorted[:-1]])
    center_of_cluster = np.empty(n_clusters, np.int64)
    center_of_cluster[lab_sorted[first]] = order[first]
    totals = np.zeros(n_clusters, np.int64)
    np.add.at(totals, labels, counts)
    return center_of_cluster, totals


def build_window_maps(
    seqs: list[str], words: np.ndarray, k: int, batch_size: int, device=None,
) -> list:
    """Per-batch window->unique-row maps, computed ONCE per hammer pass and
    shared by quality accumulation, solid-set expansion and the correction
    loop.

    Returns a list of (batch, n, idx, present, use_rc), the last three as
    (R, P) tensors on the device: idx int32 rows into `words` (-1 where
    absent), present = in the table AND within the read, use_rc marks windows
    whose canonical form is the reverse complement.  Batches shorter than k
    get (batch, n, None, None, None).

    Each batch goes to the device in the packed wire format with its N plane
    zeroed — hammer reads N as A and keeps N windows — through the
    canonical-windows kernel with its strand plane, then `words` is searched
    on the device.  use_rc is the kernel's strand plane, masked by the
    window's validity: it equals the JAX package's wherever `present` holds,
    which is everywhere it is read; idx differs from the JAX package's only
    past a read's end (-1 there)."""
    from ..ops.cuda_kernels import canonical_window_keys
    from ..parallel.sharded_mapping import device_searchsorted_rows

    dev = resolve_device(device)
    table = torch.from_numpy(np.ascontiguousarray(K.words_to_keys(words).T)).to(dev)
    maps = []
    for batch in batch_iter(seqs, batch_size=batch_size):
        R, L = batch.codes.shape
        n = batch.n_seqs  # batches may flush short (footprint/length bucket)
        if L < k:
            maps.append((batch, n, None, None, None))
            continue
        pc, pn, lengths, L = batch.packed()
        pc, lengths = (torch.from_numpy(a).to(dev) for a in (pc, lengths))
        pn = torch.zeros(pn.shape, dtype=torch.uint8, device=dev)
        keys, valid, use_rc = canonical_window_keys(pc, pn, lengths, L, k, strand=True)
        idx = device_searchsorted_rows(table, keys).reshape(valid.shape)
        maps.append((batch, n, idx, (idx >= 0) & valid, use_rc))
    return maps


def build_window_maps_plain(seqs: list[str], words: np.ndarray, k: int,
                            batch_size: int) -> list:
    """Plain numpy version of `build_window_maps`, numpy arrays out: every
    window packed in both orientations, the lesser taken, the table searched
    on the host (`searchsorted_rows`)."""
    from ..ops.extension import canonicalize

    maps = []
    for batch in batch_iter(seqs, batch_size=batch_size):
        R, L = batch.codes.shape
        n = batch.n_seqs
        if L < k:
            maps.append((batch, n, None, None, None))
            continue
        win = np.lib.stride_tricks.sliding_window_view(batch.codes, k, axis=1)
        P = win.shape[1]
        canon, use_rc = canonicalize(K.pack(win.reshape(-1, k)), k)
        valid = np.arange(P)[None, :] + k <= batch.lengths[:, None]
        idx = searchsorted_rows(words, canon).reshape(R, P).astype(np.int32)
        maps.append((batch, n, idx, (idx >= 0) & valid, use_rc.reshape(R, P)))
    return maps


def _vote_correct_batch(
    codes: torch.Tensor,
    center_codes: torch.Tensor,
    cidx: torch.Tensor,
    use_rc: torch.Tensor,
    good: torch.Tensor,
    k: int,
    majority: float,
):
    """Device vote: center bases vote on read positions.

    codes (R, L) uint8; center_codes (U, k) uint8, the canonical bases of
    every counted k-mer; cidx (R, P) rows of each window's center, use_rc
    (R, P) its orientation, good (R, P) whether it votes.  Returns
    (corrected codes (R, L) uint8, voted (R, L) bool).  Integer work: the
    argmax takes the first of equal maxima, as `jnp.argmax`."""
    R, L = codes.shape
    P = cidx.shape[1]
    oriented = center_codes[cidx]                           # (R, P, k)
    oriented = torch.where(use_rc[..., None], 3 - oriented.flip(-1), oriented)
    votes = torch.zeros((R, L, 4), dtype=torch.int32, device=codes.device)
    g = good.to(torch.int32)[..., None]
    for j in range(k):
        votes[:, j : j + P].scatter_add_(2, oriented[:, :, j : j + 1].to(torch.int64), g)
    total = votes.sum(-1)
    # first maximum: the larger vote, then the lower base
    score = (votes * 4 + (3 - torch.arange(4, dtype=torch.int32, device=codes.device))).amax(-1)
    best = (3 - score % 4).to(torch.uint8)
    bestv = score // 4
    win = (total > 0) & (bestv > majority * total)
    return torch.where(win, best, codes), win


def _vote_correct_batch_plain(codes: np.ndarray, oriented: np.ndarray, good: np.ndarray,
                              k: int, majority: float):
    """Plain numpy version of `_vote_correct_batch`, from the oriented
    center bases (R, P, k) uint8."""
    R, L = codes.shape
    P = oriented.shape[1]
    votes = np.zeros((R, L, 4), np.int32)
    g = good.astype(np.int32)
    rr, pp = np.meshgrid(np.arange(R), np.arange(P), indexing="ij")
    for j in range(k):
        np.add.at(votes, (rr, pp + j, oriented[:, :, j]), g)
    total = votes.sum(-1)
    best = np.argmax(votes, axis=-1).astype(np.uint8)
    bestv = votes.max(-1)
    win = (total > 0) & (bestv > np.float32(majority) * total.astype(np.float32))
    return np.where(win, best, codes), win


def _correct_pass(
    seqs: list[str],
    cfg: HammerConfig,
    stats: HammerStats,
    quals: list[str] | None,
    dev: torch.device,
    record: dict | None,
) -> list[str]:
    from . import bayes

    # a step's time ends with its device work only where someone reads it:
    # a caller's `record`, or the span recorder
    timed = dev.type == "cuda" and (record is not None or timetracer.enabled())

    def step(name: str):
        return timetracer.span(f"hammer.{name}", into=record, key=f"{name}_s")

    def sync() -> None:
        if timed:
            torch.cuda.synchronize(dev)

    # Unlike the assembly counting path, hammer counts N windows too (N read
    # as A): an erroneous k-mer must itself be in the table so the clustering
    # can map it to its solid center (hamcluster semantics — bad k-mers join
    # the cluster of the true k-mer they derive from).
    with step("count") as sp:
        clean = [s.upper().replace("N", "A") for s in seqs]
        kc = count_sequences(clean, cfg.k, device=dev)
        sync()
        sp.set(reads=len(seqs), unique_kmers=int(kc.num_unique))
    if kc.num_unique == 0:
        return seqs
    # window->row maps computed once, shared by every consumer below
    # (N positions are coded 0 == A in ReadBatch, so maps over `seqs`
    # equal maps over `clean`)
    with step("maps"):
        maps = build_window_maps(seqs, kc.words, cfg.k, cfg.batch_size, device=dev)
        sync()
    with step("cluster") as sp:
        labels = cluster_kmers(kc.words, cfg.k, cfg.tau)
        sp.set(clusters=int(labels.max()) + 1 if labels.size else 0)
    with step("coverage"):
        info = fit_coverage_model(kc.counts, device=dev)
        solid_bound = max(cfg.min_solid_count, info.ec_bound)

    use_quality = cfg.use_quality and quals is not None and any(quals)
    if use_quality:
        with step("quality"):
            kq = bayes.accumulate_quality(kc, clean, quals, cfg.k, cfg.batch_size, maps=maps,
                                          timings=record)
            sync()
        with step("subcluster") as sp:
            labels = bayes.subcluster_all(
                kc.words, kc.counts, labels, kq, cfg.k, cfg.subcluster_max_members
            )
            centers, totals = _cluster_centers(kc.words, kc.counts, labels)
            solid_center = bayes.solid_posterior(
                kc.counts[centers], kq.total_err_prob()[centers], solid_bound
            )
            sp.set(clusters=len(centers))
        if record is not None:
            record["pos_log_err"] = kq.pos_log_err
        # iterative solid-set expansion runs over the full k-mer solid mask
        with step("expand"):
            solid_kmer = solid_center[labels] & (centers[labels] == np.arange(kc.num_unique))
            solid_kmer, rounds = bayes.expand_solid(
                kc, solid_kmer, clean, cfg.k, cfg.expander_rounds, cfg.batch_size,
                maps=maps,
            )
            sync()
        # an expanded-solid k-mer acts as its own center from here on
        newly = solid_kmer & (centers[labels] != np.arange(kc.num_unique))
        if newly.any():
            log.info("hammer: expander certified %d extra k-mers in %d rounds",
                     int(newly.sum()), rounds)
    else:
        centers, totals = _cluster_centers(kc.words, kc.counts, labels)
        solid_center = kc.counts[centers] >= solid_bound
        newly = np.zeros(kc.num_unique, bool)
    if record is not None:
        record["labels"] = labels
    stats.unique_kmers = kc.num_unique
    stats.clusters = len(centers)
    stats.solid_kmers = int(solid_center.sum())
    log.info(
        "hammer: %d unique %d-mers, %d clusters, %d solid centers (bound %.1f)",
        kc.num_unique, cfg.k, len(centers), stats.solid_kmers, solid_bound,
    )

    with step("vote") as sp:
        # per unique k-mer: its center row and whether it votes;
        # expander-certified k-mers vote for themselves
        center_idx = torch.from_numpy(
            np.where(newly, np.arange(kc.num_unique), centers[labels])).to(dev)
        kmer_good = torch.from_numpy(solid_center[labels] | newly).to(dev)
        center_codes = torch.from_numpy(K.unpack(kc.words, cfg.k)).to(dev)  # canonical
        events = [] if record is not None and dev.type == "cuda" else None
        out: list[str] = []
        for batch, n, idx, present, use_rc in maps:
            R, L = batch.codes.shape
            if idx is None:
                out.extend(batch.sequences()[:n])
                continue
            if events is not None:
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
            safe = torch.where(idx >= 0, idx, 0).to(torch.int64)
            corrected, win = _vote_correct_batch(
                torch.from_numpy(batch.codes).to(dev), center_codes, center_idx[safe], use_rc,
                present & kmer_good[safe], cfg.k, cfg.majority)
            if events is not None:
                ev[1].record()
                events.append(ev)
            corrected, win = corrected.cpu().numpy(), win.cpu().numpy()
            inlen = np.arange(L)[None, :] < batch.lengths[:, None]
            changed = (corrected != batch.codes) & win & inlen
            stats.bases_changed += int(changed.sum())
            stats.reads_changed += int(changed.any(axis=1)[:n].sum())
            # N positions that received votes become called bases
            new_nmask = batch.n_mask & ~win
            fixed = ReadBatch(codes=corrected, lengths=batch.lengths, n_mask=new_nmask)
            out.extend(fixed.sequences()[:n])
        sync()
        sp.set(bases_changed=stats.bases_changed)
    if events:
        record.setdefault("vote_ms", []).extend(a.elapsed_time(b) for a, b in events)
    return out


def correct_reads(
    seqs: list[str],
    cfg: HammerConfig | None = None,
    quals: list[str] | None = None,
    device=None,
    record: dict | None = None,
) -> tuple[list[str], HammerStats]:
    """Correct sequencing errors in reads; returns (corrected reads, stats).

    Order and count of reads are preserved (SPAdes also keeps pairing
    intact; full-read discarding is left to the caller).  `quals` (parallel
    PHRED strings, or None) turns on the quality-aware Bayesian path.

    device: where the device work runs (None: the CUDA card; there is no
    silent CPU fallback, see `resolve_device`).  record: optional dict that
    receives, summed over passes, the wall seconds of each step (its
    `hammer.<step>` span of `utils/timetracer.py`; a step with device work
    ends with a device synchronise): `count_s`, `maps_s`, `cluster_s`,
    `coverage_s`, `quality_s`, `subcluster_s`, `expand_s`, `vote_s`; the
    CUDA-event milliseconds of every batch of the quality sum and the vote
    on the card (`quality_ms`, `vote_ms`); and the last pass's cluster
    labels (`labels`) and quality sums (`pos_log_err`).  Without `record`
    no CUDA event is made, and a step synchronises only while the span
    recorder is on."""
    cfg = cfg or HammerConfig()
    dev = resolve_device(device)
    stats = HammerStats(reads_total=len(seqs))
    for it in range(cfg.n_iters):
        before = stats.bases_changed
        seqs = _correct_pass(seqs, cfg, stats, quals, dev, record)
        log.info(
            "hammer iteration %d: %d bases changed", it, stats.bases_changed - before
        )
        if stats.bases_changed == before:
            break
    return seqs, stats
