"""spades-read-filter equivalent: drop reads/pairs with median k-mer coverage
below a threshold.

Reference: SPAdes `src/projects/spades_tools/read_filter.cpp:128`
(CQF-backed median coverage filter).  Exact counts from the counting engine
replace the approximate CQF, as in the JAX package; the per-read medians are
one device pass per batch of reads (canonical-window kernel, a search into
the count table, a per-row sort).

    python -m spades_tpu_torch.tools.read_filter -1 r1.fq -2 r2.fq -k 21 -c 2 -o out [--device cpu]
"""
from __future__ import annotations

import os
import re
import sys

import numpy as np
import torch

from .common import check_odd_k, make_parser, setup

# a read holding a letter other than ACGT, acgt and N: the reference's loop
# packs that letter as code 4, which the kernel's N mask cannot express
_SPILL_LETTER = re.compile("[^ACGTacgtN]")
# padded bases in one batch of `read_median_coverage`
_BATCH_NT = 1 << 24


def _kernel_window_keys(seqs: list[str], k: int, dev: torch.device):
    """Canonical keys (planes, R*P) and validity (R, P) of every window of
    reads of ACGT, acgt and N, from the canonical-windows kernel (its plain
    version on the CPU); R is padded past len(seqs)."""
    from ..core.reads import ReadBatch
    from ..ops.cuda_kernels import canonical_window_keys

    pc, pn, lengths, L = ReadBatch.from_sequences(seqs).packed()
    pc, pn, lengths = (torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                       for a in (pc, pn, lengths))
    return canonical_window_keys(pc, pn, lengths, L, k)


def _spill_window_keys(seqs: list[str], k: int, dev: torch.device):
    """Keys and validity of every window as the reference's loop packs them,
    for reads that hold another letter (`core/kmers.py:loop_window_keys`:
    code 4 spills into the base before it; a window with an "N" is skipped)."""
    from ..core import kmers as K

    keys, valid, _ = K.loop_window_keys(seqs, k, dev)
    return keys, valid


def _medians(keys: torch.Tensor, valid: torch.Tensor, table: torch.Tensor,
             counts: torch.Tensor) -> np.ndarray:
    """Median multiplicity of each row's valid windows: a search into the
    table's key planes, invalid windows sorted past the valid ones, and the
    mean of the two middle values in float64 (`np.median`'s value); 0 for a
    row with no valid window."""
    from ..parallel.sharded_mapping import device_searchsorted_rows

    pos = device_searchsorted_rows(table, keys).to(torch.int64)
    cov = torch.where(pos >= 0, counts[pos.clamp(min=0)], 0)
    cov = torch.where(valid.reshape(-1), cov, torch.iinfo(torch.int64).max)
    cov = torch.sort(cov.reshape(valid.shape), dim=1).values
    m = valid.sum(dim=1)
    lo = cov.gather(1, ((m - 1).clamp(min=0) // 2)[:, None])[:, 0]
    hi = cov.gather(1, (m // 2).clamp(max=cov.shape[1] - 1)[:, None])[:, 0]
    return torch.where(m > 0, (lo + hi).to(torch.float64) / 2, 0.0).cpu().numpy()


def read_median_coverage(seqs: list[str], k: int, kc, device=None) -> np.ndarray:
    """Median multiplicity of each read's canonical k-mers (0 if none), as
    the JAX package's loop gives it: windows with an N are skipped, reads
    shorter than k and reads with no window left get 0, an even count takes
    the mean of its two middle values.  Reads are batched by length, about
    `_BATCH_NT` padded bases a batch, on `device` (the CUDA card unless
    "cpu"): through the canonical-windows kernel, or `_spill_window_keys`
    for a read with a letter other than ACGT, acgt and N."""
    from .. import resolve_device
    from ..core import kmers as K

    dev = resolve_device(device)
    meds = np.zeros(len(seqs))
    lens = np.fromiter((len(s) for s in seqs), np.int64, count=len(seqs))
    todo = np.flatnonzero(lens >= k)
    if todo.size == 0 or kc.num_unique == 0:
        return meds
    table = torch.from_numpy(np.ascontiguousarray(K.words_to_keys(kc.words).T)).to(dev)
    counts = torch.from_numpy(np.ascontiguousarray(kc.counts, np.int64)).to(dev)
    spill = np.fromiter((_SPILL_LETTER.search(seqs[i]) is not None for i in todo), bool,
                        count=todo.size)
    for rows, window_keys in ((todo[~spill], _kernel_window_keys),
                              (todo[spill], _spill_window_keys)):
        rows = rows[np.argsort(lens[rows], kind="stable")]
        lo = 0
        while lo < rows.size:
            # reads sorted by length: a batch of c reads pads to c * (its last length)
            padded = np.arange(1, rows.size - lo + 1) * lens[rows[lo:]]
            hi = lo + max(1, int(np.searchsorted(padded, _BATCH_NT, side="right")))
            part = rows[lo:hi]
            keys, valid = window_keys([seqs[i] for i in part], k, dev)
            meds[part] = _medians(keys, valid, table, counts)[: part.size]
            lo = hi
    return meds


def main(argv=None) -> int:
    p = make_parser("spades_tpu_torch-read-filter", __doc__.split("\n")[0])
    p.add_argument("-1", dest="left", help="left paired reads")
    p.add_argument("-2", dest="right", help="right paired reads")
    p.add_argument("-s", dest="single", action="append", default=[], help="single reads")
    p.add_argument("-c", "--cov", type=float, default=2, help="median coverage threshold")
    p.add_argument("-o", "--outdir", default="filtered", help="output directory")
    args = p.parse_args(argv)
    setup(args)
    check_odd_k(args.kmer)

    from .. import resolve_device
    from ..io.fastx import read_fastx, write_fasta
    from ..ops.count import count_sequences

    dev = resolve_device(args.device)
    os.makedirs(args.outdir, exist_ok=True)
    if args.left and args.right:
        r1 = list(read_fastx(args.left))
        r2 = list(read_fastx(args.right))
        if len(r1) != len(r2):
            sys.exit("error: paired files have different read counts")
        all_seqs = [r.seq for r in r1] + [r.seq for r in r2]
        kc = count_sequences(all_seqs, args.kmer, device=dev)
        med = read_median_coverage(all_seqs, args.kmer, kc, device=dev)
        m1, m2 = med[: len(r1)], med[len(r1) :]
        keep = (np.maximum(m1, m2) > args.cov)
        write_fasta(
            os.path.join(args.outdir, "filtered_1.fasta"),
            [(r.name, r.seq) for r, k_ in zip(r1, keep) if k_],
        )
        write_fasta(
            os.path.join(args.outdir, "filtered_2.fasta"),
            [(r.name, r.seq) for r, k_ in zip(r2, keep) if k_],
        )
        print(f"kept {int(keep.sum())}/{len(keep)} read pairs")
    for path in args.single:
        recs = list(read_fastx(path))
        kc = count_sequences([r.seq for r in recs], args.kmer, device=dev)
        med = read_median_coverage([r.seq for r in recs], args.kmer, kc, device=dev)
        keep = med > args.cov
        base = os.path.basename(path).split(".")[0]
        write_fasta(
            os.path.join(args.outdir, f"filtered_{base}.fasta"),
            [(r.name, r.seq) for r, k_ in zip(recs, keep) if k_],
        )
        print(f"{path}: kept {int(keep.sum())}/{len(keep)} reads")
    return 0


if __name__ == "__main__":
    sys.exit(main())
