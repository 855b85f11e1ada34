"""MTS equivalent: metagenomic time-series profiling, binning, read splitting.

Reference: SPAdes `src/projects/mts/` (mts.py + Snakefile workflow:
per-sample k-mer counting -> combined multiplicity table
(`kmer_multiplicity_counter.cpp`), contig abundance profiles
(`contig_abundance_counter.cpp`), binning (canopy/CONCOCT), annotation
propagation (`propagate.cpp`), and read binning (`read_binning.cpp`)).

One CLI run covers the whole workflow: N sample read sets + contigs (FASTA or
GFA) -> `profiles.tsv` (per-contig abundance), `binning.tsv` (contig -> bin),
and per-bin read FASTA files under `<workdir>/binned_reads/`.  The samples'
k-mers are counted on `--device` (the CUDA card unless `--device cpu`); the
rest is host numpy, as in the JAX package.

    python -m spades_tpu_torch.tools.mts contigs.fasta s1.fq s2.fq -k 55 -w out [--split-reads]
"""
from __future__ import annotations

import os
import sys

from .common import check_inputs_exist, check_odd_k, make_parser, setup


def main(argv=None) -> int:
    p = make_parser("spades_tpu_torch-mts", __doc__.split("\n")[0])
    p.add_argument("contigs", help="contigs FASTA or assembly graph GFA")
    p.add_argument("samples", nargs="+", help="per-sample reads (FASTA/FASTQ, may be .gz)")
    p.add_argument("--min-mult", type=int, default=5, help="min multiplicity per sample")
    p.add_argument("--min-samples", type=int, default=1,
                   help="min samples a k-mer must reach --min-mult in")
    p.add_argument("--min-length", type=int, default=2000,
                   help="min contig length to profile/bin")
    p.add_argument("--merge-threshold", type=float, default=0.9,
                   help="canopy correlation threshold")
    p.add_argument("--estimator", choices=("median", "winsorized"), default="median")
    p.add_argument("--split-reads", action="store_true",
                   help="write per-bin read FASTAs (read_binning.cpp equivalent)")
    args = p.parse_args(argv)
    setup(args)
    check_odd_k(args.kmer)
    check_inputs_exist([args.contigs] + args.samples)

    import numpy as np

    from .. import resolve_device
    from ..io.fastx import read_fastx
    from ..mts.abundance import contig_profiles
    from ..mts.binning import canopy_bins
    from ..mts.multiplicity import profiles_from_read_sets

    dev = resolve_device(args.device)
    read_sets = []
    for f in args.samples:
        read_sets.append([r.seq for r in read_fastx(f)])
    profiles = profiles_from_read_sets(
        read_sets, args.kmer, args.min_samples, args.min_mult, device=dev
    )
    print(f"{profiles.num_kmers} filtered {args.kmer}-mers across "
          f"{profiles.num_samples} samples")

    if args.contigs.endswith(".gfa"):
        from ..graph.from_gfa import graph_from_gfa
        from ..io.gfa import read_gfa

        g = graph_from_gfa(read_gfa(args.contigs), args.kmer)
        names, seqs = [], []
        for e in g.canonical_edge_ids():
            names.append(str(int(e)))
            seqs.append(g.edge_seq(int(e)))
    else:
        recs = list(read_fastx(args.contigs))
        names = [r.name.split()[0] for r in recs]
        seqs = [r.seq for r in recs]
    keep = [i for i, s in enumerate(seqs) if len(s) >= args.min_length]
    if not keep:
        # nothing passes the length bound; profile everything instead
        keep = list(range(len(seqs)))
    names = [names[i] for i in keep]
    seqs = [seqs[i] for i in keep]

    ab, disp, ok = contig_profiles(profiles, seqs, estimator=args.estimator)
    os.makedirs(args.workdir, exist_ok=True)
    with open(os.path.join(args.workdir, "profiles.tsv"), "w") as out:
        for i, name in enumerate(names):
            cols = "\t".join(f"{a:.2f}" for a in ab[i])
            out.write(f"{name}\t{cols}\n")

    labels = np.full(len(names), -1, np.int64)
    if ok.any():
        labels[ok] = canopy_bins(ab[ok], merge_threshold=args.merge_threshold)
    with open(os.path.join(args.workdir, "binning.tsv"), "w") as out:
        for name, lab in zip(names, labels):
            out.write(f"{name}\tBIN{lab}\n" if lab >= 0 else f"{name}\tUNBINNED\n")
    n_bins = int(labels.max()) + 1 if (labels >= 0).any() else 0
    print(f"{n_bins} bins over {len(names)} contigs -> {args.workdir}")

    if args.split_reads and n_bins > 0:
        _split_reads(args, names, seqs, labels, n_bins)
    return 0


def _split_reads(args, names, seqs, labels, n_bins) -> None:
    """Assign each read to the bin its k-mers vote for (read_binning.cpp)."""
    import numpy as np

    from ..core import dna
    from ..core import kmers as K
    from ..io.fastx import read_fastx
    from ..ops.count import _lexsort_rows, searchsorted_rows
    from ..ops.extension import canonicalize

    k = args.kmer
    words_list, bin_list = [], []
    for seq, lab in zip(seqs, labels):
        if lab < 0 or len(seq) < k:
            continue
        codes = dna.encode(seq)
        wins = np.lib.stride_tricks.sliding_window_view(codes, k)
        packed = K.pack(np.ascontiguousarray(np.where(wins >= 4, 0, wins)))
        canon, _ = canonicalize(packed, k)
        words_list.append(canon)
        bin_list.append(np.full(len(canon), lab, np.int64))
    words = np.concatenate(words_list)
    bins = np.concatenate(bin_list)
    order = _lexsort_rows(words)
    words, bins = words[order], bins[order]
    first = np.concatenate([[True], np.any(words[1:] != words[:-1], axis=1)])
    words, bins = words[first], bins[first]

    outdir = os.path.join(args.workdir, "binned_reads")
    os.makedirs(outdir, exist_ok=True)
    handles = {}
    for s, sample in enumerate(args.samples):
        for rec in read_fastx(sample):
            codes = dna.encode(rec.seq)
            if len(codes) < k:
                continue
            wins = np.lib.stride_tricks.sliding_window_view(codes, k)
            valid = np.lib.stride_tricks.sliding_window_view(codes < 4, k).all(axis=1)
            packed = K.pack(np.ascontiguousarray(np.where(wins >= 4, 0, wins)))
            canon, _ = canonicalize(packed, k)
            idx = searchsorted_rows(words, canon[valid])
            idx = idx[idx >= 0]
            if len(idx) == 0:
                continue
            votes = np.bincount(bins[idx])
            b = int(votes.argmax())
            key = (s, b)
            if key not in handles:
                handles[key] = open(
                    os.path.join(outdir, f"sample{s+1}_BIN{b}.fasta"), "w"
                )
            handles[key].write(f">{rec.name}\n{rec.seq}\n")
    for h in handles.values():
        h.close()
    print(f"binned reads -> {outdir} ({len(handles)} files)")


if __name__ == "__main__":
    sys.exit(main())
