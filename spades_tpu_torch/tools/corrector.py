"""spades-corrector-core equivalent: post-assembly mismatch polishing.

Reference: SPAdes `src/projects/corrector/dataset_processor.hpp:34-68`
+ `contig_processor.cpp` (+ glue `correction_iteration_script.py`): align the
reads back to the assembled contigs, count per-position variants, apply
majority fixes.  Here `polish/corrector.py` maps the reads onto a k-mer
index of the contigs and votes, the same map/vote/fix contract without the
BWA+SAM detour; `--sam` takes the reference's path from alignments.  Host
code, as in the JAX package.

    python -m spades_tpu_torch.tools.corrector contigs.fasta r1.fq r2.fq -k 21 -w out
    python -m spades_tpu_torch.tools.corrector contigs.fasta --sam aln.sam -w out
"""
from __future__ import annotations

import os
import sys

from .common import check_inputs_exist, check_odd_k, make_parser, setup


def main(argv=None) -> int:
    p = make_parser("spades_tpu_torch-corrector", __doc__.split("\n")[0])
    p.add_argument("contigs", help="assembled contigs (FASTA)")
    p.add_argument("reads", nargs="*", default=[], help="read files (FASTA/FASTQ, optionally .gz)")
    p.add_argument("--sam", default=None,
                   help="use alignments from a SAM file (the reference's BWA-MEM "
                        "flow, corrector/dataset_processor.cpp) instead of mapping internally")
    args = p.parse_args(argv)
    setup(args)
    check_odd_k(args.kmer)
    check_inputs_exist([args.contigs] + args.reads)

    from ..io.fastx import read_fastx, read_sequences, write_fasta

    recs = list(read_fastx(args.contigs))
    os.makedirs(args.workdir, exist_ok=True)
    out = os.path.join(args.workdir, "corrected_contigs.fasta")

    if args.sam:
        fixed, corrected = _correct_from_sam(recs, args.sam)
        write_fasta(out, corrected)
        print(f"fixed {fixed} positions in {len(recs)} contigs -> {out}")
        return 0

    if not args.reads:
        sys.exit("error: provide read files or --sam alignments")
    from ..polish import CorrectorConfig, polish_contigs

    reads = list(read_sequences(args.reads))
    corrected, stats = polish_contigs(
        [r.seq for r in recs], reads, CorrectorConfig(k=args.kmer)
    )
    write_fasta(out, [(rec.name, seq) for rec, seq in zip(recs, corrected)])
    fixed = stats["fixed_simple"] + stats["fixed_interesting"]
    print(
        f"fixed {fixed} positions ({stats['fixed_interesting']} via "
        f"interesting-position sweeps) in {len(recs)} contigs -> {out}"
    )
    return 0


def _correct_from_sam(recs, sam_path):
    """Per-position majority voting from SAM alignments — the reference's
    ContigProcessor/InterestingPositionProcessor contract
    (`corrector/contig_processor.cpp`, `interesting_pos_processor.cpp`):
    SAM SEQ is already reference-strand, so votes are a direct CIGAR walk."""
    import numpy as np

    from ..io.sam import read_alignments

    name_to_idx = {rec.name.split()[0]: i for i, rec in enumerate(recs)}
    base_idx = {"A": 0, "C": 1, "G": 2, "T": 3}
    votes = [np.zeros((len(r.seq), 4), np.int64) for r in recs]
    for a in read_alignments(sam_path):
        if a.is_unmapped or a.rname not in name_to_idx:
            continue
        v = votes[name_to_idx[a.rname]]
        for rp, gp in a.aligned_pairs():
            if 0 <= gp < v.shape[0] and rp < len(a.seq):
                b = base_idx.get(a.seq[rp])
                if b is not None:
                    v[gp, b] += 1
    lut = "ACGT"
    fixed = 0
    corrected = []
    for i, rec in enumerate(recs):
        seq = list(rec.seq)
        v = votes[i]
        tot = v.sum(axis=1)
        best = v.argmax(axis=1)
        for pos in np.flatnonzero(tot >= 2):
            cur = base_idx.get(seq[pos])
            # majority fix: >half the votes and disagreeing with the contig
            if cur is not None and best[pos] != cur and v[pos, best[pos]] * 2 > tot[pos]:
                seq[pos] = lut[best[pos]]
                fixed += 1
        corrected.append((rec.name, "".join(seq)))
    return fixed, corrected


if __name__ == "__main__":
    sys.exit(main())
