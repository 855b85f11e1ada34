"""spades-kmercount equivalent: count k-mers -> binary `final_kmers`.

Reference: SPAdes `src/projects/spades_tools/kmercount.cpp:191-220`,
format per `docs/standalone.md:5-27`.  Counting runs on `--device` (the CUDA
card unless `--device cpu` is given) through `ops/count.py:count_reads`; the
output file contains the sorted unique canonical k-mers (the reference emits
the distinct k-mer set of both strands; the canonical set is the same set up
to strand normalization).

    python -m spades_tpu_torch.tools.kmercount r1.fq r2.fq -k 55 -w out [--counts] [--device cpu]
"""
from __future__ import annotations

import os
import sys

from .common import check_inputs_exist, check_odd_k, make_parser, setup


def main(argv=None) -> int:
    p = make_parser("spades_tpu_torch-kmercount", __doc__.split("\n")[0])
    p.add_argument("inputs", nargs="+", help="FASTA/FASTQ(.gz) input files")
    p.add_argument("-b", "--bufsize", type=int, default=0, help="accepted for CLI parity")
    p.add_argument("--counts", action="store_true", help="also write final_kmers.counts (int64 per record)")
    args = p.parse_args(argv)
    setup(args)
    check_odd_k(args.kmer)
    check_inputs_exist(args.inputs)

    from ..io.binary_kmers import write_kmer_file
    from ..io.fastx import read_batches
    from ..ops.count import count_reads

    # read_batches = native parser -> padded code batches, no Python strings
    kc = count_reads(read_batches(args.inputs), args.kmer, device=args.device)
    os.makedirs(args.workdir, exist_ok=True)
    out = os.path.join(args.workdir, "final_kmers")
    write_kmer_file(out, kc.words, args.kmer)
    if args.counts:
        kc.counts.astype("<i8").tofile(out + ".counts")
    print(f"{kc.num_unique} unique canonical {args.kmer}-mers ({kc.total} total) -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
