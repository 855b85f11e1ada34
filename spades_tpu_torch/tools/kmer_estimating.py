"""spades-kmer-estimating equivalent: HLL cardinality estimate.

Reference: SPAdes `src/projects/spades_tools/kmer_estimating.cpp:62`.  The
HyperLogLog registers are filled on `--device` (`ops/hll.py`).

    python -m spades_tpu_torch.tools.kmer_estimating r1.fq r2.fq -k 55 [--device cpu]
"""
from __future__ import annotations

import sys

from .common import check_inputs_exist, check_odd_k, make_parser, setup


def main(argv=None) -> int:
    p = make_parser("spades_tpu_torch-kmer-estimating", __doc__.split("\n")[0])
    p.add_argument("inputs", nargs="+", help="FASTA/FASTQ(.gz) input files")
    args = p.parse_args(argv)
    setup(args)
    check_odd_k(args.kmer)
    check_inputs_exist(args.inputs)

    from ..core.reads import batch_iter
    from ..io.fastx import read_sequences
    from ..ops.hll import estimate_kmer_cardinality

    est = estimate_kmer_cardinality(
        batch_iter(read_sequences(args.inputs)), args.kmer, device=args.device
    )
    print(f"Estimated number of unique canonical {args.kmer}-mers: {int(est)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
