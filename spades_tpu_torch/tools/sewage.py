"""Wastewater lineage disentangling CLI (sewage mode's core analysis).

Reference: SPAdes `src/projects/spades/wastewater_disentangle.cpp`
(coronaSPAdes `--sewage` flag): reads + reference genome + usher barcode CSV
-> `lineages.csv` with per-lineage abundance estimates.  The mapping, the
allele votes and the abundance solve run on `--device` (the CUDA card
unless `--device cpu` is given).

    python -m spades_tpu_torch.tools.sewage ref.fa barcodes.csv reads.fq -w out [--device cpu]
"""
from __future__ import annotations

import os
import sys

from .common import check_inputs_exist, make_parser, setup


def main(argv=None) -> int:
    p = make_parser("spades_tpu_torch-sewage", __doc__.split("\n")[0])
    p.add_argument("reference", help="reference genome (FASTA)")
    p.add_argument("barcodes", help="usher barcode CSV (lineage x mutation)")
    p.add_argument("reads", nargs="+", help="read files (FASTA/FASTQ, optionally .gz)")
    p.add_argument("--min-coverage", type=int, default=3)
    args = p.parse_args(argv)
    setup(args)
    check_inputs_exist([args.reference, args.barcodes] + args.reads)

    from .. import resolve_device
    from ..io.fastx import read_fastx, read_sequences
    from ..sewage import estimate_abundances, read_barcodes_csv

    dev = resolve_device(args.device)
    ref = next(iter(read_fastx(args.reference))).seq
    bc = read_barcodes_csv(args.barcodes)
    reads = list(read_sequences(args.reads))
    print(f"{len(bc.lineages)} lineages, {len(bc.positions)} barcode SNPs, {len(reads)} reads")
    result = estimate_abundances(ref, reads, bc, args.min_coverage, device=dev)
    os.makedirs(args.workdir, exist_ok=True)
    out = os.path.join(args.workdir, "lineages.csv")
    with open(out, "w") as fh:
        fh.write("lineage,abundance\n")
        for name, ab in result:
            fh.write(f"{name},{ab:.4f}\n")
    for name, ab in result[:10]:
        print(f"  {name}: {ab:.3f}")
    print(f"-> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
