"""spades-gsimplifier equivalent: standalone simplification of a GFA graph.

Reference: SPAdes `src/projects/spades_tools/gsimplifier.cpp:139`.  Host code
(`graph/from_gfa.py`, `coverage_model.py`, `simplify.py`).

    python -m spades_tpu_torch.tools.gsimplifier graph.gfa -k 55 -w out
"""
from __future__ import annotations

import os
import sys

from .common import check_odd_k, make_parser, setup


def main(argv=None) -> int:
    p = make_parser("spades_tpu_torch-gsimplifier", __doc__.split("\n")[0])
    p.add_argument("gfa", help="input assembly graph (GFA 1.x with DP/KC coverage)")
    p.add_argument("--read-length", type=int, default=100)
    p.add_argument("--ec-bound", type=float, default=None, help="coverage bound for EC removal (default: fit from edge coverages)")
    args = p.parse_args(argv)
    setup(args)
    check_odd_k(args.kmer)

    import numpy as np

    from ..graph.coverage_model import GenomicInfo, fit_coverage_model
    from ..graph.from_gfa import graph_from_gfa
    from ..graph.simplify import SimplifyConfig, simplify
    from ..io.contigs import extract_contigs, write_contigs
    from ..io.gfa import read_gfa, write_gfa

    gg = read_gfa(args.gfa)
    g = graph_from_gfa(gg, args.kmer)
    print(f"loaded {len(g.canonical_edge_ids())} segments from {args.gfa}")
    if args.ec_bound is not None:
        info = GenomicInfo(
            ec_bound=args.ec_bound, trusted_bound=args.ec_bound,
            estimated_mean=0.0, genome_size=0,
        )
    else:
        cov = np.round(g.coverage()[g.alive_edge_ids()]).astype(np.int64)
        info = fit_coverage_model(np.maximum(cov, 1))
    g, stats = simplify(g, info, SimplifyConfig(read_length=args.read_length))
    os.makedirs(args.workdir, exist_ok=True)
    out = os.path.join(args.workdir, "simplified.gfa")
    write_gfa(out, g)
    write_contigs(os.path.join(args.workdir, "simplified.fasta"), extract_contigs(g))
    print(
        f"simplified -> {len(g.canonical_edge_ids())} segments "
        f"(tips={stats.tips} bulges={stats.bulges} ec={stats.ec}) -> {out}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
