"""BinSPreader equivalent: refine metagenomic bins over the assembly graph.

Reference: SPAdes `src/projects/binspreader/binning_refiner.cpp:163`
(CLI surface per `docs/binspreader.md`): input = assembly GFA + binning TSV
(<contig>\t<bin>), output = refined `binning.tsv` (+ `--multi` for multiple
assignments per contig).  With `-1/-2` both mate files map on `--device`
(the CUDA card unless `--device cpu` is given) through the device index of
the graph (`MappingEngine.map_sequences`); the JAX package builds a host
index of the whole graph and maps with `map_read_batch`, with the same
mappings.  The label propagation is host numpy (`graph/binning.py`).

    python -m spades_tpu_torch.tools.binspreader g.gfa bins.tsv [-1 r1.fq -2 r2.fq]
        [--bin-dist] [--multi] -k 55 -w out [--device cpu]
"""
from __future__ import annotations

import os
import sys

from .common import check_odd_k, make_parser, setup


def main(argv=None) -> int:
    p = make_parser("spades_tpu_torch-binspreader", __doc__.split("\n")[0])
    p.add_argument("gfa", help="assembly graph (GFA 1.x)")
    p.add_argument("binning", help="initial binning TSV: contig<TAB>bin")
    p.add_argument("--multi", action="store_true", help="allow multiple bins per contig")
    p.add_argument("-e", "--eps", type=float, default=1e-5, help="convergence threshold")
    p.add_argument("-n", "--iters", type=int, default=100, help="max propagation sweeps")
    p.add_argument("-1", dest="left", default=None,
                   help="left paired/Hi-C reads: adds a weighted edge-edge link index")
    p.add_argument("-2", dest="right", default=None, help="right paired/Hi-C reads")
    p.add_argument("--bin-dist", action="store_true",
                   help="alpha-propagation correction: damp label retention "
                        "away from binned regions (alpha_propagation.cpp)")
    p.add_argument("--assignment", choices=("majority_length", "max_likelihood"),
                   default="majority_length",
                   help="per-edge bin assignment strategy")
    p.add_argument("--reads-split", action="store_true",
                   help="write per-bin read id lists (read_splitting.cpp)")
    args = p.parse_args(argv)
    setup(args)
    check_odd_k(args.kmer)

    from .. import resolve_device
    from ..graph.binning import (
        BinningConfig,
        alpha_mask,
        assign_bins,
        build_link_index,
        propagate_labels_linked,
        split_reads,
    )
    from ..graph.from_gfa import graph_from_gfa
    from ..io.gfa import read_gfa

    # the mates map on the device: without a card this raises before any read
    dev = resolve_device(args.device) if args.left and args.right else None
    gg = read_gfa(args.gfa)
    g = graph_from_gfa(gg, args.kmer)
    # segment name -> canonical edge id (graph_from_gfa orders segments by
    # sorted name: edge 2i is '+' of the i-th name, 2i+1 its conjugate)
    seg_names = {}
    for i, name in enumerate(sorted(gg.segments)):
        e = 2 * i
        seg_names[name] = min(e, int(g.e_conj[e]))

    binning = {}
    with open(args.binning) as fh:
        for line in fh:
            parts = line.strip().split("\t")
            if len(parts) >= 2:
                binning[parts[0]] = parts[1]

    cfg = BinningConfig(eps=args.eps, max_iters=args.iters)
    bin_names = sorted(set(binning.values()))
    bin_idx = {b: i for i, b in enumerate(bin_names)}
    initial = {
        seg_names[n]: bin_idx[b] for n, b in binning.items() if n in seg_names
    }

    links = None
    m1 = m2 = None
    if args.left and args.right:
        from ..alignment.mapper import MappingEngine
        from ..io.fastx import read_sequences

        engine = MappingEngine(g, device=dev)
        r1 = list(read_sequences([args.left]))
        r2 = list(read_sequences([args.right]))
        m1 = engine.map_sequences(r1)[0]
        m2 = engine.map_sequences(r2)[0]
        links = build_link_index(g, m1, m2)
        print(f"link index: {links.num_links} edge links from {len(r1)} pairs")

    alpha = None
    if args.bin_dist and initial:
        alpha = alpha_mask(g, set(initial), links=links, cfg=cfg)

    state = propagate_labels_linked(
        g, initial, len(bin_names), links=links, alpha=alpha, cfg=cfg
    )
    edge_bins = assign_bins(
        state, args.assignment, thr=cfg.multi_bin_threshold
    )
    os.makedirs(args.workdir, exist_ok=True)
    out = os.path.join(args.workdir, "binning.tsv")
    import numpy as np

    with open(out, "w") as fh:
        for name in sorted(seg_names):
            e = seg_names[name]
            bins = edge_bins[e]
            if not bins:
                continue
            if not args.multi and len(bins) > 1:
                bins = {int(np.argmax(state[e]))}
            for b in sorted(bins):
                fh.write(f"{name}\t{bin_names[b]}\n")
    if args.reads_split and m1 is not None:
        buckets = split_reads(g, m1, edge_bins)
        for b, rows in sorted(buckets.items()):
            with open(os.path.join(args.workdir, f"reads_bin_{bin_names[b]}.ids"), "w") as fh:
                fh.write("\n".join(map(str, rows)) + "\n")
        print(f"split reads into {len(buckets)} bins")
    print(f"refined {len(seg_names)} contigs over {len(bin_names)} bins -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
