"""SPAligner equivalent: align long reads to an assembly graph, emit TSV.

Reference: SPAdes `src/projects/spaligner/align_longreads.cpp:264`
(output columns documented in `docs/spaligner.md`): per aligned read one row
with the read name, start/end positions on the read, total read length, the
edge path, and the path length.  Host code (`alignment/long_read.py`).

    python -m spades_tpu_torch.tools.spaligner graph.gfa long_reads.fq -k 55 -w out
"""
from __future__ import annotations

import os
import sys

from .common import check_odd_k, make_parser, setup


def main(argv=None) -> int:
    p = make_parser("spades_tpu_torch-spaligner", __doc__.split("\n")[0])
    p.add_argument("gfa", help="assembly graph (GFA 1.x)")
    p.add_argument("sequences", help="long reads (FASTA/FASTQ, optionally .gz)")
    p.add_argument("-d", "--datatype", default="pacbio",
                   choices=("pacbio", "nanopore", "contigs"), help="input kind")
    args = p.parse_args(argv)
    setup(args)
    check_odd_k(args.kmer)

    from ..alignment.long_read import AlignerConfig, align_long_read
    from ..alignment.mapper import build_edge_index
    from ..graph.from_gfa import graph_from_gfa
    from ..io.fastx import read_fastx
    from ..io.gfa import read_gfa

    g = graph_from_gfa(read_gfa(args.gfa), args.kmer)
    print(f"loaded {len(g.canonical_edge_ids())} segments from {args.gfa}")
    # contigs are high-accuracy: longer anchors cut chaining noise; noisy
    # long reads use the short default anchor k
    cfg = AlignerConfig(k=21) if args.datatype == "contigs" else AlignerConfig()
    index = build_edge_index(g, cfg.k)

    os.makedirs(args.workdir, exist_ok=True)
    out_path = os.path.join(args.workdir, "alignment.tsv")
    n_aligned = 0
    records = list(read_fastx(args.sequences))
    with open(out_path, "w") as out:
        for i, rec in enumerate(records):
            al = align_long_read(index, g, rec.seq, i, cfg)
            if not al.path:
                continue
            n_aligned += 1
            start = al.path[0].read_start
            end = al.path[-1].read_end
            edges = ",".join(str(c.edge) for c in al.path)
            path_len = sum(c.edge_end - c.edge_start for c in al.path)
            out.write(
                f"{rec.name}\t{start}\t{end}\t{len(rec.seq)}\t{edges}\t{path_len}\n"
            )
    print(f"aligned {n_aligned}/{len(records)} sequences -> {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
