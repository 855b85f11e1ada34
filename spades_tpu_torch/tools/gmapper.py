"""spades-gmapper equivalent: map sequences onto an assembly graph.

Reference: SPAdes `src/projects/spades_tools/gmapper.cpp:144`.
Outputs one TSV row per mapped sequence: name, oriented edge id, start offset
within the edge, number of supporting k-mer anchors.  The edge index is
built on the host (as in the JAX package); the reads map on `--device` (the
CUDA card unless `--device cpu` is given) from `SPADES_DEVICE_MAP_READS`
reads on, below that on the host.

    python -m spades_tpu_torch.tools.gmapper graph.gfa reads.fq -k 55 -w out [--device cpu]
"""
from __future__ import annotations

import os
import sys

from .common import check_odd_k, make_parser, setup


def main(argv=None) -> int:
    p = make_parser("spades_tpu_torch-gmapper", __doc__.split("\n")[0])
    p.add_argument("gfa", help="assembly graph (GFA 1.x)")
    p.add_argument("sequences", help="reads to map (FASTA/FASTQ, optionally .gz)")
    args = p.parse_args(argv)
    setup(args)
    check_odd_k(args.kmer)

    from .. import resolve_device
    from ..alignment.mapper import build_edge_index, map_read_batch
    from ..graph.from_gfa import graph_from_gfa
    from ..io.fastx import read_fastx
    from ..io.gfa import read_gfa

    dev = resolve_device(args.device)
    g = graph_from_gfa(read_gfa(args.gfa), args.kmer)
    index = build_edge_index(g)
    records = list(read_fastx(args.sequences))
    mappings = map_read_batch(index, g, [r.seq for r in records], device=dev)
    os.makedirs(args.workdir, exist_ok=True)
    out_path = os.path.join(args.workdir, "mapping.tsv")
    n = 0
    with open(out_path, "w") as out:
        for rec, m in zip(records, mappings):
            if m is None:
                continue
            n += 1
            out.write(f"{rec.name}\t{m.edge}\t{m.start_offset}\t{m.n_hits}\n")
    print(f"mapped {n}/{len(records)} sequences -> {out_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
