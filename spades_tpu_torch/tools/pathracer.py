"""PathRacer equivalent: align profile HMMs to the assembly graph.

Reference: SPAdes `src/projects/pathracer/main.cpp:1127` (docs
`docs/pathracer.md`): input = .hmm profile(s) (HMMER3) + assembly graph GFA,
output = best-scoring graph paths per profile with their sequences.  Host
code (`hmm/`).

    python -m spades_tpu_torch.tools.pathracer profiles.hmm graph.gfa -k 55 -w out
"""
from __future__ import annotations

import os
import sys

from .common import check_odd_k, make_parser, setup


def main(argv=None) -> int:
    p = make_parser("spades_tpu_torch-pathracer", __doc__.split("\n")[0])
    p.add_argument("hmmfile", help="profile HMM(s), HMMER3 format")
    p.add_argument("gfa", help="assembly graph (GFA 1.x)")
    p.add_argument("--threshold", type=float, default=5.0, help="score threshold (nats)")
    p.add_argument("--top", type=int, default=10, help="paths reported per profile")
    args = p.parse_args(argv)
    setup(args)
    check_odd_k(args.kmer)

    from ..graph.from_gfa import graph_from_gfa
    from ..hmm import align_hmm_to_graph, read_hmm
    from ..io.fastx import write_fasta
    from ..io.gfa import read_gfa

    g = graph_from_gfa(read_gfa(args.gfa), args.kmer)
    profiles = read_hmm(args.hmmfile)
    print(f"{len(profiles)} profiles, {len(g.canonical_edge_ids())} graph segments")
    os.makedirs(args.workdir, exist_ok=True)
    tsv = os.path.join(args.workdir, "pathracer.tsv")
    n_hits = 0
    records = []
    with open(tsv, "w") as out:
        out.write("profile\tscore\tframe\tpath\tseq_len\n")
        for hmm in profiles:
            hits = align_hmm_to_graph(
                g, hmm, score_threshold=args.threshold, top=args.top
            )
            for i, h in enumerate(hits):
                n_hits += 1
                path_str = ",".join(str(e) for e in h.path)
                out.write(
                    f"{hmm.name}\t{h.score:.2f}\t{h.frame}\t{path_str}\t{len(h.seq)}\n"
                )
                records.append((f"{hmm.name}_path{i+1}_score{h.score:.1f}", h.seq))
    if records:
        write_fasta(os.path.join(args.workdir, "pathracer.fasta"), records)
    print(f"{n_hits} hits -> {tsv}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
