"""spades-gfa-split equivalent: split a GFA into connected components.

Reference: SPAdes `src/projects/spades_tools/gfa_split.cpp:88`.  Host code.

    python -m spades_tpu_torch.tools.gfa_split graph.gfa -w out
"""
from __future__ import annotations

import os
import sys
from collections import defaultdict

from .common import make_parser, setup


def main(argv=None) -> int:
    p = make_parser("spades_tpu_torch-gfa-split", __doc__.split("\n")[0])
    p.add_argument("gfa", help="input GFA file")
    args = p.parse_args(argv)
    setup(args)

    from ..io.gfa import read_gfa

    gg = read_gfa(args.gfa)
    parent = {n: n for n in gg.segments}

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for a, _, b, _, _ in gg.links:
        if a in parent and b in parent:
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[ra] = rb

    comps = defaultdict(list)
    for n in gg.segments:
        comps[find(n)].append(n)

    os.makedirs(args.workdir, exist_ok=True)
    for i, (root, members) in enumerate(sorted(comps.items(), key=lambda kv: -len(kv[1]))):
        mset = set(members)
        out = os.path.join(args.workdir, f"component_{i}.gfa")
        with open(out, "w") as fh:
            fh.write("H\tVN:Z:1.0\n")
            for n in members:
                cov = gg.seg_cov.get(n)
                tag = f"\tDP:f:{cov:.6f}" if cov is not None else ""
                fh.write(f"S\t{n}\t{gg.segments[n]}{tag}\n")
            for a, o1, b, o2, ov in gg.links:
                if a in mset and b in mset:
                    fh.write(f"L\t{a}\t{o1}\t{b}\t{o2}\t{ov}M\n")
    print(f"{len(comps)} components -> {args.workdir}/component_*.gfa")
    return 0


if __name__ == "__main__":
    sys.exit(main())
