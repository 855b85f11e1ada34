"""Genome consistency checker: QUAST-style assembly metrics vs a reference.

Product-component mirror of the reference's developer-mode
`genome_consistance_checker`
(SPAdes `src/common/modules/genome_consistance_checker.cpp`) and of
the nightly QUAST gate (`src/test/teamcity/teamcity.py` N50 / misassemblies
/ genome-fraction thresholds): place every contig on the reference by exact
anchor seeding on one diagonal (both strands, substitution-tolerant) and
report genome fraction, misassembled-contig count, N50/L50, largest, and
total length as one TSV + JSON line.  Host code.

    python -m spades_tpu_torch.tools.gchecker contigs.fasta genome.fasta -w out
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

from .common import check_inputs_exist, make_parser, setup


def quast_metrics(
    contigs: list[str], genomes: list[str], anchor: int = 31,
    max_divergence: float = 1e-3, min_len: int = 500,
) -> dict:
    """Gapless-placement metrics (substitution-only error model): a contig is
    correct when it sits on a single diagonal of one reference sequence with
    identity >= 1 - max_divergence; contigs < min_len are ignored (QUAST's
    --min-contig default)."""
    from ..core import dna

    idx: dict[str, tuple[int, int]] = {}
    for gi, genome in enumerate(genomes):
        for i in range(0, len(genome) - anchor + 1):
            idx.setdefault(genome[i : i + anchor], (gi, i))
    covers = [np.zeros(len(genome), bool) for genome in genomes]
    mis = 0
    lens = []
    for s in contigs:
        if len(s) < min_len:
            continue
        lens.append(len(s))
        placed = False
        for cand in (s, dna.revcomp_str(s)):
            for off in range(0, len(cand) - anchor + 1, 997):
                hit = idx.get(cand[off : off + anchor])
                if hit is None:
                    continue
                gi, p = hit
                start = p - off
                genome = genomes[gi]
                if start < 0 or start + len(cand) > len(genome):
                    continue
                a = np.frombuffer(cand.encode(), np.uint8)
                b = np.frombuffer(
                    genome[start : start + len(cand)].encode(), np.uint8
                )
                if (a != b).mean() <= max_divergence:
                    covers[gi][start : start + len(cand)] = True
                    placed = True
                break
            if placed:
                break
        if not placed:
            mis += 1
    lens.sort(reverse=True)
    total = sum(lens)
    acc, n50, l50 = 0, 0, 0
    for i, L in enumerate(lens):
        acc += L
        if acc * 2 >= total:
            n50, l50 = L, i + 1
            break
    covered = sum(int(c.sum()) for c in covers)
    glen = sum(len(g) for g in genomes)
    return {
        "n_contigs": len(lens),
        "total_length": total,
        "largest": lens[0] if lens else 0,
        "n50": n50,
        "l50": l50,
        "genome_fraction": round(covered / max(glen, 1), 6),
        "misassembled": mis,
    }


def main(argv=None) -> int:
    p = make_parser("spades_tpu_torch-gchecker", __doc__.split("\n")[0])
    p.add_argument("contigs", help="assembled contigs (FASTA)")
    p.add_argument("reference", help="reference genome (FASTA, may be multi-record)")
    p.add_argument("--min-contig", type=int, default=500)
    p.add_argument("--max-divergence", type=float, default=1e-3)
    args = p.parse_args(argv)
    setup(args)
    check_inputs_exist([args.contigs, args.reference])

    from ..io.fastx import read_sequences

    contigs = list(read_sequences([args.contigs]))
    genomes = list(read_sequences([args.reference]))
    m = quast_metrics(
        contigs, genomes, min_len=args.min_contig,
        max_divergence=args.max_divergence,
    )
    os.makedirs(args.workdir, exist_ok=True)
    out = os.path.join(args.workdir, "report.tsv")
    with open(out, "w") as fh:
        for k, v in m.items():
            fh.write(f"{k}\t{v}\n")
    print(json.dumps(m))
    return 0


if __name__ == "__main__":
    sys.exit(main())
