"""The final contigs and scaffolds against the genomes they came from.

Every 31-mer of contigs.fasta and scaffolds.fasta (windows with N left out)
should lie in a generated genome, on either strand: a substitution, an
indel or a wrong join puts up to 31 absent 31-mers into a contig.  And each
file on its own should hold the genomes' 31-mers: an edge removed as a tip,
a contig left unwritten or a stretch clipped away leaves them missing.

Readings (1e6 when a file is missing or holds no 31-mer):
  contig_kmers_absent_ppm   31-mers of contigs and scaffolds that lie in no
                            genome, per million of their 31-mers
  genome_kmers_missing_ppm  distinct canonical 31-mers of the genomes that
                            the file holding fewer of them lacks, per
                            million of the genomes' distinct 31-mers
"""
from __future__ import annotations

import os

import numpy as np

from . import kmers as R

NEEDS = ()
K = 31
FILES = ("contigs.fasta", "scaffolds.fasta")


def readings(job: dict, sample: dict, traffic: dict) -> dict:
    genome = R.sequence_set(sample["genomes"], K)
    total = absent = 0
    missing = 0
    for name in FILES:
        path = os.path.join(job["out"], name)
        if not os.path.exists(path):
            return {"contig_kmers_absent_ppm": 1e6, "genome_kmers_missing_ppm": 1e6}
        parts = []
        for _name, seq in R.read_fasta(path):
            keys, ok = R.window_keys(seq, K)
            keys = keys[ok]
            total += len(keys)
            absent += int((~R.member(genome, keys)).sum())
            parts.append(keys)
        held = np.unique(np.concatenate(parts)) if parts else np.zeros(0, np.uint64)
        missing = max(missing, int((~R.member(held, genome)).sum()))
    if total == 0 or len(genome) == 0:
        return {"contig_kmers_absent_ppm": 1e6, "genome_kmers_missing_ppm": 1e6}
    return {"contig_kmers_absent_ppm": absent / total * 1e6,
            "genome_kmers_missing_ppm": missing / len(genome) * 1e6}
