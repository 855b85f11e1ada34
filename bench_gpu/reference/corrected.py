"""Corrected reads against the reads as they were before their substitutions.

The corrector keeps the reads' order and count, so read i of
`corrected/lib1_1.cor.fasta` and `lib1_2.cor.fasta` is compared base by base
with left and right mate i before the generator planted its errors.

Reading:
  ec_wrong_bases_ppm  bases that differ from the error-free reads, per
                      million bases; a missing read counts all its bases,
                      a length that differs counts the difference
"""
from __future__ import annotations

import os

import numpy as np

from . import kmers as R

NEEDS = ()
FILES = (("lib1_1.cor.fasta", "clean1"), ("lib1_2.cor.fasta", "clean2"))


def readings(job: dict, sample: dict, traffic: dict) -> dict:
    wrong = total = 0
    for name, key in FILES:
        clean = sample[key]
        total += clean.size
        path = os.path.join(job["out"], "corrected", name)
        recs = R.read_fasta(path) if os.path.exists(path) else []
        n, rl = clean.shape
        seqs = [seq for _name, seq in recs[:n]]
        wrong += (n - len(seqs)) * rl
        if seqs and all(len(s) == rl for s in seqs):
            wrong += int((np.stack(seqs) != clean[: len(seqs)]).sum())
            continue
        for i, seq in enumerate(seqs):
            m = min(len(seq), rl)
            wrong += int((seq[:m] != clean[i, :m]).sum()) + abs(len(seq) - rl)
    return {"ec_wrong_bases_ppm": wrong / max(total, 1) * 1e6}
