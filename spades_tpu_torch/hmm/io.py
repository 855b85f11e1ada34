"""HMMER3 profile-HMM file parsing.

Capability mirror of SPAdes' hmmer wrapper surface
(`src/common/hmm/hmmfile.cpp` reading HMMER3 .hmm profiles for pathracer
and the domain/BGC stages): parses NAME/LENG/ALPH headers and
the per-node match/insert emission and transition score tables into dense
numpy arrays (scores kept as -ln(p), '*' = +inf exactly as in the format)."""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

DNA_ORDER = "ACGT"
AMINO_ORDER = "ACDEFGHIKLMNPQRSTVWY"


@dataclass
class ProfileHMM:
    name: str
    length: int           # number of match states M
    alphabet: str         # "dna" | "rna" | "amino"
    K: int                # alphabet size
    match_emit: np.ndarray   # (M+1, K) -ln p  (row 0 unused)
    insert_emit: np.ndarray  # (M+1, K)
    # transitions (M+1, 7): m->m, m->i, m->d, i->m, i->i, d->m, d->d
    trans: np.ndarray
    compo: np.ndarray = field(default=None)  # background composition (K,)


def _parse_score(tok: str) -> float:
    return np.inf if tok == "*" else float(tok)


def read_hmm(path: str) -> list[ProfileHMM]:
    """Parse all profiles in a HMMER3 .hmm file."""
    out = []
    with open(path) as fh:
        lines = iter(fh)
        cur: dict | None = None
        for line in lines:
            t = line.split()
            if not t:
                continue
            if t[0].startswith("HMMER3"):
                cur = {"name": "?", "length": 0, "alph": "dna"}
            elif cur is not None and t[0] == "NAME":
                cur["name"] = t[1]
            elif cur is not None and t[0] == "LENG":
                cur["length"] = int(t[1])
            elif cur is not None and t[0] == "ALPH":
                cur["alph"] = t[1].lower()
            elif cur is not None and t[0] == "HMM":
                M = cur["length"]
                alph = cur["alph"]
                K = 4 if alph in ("dna", "rna") else 20
                me = np.full((M + 1, K), np.inf)
                ie = np.full((M + 1, K), np.inf)
                tr = np.full((M + 1, 7), np.inf)
                compo = None
                next(lines)  # the m->m m->i ... header line
                node = 0
                for row in lines:
                    rt = row.split()
                    if not rt:
                        continue
                    if rt[0] == "//":
                        break
                    if rt[0] == "COMPO":
                        compo = np.array([_parse_score(x) for x in rt[1 : K + 1]])
                        ins = next(lines).split()
                        ie[0] = [_parse_score(x) for x in ins[:K]]
                        trs = next(lines).split()
                        tr[0] = [_parse_score(x) for x in trs[:7]]
                        continue
                    node = int(rt[0])
                    me[node] = [_parse_score(x) for x in rt[1 : K + 1]]
                    ins = next(lines).split()
                    ie[node] = [_parse_score(x) for x in ins[:K]]
                    trs = next(lines).split()
                    tr[node] = [_parse_score(x) for x in trs[:7]]
                out.append(
                    ProfileHMM(
                        name=cur["name"], length=M, alphabet=alph, K=K,
                        match_emit=me, insert_emit=ie, trans=tr, compo=compo,
                    )
                )
                cur = None
    return out


def write_hmm(path: str, hmm: ProfileHMM) -> None:
    """Write a profile in HMMER3 text format (test fixtures / round-trips)."""

    def fmt(x: float) -> str:
        return "*" if np.isinf(x) else f"{x:.5f}"

    with open(path, "w") as fh:
        fh.write("HMMER3/f [spades_tpu_torch]\n")
        fh.write(f"NAME  {hmm.name}\n")
        fh.write(f"LENG  {hmm.length}\n")
        fh.write(f"ALPH  {hmm.alphabet.upper()}\n")
        letters = DNA_ORDER if hmm.K == 4 else AMINO_ORDER
        fh.write("HMM        " + "        ".join(letters) + "\n")
        fh.write("        m->m   m->i   m->d   i->m   i->i   d->m   d->d\n")
        if hmm.compo is not None:
            fh.write("  COMPO " + " ".join(fmt(x) for x in hmm.compo) + "\n")
            fh.write("        " + " ".join(fmt(x) for x in hmm.insert_emit[0]) + "\n")
            fh.write("        " + " ".join(fmt(x) for x in hmm.trans[0]) + "\n")
        for m in range(1, hmm.length + 1):
            fh.write(
                f"  {m:5d} " + " ".join(fmt(x) for x in hmm.match_emit[m]) + " 0 - - - -\n"
            )
            fh.write("        " + " ".join(fmt(x) for x in hmm.insert_emit[m]) + "\n")
            fh.write("        " + " ".join(fmt(x) for x in hmm.trans[m]) + "\n")


def hmm_from_consensus(
    seq: str, name: str = "motif", match_p: float = 0.9, alphabet: str = "dna"
) -> ProfileHMM:
    """Build a simple profile from a consensus string (test helper and the
    easy path for motif search without hmmbuild).  alphabet: dna | amino."""
    if alphabet == "amino":
        order = "ACDEFGHIKLMNPQRSTVWY"
        codes = [order.index(c) for c in seq]
        K = 20
    else:
        from ..core import dna

        codes = dna.encode(seq)
        K = 4
    M = len(codes)
    off_p = (1.0 - match_p) / (K - 1)
    me = np.full((M + 1, K), -np.log(off_p))
    me[0] = np.inf
    for i, c in enumerate(codes, start=1):
        me[i, c] = -np.log(match_p)
    ie = np.full((M + 1, K), -np.log(1.0 / K))
    tr = np.tile(
        [-np.log(0.95), -np.log(0.025), -np.log(0.025),
         -np.log(0.5), -np.log(0.5), -np.log(0.5), -np.log(0.5)],
        (M + 1, 1),
    )
    return ProfileHMM(
        name=name, length=M, alphabet=alphabet, K=K,
        match_emit=me, insert_emit=ie, trans=tr,
        compo=np.full(K, -np.log(1.0 / K)),
    )
