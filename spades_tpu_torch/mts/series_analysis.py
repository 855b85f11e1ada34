"""Multi-sample coverage-series analysis of the assembly graph (meta mode).

Capability mirror of SPAdes' `src/projects/spades/series_analysis.cpp`:
given an MTS k-mer multiplicity table, dump per-edge (and per-edge-fragment)
abundance profiles and edge sequences (:250-287), infer a bin's base profile
from contig profiles (:193-219 InferAbundance), and clear edges whose profile
diverges from the base profile — low cosine similarity or small norm ratio —
restricted to topologically safe edges (tips or alternatives present)
(:135-190 AggressiveClearing).

The config file is a flat YAML mapping.  The port reads it with its own
reader (`load_flat_yaml`), so no PyYAML is needed.
"""
from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

from ..graph.graph import CondensedGraph
from .abundance import contig_profiles
from .multiplicity import KmerProfiles


@dataclass
class SeriesAnalysisConfig:
    """YAML config (series_analysis.cpp MappingTraits :41-55)."""

    k: int
    sample_cnt: int
    kmer_mult: str
    bin: str = ""
    bin_prof: str = ""
    min_len: int = 0
    frag_size: int = 0
    edges_sqn: str = ""
    edges_mpl: str = ""
    edge_fragments_mpl: str = ""

    @classmethod
    def load(cls, path: str) -> "SeriesAnalysisConfig":
        with open(path) as fh:
            d = load_flat_yaml(fh.read())
        return cls(**{k: v for k, v in d.items() if k in cls.__dataclass_fields__})


# YAML 1.1 plain scalars as `yaml.safe_load` resolves them (PyYAML's
# resolver patterns); forms a flat config has no use for, which PyYAML would
# read as something other than a string, are refused rather than misread
_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^([-+]?[0-9][0-9_]*\.[0-9_]*([eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*([eE][-+][0-9]+)?)$")
_REFUSED = re.compile(r"^([-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+"
                      r"|[-+]?[0-9][0-9_]*(:[0-5]?[0-9])+(\.[0-9_]*)?"
                      r"|[-+]?\.(inf|Inf|INF)|\.(nan|NaN|NAN)"
                      r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?([Tt ].*)?)$")
_KEY = re.compile(r"^([A-Za-z_][A-Za-z0-9_]*)[ \t]*:([ \t]+(.*))?$")
_ESCAPES = {"n": "\n", "t": "\t", "\\": "\\", '"': '"', "/": "/", "0": "\0", "r": "\r"}


def _scalar(text: str):
    """One scalar value: quoted strings, then null, bool, decimal int,
    float and plain strings."""
    if text[:1] == "'":
        if len(text) < 2 or text[-1] != "'":
            raise ValueError(f"unterminated or commented quoted value: {text!r}")
        return text[1:-1].replace("''", "'")
    if text[:1] == '"':
        if len(text) < 2 or text[-1] != '"':
            raise ValueError(f"unterminated or commented quoted value: {text!r}")
        body, out, i = text[1:-1], [], 0
        while i < len(body):
            c = body[i]
            if c == "\\":
                if i + 1 >= len(body) or body[i + 1] not in _ESCAPES:
                    raise ValueError(f"unsupported escape in {text!r}")
                out.append(_ESCAPES[body[i + 1]])
                i += 2
            else:
                out.append(c)
                i += 1
        return "".join(out)
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if (_REFUSED.match(text) or text[:1] in "[]{}#&*!|>%@`,-?:" and
            (text[:1] not in "-?:" or len(text) == 1 or text[1] in " \t")
            or ": " in text or text.endswith(":")):
        raise ValueError(f"not a flat string, number, bool or null: {text!r}")
    return text


def load_flat_yaml(text: str) -> dict:
    """Parse a flat YAML mapping (`key: value` per line, `#` comments) as
    `yaml.safe_load` would, for the scalars a config file holds; anything
    nested, multi-line or otherwise outside that subset raises ValueError."""
    out: dict = {}
    for n, raw in enumerate(text.splitlines(), 1):
        line = raw.rstrip()
        if not line.strip() or line.lstrip().startswith("#") or line in ("---", "..."):
            continue
        if line[0].isspace():
            raise ValueError(f"line {n}: nested or continued values are not supported")
        m = _KEY.match(line)
        if m is None:
            raise ValueError(f"line {n}: not a `key: value` line: {raw!r}")
        key, value = m.group(1), (m.group(3) or "").strip()
        if value[:1] not in ("'", '"'):
            value = re.sub(r"[ \t]+#.*$", "", value)
        if key in out:
            raise ValueError(f"line {n}: duplicate key {key!r}")
        out[key] = _scalar(value)
    return out


def cosine_sim(a: np.ndarray, b: np.ndarray) -> float:
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 or nb == 0:
        return 0.0
    return float(a @ b / (na * nb))


def infer_bin_abundance(bin_prof_path: str, bin_id: str, sample_cnt: int) -> np.ndarray:
    """Mean profile of a bin's contigs (InferAbundance :193-219)."""
    vecs = []
    with open(bin_prof_path) as fh:
        for line in fh:
            f = line.split()
            if len(f) < 1 + sample_cnt or f[0] != bin_id:
                continue
            vecs.append([float(x) for x in f[1 : 1 + sample_cnt]])
    if not vecs:
        return np.zeros(sample_cnt)
    return np.asarray(vecs).mean(axis=0)


def edge_profiles(
    profiles: KmerProfiles, g: CondensedGraph, min_len: int = 0
) -> dict[int, np.ndarray]:
    """Per-canonical-edge abundance vector (EdgeAbundance::Fill)."""
    ids = [int(e) for e in g.canonical_edge_ids() if g.e_len[e] >= max(min_len, profiles.k)]
    seqs = [g.edge_seq(e) for e in ids]
    ab, _, ok = contig_profiles(profiles, seqs)
    return {e: ab[i] for i, e in enumerate(ids) if ok[i]}


def aggressive_clearing(
    g: CondensedGraph,
    eprofiles: dict[int, np.ndarray],
    base_profile: np.ndarray,
    similarity_threshold: float = 0.8,
    norm_ratio_threshold: float = 0.1,
) -> int:
    """Remove topologically-safe edges whose profile diverges from the base
    (AggressiveClearing::ProcessEdge :146-172).  Returns edges removed."""
    base_norm = np.linalg.norm(base_profile)
    if base_norm == 0:
        return 0
    in_deg = g.in_degrees()
    out_deg = g.out_degrees()
    removed = 0
    for e in list(g.canonical_edge_ids()):
        e = int(e)
        if not g.alive[e]:
            continue
        # topological condition: alternatives present at either end, or tip
        s, t = int(g.e_start[e]), int(g.e_end[e])
        has_alt = out_deg[s] > 1 or in_deg[t] > 1
        is_tip = in_deg[s] == 0 or out_deg[t] == 0
        if not (has_alt or is_tip):
            continue
        prof = eprofiles.get(e)
        if prof is None:
            continue
        sim = cosine_sim(prof, base_profile)
        norm_ratio = float(np.linalg.norm(prof)) / base_norm
        if norm_ratio < norm_ratio_threshold or sim < similarity_threshold:
            g.kill_edges(np.array([e]))
            removed += 1
            in_deg = g.in_degrees()
            out_deg = g.out_degrees()
    return removed


def run_series_analysis(g: CondensedGraph, cfg: SeriesAnalysisConfig) -> None:
    """The SeriesAnalysis stage body (series_analysis.cpp:250-287)."""
    profiles = KmerProfiles.load(cfg.kmer_mult)
    assert profiles.num_samples == cfg.sample_cnt

    if cfg.edges_sqn:
        with open(cfg.edges_sqn, "w") as out:
            for e in g.canonical_edge_ids():
                s = g.edge_seq(int(e))
                out.write(f">NODE_{int(e)}_length_{len(s)}\n{s}\n")

    if cfg.edges_mpl:
        with open(cfg.edges_mpl, "w") as out:
            _print_fragment_profiles(g, profiles, None, cfg.min_len, out)

    if cfg.edge_fragments_mpl:
        with open(cfg.edge_fragments_mpl, "w") as out:
            _print_fragment_profiles(g, profiles, cfg.frag_size, cfg.min_len, out)


def _print_fragment_profiles(
    g: CondensedGraph, profiles: KmerProfiles, split_length: int | None,
    min_len: int, out,
) -> None:
    """PrintEdgeFragmentProfiles (:221-248): whole edges or fixed fragments."""
    names, seqs = [], []
    for e in g.canonical_edge_ids():
        full = g.edge_seq(int(e))
        step = split_length or len(full) or 1
        for i in range(0, len(full), step):
            frag = full[i : i + step]
            if len(frag) < max(min_len, profiles.k):
                break
            names.append(f"{int(e)}_{i // step}" if split_length else str(int(e)))
            seqs.append(frag)
    if not seqs:
        return
    ab, _, ok = contig_profiles(profiles, seqs)
    for i, name in enumerate(names):
        if ok[i]:
            vec = " ".join(f"{x:.2f}" for x in ab[i])
            out.write(f"{name} {len(seqs[i])} {vec}\n")
