"""Helpers for the readers of the program's own spans.

A traced job (`--time-tracing`) leaves `spades_time_trace.json` in its
output directory, which still exists while the readers run: Chrome-trace
complete events written by `spades_tpu_torch/utils/timetracer.py`, each
with `args.detail` (the span's name), `args.id` and `args.parent`, `ts` and
`dur` in microseconds.  A job without that file, or whose file has no root
span `spades` with an id (the shape the program wrote before its spans had
ids), has no spans here: every reader then returns None.
"""
from __future__ import annotations

import json
import os
import re

from bench_gpu.records import per_job

FILE = "spades_time_trace.json"
ROOT = "spades"
PER_K = re.compile(r"k\d+$")


def job_spans(job: dict) -> list[dict] | None:
    """The job's spans as {detail, id, parent, s}, or None (see above)."""
    path = os.path.join(job["out"], FILE)
    try:
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    except (OSError, ValueError):
        return None
    spans = []
    for e in events:
        args = e.get("args") or {}
        if e.get("ph") == "X" and "id" in args:
            spans.append({"detail": str(args.get("detail") or e.get("name", "")),
                          "id": args["id"], "parent": args.get("parent"),
                          "s": e["dur"] * 1e-6})
    if not any(s["detail"] == ROOT and s["parent"] is None for s in spans):
        return None
    return spans


def span_seconds(rec: dict, names) -> float | None:
    """Mean per job of the seconds of every span named one of `names`
    (0 in a job whose spans hold none of them)."""
    def value(job):
        spans = job_spans(job)
        if spans is None:
            return None
        return sum(s["s"] for s in spans if s["detail"] in names)
    return per_job(rec, value)


def unnamed_seconds(rec: dict) -> float | None:
    """Mean per job of the self time (duration less its children's) of the
    root span and of every per-K span (`k21`, ...): the part of the job that
    no step names."""
    def value(job):
        spans = job_spans(job)
        if spans is None:
            return None
        children: dict = {}
        for s in spans:
            children[s["parent"]] = children.get(s["parent"], 0.0) + s["s"]
        return sum(s["s"] - children.get(s["id"], 0.0) for s in spans
                   if s["detail"] == ROOT or PER_K.match(s["detail"]))
    return per_job(rec, value)
