"""Helpers for the metric readers: sums over a run's record of jobs.

A record (`harness.run`) holds `jobs`, one dict per job of the window with
the stage timer trail (`stage_times`: [k, stage id, s]), Construction's
phase timings (`construct_phases`: [k, {phase: s}]), the benchmark's spans
around error correction (`ec_spans`), the kernel's launches by shape
(`b1_shapes`: [R, L, k, strand, launches]) and the job's wall time
(`wall_s`); besides `window_s`, `setup_s`, the memory peaks, and `trace`,
the reduced device trace of a traced run (or None).
"""
from __future__ import annotations


def per_job(rec: dict, value) -> float | None:
    """Mean over the window's jobs of `value(job)`; None where it gives None
    for every job."""
    vals = [value(j) for j in rec["jobs"]]
    vals = [v for v in vals if v is not None]
    return sum(vals) / len(rec["jobs"]) if vals else None


def stage_seconds(rec: dict, ids=(), prefixes=()) -> float | None:
    """Mean per job of the seconds of the stages with these ids (or id
    prefixes), summed over every K; None where no such stage ran."""
    def value(job):
        hits = [s for _k, sid, s in job["stage_times"]
                if sid in ids or any(sid.startswith(p) for p in prefixes)]
        return sum(hits) if hits else None
    return per_job(rec, value)


def ec_seconds(job: dict) -> float | None:
    spans = job["ec_spans"]
    return sum(b - a for a, b in spans) if spans else None
