"""The traced run: `torch.profiler` with CUDA activity over the window, and
its reduction to device busy time, kernel times and idle gaps.

Device times are the profiler's.  The host clock is tied to the trace by a
marker kernel: the harness launches `torch.cuda._sleep` right after the
profiler starts, waits for it, and reads `time.perf_counter()`; the
marker's end in the trace is that moment.  Idle gaps are then named by the
host scope (a stage of `--time-tracing`, error correction, or `cli`) that
held the host at the gap's middle.
"""
from __future__ import annotations

import gzip
import json
import os
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARKER_CYCLES = 1_000_000


class DeviceTrace:
    """Starts the profiler and its clock marker; `stop` returns the device
    intervals on the host clock."""

    def __init__(self, workdir: str):
        import torch

        self._torch = torch
        self._path = os.path.join(workdir, "device_trace.json")
        self._prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self._prof.start()
        torch.cuda.synchronize()
        torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
        self._mark = time.perf_counter()

    def stop(self) -> dict:
        """Stop, export and read the trace: every device event as (start,
        end, name, category) in host seconds, sorted by start."""
        self._torch.cuda.synchronize()
        self._prof.stop()
        self._prof.export_chrome_trace(self._path)
        with open(self._path) as fh:
            events = json.load(fh).get("traceEvents", [])
        os.unlink(self._path)
        dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
        dev.sort(key=lambda e: float(e["ts"]))
        if not dev:
            return {"events": [], "aligned": False}
        # the marker is the first device event
        marker = dev[0]
        offset = self._mark - (float(marker["ts"]) + float(marker["dur"])) * 1e-6
        out = [(float(e["ts"]) * 1e-6 + offset, (float(e["ts"]) + float(e["dur"])) * 1e-6 + offset,
                e.get("name", ""), e["cat"]) for e in dev[1:]]
        return {"events": out, "aligned": "sleep" in marker.get("name", "").lower()
                or "spin" in marker.get("name", "").lower(), "marker": marker.get("name", "")}


def reduce(events: list, jobs: list[tuple[float, float]], scopes: list,
           top: int = 10) -> dict:
    """Device busy seconds (the union of device intervals) inside the jobs'
    intervals, seconds by operation name, the `top` longest idle gaps named
    by host scope, and idle seconds by host scope over gaps of 1 ms or more.
    `scopes` are (start, end, name) host intervals."""
    busy = 0.0
    by_name: dict[str, float] = {}
    gaps: list[tuple[float, float]] = []          # (length, middle)
    for j0, j1 in jobs:
        end = j0
        for a, b, n, _c in events:
            if b <= j0 or a >= j1:
                continue
            a, b = max(a, j0), min(b, j1)
            by_name[n] = by_name.get(n, 0.0) + (b - a)
            if a > end:
                gaps.append((a - end, (a + end) / 2))
            if b > end:
                busy += b - max(a, end)
                end = b
        if j1 > end:
            gaps.append((j1 - end, (j1 + end) / 2))
    gaps.sort(reverse=True)
    by_scope: dict[str, float] = {}
    for length, mid in gaps:
        if length < 1e-3:
            break
        name = _scope_at(scopes, mid)
        by_scope[name] = by_scope.get(name, 0.0) + length
    named = [(_scope_at(scopes, mid), length) for length, mid in gaps[:top]]
    return {"busy_s": busy, "by_name": by_name, "gaps": named, "idle_by_scope": by_scope}


def _scope_at(scopes: list, t: float) -> str:
    """The innermost host scope holding time t, else `cli`."""
    best, width = "cli", float("inf")
    for a, b, name in scopes:
        if a <= t <= b and b - a < width:
            best, width = name, b - a
    return best


def time_trace_scopes(path: str, t0: float) -> list:
    """(start, end, name) host intervals of a `--time-tracing` file whose
    clock starts at perf_counter value t0."""
    if not os.path.exists(path):
        return []
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as fh:
        events = json.load(fh).get("traceEvents", [])
    out = []
    for e in events:
        if e.get("ph") == "X":
            a = t0 + e["ts"] * 1e-6
            detail = (e.get("args") or {}).get("detail") or e.get("name", "")
            out.append((a, a + e["dur"] * 1e-6, str(detail)))
    return out
