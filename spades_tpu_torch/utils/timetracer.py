"""Chrome-trace time tracer.

Capability mirror of SPAdes' LLVM time-trace profiler integration
(`src/common/utils/perf/timetracer.hpp:28-45`
`TIME_TRACE_SCOPE` macros and the `TimeTracerRAII` of
`projects/spades/main.cpp:23-44` that writes `spades_time_trace_<K>.json`):
named scopes accumulate into a Chrome `chrome://tracing` / Perfetto-loadable
JSON file.  `torch.profiler` covers device-side tracing; this covers the host
pipeline timeline with the same scope names the stages use."""
from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager

_lock = threading.Lock()
_events: list[dict] = []
_enabled = False
_t0 = 0.0


def enable() -> None:
    global _enabled, _t0, _events
    with _lock:
        _enabled = True
        _t0 = time.perf_counter()
        _events = []


def enabled() -> bool:
    return _enabled


@contextmanager
def trace_scope(name: str, detail: str = ""):
    """TIME_TRACE_SCOPE equivalent: a named complete event."""
    if not _enabled:
        yield
        return
    start = time.perf_counter()
    try:
        yield
    finally:
        end = time.perf_counter()
        ev = {
            "name": name,
            "ph": "X",
            "ts": int((start - _t0) * 1e6),
            "dur": int((end - start) * 1e6),
            "pid": os.getpid(),
            "tid": threading.get_ident() % 0xFFFF,
        }
        if detail:
            ev["args"] = {"detail": detail}
        with _lock:
            _events.append(ev)


def instant(name: str) -> None:
    if not _enabled:
        return
    with _lock:
        _events.append(
            {
                "name": name,
                "ph": "i",
                "ts": int((time.perf_counter() - _t0) * 1e6),
                "pid": os.getpid(),
                "tid": threading.get_ident() % 0xFFFF,
                "s": "g",
            }
        )


def write(path: str) -> None:
    """Dump accumulated events as a Chrome trace JSON (TimeTracerRAII exit)."""
    with _lock:
        data = {"traceEvents": list(_events), "displayTimeUnit": "ms"}
    with open(path, "w") as fh:
        json.dump(data, fh)


def disable() -> None:
    global _enabled
    with _lock:
        _enabled = False
