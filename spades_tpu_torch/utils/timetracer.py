"""The port's span recorder: Chrome-trace complete events on `time.perf_counter`.

Capability mirror of SPAdes' LLVM time-trace profiler integration
(`src/common/utils/perf/timetracer.hpp:28-45`
`TIME_TRACE_SCOPE` macros and the `TimeTracerRAII` of
`projects/spades/main.cpp:23-44` that writes `spades_time_trace_<K>.json`):
named spans accumulate into a Chrome `chrome://tracing` / Perfetto-loadable
JSON file (`--time-tracing`).

A span (`span(name, detail, into=, key=, **attrs)`) records its name and
detail, an id and its parent's id (a per-thread stack), its start and end on
`time.perf_counter()` (`ts` and `dur` in microseconds from `_t0`), the K of
the per-K span it lies in (`k`), and counters in `args`: the attributes it
was opened with or given by `set`, and, read when it ends, `b1_launches`
(launches of the canonical-windows kernel inside it), `maxrss_mib` (the
process's resident peak so far) and, once CUDA is initialised,
`dev_alloc_mib` (`torch.cuda.memory_allocated()`; the peak is never reset).
A name that starts with "." is relative: it is recorded after its parent's
detail (`.merge` inside `construction` is `construction.merge`), so a step
shared by several callers is named by the one it serves.

With `into`, the span's duration is also added to `into[key]` whether
tracing is on or off: a caller's timings dict and the span are one
measurement.  Off and without `into`, `span` tests one flag and returns a
shared no-op.  Under `enable(profile=True)` each span also enters
`torch.profiler.record_function`, so the operator's profiler trace holds the
host steps on its own clock.  The file's `otherData` gives the clock and its
origin (`origin_s`, the `perf_counter` value of `ts` 0), so a reader lines
the spans up with a device trace without importing the program.
"""
from __future__ import annotations

import itertools
import json
import os
import resource
import threading
import time
import uuid

_lock = threading.Lock()
_events: list[dict] = []
_enabled = False
_t0 = 0.0
_run = ""
_ids = itertools.count(1)
_local = threading.local()
_kernel = None        # the canonical-windows kernel, for its launch counter
_cuda = None          # torch.cuda, for the allocated bytes
_record_function = None


class _Off:
    """What `span` returns while it has nothing to do."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **counts) -> None:
        pass


_OFF = _Off()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("name", "detail", "into", "key", "args", "id", "parent", "k",
                 "start", "launches0", "rf")

    def __init__(self, name, detail, into, key, attrs):
        self.name, self.detail, self.into, self.key = name, detail, into, key
        self.args = attrs
        self.id = self.rf = None

    def set(self, **counts) -> None:
        """Counters of the step's own work, recorded with the span."""
        self.args.update(counts)

    def __enter__(self):
        if _enabled:
            stack = _stack()
            parent = stack[-1] if stack else None
            if self.name.startswith("."):
                base = parent.detail if parent is not None else ""
                self.name = f"{base}{self.name}" if base else self.name[1:]
            self.id = next(_ids)
            self.parent = parent.id if parent is not None else None
            self.k = self.args.get("k", parent.k if parent is not None else None)
            self.detail = self.detail or self.name
            stack.append(self)
            self.launches0 = _kernel.launches
        if _record_function is not None:
            self.rf = _record_function(self.detail)
            self.rf.__enter__()
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter()
        if self.into is not None:
            self.into[self.key] = self.into.get(self.key, 0.0) + (end - self.start)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        if self.id is None:
            return False
        _stack().remove(self)
        args = {"detail": self.detail, "id": self.id, "parent": self.parent}
        if self.k is not None:
            args["k"] = self.k
        args.update(self.args)
        args["b1_launches"] = _kernel.launches - self.launches0
        args["maxrss_mib"] = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
        if _cuda.is_initialized():
            args["dev_alloc_mib"] = _cuda.memory_allocated() / 2**20
        ev = {"name": self.name, "ph": "X", "ts": int((self.start - _t0) * 1e6),
              "dur": int((end - self.start) * 1e6), "pid": os.getpid(),
              "tid": threading.get_ident() % 0xFFFF, "args": args}
        with _lock:
            _events.append(ev)
        return False


def span(name: str, detail: str = "", into: dict | None = None, key: str | None = None,
         **attrs):
    """A step of the program: `with span("cli.parse") as s: ...; s.set(reads=n)`.
    `into`/`key`: add the duration to `into[key]`, traced or not."""
    if not _enabled and into is None:
        return _OFF
    return _Span(name, detail, into, key, attrs)


def trace_scope(name: str, detail: str = ""):
    """TIME_TRACE_SCOPE equivalent: a span named `name` with `detail`."""
    return span(name, detail)


def enable(profile: bool = False) -> None:
    """Start a run of the recorder: drop earlier spans, set the clock's
    origin `_t0` and a new run id.  profile: each span also enters
    `torch.profiler.record_function` (an operator's `torch.profiler` trace)."""
    global _enabled, _t0, _events, _run, _kernel, _cuda, _record_function
    import torch

    from ..ops.cuda_kernels import canonical_window_keys

    with _lock:
        _kernel, _cuda = canonical_window_keys, torch.cuda
        _record_function = torch.profiler.record_function if profile else None
        _enabled = True
        _t0 = time.perf_counter()
        _run = uuid.uuid4().hex
        _events = []


def enabled() -> bool:
    return _enabled


def events() -> list[dict]:
    """A copy of the spans recorded so far."""
    with _lock:
        return list(_events)


def write(path: str) -> None:
    """Dump the recorded spans as a Chrome trace JSON (TimeTracerRAII exit)."""
    with _lock:
        data = {"traceEvents": list(_events), "displayTimeUnit": "ms",
                "otherData": {"clock": "time.perf_counter", "origin_s": _t0,
                              "pid": os.getpid(), "run": _run}}
    with open(path, "w") as fh:
        json.dump(data, fh)


def disable() -> None:
    """Stop recording and drop what was recorded; `_t0` stays, so a reader
    can still place the file that was written on the clock."""
    global _enabled, _events, _record_function
    with _lock:
        _enabled = False
        _record_function = None
        _events = []
