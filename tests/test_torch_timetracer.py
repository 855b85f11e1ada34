"""The port's span recorder (`spades_tpu_torch/utils/timetracer.py`) on the
CPU: parent ids and nesting, the clock's origin in the file, what it does
while off, its counters, and its spans inside an active `torch.profiler`."""
import json
import time

import pytest
import torch

from spades_tpu_torch.ops import cuda_kernels
from spades_tpu_torch.utils import timetracer as tt


@pytest.fixture(autouse=True)
def recorder_off():
    tt.disable()
    yield
    tt.disable()


def _spans(path):
    with open(path) as fh:
        data = json.load(fh)
    return data, {e["args"]["detail"]: e for e in data["traceEvents"]}


def test_nesting_gives_parent_ids_and_children_lie_inside(tmp_path):
    tt.enable()
    with tt.span("outer"):
        with tt.span("k21", k=21):
            with tt.span("Stage", "stage_id"):
                with tt.span(".sub") as sp:
                    sp.set(rows=7)
            with tt.trace_scope("Other", "other_id"):
                pass
    tt.write(str(tmp_path / "t.json"))
    data, by = _spans(tmp_path / "t.json")
    assert set(by) == {"outer", "k21", "stage_id", "stage_id.sub", "other_id"}
    assert by["outer"]["args"]["parent"] is None
    want = {"k21": "outer", "stage_id": "k21", "stage_id.sub": "stage_id", "other_id": "k21"}
    ids = {d: e["args"]["id"] for d, e in by.items()}
    assert len(set(ids.values())) == len(ids)
    for child, parent in want.items():
        c, p = by[child], by[parent]
        assert c["args"]["parent"] == ids[parent]
        assert p["ts"] <= c["ts"] and c["ts"] + c["dur"] <= p["ts"] + p["dur"] + 2
    assert by["stage_id"]["name"] == "Stage" and by["stage_id.sub"]["args"]["rows"] == 7
    assert all(by[d]["args"]["k"] == 21 for d in want)
    assert "k" not in by["outer"]["args"]
    assert all(e["ph"] == "X" for e in data["traceEvents"])


def test_the_file_gives_its_clock_origin(tmp_path):
    tt.enable()
    before = time.perf_counter()
    with tt.span("step"):
        time.sleep(0.01)
    after = time.perf_counter()
    tt.write(str(tmp_path / "t.json"))
    data, by = _spans(tmp_path / "t.json")
    other = data["otherData"]
    assert other["clock"] == "time.perf_counter" and other["origin_s"] == tt._t0
    assert other["run"] and isinstance(other["pid"], int)
    ev = by["step"]
    start = other["origin_s"] + ev["ts"] * 1e-6
    end = start + ev["dur"] * 1e-6
    assert before - 1e-6 <= start and end <= after + 1e-6 and ev["dur"] >= 10_000


def test_off_records_nothing_reads_no_counter_and_still_fills_into(monkeypatch):
    def no_read(*_a):
        raise AssertionError("a counter was read while tracing was off")

    monkeypatch.setattr(tt.resource, "getrusage", no_read)
    assert not tt.enabled()
    assert tt.span("a") is tt.span("b", "detail", rows=3)      # one shared no-op
    into = {}
    with tt.span("timed", into=into, key="x_s") as sp:
        sp.set(rows=1)
        time.sleep(0.002)
    with tt.span("timed", into=into, key="x_s"):
        pass
    with tt.span("plain"):
        pass
    assert into["x_s"] >= 0.002
    assert tt.events() == []


def test_into_and_the_span_are_one_measurement(tmp_path):
    tt.enable()
    into = {"x_s": 1.0}
    with tt.span("timed", into=into, key="x_s"):
        time.sleep(0.003)
    (ev,) = tt.events()
    assert abs(ev["dur"] * 1e-6 - (into["x_s"] - 1.0)) <= 1e-6


def test_counters(monkeypatch):
    monkeypatch.setattr(cuda_kernels.canonical_window_keys, "launches", 5)
    tt.enable()
    with tt.span("cpu_step"):
        torch.arange(10).sum()
    with tt.span("launching"):
        cuda_kernels.canonical_window_keys.launches += 3
    with tt.span("growing"):
        block = bytearray(64 * 2**20)
        block[:: 4096] = b"x" * len(block[:: 4096])
    by = {e["args"]["detail"]: e["args"] for e in tt.events()}
    assert by["cpu_step"]["b1_launches"] == 0 and by["launching"]["b1_launches"] == 3
    # on the CPU, with CUDA never initialised, no device reading
    assert all("dev_alloc_mib" not in a for a in by.values())
    rss = [e["args"]["maxrss_mib"] for e in tt.events()]
    assert rss == sorted(rss) and rss[0] > 0


def test_disable_drops_the_spans_and_keeps_the_origin():
    tt.enable()
    t0 = tt._t0
    with tt.span("step"):
        pass
    assert len(tt.events()) == 1
    tt.disable()
    assert tt.events() == [] and tt._t0 == t0 and not tt.enabled()
    with tt.span("after"):
        pass
    assert tt.events() == []


def test_spans_appear_in_an_active_profilers_trace(tmp_path):
    tt.enable(profile=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tt.span("spades"):
            with tt.span("construction.count_host"):
                torch.ones(64).cumsum(0)
    path = str(tmp_path / "prof.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        names = {e.get("name") for e in json.load(fh)["traceEvents"]}
    assert {"spades", "construction.count_host"} <= names
    assert {e["args"]["detail"] for e in tt.events()} == {"spades", "construction.count_host"}
