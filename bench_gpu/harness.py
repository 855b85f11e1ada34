"""The benchmark harness: set-up, the measured window of whole CLI jobs, the
check against the plain reference, and the result line.

A cell of `BENCHMARK.json` names a configuration (a deployment, in the file
that its entry names) and a traffic mix (`traffic/<name>.json`).  The
configuration names its generator (`gen/<name>.py`); the traffic mix gives
the CLI arguments of a job, the checks (`reference/<name>.py`) and the
control; `limits/<cell>.json` gives each compared number's limit; each
metric is read by `metrics/<name>.py`.  All of them are found by name, so a
new cell, configuration, mix or metric is new files and new entries.

A job is one `spades_tpu_torch.pipeline.main.main(argv)` call on a sample of
its own, generated from the run's seed and the job's index, into an output
directory of its own.  The window runs jobs back to back: the first always,
each further one only if, at the mean of the jobs so far, it would end
within `--seconds`.  The window's clock runs only while a job runs: writing
the next job's sample between jobs is the harness's work, not the program's.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import resource
import shutil
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "spades_tpu")
# set-up only: every device path of the port taken at the warm-up's small size
WARMUP_ENV = {"SPADES_DEVICE_MAP_READS": "1", "SPADES_HOST_COUNT_WINDOWS": "1",
              "SPADES_DEVICE_INDEX_POOL": "1"}


class Bench:
    """The benchmark's files under one checkout root, found by name."""

    def __init__(self, root: str = ROOT):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as fh:
            self.spec = json.load(fh)
        self.dir = os.path.join(root, self.spec["paths"][0])
        self._modules: dict = {}

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return self._json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return self._json(os.path.join(self.dir, "traffic", f"{name}.json"))

    def limits(self, workload: str) -> dict:
        return self._json(os.path.join(self.dir, "limits", f"{workload}.json"))

    def module(self, kind: str, name: str):
        """`<kind>/<name>.py` of the benchmark, loaded once."""
        key = (kind, name)
        if key not in self._modules:
            path = os.path.join(self.dir, kind, f"{name}.py")
            mod_name = f"bench_gpu.{kind}.{name.replace('.', '_').replace('-', '_')}"
            spec = importlib.util.spec_from_file_location(mod_name, path)
            mod = importlib.util.module_from_spec(spec)
            sys.modules[mod_name] = mod
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return self._modules[key]

    def metrics_of(self, workload: str, trace: bool) -> list[dict]:
        """The metrics a run of this cell reports: its end-to-end metrics
        with `--trace 0`, its per-layer metrics with `--trace 1`."""
        group = self.spec["per_layer"] if trace else self.spec["end_to_end"]
        return [m for m in group if "workloads" not in m or workload in m["workloads"]]

    @staticmethod
    def _json(path: str) -> dict:
        with open(path) as fh:
            return json.load(fh)


def job_seed(seed: int, index: int) -> int:
    """The seed of job `index` of a run (index -1: the warm-up)."""
    ss = np.random.SeedSequence([int(seed) % 2**63, index + 1])
    return int(ss.generate_state(1, np.uint32)[0])


def write_sample(sample: dict, workdir: str, prefix: str) -> list[str]:
    """Write a sample's pairs as FASTQ; returns the CLI's input arguments."""
    from bench_gpu.gen.synthetic import write_fastq

    p1, p2 = (os.path.join(workdir, f"{prefix}_{m}.fq") for m in (1, 2))
    write_fastq(p1, sample["r1"], 1, sample.get("q1"))
    write_fastq(p2, sample["r2"], 2, sample.get("q2"))
    return ["-1", p1, "-2", p2]


def process_age_s() -> float:
    """Seconds since this process started (from /proc), else since import."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def host_peak_bytes() -> int:
    """The process's resident peak so far (`ru_maxrss`)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def host_clocks() -> tuple[float, float]:
    """(CPU seconds this process has used, seconds the host's CPUs were
    stolen by other guests, from /proc/stat; 0 where it is not reported)."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    steal = 0.0
    try:
        with open("/proc/stat") as fh:
            fields = fh.readline().split()
        steal = int(fields[8]) / os.sysconf("SC_CLK_TCK") if len(fields) > 8 else 0.0
    except (OSError, ValueError):
        pass
    return ru.ru_utime + ru.ru_stime, steal


def io_bytes() -> dict:
    try:
        with open("/proc/self/io") as fh:
            return {a: int(b) for a, b in (line.split(": ") for line in fh if ": " in line)}
    except OSError:
        return {}


def forbidden_modules(names=None) -> list[str]:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX package's."""
    names = list(sys.modules) if names is None else names
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def reference_imports_program() -> list[str]:
    """Reference modules that hold anything of the program."""
    bad = []
    for name, mod in list(sys.modules.items()):
        if not name.startswith("bench_gpu.reference") or mod is None:
            continue
        for val in vars(mod).values():
            owner = getattr(val, "__module__", None) or getattr(val, "__name__", "")
            if isinstance(owner, str) and owner.split(".", 1)[0] in ("spades_tpu_torch", *FORBIDDEN):
                bad.append(f"{name}:{owner}")
    return sorted(set(bad))


def run(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
        root: str = ROOT, control: bool = False, log=print) -> dict:
    """One run of a cell: set-up, window, check.  Returns the result line's
    object.  `device="cpu"` runs the program on the CPU (the tests);
    `control=True` runs the traffic mix's control in the program's place."""
    import torch

    bench = Bench(root)
    cell = bench.workload(workload)
    cfg = bench.config(cell["config"])
    mix = bench.traffic(cell["traffic"])
    limits = bench.limits(workload)
    gen = bench.module("gen", cfg["generator"])
    checks = [bench.module("reference", name) for name in mix["checks"]]
    needs = {n for c in checks for n in c.NEEDS}
    on_card = device == "cuda"

    from bench_gpu.program import Program

    work = tempfile.mkdtemp(prefix="bench_gpu_")
    program = None
    try:
        program = Program(control=mix.get("control") if control else None,
                          capture_first_graph="first_graph" in needs)
        if on_card:
            from spades_tpu_torch.ops import cuda_kernels

            cuda_kernels.build()
        from spades_tpu_torch import native

        native.lib()
        argv_tail = list(cfg.get("argv", [])) + list(mix["argv"])
        if control and mix.get("control", {}).get("overlay"):
            overlay = os.path.join(work, "control_overlay.json")
            with open(overlay, "w") as fh:
                json.dump(mix["control"]["overlay"], fh)
            argv_tail += ["--config-file", overlay]
        if not on_card:
            argv_tail += ["--device", device]

        # warm-up: one small job on which every device path runs
        warm = gen.make({**cfg["params"], **cfg.get("warmup", {})}, job_seed(seed, -1))
        saved = {k: os.environ.get(k) for k in WARMUP_ENV}
        os.environ.update(WARMUP_ENV)
        try:
            program.reset()
            wout = os.path.join(work, "warmup_out")
            rc = program.run(write_sample(warm, work, "warmup") + argv_tail + ["-o", wout])
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        if rc != 0:
            raise RuntimeError(f"the warm-up job returned {rc}")
        shutil.rmtree(wout, ignore_errors=True)
        del warm

        # a job's sample is written before the job and made again for the
        # check, so that no sample is held in memory while a job runs
        inputs = [write_sample(gen.make(cfg["params"], job_seed(seed, 0)), work, "job0")]
        if on_card:
            torch.cuda.synchronize()
        setup_s = process_age_s()
        log(f"set-up {setup_s:.3f} s")

        # ---- the window -------------------------------------------------
        tracer = None
        if trace and on_card:
            from bench_gpu.trace import DeviceTrace

            tracer = DeviceTrace(work)
        trace_args = ["--time-tracing"] if trace else []
        io0 = io_bytes()
        jobs, spent = [], 0.0
        peak_dev = peak_host = 0
        while not jobs or spent + spent / len(jobs) <= seconds:
            j = len(jobs)
            if j == len(inputs):
                inputs.append(write_sample(gen.make(cfg["params"], job_seed(seed, j)), work,
                                           f"job{j}"))
            out = os.path.join(work, f"job{j}_out")
            program.reset()
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            cpu0, steal0 = host_clocks()
            t0 = time.perf_counter()
            try:
                rc = program.run(inputs[j] + argv_tail + trace_args + ["-o", out])
                err = None if rc == 0 else f"exit code {rc}"
            except Exception as exc:      # a failed job is counted, not fatal
                err = f"{type(exc).__name__}: {exc}"
            if on_card:
                torch.cuda.synchronize()
            t1 = time.perf_counter()
            cpu1, steal1 = host_clocks()
            # the copy of the first graph is the check's work, not the job's
            wall = t1 - t0 - program.copy_s
            spent += wall
            if on_card:
                peak_dev = max(peak_dev, torch.cuda.max_memory_allocated())
            if j == 0:
                # the kernel keeps no resettable peak on the card's machine,
                # so the host peak is the process's over set-up and one job
                peak_host = host_peak_bytes()
            snap = program.snapshot()
            snap.update(t0=t0, t1=t1, wall_s=wall, out=out, error=err,
                        first_graph=program.first_graph)
            if trace:
                from spades_tpu_torch.utils import timetracer

                from bench_gpu.trace import time_trace_scopes

                snap["scopes"] = time_trace_scopes(
                    os.path.join(out, "spades_time_trace.json"), timetracer._t0)
                snap["scopes"] += [(a, b, "error_correction") for a, b in snap["ec_spans"]]
            jobs.append(snap)
            log(f"job {j}: {wall:.3f} s{'' if err is None else ' FAILED ' + err}; "
                f"process CPU {cpu1 - cpu0:.3f} s, host steal {steal1 - steal0:.3f} s, "
                f"graph copy {program.copy_s:.3f} s {program.copy_bytes} B")
        io1 = io_bytes()
        device_trace = tracer.stop() if tracer is not None else None
        program.first_graph = None

        # ---- the check --------------------------------------------------
        t_check = time.perf_counter()
        found = forbidden_modules()
        readings: dict[str, float] = {}
        for j, job in enumerate(jobs):
            if job["error"] is not None:
                continue
            sample = gen.make(cfg["params"], job_seed(seed, j))
            for chk in checks:
                for name, val in chk.readings(job, sample, mix).items():
                    readings[name] = max(readings.get(name, float("-inf")), float(val))
            job["first_graph"] = None
        log(f"check {time.perf_counter() - t_check:.3f} s")
        leaked = reference_imports_program()
        failed = sum(j["error"] is not None for j in jobs)
        within = {n: (readings[n] <= limits[n]) if n in readings else False for n in limits}
        correct = failed == 0 and all(within.values()) and not found and not leaked

        rec = {"jobs": jobs, "setup_s": setup_s, "window_s": spent,
               "peak_device_bytes": peak_dev, "peak_host_bytes": peak_host, "trace": None,
               "io": {k: io1.get(k, 0) - io0.get(k, 0) for k in io1}}
        if device_trace is not None:
            from bench_gpu.trace import reduce

            scopes = [s for j in jobs for s in j.get("scopes", [])]
            red = reduce(device_trace["events"], [(j["t0"], j["t1"]) for j in jobs], scopes)
            red["aligned"] = device_trace["aligned"]
            red["marker"] = device_trace.get("marker", "")
            rec["trace"] = red
        metrics = {}
        for m in bench.metrics_of(workload, trace):
            val = bench.module("metrics", m["name"]).read(rec)
            if val is not None:
                metrics[m["name"]] = {"value": val, "unit": m["unit"]}
        result = {"correct": bool(correct), "attempted": len(jobs), "failed": failed,
                  "metrics": metrics,
                  "device": {"platform": "gpu" if on_card else "cpu",
                             "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                             "count": int(cell["chips"]),
                             "memory_peak_bytes": int(peak_dev)}}
        if trace and rec["trace"] is not None:
            result["device"]["busy_s"] = rec["trace"]["busy_s"]
            result["device"]["window_s"] = spent
            by_name = sorted(rec["trace"]["by_name"].items(), key=lambda kv: -kv[1])
            result["breakdown"] = {"device_ops": [[n, s] for n, s in by_name[:10]],
                                   "idle_gaps": [[n, s] for n, s in rec["trace"]["gaps"][:10]]}
        log(f"bytes written {rec['io']}")
        if rec["trace"] is not None:
            log(f"idle by host scope {rec['trace']['idle_by_scope']}; marker "
                f"{rec['trace']['marker']!r} aligned {rec['trace']['aligned']}")
        result["checks"] = {n: {"value": readings.get(n), "limit": limits[n]} for n in limits}
        if found:
            result["checks"]["forbidden_modules"] = {"value": found, "limit": []}
        if leaked:
            result["checks"]["reference_imports_program"] = {"value": leaked, "limit": []}
        return result
    finally:
        if program is not None:
            program.close()
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json on the card.")
    p.add_argument("--workload", required=True, help="a cell's name in BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True, help="seed of the inputs")
    p.add_argument("--seconds", type=float, required=True, help="length of the window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0,
                   help="1: per-layer metrics from a traced window")
    args = p.parse_args(argv)

    for name, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(name, os.path.join(ROOT, ".bench_cache", sub))
    import torch

    chips = Bench(ROOT).workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2

    def log(msg):
        print(msg, file=sys.stderr, flush=True)

    result = run(args.workload, args.seed, args.seconds, bool(args.trace), log=log)
    found = forbidden_modules()
    if found:
        print(f"error: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
