"""What the benchmark takes from the program: its CLI entry, its stage
timers, trails and counters, and the first K's graph for the check.

Everything is reached from outside, by the program's public module
attributes: no file of the program is changed.  `Program.reset` clears the
trails between jobs; `Program.snapshot` copies what a job left in them.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import numpy as np


class Program:
    """The port's CLI in this process, with the benchmark's own spans around
    error correction and a copy of the first graph each job constructs."""

    def __init__(self, control: dict | None = None, capture_first_graph: bool = False):
        import spades_tpu_torch.hammer as hammer_pkg
        import spades_tpu_torch.pipeline.spades_stages as stages_mod
        from spades_tpu_torch.alignment import mapper
        from spades_tpu_torch.graph import simplify
        from spades_tpu_torch.ops import cuda_kernels
        from spades_tpu_torch.pipeline import main as cli
        from spades_tpu_torch.pipeline import stages

        self._cli = cli
        self._stages = stages
        self._sst = stages_mod
        self._mapper = mapper
        self._simplify = simplify
        self._kernel = cuda_kernels.canonical_window_keys
        self.ec_spans: list[tuple[float, float]] = []
        self.first_graph: dict | None = None
        # the time and bytes of that copy, made inside the job
        self.copy_s = 0.0
        self.copy_bytes = 0
        # (object, attribute, original) of every patch, undone by `close`
        self._patched = [(hammer_pkg, "correct_reads", hammer_pkg.correct_reads),
                         (hammer_pkg, "HammerConfig", hammer_pkg.HammerConfig),
                         (stages_mod, "construct_graph", stages_mod.construct_graph)]

        # error correction: a span around the call that `main` looks up in
        # the hammer package when it runs
        inner = hammer_pkg.correct_reads
        spans = self.ec_spans

        def correct_reads(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return inner(*args, **kwargs)
            finally:
                spans.append((t0, time.perf_counter()))

        hammer_pkg.correct_reads = correct_reads
        if control and control.get("hammer"):
            # the control: the program's corrector with some of its switches
            # set otherwise (a configuration of its own, not a second program)
            hammer_pkg.HammerConfig = _with_defaults(hammer_pkg.HammerConfig, control["hammer"])

        if capture_first_graph:
            build = stages_mod.construct_graph

            def construct_graph(*args, **kwargs):
                res = build(*args, **kwargs)
                if self.first_graph is None:
                    t0 = time.perf_counter()
                    self.first_graph = _graph_arrays(res.graph)
                    self.copy_s = time.perf_counter() - t0
                    self.copy_bytes = sum(getattr(a, "nbytes", 0)
                                          for a in self.first_graph.values())
                return res

            stages_mod.construct_graph = construct_graph

    def close(self) -> None:
        """Undo the patches."""
        for obj, name, orig in self._patched:
            setattr(obj, name, orig)

    def reset(self) -> None:
        """Empty every trail and counter before a job."""
        self._stages.STAGE_TIMES.clear()
        for name in ("CONSTRUCT_PHASES", "GAP_CLOSER_STATS", "RR_STATS", "MISMATCH_STATS",
                     "MODE_STATS"):
            getattr(self._sst, name).clear()
        self._mapper.RESIDUE_STATS.clear()
        for key in self._simplify.ENGINE_RUNS:
            self._simplify.ENGINE_RUNS[key] = 0
        self._kernel.launches = 0
        self._kernel.launch_shapes = collections.Counter()
        self.ec_spans.clear()
        self.first_graph = None
        self.copy_s = 0.0
        self.copy_bytes = 0

    def run(self, argv: list[str]) -> int:
        return self._cli.main(list(argv))

    def snapshot(self) -> dict:
        """What the last job left in the trails, as plain data."""
        return {
            "stage_times": [list(t) for t in self._stages.STAGE_TIMES],
            "construct_phases": [[k, dict(d)] for k, d in self._sst.CONSTRUCT_PHASES],
            "ec_spans": list(self.ec_spans),
            "b1_shapes": [[*key, n] for key, n in sorted(self._kernel.launch_shapes.items())],
        }


def _with_defaults(cls, overrides: dict):
    """`cls` called with `overrides` in place of its defaults."""
    def make(*args, **kwargs):
        return dataclasses.replace(cls(*args, **kwargs), **overrides)
    return make


def _graph_arrays(g) -> dict:
    """Copies of a condensed graph's edge arrays: the stages that follow
    change the graph in place."""
    return {"k": int(g.k), "e_off": np.array(g.e_off), "e_len": np.array(g.e_len),
            "e_conj": np.array(g.e_conj), "e_cov": np.array(g.e_cov),
            "alive": np.array(g.alive), "seq_pool": np.array(g.seq_pool)}
