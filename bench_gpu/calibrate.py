"""Readings for a cell's limits: the program's on many seeds, the
control's on a few, and a planted fault's on a few, each one run of the
cell (set-up, one job, the check) in this process, on the card.

    python3 bench_gpu/calibrate.py --workload isolate.asm --seeds 12 --control-seeds 3 \
        --fault half_contigs --fault-seeds 3 --first-seed 5000

Prints one `READING` line per run and, per compared number, the program's
largest reading (the lower end of its limit) and the smallest of the
control and of the fault (the upper end).  The benchmark's own runs never
run the control or a fault.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_gpu import harness  # noqa: E402


def _half_contigs():
    """Every second contig and scaffold left out where they are written."""
    from spades_tpu_torch.pipeline import spades_stages

    inner = spades_stages.write_contigs

    def write_contigs(path, contigs):
        inner(path, list(contigs)[::2])

    spades_stages.write_contigs = write_contigs
    return lambda: setattr(spades_stages, "write_contigs", inner)


# name -> plant(): plants the fault in the program, returns its undo
FAULTS = {"half_contigs": _half_contigs}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, required=True)
    p.add_argument("--fault", choices=sorted(FAULTS), help="a fault to plant in the program")
    p.add_argument("--fault-seeds", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cpu: a rehearsal without the card")
    p.add_argument("--log", action="store_true", help="the harness's log on standard error")
    args = p.parse_args(argv)

    seed = iter(range(args.first_seed, args.first_seed + 10**6))
    plan = [("program", next(seed)) for _ in range(args.seeds)]
    plan += [("control", next(seed)) for _ in range(args.control_seeds)]
    if args.fault:
        plan += [(args.fault, next(seed)) for _ in range(args.fault_seeds)]
    seen: dict[str, dict[str, list[float]]] = {}

    def log(msg):
        if args.log:
            print(msg, file=sys.stderr, flush=True)

    for kind, s in plan:
        undo = FAULTS[kind]() if kind in FAULTS else None
        try:
            res = harness.run(args.workload, s, 1, False, device=args.device,
                              control=kind == "control", log=log)
        finally:
            if undo is not None:
                undo()
        vals = {n: c["value"] for n, c in res["checks"].items()}
        job_s = res["metrics"].get("job_s", {}).get("value")
        print("READING", kind, s, json.dumps(vals), f"job_s={job_s}", flush=True)
        for n, v in vals.items():
            seen.setdefault(kind, {}).setdefault(n, []).append(float("inf") if v is None else v)
    for n in sorted(seen.get("program", {})):
        vals = seen["program"][n]
        line = f"SUMMARY {n}: program max {max(vals)!r} over {len(vals)} seeds"
        for kind in sorted(seen):
            if kind != "program" and n in seen[kind]:
                line += f"; {kind} min {min(seen[kind][n])!r} over {len(seen[kind][n])} seeds"
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
