"""Run one cell of BENCHMARK.json on the card and print its result line.

    python3 bench_gpu/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits with 2, printing no result, without as many CUDA devices as the cell
asks for.  See `bench_gpu/harness.py` for what a run does.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_gpu.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
