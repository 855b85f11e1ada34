"""pack_s: seconds per job packing the run-wide and paired read stores
(the program's `cli.pack` span, `ReadStore.build` in `pipeline/run.py`)."""
from bench_gpu.spans import span_seconds


def read(rec):
    return span_seconds(rec, ("cli.pack",))
