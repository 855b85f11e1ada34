"""unspanned_s: seconds per job that no step of the program names: the self
time of its root span `spades` (`pipeline/main.py`) and of every per-K span
`k<K>` (`pipeline/run.py`)."""
from bench_gpu.spans import unnamed_seconds


def read(rec):
    return unnamed_seconds(rec)
