"""ec_s: seconds per job in error correction, a span of the benchmark's own
around `spades_tpu_torch.hammer.correct_reads`."""
from bench_gpu.records import ec_seconds, per_job


def read(rec):
    return per_job(rec, ec_seconds)
