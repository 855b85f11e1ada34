"""ec_cluster_s: seconds per job in BayesHammer's Hamming clustering (the
program's `hammer.cluster` spans, `hammer/hammer.py`), summed over passes."""
from bench_gpu.spans import span_seconds


def read(rec):
    return span_seconds(rec, ("hammer.cluster",))
