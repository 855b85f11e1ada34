"""count_host_s: seconds per job of Construction's small-batch host count
(its `host_s` phase), summed over every K."""
from bench_gpu.records import per_job


def read(rec):
    def value(job):
        phases = [d["host_s"] for _k, d in job["construct_phases"] if "host_s" in d]
        return sum(phases) if phases else None
    return per_job(rec, value)
