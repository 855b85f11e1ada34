"""flanking_s: seconds per job in the refreshes of the flanking index that
meta's relative-coverage disconnector reads (the program's
`simplification.flanking` spans, `graph/flanking.py:FlankingTable.refresh`),
summed over every K; None where the program opens no such span."""
from bench_gpu.records import per_job
from bench_gpu.spans import job_spans

NAME = "simplification.flanking"


def read(rec):
    def value(job):
        spans = job_spans(job)
        hits = [s["s"] for s in spans or () if s["detail"] == NAME]
        return sum(hits) if hits else None
    return per_job(rec, value)
