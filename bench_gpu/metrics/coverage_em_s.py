"""coverage_em_s: seconds per job in the coverage model's EM (the program's
`coverage_fit.em` spans, `graph/coverage_model.py:fit_coverage_model`, one
per fit, on the card or the host by the span's `path`), summed over every K;
None where the program opens no such span."""
from bench_gpu.records import per_job
from bench_gpu.spans import job_spans

NAME = "coverage_fit.em"


def read(rec):
    def value(job):
        spans = job_spans(job)
        hits = [s["s"] for s in spans or () if s["detail"] == NAME]
        return sum(hits) if hits else None
    return per_job(rec, value)
