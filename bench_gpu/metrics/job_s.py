"""job_s: wall seconds per CLI invocation over the window (host clock)."""


def read(rec):
    return rec["window_s"] / len(rec["jobs"]) if rec["jobs"] else None
