"""job_s.ec: wall seconds per CLI invocation over the window (host clock),
per layer in the cells whose job time spreads too widely for a bound."""


def read(rec):
    return rec["window_s"] / len(rec["jobs"]) if rec["jobs"] else None
