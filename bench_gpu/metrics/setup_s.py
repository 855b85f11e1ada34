"""setup_s: seconds from the process's start to the window's (host clock):
imports, the builds, the warm-up job and the first sample."""


def read(rec):
    return rec["setup_s"]
