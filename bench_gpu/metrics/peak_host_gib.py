"""peak_host_gib: the process's resident peak (`ru_maxrss`) at the end of
the window's first job, over set-up and that one invocation: the card's
machine keeps no resettable peak (it refuses /proc/self/clear_refs)."""


def read(rec):
    return rec["peak_host_bytes"] / 2**30 if rec["peak_host_bytes"] else None
