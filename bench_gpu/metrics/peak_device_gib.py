"""peak_device_gib: the most device memory a job of the window allocated
(`torch.cuda.max_memory_allocated` after a reset before each job)."""


def read(rec):
    return rec["peak_device_bytes"] / 2**30 if rec["peak_device_bytes"] else None
