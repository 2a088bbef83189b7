"""peak_mem_mb (MB, the device's allocator): the most device memory the
program held at once over set-up and the window, published snapshots
included (``torch.cuda.max_memory_allocated``, reset after the inputs
were made and before the system was built)."""


def read(rec):
    return rec["peak_bytes"] / 1e6 if rec["peak_bytes"] else None
