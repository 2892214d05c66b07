"""device.peak_mem_gib: torch.cuda.max_memory_allocated over the
window (the peak statistics are reset when it opens), in GiB."""


def read(run):
    if run.peak_window_bytes is None:
        return None
    return run.peak_window_bytes / 2 ** 30
