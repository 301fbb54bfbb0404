"""peak_mem_gib: torch.cuda.max_memory_allocated over the measured window
(the allocator's peak, reset when the window opens), in GiB."""


def read(run):
    b = run.window_peak_bytes
    return b / 2.0 ** 30 if b else None
