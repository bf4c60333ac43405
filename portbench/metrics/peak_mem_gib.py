"""The CUDA allocator's peak over set-up and window, GiB
(``torch.cuda.max_memory_allocated`` read when the window closes)."""


def read(run):
    return run.peak_bytes / 2 ** 30
