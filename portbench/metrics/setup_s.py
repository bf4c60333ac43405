"""Set-up: seconds from the process's start to the window's start
(imports, CUDA start-up, building the kernels on a checkout's first run,
weights and state from the seed, warm-up at the cell's shapes)."""


def read(run):
    return run.setup_s
