"""Prefill throughput: every prompt position (patches and tokens) of every
request completed in the window over the window's host seconds."""


def read(run):
    if not run.window.items:
        return None
    return run.window.units / run.window.seconds
