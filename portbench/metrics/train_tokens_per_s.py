"""Training throughput: every token of every step completed in the window
over the window's host seconds (from the first step's issue to the last
step's loss on the host)."""


def read(run):
    if not run.window.items:
        return None
    return run.window.units / run.window.seconds
