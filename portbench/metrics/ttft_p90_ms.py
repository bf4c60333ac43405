"""Time to first token, 90th percentile over all requests of the window,
each timed on the host from its issue to its greedy first tokens on the
host (inclusive quantiles of ``statistics.quantiles``)."""

import statistics


def read(run):
    items = run.window.items
    if len(items) < 2:
        return None
    ms = [1e3 * (it.done - it.issued) for it in items]
    return statistics.quantiles(ms, n=10, method="inclusive")[8]
