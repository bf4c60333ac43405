"""Host milliseconds from a request's call into ``lm.prefill`` until the
call returns, before the wait for the device: the mean over the window's
requests after the traced ones (over all of them where every one was
traced), so that the profiler's own host cost is left out."""


def read(run):
    items = run.window.items
    if not items:
        return None
    rest = items[run.window.traced:] or items
    return 1e3 * sum(it.enqueue_s for it in rest) / len(rest)
