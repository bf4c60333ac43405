"""Device milliseconds a training step spends in copies: memcpy activity
and every kernel whose name holds "copy" (casts and layout copies),
summed over the traced steps, per step."""


def _is_copy(name: str) -> bool:
    low = name.lower()
    return low.startswith("memcpy") or "copy" in low


def read(run):
    if run.trace is None or not run.trace.items:
        return None
    secs, _ = run.trace.op_seconds(_is_copy)
    return 1e3 * secs / run.trace.items
