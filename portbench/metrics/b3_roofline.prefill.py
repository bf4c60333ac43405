"""B3, the port's selective-scan kernel (``kernels/selective_scan.py``
over ``csrc/selective_scan.cu``), against its roofline in a prefill: the
least time of one launch at the cell's shape (``counts_hybrid.
scan_bound``: one exponential per (step, channel, state) on the special-
function units, or x, dt, y, B and C moved once) times the launches of
kernels named ``selective_scan`` in the trace, over their device time, %.
None where the trace holds no such kernel."""

from portbench import counts_hybrid
from portbench.seeded_hybrid import dims


def read(run):
    if run.trace is None:
        return None
    secs, launches = run.trace.op_seconds(lambda n: "selective_scan" in n)
    if launches == 0 or secs <= 0:
        return None
    s, t = dims(run.conf), run.traffic
    bound, _ = counts_hybrid.scan_bound(t["batch"], t["prompt_tokens"],
                                        s["d_inner"], s["d_state"])
    return 100.0 * bound * launches / secs
