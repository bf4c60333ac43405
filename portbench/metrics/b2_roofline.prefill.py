"""B2, the port's flash-attention kernel (``kernels/flash_attention.py``
over ``csrc/flash_attention.cu``), against its roofline: the least time
of each launch at the prefill's shape (``counts.flash_bound``: the causal
pairs' products at the bf16 peak, or its bytes at the HBM rate) times the
launches found in the trace, over the device time of those kernels, %."""

from portbench import counts
from portbench.seeded import dims


def read(run):
    if run.trace is None:
        return None
    secs, launches = run.trace.op_seconds(lambda n: "flash_attention" in n)
    if launches == 0 or secs <= 0:
        return None
    s, t = dims(run.conf), run.traffic
    seq = s["patches"] + t["prompt_tokens"]
    bound, _ = counts.flash_bound(t["batch"] * s["heads"], seq, seq,
                                  s["head_dim"], s["head_dim"], 2, True)
    return 100.0 * bound * launches / secs
