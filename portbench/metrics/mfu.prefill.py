"""The whole prefill's share of the card's bf16 peak over the traced
requests: ``counts.prefill_flops`` per request × requests traced ÷ the
traced span ÷ 989 TFLOP/s, in % (``trace.peak_share``)."""

from portbench.trace import peak_share as read  # noqa: F401
