"""The training step's share of the card's bf16 peak over the traced
steps: ``counts.train_step_flops`` per step × steps traced ÷ the traced
span ÷ 989 TFLOP/s, in % (``trace.peak_share``)."""

from portbench.trace import peak_share as read  # noqa: F401
