"""The device's idle share of the traced training steps, in %
(``trace.idle_pct``)."""

from portbench.trace import idle_pct as read  # noqa: F401
