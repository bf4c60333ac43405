"""The device's idle share of the traced prefill requests, in %
(``trace.idle_pct``)."""

from portbench.trace import idle_pct as read  # noqa: F401
