"""Named spans of the port on the profiler's clock.

``span(name)`` records ``name`` as a range while a ``torch.profiler`` (or
autograd) profiler records, and is one shared null context otherwise: no
``RecordFunction`` is built and the cost is one call into C.  So the spans
exist exactly when someone profiles, and then they lie in the same trace
as the device's activity, on its clock.  Spans opened on autograd's device
thread (the recompute of a checkpointed group inside the backward) are
recorded there too.

A span is a host range of function scope (``_RecordFunctionFast``, the
range ``torch.profiler`` gives an operator), not a user annotation
(``torch.profiler.record_function``): the profiler copies a user
annotation onto the device's timeline as one more device event, from the
first to the last kernel launched inside it, which a reader of the
device's activity cannot tell from a kernel where the events carry no
activity type (torch 2.11).  A span's device time is that of the
activities whose runtime call it holds (their correlation ids).

The port's spans are named ``repro_torch.<part>``: ``prefill``,
``decode``, ``embed``, ``cast``, ``layer``, ``norm``, ``attention``,
``mamba``, ``mlp``, ``moe``, ``unembed`` (``models/lm.py``) and
``forward``, ``loss``, ``backward``, ``optimizer`` (``launch/steps.py``).
"""

from __future__ import annotations

import contextlib
import functools

import torch

__all__ = ["span", "spanned"]

_OFF = contextlib.nullcontext()
_RANGE = torch._C._profiler._RecordFunctionFast


def span(name: str):
    """A context that records ``name`` as a range while a profiler is on."""
    if torch.autograd._profiler_enabled():
        return _RANGE(name)
    return _OFF


def spanned(name: str):
    """Decorate a function to run inside ``span(name)``, asked anew at each
    call, so a call opens the span exactly when a profiler records."""
    def wrap(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return wrapper
    return wrap
