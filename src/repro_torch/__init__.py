"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

Laid out like ``repro``: ``core.acadl``, ``core.archs``, ``core.mapping``
(copies of the framework-free modules), ``core.aidg`` (the AIDG builder,
the max-plus engines, the DSE sweeps, the packed matrix and the Explorer
in PyTorch), ``core.network`` (whole-network cells, copied),
``kernels`` (hand-written CUDA kernels with their plain PyTorch versions,
sources in ``csrc/``, and the reference's ``ops``/``ref`` API over them),
``configs`` and ``models``.  ``convert`` carries an AIDG
across from numpy.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
