"""The reference regressors, one module a regressor architecture, found by
the configuration's ``regressor.arch``: ``regressors/<arch>.py``.

Each module exports

- ``forward(p, tree, x_nhwc) -> (B, 62)``: normalized (B, S, S, 3) crops,
  S the configuration's ``regressor.crop``, through the net of the
  ``backbone`` subtree of a merged tree (:func:`perfbench.reference.nets.
  merge`), every convolution and matrix product through the
  :class:`~perfbench.reference.precision.Precision` ``p``, so that the
  fp8 control covers it;
- ``spec() -> Spec or None``: every leaf of a seeded SynergyNet tree of
  the architecture (the backbone under ``backbone``, then
  :func:`~perfbench.reference.nets.synergy_mlp_spec` of its pooled
  feature's width), with the kinds that :func:`perfbench.weights.draw`
  scales by; None for an architecture served only from a shipped file.
"""

from __future__ import annotations

from perfbench import by_name


def load(arch: str):
    """The reference module of regressor architecture ``arch``."""
    return by_name(__name__, arch)
