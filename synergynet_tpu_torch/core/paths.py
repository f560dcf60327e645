"""Where the port reads and writes generated files.

A repo checkout keeps them beside the sources: ``<repo>/assets`` for asset
caches, shared with the JAX package so both read the same synthetic 3DMM
pack, and ``<repo>/build`` for compiled kernels. A wheel install's package
parent is site-packages, which may be read-only and must not collect
generated files, so there a user cache dir is used instead (the JAX
package's rule, ``synergynet_tpu/mm3d/assets.py:258-274``).
"""

from __future__ import annotations

import os

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _in_checkout() -> bool:
    return os.path.exists(os.path.join(_ROOT, "pyproject.toml"))


def _user_cache() -> str:
    return (os.environ.get("XDG_CACHE_HOME")
            or os.path.join(os.path.expanduser("~"), ".cache"))


def asset_dir() -> str:
    """The repo's ``assets/`` in a checkout, else the JAX package's user
    cache dir (``$XDG_CACHE_HOME/synergynet_tpu``)."""
    if _in_checkout():
        return os.path.join(_ROOT, "assets")
    return os.path.join(_user_cache(), "synergynet_tpu")


def build_dir() -> str:
    """Where kernels compile to: ``<repo>/build/synergynet_tpu_torch`` in a
    checkout, else ``$XDG_CACHE_HOME/synergynet_tpu_torch/build``."""
    if _in_checkout():
        return os.path.join(_ROOT, "build", "synergynet_tpu_torch")
    return os.path.join(_user_cache(), "synergynet_tpu_torch", "build")
