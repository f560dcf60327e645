"""HRNet's exchange units, each output one pass of kernel F1: the least
bytes any implementation of them moves. Per face and exchange output i of
a module of n branches, the identity (branch i's values) read once, each
term read once at its own resolution (a term from a branch of higher
resolution at branch i's extent, one from a branch of lower resolution,
before its upsample, at that branch's extent, both with branch i's
channels) and the output written once, in the configuration's dtype; the
BatchNorms' statistics and parameters (kilobytes) are left out, and so
are the operations, a few a value. The convolutions that make the terms
are not part of the unit."""

from __future__ import annotations

BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def unit_values(sizes, widths) -> int:
    """Values read and written a face by one exchange unit over branches
    of extent ``sizes`` and channels ``widths``."""
    n = len(sizes)
    total = 0
    for i in range(n):
        total += 2 * widths[i] * sizes[i] ** 2
        for j in range(n):
            if j != i:
                total += widths[i] * sizes[max(i, j)] ** 2
    return total


def values(s: int, widths, modules) -> int:
    """Values a face at s x s input (s a multiple of 32): branch b at s /
    2^(b + 2), stages of ``modules`` modules over 2, 3, 4 ... branches."""
    total = 0
    for stage, n in enumerate(modules):
        branches = stage + 2
        sizes = [s // 2 ** (b + 2) for b in range(branches)]
        total += n * unit_values(sizes, widths[:branches])
    return total


def nbytes(regressor: dict, dtype: str) -> int:
    """Bytes a face for a configuration's ``regressor`` (its ``crop``,
    ``widths`` and ``modules``) in ``dtype``."""
    return BYTES[dtype] * values(regressor["crop"], regressor["widths"],
                                 regressor["modules"])
