"""The 3DMM decode of ``b`` faces over ``nver`` vertices (kernel B1's
contract for the dense mesh): per vertex 3 x 50 multiply-adds of the
basis, the mean, 3 x 3 multiply-adds of the rotation, the offset and the
y flip. Bytes: the parameters read, the coordinate-split basis and mean
(50 + 1 values a coordinate of a vertex, rounded up to 128 vertices) read
once, the mesh written once, float32."""

from __future__ import annotations

NVER = 53_215
N_LMK = 68
LANE = 128


def flops(b: int, nver: int) -> int:
    return b * nver * (300 + 3 + 18 + 3 + 1)


def work(b: int, nver: int = NVER):
    """(bytes, operations)."""
    npad = -(-nver // LANE) * LANE
    nbytes = 4 * (b * (50 + 9 + 3) + 3 * npad * 51 + b * 3 * nver)
    return nbytes, flops(b, nver)
