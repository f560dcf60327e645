"""ResNeSt's split-attention radix combine: the least bytes any
implementation of it moves. Per face and split-attention block, the
block's radix tensor (r c values at each of its H x W positions) read
once and the combined tensor (c values a position) written once, in the
configuration's dtype; the pooled vector, Conv_2's logits and their
weights (r c values a face and block) are left out. Its operations, a
few a value, are far below every peak and are not counted."""

from __future__ import annotations

from perfbench.counts.conv import out_size

BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def values(s: int, layers, radix: int, cardinality: int = 1,
           bottleneck_width: int = 64, avd: bool = True,
           avd_first: bool = False) -> int:
    """Radix-tensor and combined values of one face at s x s input: a deep
    stem (3x3/2) and a 3x3/2 max-pool, then each block's split attention
    at its input's extent where ``avd`` pools around it (before it with
    ``avd_first``), else at its stride's."""
    h = out_size(out_size(s, 3, 2, 1), 3, 2, 1)
    total = 0
    for stage, n in enumerate(layers):
        c = int(64 * 2 ** stage * bottleneck_width / 64) * cardinality
        for i in range(n):
            stride = 2 if stage > 0 and i == 0 else 1
            after = out_size(h, 3, stride, 1)
            at = h if avd and stride > 1 and not avd_first else after
            total += (radix + 1) * c * at * at
            h = after
    return total


def nbytes(regressor: dict, dtype: str) -> int:
    """Bytes a face for a configuration's ``regressor`` (its ``crop``,
    ``layers``, ``radix``, ``cardinality``, ``bottleneck_width``, ``avd``
    and ``avd_first``) in ``dtype``."""
    r = regressor
    return BYTES[dtype] * values(
        r["crop"], r["layers"], r["radix"], r.get("cardinality", 1),
        r.get("bottleneck_width", 64), r.get("avd", True),
        r.get("avd_first", False))
