"""Scaled dot-product attention over T tokens in heads of d: per head and
layer, the scores q k^T and the weighted values p v, 2 T^2 d operations
each; q, k and v read once and the output written once, T d values each
in bfloat16. The scores and the softmax stay on chip and are not bytes."""

from __future__ import annotations

BYTES = 2          # bfloat16


def flops(faces: int, layers: int, heads: int, tokens: int,
          head_dim: int) -> int:
    return faces * layers * heads * 4 * tokens * tokens * head_dim


def nbytes(faces: int, layers: int, heads: int, tokens: int,
           head_dim: int) -> int:
    return faces * layers * heads * 4 * tokens * head_dim * BYTES
