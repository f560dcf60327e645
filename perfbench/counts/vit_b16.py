"""ViT-B/16 (arXiv:2010.11929, Table 1: patch 16, hidden 768, 12 blocks,
12 heads of 64, MLP 3072) with the 12/40/10 head, at s x s input: the
patch convolution, every block's q/k/v, output and MLP Dense layers, the
attention's two products (scores and weighted values), and the head.
LayerNorm, softmax, GELU and the residual adds are elementwise and not
counted. The widths below are the configuration's (``synergy_vit_b16``'s
``regressor`` keys) and the port's ``vit_b16`` defaults; a test holds all
three equal."""

from __future__ import annotations

from perfbench.counts import attention

PATCH = 16
WIDTH = 768
DEPTH = 12
HEADS = 12
MLP = 3072


def flops(s: int) -> int:
    n = (s // PATCH) ** 2
    t = n + 1
    total = 2 * n * PATCH * PATCH * 3 * WIDTH
    dense = 2 * t * WIDTH * (3 * WIDTH + WIDTH + 2 * MLP)
    total += DEPTH * dense
    total += attention.flops(1, DEPTH, HEADS, t, WIDTH // HEADS)
    return total + 2 * WIDTH * 62
