"""V-MoE-B/16 "Every-2" (arXiv:2106.05974: ViT-B/16 with the MLP of blocks
1, 3, 5, 7, 9 and 11 a mixture of 32 experts, each token routed to 2) with
the 12/40/10 head, at s x s input: ViT-B/16's operations
(``counts/vit_b16.py``), plus in each MoE block the second expert's MLP
(each token runs two expert MLPs where a dense block runs one) and the
router's ``2 T D E``. The widths below are the configuration's
(``synergy_vmoe_b16``'s ``regressor`` keys) and the port's ``vmoe_b16``
defaults; a test holds all three equal."""

from __future__ import annotations

from perfbench.counts import moe, vit_b16

EXPERTS = 32
TOP_K = 2
MOE_LAYERS = (1, 3, 5, 7, 9, 11)


def flops(s: int) -> int:
    t = (s // vit_b16.PATCH) ** 2 + 1
    w, h = vit_b16.WIDTH, vit_b16.MLP
    extra = (moe.gemm_flops(t, w, h, TOP_K) - moe.gemm_flops(t, w, h, 1)
             + moe.router_flops(t, w, EXPERTS))
    return vit_b16.flops(s) + len(MOE_LAYERS) * extra
