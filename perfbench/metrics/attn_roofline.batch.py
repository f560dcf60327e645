"""The attention kernels' share of their roofline, %: every face's
layers and heads (``perfbench.counts.attention`` at the configuration's
``num_layers``, ``num_heads`` and ``head_dim``, and the tokens of its
``crop`` in patches of ``patch_size`` and the class token: q, k and v
read once and the output written once in bfloat16, 4 T^2 d operations a
head and layer) against the HBM rate and the bf16 peak, over the trace's
``flash_fwd`` time per call. The faces are the call's face slots, all of
which the regressor runs."""

from perfbench.counts import attention
from perfbench.peaks import BF16_FLOPS, bound
from perfbench.tracing import op_seconds

FRAGMENT = "flash_fwd"


def read(rec):
    t = op_seconds(rec.trace, FRAGMENT)
    if t is None:
        return None
    r = rec.cfg["regressor"]
    tokens = (r["crop"] // r["patch_size"]) ** 2 + 1
    shape = (rec.traffic["frames_per_call"] * rec.cfg["max_faces"],
             r["num_layers"], r["num_heads"], tokens, r["head_dim"])
    return 100.0 * bound(attention.nbytes(*shape), attention.flops(*shape),
                         BF16_FLOPS)[0] / t
