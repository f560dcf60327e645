"""The conv backbones' BatchNorm + activation + residual sites, each one
pass of kernel BN1: the least bytes any implementation of them moves. Per
face and site, the conv output read once, the shortcut read once where the
site adds one (as it is, or a second conv output under its own
BatchNorm), and the result written once, in the configuration's dtype; the
per-channel statistics and parameters (kilobytes) are left out, and so are
the operations, a few a value.

Sites: MobileNetV2's every conv (stem, expansions, depthwise convs and the
last conv with ReLU6; projections bare or with the identity residual);
ResNeSt's three stem convs, and in each bottleneck its first conv, the
split attention's radix conv (both with ReLU) and its end, the last conv
plus the shortcut under a ReLU. The split attention's BatchNorm on its
pooled vector is not a site."""

from __future__ import annotations

from typing import Optional

from perfbench.counts.conv import out_size
from perfbench.counts.mobilenet_v2 import SETTING

BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def make_divisible(v: float, divisor: int = 8) -> int:
    """MobileNetV2's channel rounding (never below 90%)."""
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    return new_v + divisor if new_v < 0.9 * v else new_v


def mobilenet_v2_values(s: int, width_mult: float = 1.0,
                        last_channel: Optional[int] = None) -> int:
    """Values read and written a face at s x s input."""
    h = out_size(s, 3, 2, 1)
    cin = make_divisible(32 * width_mult)
    total = 2 * cin * h * h
    for t, c, n, st in SETTING:
        cout = make_divisible(c * width_mult)
        for i in range(n):
            stride = st if i == 0 else 1
            hid = int(round(cin * t))
            if t != 1:
                total += 2 * hid * h * h            # expansion
            h = out_size(h, 3, stride, 1)
            total += 2 * hid * h * h                # depthwise
            res = stride == 1 and cin == cout
            total += (3 if res else 2) * cout * h * h
            cin = cout
    last = last_channel or make_divisible(1280 * max(1.0, width_mult))
    return total + 2 * last * h * h


def resnest_values(s: int, layers, radix: int, cardinality: int = 1,
                   bottleneck_width: int = 64, stem_width: int = 32,
                   avd: bool = True, avd_first: bool = False) -> int:
    """Values read and written a face at s x s input: a deep stem (3x3/2,
    3x3, 3x3) and a 3x3/2 max-pool, then each bottleneck's three sites;
    the split attention runs at its input's extent where ``avd`` pools
    after it, else at its stride's."""
    h = out_size(s, 3, 2, 1)
    total = 2 * 4 * stem_width * h * h
    h = out_size(h, 3, 2, 1)
    for stage, n in enumerate(layers):
        width = int(64 * 2 ** stage * bottleneck_width / 64) * cardinality
        out = 4 * 64 * 2 ** stage
        for i in range(n):
            stride = 2 if stage > 0 and i == 0 else 1
            after = out_size(h, 3, stride, 1)
            at = h if avd and stride > 1 and not avd_first else after
            total += 2 * width * h * h + 2 * radix * width * at * at
            total += 3 * out * after * after
            h = after
    return total


def nbytes(regressor: dict, dtype: str) -> Optional[int]:
    """Bytes a face for a configuration's ``regressor`` in ``dtype``, or
    None for an architecture without BN1 sites."""
    r = regressor
    if r["arch"] == "mobilenet_v2":
        values = mobilenet_v2_values(r["crop"], r.get("width_mult", 1.0),
                                     r.get("last_channel"))
    elif r["arch"].startswith("resnest"):
        values = resnest_values(
            r["crop"], r["layers"], r["radix"], r.get("cardinality", 1),
            r.get("bottleneck_width", 64), r.get("stem_width", 32),
            r.get("avd", True), r.get("avd_first", False))
    else:
        return None
    return BYTES[dtype] * values
