"""Running metric meters (reference utils/ddfa.py:105-119 AverageMeter).

Counterpart of ``synergynet_tpu/train/meters.py``: host-side averages;
a device tensor passed in is read with ``float()``, so callers update a
meter only where they mean to wait for the device.
"""

from __future__ import annotations


class AverageMeter:
    """Tracks current value, running sum, count and average."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class MeterBank:
    """Dict of AverageMeters keyed by metric name."""

    def __init__(self):
        self.meters = {}

    def update(self, metrics: dict, n: int = 1):
        for k, v in metrics.items():
            self.meters.setdefault(k, AverageMeter()).update(float(v), n)

    def averages(self) -> dict:
        return {k: m.avg for k, m in self.meters.items()}

    def format(self) -> str:
        return "\t".join(f"{k}: {m.val:.4f} ({m.avg:.4f})"
                         for k, m in self.meters.items())
