"""Unified configuration tree (dataclasses, JSON round trip).

A copy of ``synergynet_tpu/core/config.py`` (the port keeps its own, as it
imports nothing of the JAX package): one nested dataclass tree covers
model / train / data / eval / detect / render, every CLI builds from it,
and it serializes to and from JSON, so a config written by either package
loads in the other. ``model.compute_dtype`` names a torch dtype here
(``getattr(torch, name)``); ``train.per_replica_bn`` normalizes each
data row of the Trainer's mesh alone (``bn_groups`` = the data size).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass
class ModelConfig:
    arch: str = "mobilenet_v2"          # reference train_script.sh:10
    img_size: int = 120
    param_classes: int = 62
    compute_dtype: str = "bfloat16"     # params stay fp32


@dataclass
class TrainConfig:
    batch_size: int = 1024              # train_script.sh:14
    base_lr: float = 0.08               # train_script.sh:13
    milestones: Tuple[int, ...] = (48, 64)
    warmup: int = 5
    epochs: int = 80
    momentum: float = 0.9
    weight_decay: float = 5e-4          # main_train.py:49
    nesterov: bool = True
    print_freq: int = 50                # main_train.py:53
    save_val_freq: int = 10             # main_train.py:55
    snapshot_dir: str = "ckpts"
    resume: Optional[str] = None
    seed: int = 0
    num_workers: int = 8                # train_script.sh:16
    test_initial: bool = False          # train_script.sh:24
    # Per-replica BatchNorm train-parity mode: split the batch into
    # data-axis groups and compute BN stats per group (the reference's
    # nn.DataParallel semantics, main_train.py:176); default is sync-BN
    # over the global batch (strictly more stable).
    per_replica_bn: bool = False
    # Microbatch gradient accumulation: run the batch as N sequential
    # microbatches (exact mean of gradients, chained BN stats).
    accum_steps: int = 1


@dataclass
class DataConfig:
    root: str = ""
    filelists_train: Optional[str] = None
    param_fp_train: Optional[str] = None
    synthetic_size: int = 2048          # fallback when no real data present
    # Synthetic appearance: "dots" (68 landmark dots over noise — sparse,
    # near-unlearnable for a global-avgpool CNN) or "shaded" (lit render
    # of the deformed surface + dots, data/shaded.py — dense appearance,
    # the distributional analogue of real 300W-LP crops).
    appearance: str = "dots"
    # Force the streaming GeneratedCropDataset even below the ~100K-crop
    # materialization threshold.
    streaming: bool = False
    jitter: Tuple[float, float, float] = (0.4, 0.4, 0.4)
    border: int = 5
    occlusion_prob: float = 0.01
    device_augment: bool = False   # fuse augmentation into the train step


@dataclass
class EvalConfig:
    batch_size: int = 128
    norm_std: float = 128.0             # 130 in-training (quirk Q6)
    synthetic_size: int = 256


@dataclass
class DetectConfig:
    weights: Optional[str] = None
    confidence_threshold: float = 0.05
    nms_threshold: float = 0.3
    vis_threshold: float = 0.5


@dataclass
class RenderConfig:
    alpha: float = 0.6                  # overlay weight (utils/render.py:31)
    intensity_ambient: float = 0.75
    intensity_directional: float = 0.7
    intensity_specular: float = 0.2
    specular_exp: int = 5


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    detect: DetectConfig = field(default_factory=DetectConfig)
    render: RenderConfig = field(default_factory=RenderConfig)

    def to_json(self, path: Optional[str] = None) -> str:
        s = json.dumps(dataclasses.asdict(self), indent=2)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s

    @classmethod
    def from_json(cls, src: str) -> "Config":
        d = json.loads(open(src).read() if src.endswith(".json") else src)
        return cls.from_dict(d)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        kw = {}
        for f in dataclasses.fields(cls):
            sub = d.get(f.name, {})
            sub_cls = f.default_factory
            flds = {x.name for x in dataclasses.fields(sub_cls)}
            known = {k: (tuple(v) if isinstance(v, list) else v)
                     for k, v in sub.items() if k in flds}
            kw[f.name] = sub_cls(**known)
        return cls(**kw)
