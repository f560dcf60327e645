#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``synergynet_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--profile DIR] [--parent DIR]

Needs one NVIDIA Hopper card and the CUDA toolkit (nvcc); fails without
them, and fails when the port's package is not beside this script. Phases,
each fatal on failure:

1. the card: ``nvidia-smi`` name and power limit;
2. build every kernel of the serving, overlay, fused-stem and deferred
   paths from ``synergynet_tpu_torch/csrc`` (nvcc, sm_90a, one nvcc per
   source, all started together) and print the build seconds and ptxas
   resource lines;
3. each kernel against its plain PyTorch twin on the card, at its path's
   shapes, with kernel and plain times (CUDA events, L2 flushed between
   launches, as the path finds it cold):
   fused decode (B1): 8 and 1024 faces on the full 53,215-vertex basis,
   f32, within rtol 1e-4 / atol 1e-3, its time as min / median / max over
   20 runs, its share of the bound and its ratio to the library call;
   z-buffer raster (B2) and ids resolve (B3), both taking the mesh: 8 lit
   BFM meshes (846,720 triangles, int32 and int64) decoded from seeded
   random param62 in rois spread over the 720x1088 canvas, and stress
   meshes (ties, degenerate, giant, parked, off-canvas, empty): zbuf,
   payloads, triangle id and w0 bit-identical to the record-based twins,
   the visibility path equal to its record route and the deferred path to
   the payload path; times as for B1, with the bound of the mesh form and
   of the record form;
   fused stem (B4): 1 and 128 720x1088 frames packed s2d8, mean
   subtracted, bf16, within rtol 1.6e-2 / atol 1e-5 (bf16's own
   tolerance), with the share of elements that differ, and its time as
   min / median / max over 20 runs beside the bound and cuDNN's conv;
4. the serving path at full width -- MobileNetV2 1.0 on the shipped
   trained weights, bf16; the port's torch.Generator-seeded random-init
   bf16 FaceBoxes detector (``random_init_variables(0)``, passed
   explicitly: the default detector holds the JAX package's init);
   8 faces per 720x1088 frame: ``FusedFrameEngine.__call__`` on a 720x1088
   and a 480x640 frame, ``process_batch`` on 128 frames; output shapes,
   finite values, landmarks equal to the dense mesh at the keypoint
   vertices, and the dense mesh against the plain twin on the path's own
   param62; every kernel's launch count over these calls (and only these)
   must be > 0. Then the same calls and checks on a second engine whose
   detector runs the fused stem (``stem_mode="pallas"``), with the stem
   kernel's launch count > 0, and its agreement with the first engine
   printed (equal face counts, largest roi difference);
5. the overlay path at full width: ``FusedOverlayEngine.__call__`` on a
   720x1088, a 480x640 and an oversized 1080x1920 frame; the raster
   kernel's launch count over these calls (and only these) must be > 0;
   the overlay has the input's shape and dtype uint8, landmarks, meshes
   and poses equal ``FusedFrameEngine.__call__``'s, both raster kernels
   equal their twins bit for bit on the path's own meshes, the overlay
   equals the same render through the plain twin, and undrawn pixels equal
   the frame. Then the deferred raster on the same lit meshes:
   ``rasterize_buffers_tiled(..., deferred=True)`` equals ``deferred=False``
   bit for bit, the ids kernel's launch count over those calls is > 0,
   and the visibility path's triangle ids equal the ids kernel's;
6. end-to-end faces/s at 1 and 128 frames per call for the XLA-stem and
   the fused-stem engines in turns, ms per overlay frame (CUDA events or
   host clock after a synchronise, after warm-up), a per-stage breakdown
   of each, and the deferred raster's time beside the payload raster's;
   with ``--parent DIR`` (a checkout of an earlier commit) the same-work
   A/B of the raster entry points: the parent's and this tree's, mesh in
   and buffers out, in turns (parent, this, this, parent), each turn
   ``chip_smoke.py --raster-worker`` in a process of its own;
7. with ``--profile DIR`` only: ``process_batch`` at 1 and 128 frames and
   one overlay frame under ``torch.profiler`` -- device busy time, idle
   share, device ops per call, the leading ops and the raster's fill, walk
   and resolve -- with the Chrome traces and a summary in DIR;
8. the training path (no kernel of B1-B4 on it): one fp32 step (TF32 off)
   at batch 8 from the trained weights on the card and on the CPU, held
   within ``CARD_VS_CPU_REL`` of each leaf's scale; the default config's
   step (MobileNetV2 1.0, bf16, batch 1024) under
   ``set_sync_debug_mode("error")``, its median ms on a device-resident
   batch (CUDA events), crops/s (host clock) and peak memory, and a NaN
   batch skipped atomically; 30 steps on one fixed batch lowering
   ``loss_total`` (below the first step's, and the 30 steps' mean too);
   ``Trainer(cfg).fit(1)`` on 8 steps' worth of synthetic crops with the
   loader, the eval hook (n = 256) and a save, its crops/s and the
   loader's alone, then ``resume`` from the checkpoint. With ``--profile``
   also the step's idle share and device ops;
9. the training data path (no kernel of B1-B4 on it either): 1,024 shaded
   crops rendered on the card and on the CPU from the same keys (the keyed
   draws bit for bit, uint8 within 1 on at most 1e-3 of the values, the
   dots exact) and the card's render time; the device augmentation's core
   on the card against the CPU on the same draws (atol 1e-3, all 6 op
   orders), the step with ``augment=`` against the step without it, each
   once under ``set_sync_debug_mode("error")``; ``Trainer.fit(1)`` on
   streamed dots crops through the loader's ``fetch_batch`` fast path with
   ``device_augment``, beside phase 8's loader-bound figure;
   ``Trainer.fit(1)`` on streamed shaded crops rendered on the card by the
   loader, and the loader's rate rendering on the host CPU with one render
   at a time, one intra-op thread a slab thread, or neither;
   ``fit_resident`` on 16,384
   dots crops and ``fit_resident_generative`` on 16,384 shaded parameters,
   2 epochs each, the second under ``set_sync_debug_mode("error")`` up to
   its one metrics read, with epoch ms, crops/s and peak memory; and
   ``python -m synergynet_tpu_torch.cli.train --resident`` for one epoch;
10. the packaged two-stage API and the host renders (``api_phase``):
   launches of B1-B4 over its calls, each held against the CPU or its twin;
11. model families and reference weights (``families_phase``): for
   ``mobilenet_1``, ``resnet50``, ``resnext50_32x4d``, ``ghostnet``,
   ``resnest50`` and ``mobilenet_v2_1.4``, a reference-layout
   ``best.pth.tar`` made from a seed and imported through
   ``nn/torch_import.py``; ``get_all_outputs`` with 8 rects in f32 (TF32
   off) against the CPU and ``FusedFrameEngine.process_batch`` at 128
   frames in bf16, B1 launched in each, with ms per call and faces/s; a
   seeded ``FaceBoxesProd.pth`` through ``FaceBoxes(weights_path=...)``
   in f32 with the fused stem (B4's f32 entry launched), with stem_r=4 and
   with the 3-channel stem, each against the CPU face for face; B4's f32
   entry against its twin (within 1e-5 of the output's largest
   magnitude), cuDNN's f32 conv with TF32 off, its 3xTF32 bound (the
   FMA units' beside it) and its clock64 stall shares at 1 and 128
   frames.
12. reference-data ingest, the evaluation CLI and the f32 engine
   (``ingest_eval_phase``): a seeded ``3dmm_data/`` tree and a raw BFM
   ``.mat`` with its whitening pickle (scipy writes them), converted bit
   for bit, the raw one installed through ``$SYNERGY_BFM`` and loaded onto
   the card; ``decode_dense_fast`` on 8 and 1,024 faces against B1's plain
   twin (B1's launches over these calls are the ``kernels`` line's
   ``launches_eval``); ``python -m synergynet_tpu_torch.cli.evaluate``'s
   ``main`` on the card and with ``--platform cpu``, on the shipped
   ``.npz`` and on a seeded ``resnet50`` ``best.pth.tar``, over an
   ``--aflw2000-npz`` of 512 synthetic samples written by
   ``save_eval_pack`` at batch 128, NME and FOE card vs CPU within 1e-3,
   ms per CLI call and images/s; the f32 ``FusedFrameEngine`` on phase
   10's frame against the CPU (equal face counts, rois within
   ``BOX_TOL``, meshes within rtol 1e-4 / atol 1e-3), the TF32 flags
   before and after its call, its difference when one TF32 pass runs (no
   guard, the flags on), and its ms at B=1 with and without the guard, in
   turns, beside the bf16 engine's. The apps (``cli.infer``,
   ``cli.artistic``, ``cli.uv_texture``, ``pipeline.draw``) read, write
   and draw images with cv2 and matplotlib, which the card's machine may
   not have, so this run does not call them: their work on the card is
   ``get_all_outputs`` and ``render_overlay``, which phase 10 drives and
   holds.

Prints the kernels as one JSON line (each with its launches on its path,
error against its twin, kernel, plain and library ms, and the least time
the card could take, from this run's shapes; each kernel's ``ms`` is the
median of 20 runs on the device clock, with ``ms_min`` / ``ms_max`` and
the entry point's mean ``ms_entry`` beside it; each entry's ``timing``
says how its times were taken), the card's name and power limit, and last
``{"ok": true, "device": {...}}``.
"""

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

FACES = 8
BATCH = 128
CANVAS = (720, 1088)
OVERLAY_FRAMES = ((720, 1088), (480, 640), (1080, 1920))
RTOL, ATOL = 1e-4, 1e-3     # the dense decode's tolerance (f32)
STEM_TOL = dict(rtol=1.6e-2, atol=1e-5)     # bf16's own tolerance
DEVICE = "cuda:0"
KERNELS = ("fused_decode", "raster_tiled", "stem_s2d8")
# Published H100 SXM peaks (dense): HBM bytes/s, bf16 tensor-core and f32
# (outside the tensor cores) FLOP/s, and TF32 tensor-core FLOP/s (NVIDIA's
# H100 SXM data sheet, dense TF32).
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
TF32_FLOPS = 495e12


def log(msg):
    print(msg, flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip()


def time_ms(fn, n, torch, flush=None):
    """Mean milliseconds of ``fn()`` over ``n`` runs after two warm-ups,
    by CUDA events around each run; ``flush()`` runs untimed before each."""
    for _ in range(2):
        fn()
    total = 0.0
    for _ in range(n):
        if flush is not None:
            flush()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / n


def time_spread(fn, n, torch, flush, spin=1_000_000):
    """(min, median, max) milliseconds of ``fn()`` on the device over ``n``
    runs after two warm-ups, by CUDA events around each run; ``flush()``
    runs untimed before each, so every run finds the L2 cache cold. A spin
    of ``spin`` cycles (~0.5 ms by default) on the device follows the
    flush, so the host has enqueued ``fn()``'s launches before the start
    event is reached: the time is the device's, not the host's launch
    overhead, as long as the host enqueues ``fn()`` within the spin."""
    for _ in range(2):
        fn()
    runs = []
    for _ in range(n):
        flush()
        torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end))
    return min(runs), float(np.median(runs)), max(runs)


def bound(nbytes, flops, peak):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the operations over ``peak``."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bbox_pixels(rec):
    """Pixels inside the twin's records' clamped bboxes: the fragments a
    raster kernel tests for this data."""
    bb = rec[:, 9:13].long()
    nx = (bb[:, 1] - bb[:, 0] + 1).clamp(min=0)
    ny = (bb[:, 3] - bb[:, 2] + 1).clamp(min=0)
    return int((nx * ny).sum())


def raster_bounds(nver, ntri, n_payload, frags, drawn, h, w, tri_bytes):
    """(bound_ms, bound_by) of kernels B2 (``n_payload`` payloads) or B3
    (``n_payload`` 0: depth and id out) in the mesh form (reads vertices,
    triangles and payloads, writes the buffers) and in the earlier record
    form (reads (T, 13 + 3P) f32 plane records). Operations, f32: the setup (53 a
    triangle: u, v and depth planes), 13 a bbox pixel (three planes and
    u + v) and, for B2, the winner's 41-flop setup and 16 a payload a drawn
    pixel."""
    out = h * w * 4 * (1 + max(n_payload, 1))
    resolve = drawn * (41 + 16 * n_payload) if n_payload else 0
    mesh = bound(4 * nver * (3 + n_payload) + tri_bytes * 3 * ntri + out,
                 53 * ntri + 13 * frags + resolve, F32_FLOPS)
    records = bound(4 * ntri * (13 + 3 * n_payload) + out,
                    13 * frags + resolve, F32_FLOPS)
    return mesh, records


def lit_meshes(torch, dev):
    """8 BFM meshes decoded by the plain twin from seeded random param62 in
    rois spread over the 720x1088 canvas and lit as the overlay lights
    them, from the package on ``sys.path``: (verts (F*V, 3), tris (F*T, 3)
    int32, light (F*V, 3)), the overlay path's raster input at full
    width."""
    from synergynet_tpu_torch.mm3d import load_param_pack, rescale_to_roi
    from synergynet_tpu_torch.ops import (build_decode_basis,
                                          decode_dense_fused_reference)
    from synergynet_tpu_torch.pipeline.overlay_engine import light_faces
    from synergynet_tpu_torch.render import one_ring_table
    pack = load_param_pack().to(dev)
    basis = build_decode_basis(pack).to(dev)
    ch, cw = CANVAS
    rng = np.random.default_rng(0)
    p = torch.tensor(rng.normal(0, 1, (FACES, 62)).astype(np.float32),
                     device=dev)
    size = rng.uniform(80, 600, FACES)
    x0, y0 = rng.uniform(0, cw - size), rng.uniform(0, ch - size)
    rois = torch.tensor(np.stack([x0, y0, x0 + size, y0 + size], 1),
                        dtype=torch.float32, device=dev)
    with torch.inference_mode():
        dense = rescale_to_roi(decode_dense_fused_reference(p, basis, pack),
                               rois)
        tris = np.ascontiguousarray(pack.tri.cpu().numpy().T).astype(np.int32)
        nver = dense.shape[2]
        rings = one_ring_table(tris, nver).long().to(dev)
        verts, light = light_faces(
            dense.transpose(1, 2), torch.ones(FACES, dtype=torch.bool,
                                              device=dev),
            torch.from_numpy(tris).to(dev), rings)
    tris_all = (tris[None] + (np.arange(FACES, dtype=np.int32) * nver)[
        :, None, None]).reshape(-1, 3)
    return (verts.reshape(-1, 3).contiguous(),
            torch.from_numpy(tris_all).to(dev),
            light.reshape(-1, 3).contiguous())


# Spin before the start event in the same-work A/B: ~10 ms, longer than the
# host takes to enqueue the record form's ~60 eager ops.
AB_SPIN = 20_000_000


def raster_split(top):
    """Device ms per call of the raster kernels' three launches from
    ``profile_calls``' op list, and of everything else."""
    split = {"fill": 0.0, "walk": 0.0, "resolve": 0.0, "other": 0.0}
    for name, ms in top:
        key = ("fill" if "fill_keys" in name else
               "walk" if "raster_kernel" in name or "raster_mesh_kernel"
               in name else "resolve" if "resolve" in name else "other")
        split[key] += ms
    return split


def raster_worker(pkg_dir):
    """One turn of the same-work A/B: import the package at ``pkg_dir``
    (this checkout, or a parent's), rasterize :func:`lit_meshes` through
    its payload and ids entry points as its overlay and deferred paths
    call them -- mesh in, buffers out, whatever the package builds on the
    way -- and print one JSON line: each entry's device time (median, min,
    max of 20 L2-flushed runs behind a ~10 ms spin), its mean with the
    host's gaps inside, and the device ms of each launch under
    ``torch.profiler``."""
    sys.path.insert(0, os.path.abspath(pkg_dir))
    import torch
    from synergynet_tpu_torch.core.profiling import profile_calls
    from synergynet_tpu_torch import render
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a card")
    dev = torch.device(DEVICE)
    ch, cw = CANVAS
    v, t, c = lit_meshes(torch, dev)
    if hasattr(render, "rasterize_mesh"):
        form = "mesh: setup inside the kernels, int32 triangles"
        entries = {
            "payload": lambda: render.rasterize_mesh(v, t, c, h=ch, w=cw),
            "ids": lambda: render.rasterize_mesh_ids(v, t, h=ch, w=cw)}
    else:
        # The earlier record form: int64 triangles, as its overlay engine
        # passed them, and the record build before each kernel.
        form = "records: plane_records / compact_records, int64 triangles"
        t = t.long()
        none = v.new_zeros((v.shape[0], 0))
        entries = {
            "payload": lambda: render.rasterize_records(
                render.plane_records(v, t, c, h=ch, w=cw), 3, h=ch, w=cw),
            "ids": lambda: render.rasterize_ids(
                render.compact_records(v, t, none, h=ch, w=cw)[0], h=ch,
                w=cw)}
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    out = {"package": os.path.abspath(render.__file__), "form": form}
    trace_dir = os.path.join(os.path.abspath(pkg_dir), "build")
    os.makedirs(trace_dir, exist_ok=True)
    with torch.inference_mode():
        for name, fn in entries.items():
            spread = time_spread(fn, 20, torch, flush_buf.zero_, AB_SPIN)
            entry = time_ms(fn, 20, torch, flush_buf.zero_)
            prof = profile_calls(fn, 5, os.path.join(
                trace_dir, f"raster_ab_{name}.json"), top=1000)
            out[name] = {"ms": spread[1], "ms_min": spread[0],
                         "ms_max": spread[2], "ms_entry": entry,
                         "device_ms": raster_split(prof["top"]),
                         "busy_ms": prof["busy_ms"]}
    print("raster_worker " + json.dumps(out), flush=True)


def raster_ab(parent_dir, card):
    """The same-work A/B in turns (parent, this tree, this tree, parent),
    each turn :func:`raster_worker` in a process of its own. -> {"parent":
    [turn, turn], "change": [turn, turn]}."""
    here = os.path.dirname(os.path.abspath(__file__))
    turns = {"parent": [], "change": []}
    for who in ("parent", "change", "change", "parent"):
        pkg = parent_dir if who == "parent" else here
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--raster-worker",
             pkg], capture_output=True, text=True, timeout=600)
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("raster_worker ")]
        if proc.returncode != 0 or not line:
            fail(f"raster A/B turn on {pkg} failed (exit {proc.returncode})"
                 f":\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        turn = json.loads(line[-1][len("raster_worker "):])
        turns[who].append(turn)
        log(f"raster A/B {who} ({turn['form']}): " + "; ".join(
            f"{k} {turn[k]['ms']:.4f} ms ({turn[k]['ms_min']:.4f}-"
            f"{turn[k]['ms_max']:.4f}) on the device clock, entry "
            f"{turn[k]['ms_entry']:.4f} ms, launches "
            + ", ".join(f"{n} {ms:.4f}" for n, ms in
                        turn[k]["device_ms"].items())
            for k in ("payload", "ids")) + f" | {card}")
    return turns


def stress_meshes(rng, h, w):
    """Meshes that stress the raster kernel's edge cases: (name, verts
    (V, 3), tris (T, 3), colors (V, 3)) as numpy f32 / int32."""
    v = rng.uniform([0, 0, -5], [w, h, 5], (3000, 3)).astype(np.float32)
    t = rng.integers(0, 3000, (4000, 3)).astype(np.int32)
    c = rng.uniform(0, 1, (3000, 3)).astype(np.float32)
    d = v.copy()
    d[:300, :2] = d[0, :2]                         # zero-area triangles
    d[300:600, 1] = d[300:600, 0] * 0.5            # collinear triangles
    g = np.asarray([[-20, -20, 1], [3 * w, -10, 1], [-10, 3 * h, 1],
                    [10, 10, 2], [w - 10, 20, 2], [20, h - 10, 2]],
                   np.float32)
    p = v.copy()
    p[1500:] += 1e7                                # parked vertices
    o = v.copy()
    o[:, 0] += 1e30                                # far off the canvas
    return [
        ("random", v, t, c),
        ("ties", v, np.concatenate([t, t[::-1]]), c),
        ("degenerate", d, np.concatenate(
            [t, rng.integers(0, 600, (1000, 3))]).astype(np.int32), c),
        ("giant", np.concatenate([v, g]), np.concatenate(
            [t, [[3000, 3001, 3002], [3003, 3004, 3005]]]).astype(np.int32),
         np.concatenate([c, rng.uniform(0, 1, (6, 3))]).astype(np.float32)),
        ("parked", p, t, c),
        ("offcanvas", o, t, c),
        ("empty", v, t[:0], c),
    ]


TRAIN_BATCH = 1024
TRAIN_STEPS = 8             # the fit phase's epoch: 8 steps of 1024 crops
OVERFIT_STEPS = 30
# Card against CPU, one fp32 step (TF32 off) from the trained weights: the
# largest |difference| of a leaf (update, trace, running statistics) over
# its scale. Reductions run in another order on the card, so fp32 rounding
# differs from the first layer on; measured 3.3e-5 on an NVIDIA H100 80GB
# HBM3 at 700.00 W.
CARD_VS_CPU_REL = 1e-3


def worst_rel(got: dict, want: dict):
    """(largest per-leaf max |got - want| over the leaf's scale (its largest
    |value|, at least 1e-2 of the largest of all leaves), that leaf)."""
    top = max(float(w.abs().max()) for w in want.values())
    worst = (0.0, "")
    for k, w in want.items():
        scale = max(float(w.abs().max()), 1e-2 * top, 1e-30)
        err = float((got[k].cpu() - w.cpu()).abs().max()) / scale
        worst = max(worst, (err, k))
    return worst


def training_phase(torch, dev, card, profile_dir):
    """The port's training path on the card (phase 8); returns the numbers
    for the JSON line."""
    from synergynet_tpu_torch.convert import synergy_state_dict
    from synergynet_tpu_torch.core.checkpoint import (load_trained_variables,
                                                      shipped_trained_path)
    from synergynet_tpu_torch.core.config import Config
    from synergynet_tpu_torch.data import make_crops_with_params
    from synergynet_tpu_torch.mm3d import load_param_pack
    from synergynet_tpu_torch.mm3d.codec import full_fp32
    from synergynet_tpu_torch.nn import SynergyNet
    from synergynet_tpu_torch.train import (TrainState, Trainer,
                                            create_train_state, lr_per_step,
                                            make_optimizer, make_train_step,
                                            make_synthetic_eval_hook)
    out = {}
    cfg = Config()
    t = cfg.train
    pack = load_param_pack()
    opt = make_optimizer(lr_per_step(t.base_lr, t.milestones, t.warmup,
                                     TRAIN_STEPS),
                         momentum=t.momentum, nesterov=t.nesterov,
                         weight_decay=t.weight_decay)
    syn = make_crops_with_params(TRAIN_BATCH, seed=5, device=dev)
    cpu = torch.device("cpu")

    # -- 8a. one fp32 step on the card and on the CPU, same state and data --
    trained = synergy_state_dict(load_trained_variables(
        shipped_trained_path()))
    img8 = torch.from_numpy(syn["images"][:8])
    tgt8 = torch.from_numpy(syn["params"][:8])
    after = {}
    with full_fp32():
        for where, d in (("card", dev), ("cpu", cpu)):
            model = SynergyNet(dropout=0.0).to(d)
            model.load_state_dict(trained)
            st = TrainState(model, t.weight_decay)
            before = dict((k, v.detach().clone()) for k, v in
                          model.named_parameters())
            _, m = make_train_step(pack, opt, device=d)(st, img8, tgt8)
            named = dict(model.named_parameters())
            trace = dict(zip(named, torch.split(st.trace, [
                p.numel() for p in named.values()])))
            after[where] = ({k: (named[k].detach() - before[k]).cpu()
                              for k in named},
                             {k: v.cpu() for k, v in trace.items()},
                             {k: v.cpu() for k, v in model.named_buffers()},
                             float(m["loss_total"]))
    errs = {name: worst_rel(after["card"][i], after["cpu"][i])
            for i, name in enumerate(("update", "trace", "batch_stats"))}
    loss_err = abs(after["card"][3] - after["cpu"][3]) / abs(after["cpu"][3])
    log("train step, card vs CPU (B=8, fp32, TF32 off, trained weights, "
        "dropout 0): " + ", ".join(f"{k} {v[0]:.2e} ({v[1]})"
                                   for k, v in errs.items())
        + f", loss_total rel {loss_err:.2e} (tolerance {CARD_VS_CPU_REL} of"
        " each leaf's scale)")
    if max(v[0] for v in errs.values()) > CARD_VS_CPU_REL \
            or loss_err > 1e-4:
        fail("train step: the card disagrees with the CPU")
    out["card_vs_cpu"] = {k: v[0] for k, v in errs.items()}

    # -- 8b. the full-size step: no host sync, timing, the NaN skip -----------
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(0)
    model = SynergyNet(dtype=getattr(torch, cfg.model.compute_dtype)).to(dev)
    st = create_train_state(model, gen, opt)
    step = make_train_step(pack, opt, device=dev)
    imgs = torch.from_numpy(syn["images"]).to(dev)
    tgts = torch.from_numpy(syn["params"]).to(dev)
    losses = []
    for _ in range(3):                                   # warm-up
        losses.append(step(st, imgs, tgts, gen)[1]["loss_total"])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, m = step(st, imgs, tgts, gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    losses.append(m["loss_total"])
    log("train step under set_sync_debug_mode('error'): no host sync")
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for _ in range(10):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        losses.append(step(st, imgs, tgts, gen)[1]["loss_total"])
        b.record()
        torch.cuda.synchronize()
        runs.append(a.elapsed_time(b))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_host = 10
    t0 = time.perf_counter()
    for _ in range(n_host):
        losses.append(step(st, imgs, tgts, gen)[1]["loss_total"])
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t0
    ms = float(np.median(runs))
    out.update(step_ms=ms, step_ms_min=min(runs), step_ms_max=max(runs),
               step_crops_per_s=n_host * TRAIN_BATCH / host_s,
               peak_gib=peak)
    log(f"train step B={TRAIN_BATCH} bf16 (device-resident batch): median "
        f"{ms:.3f} ms (min {min(runs):.3f}, max {max(runs):.3f}, CUDA "
        f"events, 10 steps after 4 warm-up), {out['step_crops_per_s']:.1f} "
        f"crops/s on the host clock over {n_host} steps, peak "
        f"{peak:.2f} GiB | {card}")
    if not all(torch.isfinite(x) for x in losses):
        fail("train step: non-finite loss")

    bad = imgs.float().sub(127.5).div(128.0)
    bad[0, 5, 5, 0] = float("nan")
    keep = [x.clone() for x in (st.params, st.stats, st.trace, st.count)]
    n0 = int(st.step)
    _, m = step(st, bad, tgts, gen)
    if float(m["skipped"]) != 1.0 or int(st.step) != n0 + 1 or not all(
            torch.equal(a, b) for a, b in zip(
                keep, (st.params, st.stats, st.trace, st.count))):
        fail("train step: a NaN batch was not skipped atomically")
    log("train step with a NaN pixel: skipped == 1, parameters, running "
        "statistics, momentum and count bit-identical, step advanced")

    if profile_dir:
        from synergynet_tpu_torch.core.profiling import profile_calls
        p = profile_calls(lambda: step(st, imgs, tgts, gen), 3,
                          os.path.join(profile_dir, "trace_train.json"))
        out["profile"] = dict(p, calls=3, unprofiled_ms=ms)
        log(f"profile train step B={TRAIN_BATCH} (3 steps): device busy "
            f"{p['busy_ms']:.3f} of {p['wall_ms']:.3f} ms per step, idle "
            f"share {p['idle_share']:.3f}, {p['ops']:.1f} device ops per "
            f"step | {card}")
        for name, t_ms in p["top"]:
            log(f"  {t_ms:9.3f} ms  {name[:110]}")
    del st, model, imgs, tgts, bad, keep
    torch.cuda.empty_cache()

    # -- 8c. overfitting one batch --------------------------------------------
    model = SynergyNet(dtype=getattr(torch, cfg.model.compute_dtype)).to(dev)
    st = create_train_state(model, torch.Generator(device=dev).manual_seed(1),
                            opt)
    imgs = torch.from_numpy(syn["images"]).to(dev)
    tgts = torch.from_numpy(syn["params"]).to(dev)
    curve = [step(st, imgs, tgts, gen)[1]["loss_total"]
             for _ in range(OVERFIT_STEPS)]
    curve = [float(x) for x in curve]
    # With the default config's flat warm-up rate (0.016, momentum 0.9) the
    # loss falls for about a dozen steps and then oscillates around a level
    # near its start: the check is that the loss goes below its first value
    # and that the 30 steps' mean stays below it.
    mean = float(np.mean(curve))
    log(f"{OVERFIT_STEPS} steps on one fixed {TRAIN_BATCH}-crop batch: "
        f"loss_total first {curve[0]:.4f}, min {min(curve):.4f} (step "
        f"{int(np.argmin(curve)) + 1}), mean {mean:.4f}, last "
        f"{curve[-1]:.4f}; curve " + " ".join(f"{x:.4f}" for x in curve))
    if not (all(np.isfinite(curve)) and min(curve) < curve[0]
            and mean < curve[0]):
        fail("overfitting one batch did not lower loss_total")
    out["overfit_loss"] = curve
    del st, model, imgs, tgts
    torch.cuda.empty_cache()

    # -- 8d. Trainer.fit(1) at full width, eval, save, resume -----------------
    snap = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_train")
    cfg.data.synthetic_size = TRAIN_STEPS * TRAIN_BATCH
    cfg.train.snapshot_dir = snap
    cfg.train.print_freq = 4
    hook = make_synthetic_eval_hook(n=256, device=dev)
    spent = {"eval": 0.0, "save": 0.0}

    def timed(fn, key):
        def run(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spent[key] += time.perf_counter() - t0
        return run

    t0 = time.perf_counter()
    tr = Trainer(cfg, eval_hook=timed(hook, "eval"), device=dev)
    setup_s = time.perf_counter() - t0
    tr.save = timed(tr.save, "save")
    t0 = time.perf_counter()
    history = tr.fit(1)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    h = history[1]
    train_s = fit_s - spent["eval"] - spent["save"]
    out.update(fit_crops_per_s=cfg.data.synthetic_size / train_s,
               fit_s=fit_s, fit_setup_s=setup_s, eval_s=spent["eval"],
               save_s=spent["save"], fit_history=h)
    log(f"Trainer(cfg).fit(1): {TRAIN_STEPS} steps of {TRAIN_BATCH} crops "
        f"with the loader (TrainTransform, {cfg.train.num_workers} threads)"
        f" in {train_s:.2f} s: {out['fit_crops_per_s']:.1f} crops/s on the "
        f"host clock; eval {spent['eval']:.2f} s, save {spent['save']:.2f} "
        f"s, set-up {setup_s:.2f} s; losses " + ", ".join(
            f"{k} {v:.4f}" for k, v in h.items() if k != "eval")
        + f"; eval NME {h['eval']['nme_mean']:.3f}% | {card}")
    if not all(np.isfinite(v) for k, v in h.items() if k != "eval") \
            or h["skipped"] != 0.0 or not np.isfinite(h["eval"]["nme_mean"]):
        fail(f"Trainer.fit: {h}")
    # The loader alone, an epoch with no step: what the host can feed.
    tr.loader.set_epoch(2)
    t0 = time.perf_counter()
    n = sum(len(b[0]) for b in tr.loader)
    out["loader_crops_per_s"] = n / (time.perf_counter() - t0)
    log(f"the loader alone (TrainTransform, {cfg.train.num_workers} "
        f"threads, no step): {out['loader_crops_per_s']:.1f} crops/s on the "
        f"host clock over {n} crops; the step alone "
        f"{out['step_crops_per_s']:.1f}")
    cfg.train.resume = tr.ckpt_path(1)
    tr2 = Trainer(cfg, device=dev)
    if tr2.start_epoch != 2 or not all(
            torch.equal(getattr(tr2.state, k), getattr(tr.state, k))
            for k in ("params", "stats", "trace", "count", "step")):
        fail("Trainer.resume did not restore the saved state")
    log("Trainer resume from the epoch-1 checkpoint: start epoch 2, state "
        "bit-identical")
    return out


RENDER_CROPS = 1024
RESIDENT_STEPS = 16         # resident epochs: 16 steps of 1024 crops
RESIDENT_EPOCHS = 2
# The card against the CPU on the same keys: the draws bit for bit, the
# rendered uint8 within one level on at most this share of the values
# (fp32 products and exponentials round differently), the dots exact.
RENDER_SHARE = 1e-3
AUGMENT_ATOL = 1e-3


def resident_run(torch, fit, trainer, args, card, label):
    """Two resident epochs; the second under ``set_sync_debug_mode("error")``
    up to its one metrics read. Returns the numbers."""
    from synergynet_tpu_torch.train import resident
    real = resident.epoch_metrics
    reads = []

    def read(sums, steps):
        torch.cuda.set_sync_debug_mode(0)
        m = real(sums, steps)
        reads.append(time.perf_counter())
        return m

    def arm(epoch, metrics):
        if epoch == 1:
            torch.cuda.synchronize()
            reads.append(time.perf_counter())
            torch.cuda.set_sync_debug_mode("error")
    resident.epoch_metrics = read
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        history = fit(trainer, *args, epochs=RESIDENT_EPOCHS, log_fn=arm)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        resident.epoch_metrics = real
    n = RESIDENT_STEPS * TRAIN_BATCH
    first_s, second_s = reads[0] - t0, reads[2] - reads[1]
    out = dict(epoch1_ms=first_s * 1e3, epoch2_ms=second_s * 1e3,
               crops_per_s=n / second_s,
               peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               history={str(k): v for k, v in history.items()})
    log(f"{label}: {RESIDENT_EPOCHS} epochs of {RESIDENT_STEPS} steps of "
        f"{TRAIN_BATCH} crops; epoch 1 {out['epoch1_ms']:.1f} ms (its set-up"
        f" inside), epoch 2 {out['epoch2_ms']:.1f} ms under "
        f"set_sync_debug_mode('error') up to its one metrics read: "
        f"{out['crops_per_s']:.1f} crops/s on the host clock; peak "
        f"{out['peak_gib']:.2f} GiB; loss_total " + ", ".join(
            f"{h['loss_total']:.4f}" for h in history.values()) + f" | {card}")
    if int(trainer.state.step) != RESIDENT_EPOCHS * RESIDENT_STEPS or \
            not all(np.isfinite(v) for h in history.values()
                    for v in h.values()) or \
            any(h["skipped"] != 0.0 for h in history.values()):
        fail(f"{label}: {history}")
    return out


def data_phase(torch, dev, card, training):
    """The training data path on the card (phase 9): the shaded render,
    the device augmentation, the streaming Trainer, resident and
    generative epochs and the resident CLI; returns the numbers."""
    from synergynet_tpu_torch.cli import train as cli
    from synergynet_tpu_torch.core.config import Config
    from synergynet_tpu_torch.data import (GeneratedCropDataset,
                                           PrefetchLoader, keyed,
                                           make_crops_with_params,
                                           sample_params)
    from synergynet_tpu_torch.data.device_augment import (
        _PERMS, augment_from, device_augment)
    from synergynet_tpu_torch.data.shaded import (DOT_BGR, _dot_mask,
                                                  light_from,
                                                  render_shaded_crops,
                                                  shaded_draws)
    from synergynet_tpu_torch.mm3d import decode_landmarks, load_param_pack
    from synergynet_tpu_torch.nn import SynergyNet
    from synergynet_tpu_torch.train import (Trainer, create_train_state,
                                            fit_resident,
                                            fit_resident_generative,
                                            lr_per_step, make_optimizer,
                                            make_train_step)
    out = {}
    cpu = torch.device("cpu")
    pack = load_param_pack()
    pack_dev = pack.to(dev)

    # -- 9a. the shaded render: card vs CPU on the same keys, its time -------
    params = torch.from_numpy(sample_params(np.random.default_rng(7),
                                            RENDER_CROPS))
    idx = torch.arange(RENDER_CROPS)
    key = keyed.make_key(7)
    card_draws = [d.cpu() for d in shaded_draws(key, idx.to(dev))]
    differ = [name for name, a, b in zip(
        ("light x, y", "base", "noise"), card_draws,
        shaded_draws(key, idx)) if not torch.equal(a, b)]
    if differ:
        fail(f"keyed draws: the card's {', '.join(differ)} differ from the "
             "CPU's")
    light_card = light_from(card_draws[0].to(dev)).cpu()
    light_cpu = light_from(card_draws[0])
    light_rows = int((light_card != light_cpu).any(1).sum())
    out["light_rows_differ"] = light_rows
    t0 = time.perf_counter()
    on_cpu = render_shaded_crops(params, pack, key, idx)
    cpu_s = time.perf_counter() - t0
    on_card = render_shaded_crops(params.to(dev), pack_dev, key,
                                  idx.to(dev)).cpu()
    diff = (on_card.int() - on_cpu.int()).abs()
    share = float((diff > 0).float().mean())
    dots = _dot_mask(decode_landmarks(params, pack), 120)
    dot = torch.tensor(DOT_BGR, dtype=torch.uint8)
    dots_ok = torch.equal(on_card[dots], on_cpu[dots]) and bool(
        (on_cpu[dots] == dot).all())
    p_dev, i_dev = params.to(dev), idx.to(dev)
    r_min, r_ms, r_max = time_spread(
        lambda: render_shaded_crops(p_dev, pack_dev, key, i_dev), 10, torch,
        flush=lambda: None, spin=0)
    out["render"] = dict(crops=RENDER_CROPS, ms=r_ms, ms_min=r_min,
                         ms_max=r_max, cpu_s=cpu_s,
                         max_level_diff=int(diff.max()), diff_share=share,
                         light_rows_differ=out.pop("light_rows_differ"))
    log(f"shaded render of {RENDER_CROPS} crops (decode + render): keyed "
        f"draws bit-identical card vs CPU (the unit light from them differs "
        f"in the last bits on {light_rows} of {RENDER_CROPS} rows); uint8 "
        f"max difference "
        f"{int(diff.max())} on a share of {share:.2e} (limit 1 on "
        f"{RENDER_SHARE:.0e}); dots {'exact' if dots_ok else 'DIFFER'}; "
        f"card median {r_ms:.3f} ms (min {r_min:.3f}, max {r_max:.3f}, "
        f"CUDA events, 10 runs), CPU {cpu_s:.2f} s (host clock, one run) "
        f"| {card}")
    if int(diff.max()) > 1 or share > RENDER_SHARE or not dots_ok:
        fail("shaded render: the card disagrees with the CPU")

    # -- 9b. device augmentation: card vs CPU, the step with and without it --
    syn = make_crops_with_params(TRAIN_BATCH, seed=5, device=dev)
    imgs = torch.from_numpy(syn["images"])
    tgts = torch.from_numpy(syn["params"])
    rng = np.random.default_rng(3)
    f = torch.from_numpy(rng.uniform(0.6, 1.4, (TRAIN_BATCH, 3)).astype(
        np.float32))
    occ = torch.from_numpy(rng.random(TRAIN_BATCH) < 0.3)
    kind = torch.from_numpy(rng.integers(0, 7, TRAIN_BATCH))
    worst = 0.0
    for perm in _PERMS:
        a = augment_from(imgs.to(dev), f.to(dev), perm, occ.to(dev),
                         kind.to(dev)).cpu()
        worst = max(worst, float((a - augment_from(imgs, f, perm, occ,
                                                   kind)).abs().max()))
    imgs_dev, tgts_dev = imgs.to(dev), tgts.to(dev)
    _, a_ms, _ = time_spread(lambda: device_augment(imgs_dev, 11), 10,
                             torch, flush=lambda: None, spin=0)
    log(f"device augmentation of {TRAIN_BATCH} crops, card vs CPU on the "
        f"same draws, all 6 op orders: max |difference| {worst:.2e} "
        f"(atol {AUGMENT_ATOL}); device_augment alone: median "
        f"{a_ms:.3f} ms (CUDA events, 10 runs) | {card}")
    if worst > AUGMENT_ATOL:
        fail("device augmentation: the card disagrees with the CPU")
    cfg = Config()
    t = cfg.train
    opt = make_optimizer(lr_per_step(t.base_lr, t.milestones, t.warmup,
                                     TRAIN_STEPS),
                         momentum=t.momentum, nesterov=t.nesterov,
                         weight_decay=t.weight_decay)
    gen = torch.Generator(device=dev).manual_seed(0)
    st = create_train_state(SynergyNet(dtype=getattr(
        torch, cfg.model.compute_dtype)).to(dev), gen, opt)
    plain = make_train_step(pack, opt, device=dev)
    aug = make_train_step(pack, opt, device=dev, augment=device_augment)
    seeds = iter(range(10 ** 6))
    turns = {"plain": [], "augment": []}
    calls = {"plain": lambda: plain(st, imgs_dev, tgts_dev, gen),
             "augment": lambda: aug(st, imgs_dev, tgts_dev, gen,
                                    next(seeds))}
    for fn in calls.values():
        for _ in range(2):
            fn()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for fn in calls.values():
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for name in ("plain", "augment", "augment", "plain"):
        turns[name].append(time_spread(calls[name], 5, torch,
                                       flush=lambda: None, spin=0)[1])
    step_ms = {k: float(np.mean(v)) for k, v in turns.items()}
    out["augment"] = dict(max_abs_err=worst, ms=a_ms,
                          step_ms=step_ms["augment"],
                          plain_step_ms=step_ms["plain"])
    log(f"train step B={TRAIN_BATCH} bf16 with augment=device_augment: "
        f"{step_ms['augment']:.3f} ms against {step_ms['plain']:.3f} ms "
        f"without (CUDA events; the mean of two turns' medians of 5 steps, "
        f"in turns plain, augment, augment, plain); one step of each under "
        f"set_sync_debug_mode('error'): no host sync | {card}")
    if not torch.isfinite(st.params).all():
        fail("train step with augment: non-finite parameters")
    del st, plain, aug, calls, imgs_dev, tgts_dev
    torch.cuda.empty_cache()

    # -- 9c. Trainer.fit(1) on streamed crops with device augmentation -------
    snap = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_data")
    cfg = Config()
    cfg.data.synthetic_size = TRAIN_STEPS * TRAIN_BATCH
    cfg.data.streaming = True
    cfg.data.device_augment = True
    cfg.train.batch_size = TRAIN_BATCH
    cfg.train.snapshot_dir = snap
    cfg.train.print_freq = 4
    tr = Trainer(cfg, device=dev)
    if tr.dataset.transform is not None:
        fail("streaming with device_augment kept a host transform")
    t0 = time.perf_counter()
    h = tr.fit(1)[1]
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    tr.loader.set_epoch(2)
    t0 = time.perf_counter()
    n = sum(len(b[0]) for b in tr.loader)
    loader_rate = n / (time.perf_counter() - t0)
    out["streaming"] = dict(
        fit_crops_per_s=cfg.data.synthetic_size / fit_s,
        loader_crops_per_s=loader_rate,
        phase8_fit_crops_per_s=training["fit_crops_per_s"],
        phase8_loader_crops_per_s=training["loader_crops_per_s"],
        history=h)
    log(f"Trainer(cfg).fit(1) on streamed dots crops (fetch_batch fast path,"
        f" {cfg.train.num_workers} threads) with device_augment: "
        f"{TRAIN_STEPS} steps of {TRAIN_BATCH} in {fit_s:.2f} s, "
        f"{out['streaming']['fit_crops_per_s']:.1f} crops/s on the host "
        f"clock (phase 8, TrainTransform loader: "
        f"{training['fit_crops_per_s']:.1f}); the fast-path loader alone "
        f"{loader_rate:.1f} crops/s (phase 8's loader "
        f"{training['loader_crops_per_s']:.1f}); loss_total "
        f"{h['loss_total']:.4f} | {card}")
    if not all(np.isfinite(v) for v in h.values()) or h["skipped"] != 0.0:
        fail(f"Trainer.fit on a stream: {h}")
    del tr
    torch.cuda.empty_cache()

    # Streamed shaded crops render on the Trainer's device, in the loader's
    # slab threads.
    cfg.data.appearance = "shaded"
    cfg.data.synthetic_size = 2 * TRAIN_BATCH
    tr = Trainer(cfg, device=dev)
    if tr.dataset.device != tr.device:
        fail(f"the Trainer on {tr.device} streams shaded crops rendered on "
             f"{tr.dataset.device}")
    tr.dataset.lmk                   # decoded before the clock starts
    t0 = time.perf_counter()
    h = tr.fit(1)[1]
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    tr.loader.set_epoch(2)
    t0 = time.perf_counter()
    n = sum(len(b[0]) for b in tr.loader)
    shaded_rate = n / (time.perf_counter() - t0)
    if not all(np.isfinite(v) for v in h.values()) or h["skipped"] != 0.0:
        fail(f"Trainer.fit on a shaded stream: {h}")
    del tr
    torch.cuda.empty_cache()
    # The same loader rendering on the host CPU, three ways in turns: one
    # render at a time over all intra-op threads (the dataset's lock), each
    # slab thread's render on one intra-op thread, and neither bound.
    host = GeneratedCropDataset(TRAIN_BATCH, seed=0, appearance="shaded",
                                device="cpu")
    host.lmk
    lock, threads = host._render_lock, torch.get_num_threads()
    host_rates = {"lock": [], "one_thread": [], "neither": []}
    try:
        for mode in ("lock", "one_thread", "neither", "neither",
                     "one_thread", "lock"):
            host._render_lock = (lock if mode == "lock"
                                 else contextlib.nullcontext())
            torch.set_num_threads(1 if mode == "one_thread" else threads)
            t0 = time.perf_counter()
            n = sum(len(b[0]) for b in PrefetchLoader(
                host, TRAIN_BATCH, num_workers=cfg.train.num_workers))
            host_rates[mode].append(n / (time.perf_counter() - t0))
    finally:
        torch.set_num_threads(threads)
        host._render_lock = lock
    out["shaded_stream"] = dict(
        fit_crops_per_s=cfg.data.synthetic_size / fit_s,
        card_loader_crops_per_s=shaded_rate,
        host_loader_crops_per_s=host_rates, intra_op_threads=threads,
        history=h)
    log(f"Trainer(cfg).fit(1) on streamed shaded crops rendered on "
        f"{dev} by the loader's {cfg.train.num_workers} slab threads, "
        f"device_augment: 2 steps of {TRAIN_BATCH} in {fit_s:.2f} s, "
        f"{out['shaded_stream']['fit_crops_per_s']:.1f} crops/s; that loader"
        f" alone {shaded_rate:.1f} crops/s; the loader rendering on the host "
        f"CPU ({threads} intra-op threads), crops/s in turns ABCCBA: one "
        f"render at a time " + ", ".join(
            f"{r:.1f}" for r in host_rates["lock"]) + "; one intra-op "
        "thread a slab " + ", ".join(
            f"{r:.1f}" for r in host_rates["one_thread"]) + "; neither " +
        ", ".join(f"{r:.1f}" for r in host_rates["neither"]) +
        f" (host clock, {TRAIN_BATCH} crops each) | {card}")

    # -- 9d. resident and generative epochs -----------------------------------
    cfg = Config()
    cfg.data.synthetic_size = RESIDENT_STEPS * TRAIN_BATCH
    cfg.data.device_augment = True
    cfg.train.batch_size = TRAIN_BATCH
    cfg.train.snapshot_dir = snap
    cfg.train.save_val_freq = 100
    tr = Trainer(cfg, device=dev)
    out["resident"] = resident_run(
        torch, fit_resident, tr, (tr.dataset.images, tr.dataset.params),
        card, f"fit_resident on {cfg.data.synthetic_size} dots crops "
        f"({tr.dataset.images.nbytes / 1e9:.2f} GB on the card), "
        "device_augment")
    del tr
    torch.cuda.empty_cache()
    cfg.data.streaming = True
    cfg.data.appearance = "shaded"
    tr = Trainer(cfg, device=dev)
    out["generative"] = resident_run(
        torch, fit_resident_generative, tr, (tr.dataset.params,), card,
        f"fit_resident_generative on {cfg.data.synthetic_size} shaded "
        "params (crops rendered on the card every step), device_augment")
    del tr
    torch.cuda.empty_cache()

    # -- 9e. the CLI's --resident ---------------------------------------------
    history = cli.main(["--resident", "--no-eval", "--synthetic-size",
                        str(2 * TRAIN_BATCH), "--batch-size",
                        str(TRAIN_BATCH), "--epochs", "1",
                        "--snapshot-dir", snap, "--log-file",
                        os.path.join(snap, "train_cli.log")])
    log(f"cli.train --resident: one epoch of 2 steps of {TRAIN_BATCH} on "
        f"the card, loss_total {history[1]['loss_total']:.4f}, skipped "
        f"{history[1]['skipped']}")
    if not np.isfinite(history[1]["loss_total"]) or \
            history[1]["skipped"] != 0.0:
        fail(f"cli.train --resident: {history}")
    out["cli_resident"] = history[1]
    return out


# The packaged API's 8 faces on the 720x1088 frame: rects inside it and
# over its left, top and right edges (x1, y1, x2, y2, score).
API_RECTS = [[60.0 + 125 * i, 90.0 + 70 * (i % 4), 190.0 + 125 * i,
              250.0 + 70 * (i % 4), 0.9] for i in range(8)]
API_RECTS[0][:2] = [-30.0, -20.0]
API_RECTS[7][2] = 1120.0
CHAIN_TOL = dict(rtol=1e-4, atol=1e-2)   # param62's 1e-4 through the decode
BOX_TOL = dict(rtol=1e-4, atol=0.05)     # f32 logits' 1e-4 through exp(0.2 x)
# The phase's frame: seed 5 keeps every candidate score of the default f32
# detector more than 1e-3 from the 0.5 visibility threshold, so the card's
# and the CPU's detections can be held face for face (checked in the run).
API_FRAME_SEED = 5


def api_phase(torch, dev, card):
    """The packaged two-stage API and the host renders on the card (phase
    10): launches of B1-B4 over the phase's own calls, each path held
    against the CPU or the plain twin, and times. Returns the numbers for
    the JSON line."""
    from synergynet_tpu_torch.detect import FaceBoxes
    from synergynet_tpu_torch.detect.detector import (VIS_THRESHOLD,
                                                      prepare_frame,
                                                      random_init_variables)
    from synergynet_tpu_torch.detect.stem_fused import (
        fused_stem1_s2d8, fused_stem1_s2d8_reference)
    from synergynet_tpu_torch.mm3d import rescale_to_roi, square_box
    from synergynet_tpu_torch.mm3d.codec import full_fp32
    from synergynet_tpu_torch.ops.fused_decode import (
        decode_dense_fused, decode_dense_fused_reference)
    from synergynet_tpu_torch.pipeline import (SynergyNet3DMM,
                                               UVTextureMapper,
                                               preprocess_crops)
    from synergynet_tpu_torch.pipeline.api import _crops_on
    from synergynet_tpu_torch.render import (
        OVERLAY_LIGHT_CFG, RenderPipeline, add_weighted_u8, rasterize,
        rasterize_mesh, rasterize_mesh_ids, rasterize_tiled,
        rasterize_triangles, render_overlay, render_texture)

    t_phase = time.perf_counter()
    ch, cw = CANVAS
    img = np.random.default_rng(API_FRAME_SEED).integers(0, 256, (ch, cw, 3),
                                                         np.uint8)
    det_x = FaceBoxes(random_init_variables(0), dtype=torch.bfloat16,
                      device=dev)
    det_p = FaceBoxes(random_init_variables(0), dtype=torch.bfloat16,
                      device=dev, stem_mode="pallas")
    det_f = FaceBoxes(device=dev)        # the API's default: f32, XLA stem
    api = SynergyNet3DMM(variables="trained", device=dev, detector=det_p)
    pipe = RenderPipeline(device=dev, **OVERLAY_LIGHT_CFG)
    tri = api.pack.tri.numpy()
    nver = api.pack.nver
    mapper = UVTextureMapper.synthetic(nver)
    uv = (np.stack([mapper.coord_v, mapper.coord_u], 1) / 255.0).astype(
        np.float32)
    texture = np.random.default_rng(11).integers(0, 256, (256, 256, 3),
                                                 np.uint8)
    colors = np.random.default_rng(12).uniform(0, 1, (FACES * nver, 3)
                                               ).astype(np.float32)
    tris_all = np.concatenate([tri.T + i * nver for i in range(FACES)]
                              ).astype(np.int32)
    torch.cuda.synchronize()

    # -- the phase's own calls: launches over these only ----------------------
    counters = {"B1 fused_decode": decode_dense_fused,
                "B2 raster_tiled": rasterize_mesh,
                "B3 raster_ids": rasterize_mesh_ids,
                "B4 stem_s2d8": fused_stem1_s2d8}
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    outs = {interp: api.get_all_outputs(img, rects=API_RECTS,
                                        interpolation=interp)
            for interp in ("lanczos4", "linear")}
    faces = {"xla": det_x(img), "pallas": det_p(img), "f32": det_f(img)}
    found = api.get_all_outputs(img)
    meshes = outs["lanczos4"][1]
    overlay, solid = render_overlay(img, meshes, tri, pipeline=pipe)
    textured = render_texture(meshes[0].T, tri.T, uv, texture, img,
                              device=dev)
    v_all = np.concatenate([m.T for m in meshes]).astype(np.float32)
    raster_out = {
        "rasterize_tiled": rasterize_tiled(v_all, tris_all, colors, bg=img,
                                           alpha=0.7, device=dev),
        "rasterize": rasterize(v_all, tris_all, colors, bg=img, alpha=0.7,
                               device=dev),
        "rasterize_triangles": rasterize_triangles(v_all, tris_all, h=ch,
                                                   w=cw, device=dev)}
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    calls_s = time.perf_counter() - t0
    log(f"packaged API + host renders: launches over the phase's calls "
        f"{launches} (get_all_outputs x3, FaceBoxes.__call__ x3, "
        f"render_overlay of {FACES} faces, render_texture, rasterize_tiled, "
        f"rasterize, rasterize_triangles), {calls_s:.1f} s")
    for k, n in launches.items():
        if n <= 0:
            fail(f"phase 10 never launched kernel {k}")

    # -- checks ---------------------------------------------------------------
    rois = np.stack([square_box(r) for r in API_RECTS])
    cpu = SynergyNet3DMM(variables="trained", device="cpu")
    crops_card = {}
    for interp, (pts, verts, poses) in outs.items():
        if len(pts) != FACES:
            fail(f"get_all_outputs {interp}: {len(pts)} faces")
        for lm, v, (ang, t) in zip(pts, verts, poses):
            if lm.shape != (3, 68) or v.shape != (3, nver) or \
                    ang.shape != (3,) or t.shape != (3,):
                fail(f"get_all_outputs {interp}: shapes {lm.shape} "
                     f"{v.shape}")
            if not all(np.isfinite(a).all() for a in (lm, v, ang, t)):
                fail(f"get_all_outputs {interp}: non-finite output")
        crops_card[interp] = preprocess_crops(img, rois, interp, device=dev)
        if not np.array_equal(crops_card[interp], preprocess_crops(
                img, rois, interp, device="cpu")):
            fail(f"preprocess_crops {interp}: the card differs from the CPU")
    # The dense meshes against kernel B1's plain twin on the path's param62.
    with full_fp32(), torch.inference_mode():
        p62 = api.process_crops(crops_card["lanczos4"], rois)[0]
        r_t = torch.tensor(rois.astype(np.float32), device=dev)
        ref = rescale_to_roi(decode_dense_fused_reference(
            torch.tensor(p62, device=dev), api.basis, api.pack_dev), r_t)
    got = torch.tensor(np.stack(meshes), device=dev)
    dense_err = (got - ref).abs().max().item()
    torch.testing.assert_close(got, ref, rtol=RTOL, atol=ATOL)
    # get_all_outputs on the card (its default: f32, TF32 off) against the
    # CPU.
    api_err = 0.0
    for interp in ("lanczos4", "linear"):
        want = cpu.get_all_outputs(img, rects=API_RECTS,
                                   interpolation=interp)
        for g, w_ in zip(outs[interp][0] + outs[interp][1],
                         want[0] + want[1]):
            np.testing.assert_allclose(g, w_, **CHAIN_TOL)
            api_err = max(api_err, float(np.abs(g - w_).max()))
    log(f"get_all_outputs, {FACES} rects on {ch}x{cw}, lanczos4 and linear: "
        f"shapes and finite; preprocess_crops card == CPU bit for bit; dense "
        f"vs B1's plain twin max_abs_err {dense_err:.3e} (rtol {RTOL}, atol "
        f"{ATOL}); card (f32, TF32 off) vs CPU max |difference| {api_err:.3e} "
        f"(rtol {CHAIN_TOL['rtol']}, atol {CHAIN_TOL['atol']})")
    # The default detector's host calls (f32, TF32 off) against the CPU,
    # face for face, on a frame that keeps every candidate score clear of
    # the visibility threshold.
    det_cpu = FaceBoxes(device="cpu")
    _, packed_c, hw_c, _ = prepare_frame(img, det_cpu.stem_r, "cpu")
    with torch.inference_mode():
        s_cpu, _ = det_cpu.candidates(packed_c[None], hw_c[None])
    margin = (s_cpu[s_cpu > 0] - VIS_THRESHOLD).abs().min().item()
    if margin <= 1e-3:
        fail(f"the frame's candidate scores come {margin:.2e} from the "
             "visibility threshold: pick a frame that keeps 1e-3 clear")
    raw_g, n_g = det_f.detect_raw(img)
    raw_c, n_c = det_cpu.detect_raw(img)
    if not n_g == n_c == len(faces["f32"]) > 0:
        fail(f"FaceBoxes default: {n_g} faces on the card (__call__ "
             f"{len(faces['f32'])}), {n_c} on the CPU")
    np.testing.assert_allclose(raw_g[:n_g, :4], raw_c[:n_c, :4], **BOX_TOL)
    np.testing.assert_allclose(raw_g[:n_g, 4], raw_c[:n_c, 4], rtol=0,
                               atol=1e-4)
    if faces["f32"] != [list(map(float, raw_g[i])) for i in range(n_g)]:
        fail("FaceBoxes default: __call__ differs from detect_raw")
    det_err = float(np.abs(raw_g[:n_g, :4] - raw_c[:n_c, :4]).max())
    # The fused stem (B4) inside the bf16 host call, on this frame's stem
    # input, against its twin on the CPU. The bf16 detector as a whole is
    # not held against the CPU: bf16 rounding through the random-init net
    # moves scores by up to 0.09 and boxes by tens of pixels between bf16
    # and f32 on one device, so its faces are compared between the stems.
    stem = det_p.net.conv1_s2d8
    _, packed_g, _, _ = prepare_frame(img, det_p.stem_r, dev)
    x_g = (packed_g[None] - det_p.mean).to(torch.bfloat16)
    with torch.inference_mode():
        got_s = fused_stem1_s2d8(x_g, stem.tap_weights(), stem.bias.detach())
        want_s = fused_stem1_s2d8_reference(
            x_g.cpu(), stem.tap_weights().cpu(), stem.bias.detach().cpu())
    torch.testing.assert_close(got_s.cpu().float(), want_s.float(),
                               **STEM_TOL)
    stem_err = (got_s.cpu().float() - want_s.float()).abs().max().item()
    # The two bf16 stems' detections: counts, and each fused-stem box
    # against the nearest XLA-stem box (the stems round to bf16 at
    # different points, and near-equal scores may order the boxes
    # differently). Printed only.
    n_x, n_p = len(faces["xla"]), len(faces["pallas"])
    if n_p <= 0 or len(found[0]) != n_p:
        fail(f"get_all_outputs without rects: {len(found[0])} faces, the "
             f"detector {n_p}")
    if not all(np.isfinite(v).all() for v in found[1]):
        fail("get_all_outputs without rects: non-finite meshes")
    bx = np.asarray(faces["xla"])[:, :4]
    bp = np.asarray(faces["pallas"])[:, :4]
    near = np.abs(bp[:, None] - bx[None]).max(-1).min(-1)
    rel = near / np.maximum(np.abs(bp).max(-1), 1.0)
    log(f"FaceBoxes() default (f32, TF32 off) on {ch}x{cw}: {n_g} faces on "
        f"the card and on the CPU, boxes within {det_err:.3e} px (rtol "
        f"{BOX_TOL['rtol']}, atol {BOX_TOL['atol']}), scores 1e-4, the "
        f"frame's candidate scores {margin:.2e} clear of {VIS_THRESHOLD}; "
        f"B4 inside the bf16 host call vs its twin on the CPU: max_abs_err "
        f"{stem_err:.3e} (rtol {STEM_TOL['rtol']}, atol {STEM_TOL['atol']})")
    log(f"FaceBoxes(random_init_variables(0)) bf16 on {ch}x{cw}: {n_x} faces "
        f"with the XLA stem, {n_p} with the fused stem (B4); each fused-stem "
        f"box against the nearest XLA-stem box: largest difference "
        f"{near.max():.3f} px ({rel.max():.2e} of the box's largest "
        f"coordinate), {(near <= 1.0).mean():.3f} within 1 px; "
        f"get_all_outputs without rects: {len(found[0])} faces, finite")
    # The host renders against the same calls on the CPU.
    pipe_cpu = RenderPipeline(device="cpu", **OVERLAY_LIGHT_CFG)
    ov_c, solid_c = render_overlay(img, meshes, tri, pipeline=pipe_cpu)
    drawn = (solid != img).any(-1)
    if not np.array_equal(drawn, (solid_c != img).any(-1)):
        fail("render_overlay: the card draws other pixels than the CPU")
    solid_diff = np.abs(solid.astype(int) - solid_c)
    ov_diff = int(np.abs(overlay.astype(int) - ov_c).max())
    if max(ov_diff, solid_diff.max()) > 1:
        fail(f"render_overlay: card vs CPU differ by "
             f"{max(ov_diff, solid_diff.max())} levels")
    tex_c = render_texture(meshes[0].T, tri.T, uv, texture, img,
                           device="cpu")
    if not np.array_equal(textured, tex_c):
        fail("render_texture: the card differs from the CPU")
    for name, got_r in raster_out.items():
        if name == "rasterize_triangles":
            want_r = rasterize_triangles(v_all, tris_all, h=ch, w=cw,
                                         device="cpu")
            same = all(torch.equal(g.cpu(), w_) for g, w_ in zip(got_r,
                                                                 want_r))
        else:
            fn = rasterize_tiled if name == "rasterize_tiled" else rasterize
            same = np.array_equal(got_r, fn(v_all, tris_all, colors, bg=img,
                                            alpha=0.7, device="cpu"))
        if not same:
            fail(f"{name}: the card differs from its CPU twin")
    log(f"render_overlay of {FACES} faces on {ch}x{cw}: {drawn.mean():.3f} of "
        f"the frame drawn, the same pixels as on the CPU, solid within "
        f"{solid_diff.max()} level of it on {(solid_diff > 0).any(-1).mean():.2e}"
        f" of pixels (the light's last bit), overlay within {ov_diff}; "
        "render_texture (synthetic UVTextureMapper, seeded 256x256 texture) "
        "== CPU; rasterize_tiled, rasterize, rasterize_triangles == their "
        "CPU twins bit for bit")

    # -- times: CUDA events around each whole call, after warm-up -------------
    frame = torch.from_numpy(img).to(dev)
    crops_t = _crops_on(frame, rois, "lanczos4")
    rois_t = torch.tensor(rois.astype(np.float32), device=dev)
    outs_t = api._process(crops_t, rois_t)
    tris_t = torch.from_numpy(np.ascontiguousarray(tri.T)).to(dev)
    rings_t = pipe.rings(np.ascontiguousarray(tri.T), nver)
    verts_t = torch.from_numpy(np.ascontiguousarray(meshes[0].T)).to(dev)
    solid_t = pipe.render(verts_t, tris_t, frame, rings_t)
    calls = (
        ("get_all_outputs, 8 rects, lanczos4 (f32, TF32 off)", lambda:
            api.get_all_outputs(img, rects=API_RECTS), 10),
        ("get_all_outputs, 8 rects, linear (f32, TF32 off)", lambda:
            api.get_all_outputs(img, rects=API_RECTS,
                                interpolation="linear"), 10),
        ("FaceBoxes.__call__, fused stem (bf16)", lambda: det_p(img), 10),
        ("FaceBoxes.__call__, default (f32, TF32 off)", lambda: det_f(img),
         10),
        ("render_overlay, 1 face", lambda: render_overlay(
            img, meshes[:1], tri, pipeline=pipe), 10),
        (f"render_overlay, {FACES} faces", lambda: render_overlay(
            img, meshes, tri, pipeline=pipe), 5),
        ("render_texture", lambda: render_texture(
            meshes[0].T, tri.T, uv, texture, img, device=dev), 10))
    # Stages of get_all_outputs (the preprocess stage first) and of
    # render_overlay, each timed alone on the same inputs.
    stages = (
        ("get_all_outputs: preprocess (frame upload + lanczos4 crops)",
         lambda: _crops_on(torch.from_numpy(img).to(dev), rois,
                           "lanczos4"), 10),
        ("get_all_outputs: lanczos4 crops alone, frame on the card",
         lambda: _crops_on(frame, rois, "lanczos4"), 10),
        ("get_all_outputs: regress + decode (B1) on the card", lambda:
            api._process(crops_t, rois_t), 10),
        ("get_all_outputs: outputs to the host", lambda: [
            x.cpu().numpy() for x in outs_t], 10),
        ("render_overlay: frame + topology upload", lambda: (
            torch.from_numpy(img).to(dev),
            torch.from_numpy(np.ascontiguousarray(tri.T)).to(dev)), 10),
        ("render_overlay: ring table lookup (host hash)", lambda:
            pipe.rings(np.ascontiguousarray(tri.T), nver), 10),
        ("render_overlay: one face on the card (normals, light, B2, blend)",
         lambda: pipe.render(verts_t, tris_t, frame, rings_t), 10),
        ("render_overlay: solid to the host", lambda: solid_t.cpu().numpy(),
         10),
        ("render_overlay: add_weighted_u8 (host, float64)", lambda:
            add_weighted_u8(img, 0.4, solid, 0.6), 10))
    times = {name: time_ms(fn, n, torch) for name, fn, n in calls}
    stage_ms = {name: time_ms(fn, n, torch) for name, fn, n in stages}
    log("phase 10 times, ms per call (CUDA events, mean after 2 warm-ups): "
        + ", ".join(f"{k} {v:.3f}" for k, v in times.items())
        + f" | {card}")
    log("phase 10 stages, ms (the same timing): " + ", ".join(
        f"{k} {v:.3f}" for k, v in stage_ms.items()) + f" | {card}")
    secs = time.perf_counter() - t_phase
    log(f"phase 10 (packaged API + host renders): {secs:.1f} s")
    return {"launches": launches, "times_ms": times, "stages_ms": stage_ms,
            "dense_err": dense_err,
            "card_vs_cpu_err": api_err, "faces_xla": n_x, "faces_fused": n_p,
            "faces_f32": n_g, "det_box_err_px": det_err,
            "det_score_margin": margin, "stem_err": stem_err,
            "stem_box_diff_px": float(near.max()),
            "drawn_share": float(drawn.mean()), "seconds": secs}


# -- 11. model families and reference weights ---------------------------------

# One representative of each backbone family at its published widths.
FAMILY_ARCHS = ("mobilenet_1", "resnet50", "resnext50_32x4d", "ghostnet",
                "resnest50", "mobilenet_v2_1.4")
# The detector phase's parity frame: seeded reference-layout weights
# (seed 0) on this 120x160 frame keep every candidate score more than 1e-3
# from the 0.5 visibility threshold (checked in the run), so the card's
# and the CPU's detections can be held face for face.
DET_FRAME = ((120, 160), 1)
# B4's f32 entry against its twin: both sum 768 f32 products, in another
# order; no worse than 1e-5 of the output's largest magnitude.
STEM_F32_REL = 1e-5


def stem_f32_stalls(torch, dev, launch, x, k4, bias):
    """Where B4's f32 product loop waits: one launch of the kernel's
    clock64-stamped build (``launch(..., stamps=)``, its output checked
    equal to the plain build's), and the shares of all warps' cycles spent
    waiting for window chunks (their barrier and the block barrier before
    the products), in the products, in epilogue + pool, and in the rest
    (staging the taps); and warps 0-3's product cycles over warps 4-7's."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stamps = torch.zeros(sms * 8 * 4, dtype=torch.int64, device=dev)
    got = launch(x, k4, bias, stamps=stamps)
    if not torch.equal(got, launch(x, k4, bias)):
        fail("B4 f32 entry: the stamped build's output differs")
    s = stamps.view(-1, 8, 4).double()
    s = s[s[:, 0, 3] > 0]
    tot = s.sum((0, 1))
    parts = dict(zip(("wait", "products", "epilogue_pool"),
                     (tot[:3] / tot[3]).tolist()))
    parts["rest"] = 1.0 - sum(parts.values())
    # Warps 0-3 also take the two left-over m16 tiles.
    mma = s[:, :, 1].mean(0)
    parts["products_w0_3_over_w4_7"] = (mma[:4].mean() / mma[4:].mean()).item()
    return {k: round(v, 4) for k, v in parts.items()}


def families_phase(torch, dev, card, frames, frames_s2d, hws, det_bf16):
    """Every backbone family and the reference weights on the card (phase
    11): for each of ``FAMILY_ARCHS`` a reference-layout ``best.pth.tar``
    made from a seed and loaded through ``nn/torch_import``, served by
    ``SynergyNet3DMM`` (``get_all_outputs`` with 8 rects in f32, TF32
    off, against the CPU) and ``FusedFrameEngine.process_batch`` at 128
    frames in bf16, B1 launched in each; the detector from a seeded
    ``FaceBoxesProd.pth`` in f32 with the fused stem (B4's f32 entry),
    stem_r=4 and the 3-channel stem, each against the CPU face for face;
    and B4's f32 entry against its twin, cuDNN's f32 conv with TF32 off,
    its 3xTF32 and FMA-unit bounds and its stall shares at 1 and 128
    frames. Returns the numbers for the JSON line."""
    import torch.nn.functional as F

    from synergynet_tpu_torch.detect import FaceBoxes
    from synergynet_tpu_torch.detect.detector import (VIS_THRESHOLD,
                                                      prepare_frame)
    from synergynet_tpu_torch.detect import stem_fused
    from synergynet_tpu_torch.detect.stem_fused import (
        fused_stem1_s2d8, fused_stem1_s2d8_reference)
    from synergynet_tpu_torch.detect.torch_import import \
        seeded_faceboxes_state_dict
    from synergynet_tpu_torch.mm3d import rescale_to_roi
    from synergynet_tpu_torch.mm3d.codec import full_fp32
    from synergynet_tpu_torch.nn.torch_import import (
        expected_torch_shapes, load_synergynet_variables,
        seeded_torch_state_dict)
    from synergynet_tpu_torch.ops.fused_decode import (
        decode_dense_fused, decode_dense_fused_reference)
    from synergynet_tpu_torch.mm3d import load_param_pack
    from synergynet_tpu_torch.pipeline import (FusedFrameEngine,
                                               SynergyNet3DMM)

    t_phase = time.perf_counter()
    ch, cw = CANVAS
    pack = load_param_pack()
    img = np.random.default_rng(API_FRAME_SEED).integers(0, 256, (ch, cw, 3),
                                                         np.uint8)
    tmp = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke_weights")
    os.makedirs(tmp, exist_ok=True)
    families = {}
    b = frames.shape[0]
    for i, arch in enumerate(FAMILY_ARCHS):
        t0 = time.perf_counter()
        sd = seeded_torch_state_dict(expected_torch_shapes(arch), 10 + i)
        path = os.path.join(tmp, f"{arch}.pth.tar")
        torch.save({"state_dict": {"module." + k: v for k, v in sd.items()}},
                   path)
        tree = load_synergynet_variables(path, arch=arch)
        api32 = SynergyNet3DMM(variables=tree, arch=arch, pack=pack,
                               device=dev)
        api16 = SynergyNet3DMM(variables=tree, arch=arch,
                               dtype=torch.bfloat16,
                               pack=pack, device=dev)
        eng = FusedFrameEngine(api16, detector=det_bf16, max_faces=FACES)
        # The family's own calls: launches over these only.
        decode_dense_fused.launches = 0
        got = api32.get_all_outputs(img, rects=API_RECTS)
        out = eng.process_batch(frames, frames_s2d, hws)
        torch.cuda.synchronize()
        launches = decode_dense_fused.launches
        if launches <= 0:
            fail(f"phase 11 {arch}: never launched kernel B1")
        want = SynergyNet3DMM(variables=tree, arch=arch, pack=pack,
                              device="cpu").get_all_outputs(
                                  img, rects=API_RECTS)
        if [len(x) for x in got] != [FACES] * 3:
            fail(f"phase 11 {arch}: get_all_outputs gave "
                 f"{[len(x) for x in got]} faces")
        err = 0.0
        for g, w_ in zip(got[0] + got[1] + [t for p in got[2] for t in p],
                         want[0] + want[1] + [t for p in want[2] for t in p]):
            if not np.isfinite(g).all():
                fail(f"phase 11 {arch}: non-finite get_all_outputs")
            np.testing.assert_allclose(g, w_, **CHAIN_TOL)
            err = max(err, float(np.abs(g - w_).max()))
        shapes = [tuple(x.shape) for x in out]
        if shapes[3] != (b, FACES, 62) or shapes[5] != (b, FACES, 3, 53215):
            fail(f"phase 11 {arch}: process_batch shapes {shapes}")
        if not all(torch.isfinite(x).all() for x in out[2:]):
            fail(f"phase 11 {arch}: non-finite process_batch outputs")
        # B1 against its twin on the path's own param62, in the decode's
        # units (the kernel's tolerance), and the path's dense mesh equal to
        # the kernel's output rescaled to the rois.
        with torch.inference_mode():
            flat_p, flat_r = out[3].reshape(-1, 62), out[2].reshape(-1, 4)
            kern = decode_dense_fused(flat_p, api16.basis, api16.pack_dev)
            ref = decode_dense_fused_reference(flat_p, api16.basis,
                                               api16.pack_dev)
            torch.testing.assert_close(kern, ref, rtol=RTOL, atol=ATOL)
            if not torch.equal(out[5].reshape(kern.shape),
                               rescale_to_roi(kern, flat_r)):
                fail(f"phase 11 {arch}: process_batch's dense mesh differs "
                     "from B1's output rescaled to its rois")
        del out, kern, ref
        ms_api = time_ms(lambda: api32.get_all_outputs(img, rects=API_RECTS),
                         5, torch)
        ms_b = time_ms(lambda: eng.process_batch(frames, frames_s2d, hws), 3,
                       torch)
        families[arch] = {
            "params_m": sum(v.numel() for v in sd.values()) / 1e6,
            "launches_b1": launches, "card_vs_cpu_err": err,
            "get_all_outputs_ms": ms_api,
            "get_all_outputs_faces_per_s": FACES / ms_api * 1e3,
            "process_batch_ms": ms_b,
            "process_batch_faces_per_s": b * FACES / ms_b * 1e3}
        log(f"phase 11 {arch} ({families[arch]['params_m']:.1f}M values in "
            f"a seeded best.pth.tar, imported): B1 launched "
            f"{launches} times; get_all_outputs 8 rects f32 (TF32 off) card "
            f"vs CPU max |difference| {err:.3e} (rtol {CHAIN_TOL['rtol']}, "
            f"atol {CHAIN_TOL['atol']}), {ms_api:.3f} ms per call, "
            f"{FACES / ms_api * 1e3:.1f} faces/s; process_batch B={b} bf16 "
            f"{ms_b:.3f} ms per call, {b * FACES / ms_b * 1e3:.1f} faces/s; "
            f"{time.perf_counter() - t0:.1f} s | {card}")
        del api32, api16, eng
        torch.cuda.empty_cache()

    # -- the detector from a seeded FaceBoxesProd.pth ------------------------
    path = os.path.join(tmp, "FaceBoxesProd.pth")
    torch.save({"module." + k: v for k, v in
                seeded_faceboxes_state_dict(0).items()}, path)
    (fh, fw), fseed = DET_FRAME
    small = np.random.default_rng(fseed).integers(0, 256, (fh, fw, 3),
                                                  np.uint8)
    topologies = (("fused stem (B4 f32), stem_r=8", dict(stem_mode="pallas")),
                  ("stem_r=4", dict(stem_r=4)),
                  ("3-channel stem", dict(stem_s2d=False)))
    detectors = {}
    for name, kw in topologies:
        det = FaceBoxes(weights_path=path, device=dev, **kw)
        cpu = FaceBoxes(weights_path=path, device="cpu", **kw)
        fused_stem1_s2d8.launches_f32 = 0
        raw_g, n_g = det.detect_raw(small)
        faces = det(small)
        torch.cuda.synchronize()
        f32_launches = fused_stem1_s2d8.launches_f32
        if "pallas" in kw.values() and f32_launches <= 0:
            fail("phase 11: the f32 fused-stem detector never launched B4's "
                 "f32 entry")
        _, packed_c, hw_c, _ = prepare_frame(small, cpu.stem_r, "cpu")
        with torch.inference_mode():
            s_cpu, _ = cpu.candidates(packed_c[None], hw_c[None])
        margin = (s_cpu[s_cpu > 0] - VIS_THRESHOLD).abs().min().item()
        if margin <= 1e-3:
            fail(f"phase 11 detector {name}: the frame's candidate scores "
                 f"come {margin:.2e} from the visibility threshold")
        raw_c, n_c = cpu.detect_raw(small)
        if not n_g == n_c == len(faces) > 0:
            fail(f"phase 11 detector {name}: {n_g} faces on the card, {n_c} "
                 "on the CPU")
        np.testing.assert_allclose(raw_g[:n_g, :4], raw_c[:n_c, :4],
                                   **BOX_TOL)
        np.testing.assert_allclose(raw_g[:n_g, 4], raw_c[:n_c, 4], rtol=0,
                                   atol=1e-4)
        box_err = float(np.abs(raw_g[:n_g, :4] - raw_c[:n_c, :4]).max())
        ms = time_ms(lambda: det(img), 5, torch)
        detectors[name] = {"faces": n_g, "box_err_px": box_err,
                           "score_margin": margin, "ms_720x1088": ms,
                           "launches_f32": f32_launches}
        log(f"phase 11 detector {name} (f32, from a seeded "
            f"FaceBoxesProd.pth): {n_g} faces on {fh}x{fw}, card = CPU face "
            f"for face (boxes within {box_err:.3e} px, scores 1e-4, "
            f"{margin:.2e} clear of {VIS_THRESHOLD}); B4 f32 launches "
            f"{f32_launches}; __call__ on {ch}x{cw} {ms:.3f} ms | {card}")
    stem_det = FaceBoxes(weights_path=path, device=dev, stem_mode="pallas")

    # -- B4's f32 entry vs its twin, cuDNN's f32 conv and the bound -----------
    stem = stem_det.net.conv1_s2d8
    k4, s_bias = stem.tap_weights(), stem.bias.detach()
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    stem_f32 = {}
    with torch.inference_mode():
        for nb in (1, b):
            xb = (frames_s2d[:nb] - stem_det.mean).contiguous()
            got = fused_stem1_s2d8(xb, k4, s_bias)
            want = fused_stem1_s2d8_reference(xb, k4, s_bias)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            scale = want.abs().max().item()
            if not err <= STEM_F32_REL * scale:
                fail(f"B4 f32 entry B={nb}: max_abs_err {err:.3e} > "
                     f"{STEM_F32_REL} x {scale:.3e}")
            del got, want
            spread = time_spread(lambda: fused_stem1_s2d8(xb, k4, s_bias), 20,
                                 torch, flush_buf.zero_)
            plain = time_ms(lambda: fused_stem1_s2d8_reference(
                xb, k4, s_bias), 5, torch, flush_buf.zero_)
            # The library yardstick: cuDNN's f32 conv with bias on the
            # pre-padded input, TF32 off, without the pool.
            xpad = F.pad(xb.permute(0, 3, 1, 2), (1, 0, 1, 0)).contiguous(
                memory_format=torch.channels_last)
            with full_fp32():
                lib = time_spread(lambda: F.conv2d(xpad, stem.weight,
                                                   stem.bias),
                                  20, torch, flush_buf.zero_)[1]
            del xpad
            # The products run as 3xTF32 on the tensor cores (three TF32
            # MMAs a product); the FMA units' bound on the same work beside.
            npos = nb * xb.shape[1] * xb.shape[2]
            nbytes = 4 * (xb.numel() + k4.numel() + npos * 48 + 192)
            conv_flops = 2 * npos * 768 * 192
            s_bound = bound(nbytes, 3 * conv_flops, TF32_FLOPS)
            fma_bound = bound(nbytes, conv_flops + 9 * npos * 48, F32_FLOPS)
            stalls = stem_f32_stalls(torch, dev, stem_fused._launch, xb, k4,
                                     s_bias)
            stem_f32[nb] = {"ms": spread[1], "ms_min": spread[0],
                            "ms_max": spread[2], "plain_ms": plain,
                            "library_ms": lib, "bound_ms": s_bound[0],
                            "bound_by": s_bound[1],
                            "bound_fma_ms": fma_bound[0],
                            "max_abs_err": err, "out_scale": scale,
                            "stall_shares": stalls}
            log(f"stem_s2d8 f32 entry B={nb} ({tuple(xb.shape)} f32, "
                f"3xTF32): max_abs_err {err:.3e} of {scale:.3e} (limit "
                f"{STEM_F32_REL} of it) | kernel min/median/max "
                f"{spread[0]:.4f} / {spread[1]:.4f} / {spread[2]:.4f} ms over "
                f"20 | plain {plain:.4f} ms | cuDNN f32 conv (TF32 off) alone "
                f"{lib:.4f} ms | 3xTF32 bound {s_bound[0]:.4f} ms "
                f"({s_bound[1]}), FMA-unit bound {fma_bound[0]:.4f} ms | "
                f"{s_bound[0] / spread[1]:.3f} of the 3xTF32 bound, "
                f"{spread[1] / lib:.3f}x the cuDNN conv | clock64 shares per "
                f"warp: {stalls} | {card}")
            del xb
    del flush_buf
    torch.cuda.empty_cache()
    secs = time.perf_counter() - t_phase
    log(f"phase 11 (model families and reference weights): {secs:.1f} s")
    return {"families": families, "detectors": detectors,
            "stem_f32": {str(k): v for k, v in stem_f32.items()},
            "launches_f32": detectors[topologies[0][0]]["launches_f32"],
            "seconds": secs}


# -- 12. reference-data ingest, the evaluation CLI, the f32 engine ------------

# The evaluation CLI's defaults: 512 synthetic samples, batch 128.
EVAL_N, EVAL_BATCH = 512, 128
EVAL_ATOL = 1e-3        # NME (percent) and FOE (degrees), card vs CPU
ENGINE_MESH_TOL = dict(rtol=1e-4, atol=1e-3)   # the dense decode's, f32


def write_reference_bfm(tmp, d, rng):
    """``d`` (an asset dict) written as the reference's ``3dmm_data/``
    (npy bases, the whitening pickle, a 1-based ``tri.mat``) and as a raw
    BFM ``.mat`` in the ``model_refine`` layout (bases padded with columns
    the conversion trims, 1-based keypoints and triangles) with its
    whitening pickle. -> (3dmm_data dir, .mat path, .pkl path)."""
    import pickle

    import scipy.io as sio

    ref = os.path.join(tmp, "3dmm_data")
    os.makedirs(ref, exist_ok=True)
    for name, key in (("u_shp", "u_shp"), ("u_exp", "u_exp"),
                      ("w_shp_sim", "w_shp"), ("w_exp_sim", "w_exp"),
                      ("keypoints_sim", "keypoints")):
        np.save(os.path.join(ref, name + ".npy"), d[key])
    pkl = os.path.join(ref, "param_whitening.pkl")
    with open(pkl, "wb") as f:
        pickle.dump({"param_mean": d["param_mean"],
                     "param_std": d["param_std"]}, f)
    sio.savemat(os.path.join(ref, "tri.mat"),
                {"tri": d["tri"].astype(np.float64) + 1})
    nv3 = d["w_shp"].shape[0]
    kp_vert = (d["keypoints"].reshape(-1, 3)[:, 0] // 3).astype(np.float64)
    mat = os.path.join(tmp, "BFM_model_front.mat")
    sio.savemat(mat, {"model_refine": {
        "w": np.concatenate([d["w_shp"], rng.normal(0, 5, (nv3, 20))], 1),
        "w_exp": np.concatenate([d["w_exp"], rng.normal(0, 2, (nv3, 19))],
                                1),
        "mu_shape": d["u_shp"].astype(np.float64),
        "mu_exp": d["u_exp"].astype(np.float64),
        "keypoints": (kp_vert + 1.0)[None, :],
        "tri": d["tri"].astype(np.int64) + 1}})
    return ref, mat, pkl


def engine_faces(torch, engine, img):
    """``engine.process_batch`` on one frame -> (n faces, rois (n, 4),
    dense (n, 3, N)) as numpy."""
    from synergynet_tpu_torch.detect.detector import prepare_frame
    canvas, packed, hw, _ = prepare_frame(img, engine.detector.stem_r,
                                          engine.api.device)
    out = engine.process_batch(canvas[None], packed[None], hw[None])
    n = int(out[1][0])
    return n, out[2][0, :n].cpu().numpy(), out[5][0, :n].cpu().numpy()


def tf32_flags(torch):
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def ingest_eval_phase(torch, dev, card):
    """Reference-data ingest, the evaluation CLI and the f32 engine on the
    card (phase 12). Returns the numbers for the JSON line."""
    from synergynet_tpu_torch.cli import evaluate as cli_evaluate
    from synergynet_tpu_torch.core.checkpoint import shipped_trained_path
    from synergynet_tpu_torch.data import (make_synthetic_aflw2000,
                                           save_eval_pack)
    from synergynet_tpu_torch.detect import FaceBoxes
    from synergynet_tpu_torch.detect.detector import random_init_variables
    from synergynet_tpu_torch.mm3d import assets
    from synergynet_tpu_torch.nn.torch_import import (expected_torch_shapes,
                                                      seeded_torch_state_dict)
    from synergynet_tpu_torch.ops.fused_decode import (
        decode_dense_fast, decode_dense_fused, decode_dense_fused_reference,
        get_decode_basis)
    from synergynet_tpu_torch.pipeline import FusedFrameEngine, SynergyNet3DMM
    from synergynet_tpu_torch.pipeline import api as api_module

    t_phase = time.perf_counter()
    tmp = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke_ingest")
    os.makedirs(tmp, exist_ok=True)
    out = {}

    # -- the converters, the converted pack on the card, B1 on it -------------
    t0 = time.perf_counter()
    src = assets.make_synthetic_assets(seed=5)
    ref_dir, mat, pkl = write_reference_bfm(tmp, src,
                                            np.random.default_rng(99))
    converted = {"3dmm_data": assets.convert_reference_assets(ref_dir),
                 "raw BFM": assets.convert_raw_bfm(mat, pkl)}
    for name, d in converted.items():
        for k in src:
            if not np.array_equal(d[k], src[k]):
                fail(f"phase 12: convert {name} changed {k}")
    bfm = os.path.join(tmp, "converted_bfm.npz")
    assets.save_assets_npz(bfm, converted["raw BFM"])
    before_env = os.environ.get("SYNERGY_BFM")
    os.environ["SYNERGY_BFM"] = bfm
    try:
        pack = assets.device_pack(assets.load_param_pack(), dev)
    finally:
        if before_env is None:
            os.environ.pop("SYNERGY_BFM")
        else:
            os.environ["SYNERGY_BFM"] = before_env
    convert_s = time.perf_counter() - t0
    rng = np.random.default_rng(12)
    params = {b: torch.tensor(rng.normal(0, 1, (b, 62)).astype(np.float32),
                              device=dev) for b in (FACES, FACES * BATCH)}
    torch.cuda.synchronize()
    decode_dense_fused.launches = 0
    fast = {b: decode_dense_fast(p, pack) for b, p in params.items()}
    torch.cuda.synchronize()
    launches = decode_dense_fused.launches
    if launches <= 0:
        fail("phase 12: decode_dense_fast never launched kernel B1")
    basis = get_decode_basis(pack)
    if get_decode_basis(pack) is not basis or basis.w.device != dev:
        fail("phase 12: the decode basis is not cached on the pack's device")
    dense_err = 0.0
    for b, p in params.items():
        want = decode_dense_fused_reference(p, basis, pack)
        torch.testing.assert_close(fast[b], want, rtol=RTOL, atol=ATOL)
        dense_err = max(dense_err, (fast[b] - want).abs().max().item())
    del fast
    out["converters"] = {"seconds": convert_s, "launches_b1": launches,
                         "max_abs_err": dense_err, "nver": pack.nver}
    log(f"phase 12 converters: 3dmm_data/ and a raw BFM .mat "
        f"({pack.nver} vertices) converted bit for bit, the raw one "
        f"installed through $SYNERGY_BFM and loaded onto the card in "
        f"{convert_s:.1f} s; decode_dense_fast on {FACES} and "
        f"{FACES * BATCH} faces: B1 launched {launches} times, max_abs_err "
        f"{dense_err:.3e} against its twin (rtol {RTOL}, atol {ATOL}) | "
        f"{card}")
    del pack, basis
    torch.cuda.empty_cache()

    # -- the evaluation CLI, card vs CPU --------------------------------------
    npz = save_eval_pack(make_synthetic_aflw2000(EVAL_N, device=dev),
                         os.path.join(tmp, "aflw2000_synthetic.npz"))
    pth = os.path.join(tmp, "resnet50.pth.tar")
    torch.save({"state_dict": {"module." + k: v for k, v in
                               seeded_torch_state_dict(
                                   expected_torch_shapes("resnet50"),
                                   11).items()}}, pth)
    evals = {}
    for label, wargs in (("mobilenet_v2 shipped .npz",
                          ["-w", shipped_trained_path()]),
                         ("resnet50 seeded .pth.tar",
                          ["-w", pth, "--arch", "resnet50"])):
        argv = wargs + ["--aflw2000-npz", npz, "--batch-size",
                        str(EVAL_BATCH)]
        runs = {}
        for where, extra in (("card", []), ("cpu", ["--platform", "cpu"])):
            t0 = time.perf_counter()
            r = cli_evaluate.main(argv + extra)
            if where == "card":
                torch.cuda.synchronize()
            runs[where] = (r, time.perf_counter() - t0)
        (g, g_s), (c, c_s) = runs["card"], runs["cpu"]
        diffs = {"nme_mean": abs(g["nme_mean"] - c["nme_mean"]),
                 "foe_mae_mean": abs(g["foe"]["mae_mean"]
                                     - c["foe"]["mae_mean"])}
        for name in ("[ 0, 30]", "[30, 60]", "[60, 90]"):
            if g["nme"][name]["count"]:
                diffs[name] = abs(g["nme"][name]["mean"]
                                  - c["nme"][name]["mean"])
        if not (np.isfinite(g["nme_mean"]) and np.isfinite(
                g["foe"]["mae_mean"])):
            fail(f"phase 12 evaluate {label}: non-finite report")
        if max(diffs.values()) > EVAL_ATOL:
            fail(f"phase 12 evaluate {label}: card vs CPU {diffs} > "
                 f"{EVAL_ATOL}")
        evals[label] = {"nme_mean": g["nme_mean"],
                        "foe_mae_mean": g["foe"]["mae_mean"],
                        "max_card_cpu_diff": max(diffs.values()),
                        "card_ms": g_s * 1e3, "cpu_ms": c_s * 1e3,
                        "card_images_per_s": EVAL_N / g_s,
                        "cpu_images_per_s": EVAL_N / c_s}
        log(f"phase 12 evaluate ({label}, {EVAL_N} synthetic samples from "
            f"--aflw2000-npz, batch {EVAL_BATCH}, f32 TF32 off): NME "
            f"{g['nme_mean']:.4f} FOE {g['foe']['mae_mean']:.4f}, card vs "
            f"CPU max |difference| {max(diffs.values()):.3e} (atol "
            f"{EVAL_ATOL}); one CLI call (host clock, model build and "
            f"weights included) card {g_s * 1e3:.1f} ms = "
            f"{EVAL_N / g_s:.1f} images/s, CPU {c_s * 1e3:.1f} ms = "
            f"{EVAL_N / c_s:.1f} images/s | {card}")
    out["evaluate"] = evals

    # -- C11: the f32 engine on the card, TF32 off ----------------------------
    ch, cw = CANVAS
    img = np.random.default_rng(API_FRAME_SEED).integers(0, 256, (ch, cw, 3),
                                                         np.uint8)
    eng = FusedFrameEngine(SynergyNet3DMM(variables="trained", device=dev))
    cpu = FusedFrameEngine(SynergyNet3DMM(variables="trained", device="cpu"))
    flags_before = tf32_flags(torch)
    n, rois, dense = engine_faces(torch, eng, img)
    flags_after = tf32_flags(torch)
    if flags_after != flags_before:
        fail(f"phase 12: the f32 engine left the TF32 flags at "
             f"{flags_after}, found {flags_before}")
    n_c, rois_c, dense_c = engine_faces(torch, cpu, img)
    if not n == n_c > 0:
        fail(f"phase 12 f32 engine: {n} faces on the card, {n_c} on the CPU")
    np.testing.assert_allclose(rois, rois_c, **BOX_TOL)
    np.testing.assert_allclose(dense, dense_c, **ENGINE_MESH_TOL)
    roi_err = float(np.abs(rois - rois_c).max())
    mesh_err = float(np.abs(dense - dense_c).max())
    mesh_excess = float((np.abs(dense - dense_c) - ENGINE_MESH_TOL["rtol"]
                         * np.abs(dense_c)).max())

    # One TF32 pass: the engine without its guard and with TF32 forced on
    # for cuBLAS and cuDNN, against the same CPU faces.
    def unguarded():
        real = api_module.full_fp32_if
        api_module.full_fp32_if = lambda dtype: contextlib.nullcontext()
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        return real

    def guarded(real):
        api_module.full_fp32_if = real
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags_before

    real = unguarded()
    try:
        n_t, rois_t, dense_t = engine_faces(torch, eng, img)
    finally:
        guarded(real)
    tf32 = {"faces": n_t}
    if n_t == n_c:
        tf32["roi_err_px"] = float(np.abs(rois_t - rois_c).max())
        tf32["mesh_err"] = float(np.abs(dense_t - dense_c).max())
        tf32["mesh_excess"] = float((np.abs(dense_t - dense_c)
                                     - ENGINE_MESH_TOL["rtol"]
                                     * np.abs(dense_c)).max())
        tf32["within_tolerance"] = bool(
            np.allclose(rois_t, rois_c, **BOX_TOL)
            and np.allclose(dense_t, dense_c, **ENGINE_MESH_TOL))
    else:
        tf32["within_tolerance"] = False

    # Times at B=1: the f32 engine with its guard and without it (TF32
    # forced on) in turns, and the bf16 engine of phase 4.
    from synergynet_tpu_torch.detect.detector import prepare_frame
    canvas, packed, hw, _ = prepare_frame(img, 8, dev)
    args1 = (canvas[None], packed[None], hw[None])
    api16 = SynergyNet3DMM(variables="trained", dtype=torch.bfloat16,
                           device=dev)
    eng16 = FusedFrameEngine(api16, detector=FaceBoxes(
        random_init_variables(0), dtype=torch.bfloat16, device=dev),
        max_faces=FACES)
    turns = {"f32": [], "f32_tf32_on": []}
    for which in ("f32", "f32_tf32_on", "f32_tf32_on", "f32"):
        real = unguarded() if which == "f32_tf32_on" else None
        try:
            turns[which].append(time_ms(lambda: eng.process_batch(*args1),
                                        10, torch))
        finally:
            if real is not None:
                guarded(real)
    ms16 = time_ms(lambda: eng16.process_batch(*args1), 10, torch)
    ms32 = float(np.mean(turns["f32"]))
    ms_on = float(np.mean(turns["f32_tf32_on"]))
    out["f32_engine"] = {
        "faces": n, "roi_err_px": roi_err, "mesh_err": mesh_err,
        "mesh_excess": mesh_excess, "tf32_flags_before": flags_before,
        "tf32_flags_after": flags_after, "one_tf32_pass": tf32,
        "ms_b1": ms32, "ms_b1_turns": turns["f32"],
        "ms_b1_tf32_on": ms_on, "ms_b1_tf32_on_turns": turns["f32_tf32_on"],
        "repair_cost_ms_b1": ms32 - ms_on, "bf16_ms_b1": ms16}
    log(f"phase 12 C11: FusedFrameEngine(SynergyNet3DMM(variables='trained'))"
        f" f32 on {ch}x{cw} (seed {API_FRAME_SEED}): {n} faces, card = CPU "
        f"(rois within {roi_err:.3e} px of BOX_TOL {BOX_TOL}, meshes within "
        f"{mesh_err:.3e}, rtol {ENGINE_MESH_TOL['rtol']} / atol "
        f"{ENGINE_MESH_TOL['atol']}); TF32 flags (matmul, cudnn) before "
        f"{flags_before} after {flags_after}; one TF32 pass (no guard, TF32 "
        f"forced on): {tf32} | {card}")
    log(f"phase 12 C11 times at B=1 (process_batch, CUDA events, mean of 10 "
        f"after 2 warm-ups, turns off/on/on/off): f32 TF32 off "
        f"{ms32:.3f} ms {turns['f32']}, f32 without the guard, TF32 forced "
        f"on {ms_on:.3f} ms {turns['f32_tf32_on']}, the repair's cost "
        f"{ms32 - ms_on:+.3f} ms; bf16 engine {ms16:.3f} ms | {card}")
    del eng, cpu, eng16, api16
    torch.cuda.empty_cache()
    shutil.rmtree(tmp)                  # ~280 MB of written reference files
    secs = time.perf_counter() - t_phase
    out["seconds"] = secs
    out["launches_b1"] = launches
    log(f"phase 12 (ingest, the evaluation CLI, the f32 engine): {secs:.1f} s")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile process_batch and one overlay frame; "
                    "traces go to DIR")
    ap.add_argument("--parent", metavar="DIR",
                    help="a checkout of the parent commit: time its raster "
                    "entry points against this tree's, in turns")
    ap.add_argument("--raster-worker", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.raster_worker:
        raster_worker(args.raster_worker)
        return
    t_start = time.perf_counter()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a card")
    from synergynet_tpu_torch.detect import FaceBoxes
    from synergynet_tpu_torch.detect.detector import random_init_variables
    from synergynet_tpu_torch.detect.net import space_to_depth
    from synergynet_tpu_torch.detect.stem_fused import (
        fused_stem1_s2d8, fused_stem1_s2d8_reference)
    from synergynet_tpu_torch.mm3d import rescale_to_roi
    from synergynet_tpu_torch.mm3d.codec import full_fp32
    from synergynet_tpu_torch.ops import cuda_build, fused_decode
    from synergynet_tpu_torch.ops.fused_decode import (
        decode_dense_fused, decode_dense_fused_reference)
    from synergynet_tpu_torch.pipeline import (FusedFrameEngine,
                                               FusedOverlayEngine,
                                               SynergyNet3DMM, prepare_frame,
                                               unpack_face_outputs)
    from synergynet_tpu_torch.ops.resize import _resize_linear
    from synergynet_tpu_torch.pipeline.overlay_engine import (
        _face_buckets, composite, light_faces)
    from synergynet_tpu_torch.render import (
        DEPTH_INIT, plane_records, rasterize_buffers_reference,
        rasterize_buffers_tiled, rasterize_mesh, rasterize_mesh_ids,
        rasterize_mesh_ids_reference, rasterize_records_reference,
        rasterize_triangles_tiled)
    from synergynet_tpu_torch.render.raster_tiled import _visibility_records

    dev = torch.device(DEVICE)
    card = card_line()
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | {torch.cuda.get_device_name(0)}")

    # -- 2. build, one nvcc per source, all at once ---------------------------
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        for fut in [pool.submit(cuda_build.load_kernel_library, k)
                    for k in KERNELS]:
            fut.result()
    for k in KERNELS:
        info = cuda_build.build_info(k)
        log(f"build {k}: nvcc {info['seconds']:.2f} s")
        for line in info["ptxas"]:
            log(f"  {line}")
    log(f"built {len(KERNELS)} kernels in parallel: "
        f"{time.perf_counter() - t0:.2f} s total")

    # -- 3a. kernel B1 vs plain twin at the path's shapes ---------------------
    api = SynergyNet3DMM(variables="trained", dtype=torch.bfloat16,
                         device=dev)
    pack, basis = api.pack_dev, api.basis
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    rng = np.random.default_rng(0)
    kernel_stats = {}
    max_err = 0.0
    for b in (FACES, FACES * BATCH):
        p = torch.tensor(rng.normal(0, 1, (b, 62)).astype(np.float32),
                         device=dev)
        got = decode_dense_fused(p, basis, pack)
        want = decode_dense_fused_reference(p, basis, pack)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
        max_err = max(max_err, err)
        del got, want
        # The kernel alone, through its launch wrapper: the (B, 62) prologue
        # (de-whitening, a few eager ops) stays outside, as in the JAX
        # package.
        operands = fused_decode._prologue(p, pack)
        spread = time_spread(lambda: fused_decode._launch(*operands, basis),
                             20, torch, flush_buf.zero_)
        ms = spread[1]
        # The entry point whole, prologue and the host's launch gaps inside
        # the events: the series' earlier yardstick, kept beside it.
        entry = time_ms(lambda: decode_dense_fused(p, basis, pack), 20,
                        torch, flush_buf.zero_)
        plain = time_ms(lambda: decode_dense_fused_reference(p, basis, pack),
                        20, torch, flush_buf.zero_)
        # The library yardstick: the (B, 50) x (50, 3 Npad) basis product
        # alone, f32 with TF32 off, without the rotation and offset.
        alpha = p[:, :50].contiguous()
        w_t = basis.w.reshape(-1, 50).T.contiguous()
        with full_fp32():
            lib = time_spread(lambda: torch.matmul(alpha, w_t), 20, torch,
                              flush_buf.zero_)[1]
        del w_t
        nver, npad = basis.nver, basis.npad
        nbytes = 4 * (b * (50 + 9 + 3) + 3 * npad * 51 + b * 3 * nver)
        # Per vertex: 3 x 50 MACs, the mean, 3 x 3 MACs, offset, y flip.
        b_ms, b_by = bound(nbytes, b * nver * (300 + 3 + 18 + 3 + 1),
                           F32_FLOPS)
        kernel_stats[b] = (ms, plain, lib, b_ms, b_by, spread, entry)
        log(f"fused_decode B={b}: max_abs_err {err:.3e} (rtol {RTOL}, atol "
            f"{ATOL}) | kernel min/median/max {spread[0]:.4f} / "
            f"{spread[1]:.4f} / {spread[2]:.4f} ms over 20 | entry point "
            f"{entry:.4f} ms (mean, host gaps inside) | plain "
            f"{plain:.4f} ms | matmul alone {lib:.4f} ms | bound {b_ms:.4f} "
            f"ms ({b_by}) | {b_ms / ms:.3f} of bound, {ms / lib:.3f}x the "
            f"matmul | {card}")

    det = FaceBoxes(random_init_variables(0), dtype=torch.bfloat16,
                    device=dev)
    eng = FusedFrameEngine(api, detector=det, max_faces=FACES)
    ov = FusedOverlayEngine(eng)
    ch, cw = CANVAS
    ntri = ov.tris_face.shape[0]

    # -- 3b. kernels B2 and B3 vs plain twins: 8 lit meshes, stress meshes ----
    r_err = 0.0
    r3_err = 0.0

    def raster_twins(v, t, c, h, w, what):
        """Both mesh kernels against their twins on the same mesh, bit for
        bit: B2's zbuf and payloads, B3's zbuf, ids and w0; the visibility
        path against its record route (the JAX package's), the deferred
        path against the payload path. -> (zbuf, ids)."""
        nonlocal r_err, r3_err
        got = rasterize_mesh(v, t, c, h=h, w=w)
        got3 = rasterize_mesh_ids(v, t, h=h, w=w, w0=True)
        torch.cuda.synchronize()
        want = rasterize_buffers_reference(v, t, c, h=h, w=w)
        want3 = rasterize_mesh_ids_reference(v, t, h=h, w=w, w0=True)
        for g, x, name in zip(got + got3, want + want3,
                              ("zbuf", "color", "ids zbuf", "tri_id", "w0")):
            if not torch.equal(g, x):
                bad = (g != x).sum().item()
                fail(f"raster {what}: {name} differs from the plain twin at "
                     f"{bad} entries")
        r_err = max(r_err, max((g - x).abs().max().item()
                               for g, x in zip(got, want)))
        r3_err = max(r3_err, max((g.double() - x.double()).abs().max().item()
                                 for g, x in zip(got3, want3)))
        if not torch.equal(got3[0], got[0]):
            fail(f"raster ids {what}: zbuf differs from the payload kernel's")
        rec = _visibility_records(v, t, h=h, w=w)
        zr, pay = rasterize_records_reference(rec, 2, h=h, w=w)
        drawn = zr > DEPTH_INIT
        tri, zv, w0 = rasterize_triangles_tiled(v, t, h=h, w=w)
        if not (torch.equal(zv, zr) and torch.equal(tri, torch.where(
                drawn, pay[..., 0].to(torch.int32), -1)) and torch.equal(
                w0, torch.where(drawn, pay[..., 1], 0.0))):
            fail(f"visibility {what}: differs from the record route")
        zd, cd = rasterize_buffers_tiled(v, t, c, h=h, w=w, deferred=True)
        if not (torch.equal(zd, got[0]) and torch.equal(cd, got[1])):
            fail(f"deferred {what}: differs from the payload path")
        return got[0], got3[1]

    v8, t8, c8 = lit_meshes(torch, dev)
    with torch.inference_mode():
        zb, _ = raster_twins(v8, t8, c8, ch, cw, f"{FACES} lit meshes")
        z64, _ = raster_twins(v8, t8.long(), c8, ch, cw,
                              f"{FACES} lit meshes, int64 triangles")
        drawn8 = (zb > DEPTH_INIT).sum().item()
        rec8 = plane_records(v8, t8, c8, h=ch, w=cw)
        frags8 = bbox_pixels(rec8)
        r_bounds = raster_bounds(v8.shape[0], t8.shape[0], 3, frags8,
                                 drawn8, ch, cw, 4)
        r3_bounds = raster_bounds(v8.shape[0], t8.shape[0], 0, frags8,
                                  drawn8, ch, cw, 4)
        r_spread = time_spread(lambda: rasterize_mesh(v8, t8, c8, h=ch, w=cw),
                               20, torch, flush_buf.zero_)
        r_entry = time_ms(lambda: rasterize_mesh(v8, t8, c8, h=ch, w=cw), 20,
                          torch, flush_buf.zero_)
        r_plain = time_ms(lambda: rasterize_buffers_reference(
            v8, t8, c8, h=ch, w=cw), 5, torch, flush_buf.zero_)
        r3_spread = time_spread(lambda: rasterize_mesh_ids(v8, t8, h=ch,
                                                           w=cw),
                                20, torch, flush_buf.zero_)
        r3_entry = time_ms(lambda: rasterize_mesh_ids(v8, t8, h=ch, w=cw),
                           20, torch, flush_buf.zero_)
        r3_plain = time_ms(lambda: rasterize_mesh_ids_reference(
            v8, t8, h=ch, w=cw), 5, torch, flush_buf.zero_)
        for name, spread, entry, plain, (mb, rb) in (
                ("B2 payloads", r_spread, r_entry, r_plain, r_bounds),
                ("B3 depth + id", r3_spread, r3_entry, r3_plain, r3_bounds)):
            log(f"raster {name}, {FACES} lit meshes x {ntri} triangles on "
                f"{ch}x{cw}: bit-identical to the plain twin (int32 and "
                f"int64 triangles), {drawn8 / (ch * cw):.3f} of pixels drawn,"
                f" {frags8} bbox pixels | kernel min/median/max "
                f"{spread[0]:.4f} / {spread[1]:.4f} / {spread[2]:.4f} ms over "
                f"20 | entry point {entry:.4f} ms (mean, host gaps inside) |"
                f" plain {plain:.4f} ms | bound, mesh form {mb[0]:.4f} ms "
                f"({mb[1]}), record form {rb[0]:.4f} ms ({rb[1]}) | "
                f"{mb[0] / spread[1]:.3f} of bound | {card}")
        for name, v, t, c in stress_meshes(np.random.default_rng(3), ch, cw):
            v, t, c = (torch.tensor(a, device=dev) for a in (v, t, c))
            z, _ = raster_twins(v, t, c, ch, cw, f"stress mesh {name}")
            n_drawn = (z > DEPTH_INIT).sum().item()
            if (n_drawn == 0) != (name in ("offcanvas", "empty")):
                fail(f"raster stress mesh {name}: {n_drawn} pixels drawn")
            log(f"raster B2 + B3 stress {name}: {t.shape[0]} triangles, "
                f"{n_drawn} pixels drawn, bit-identical")
    del v8, t8, c8, rec8

    # -- 3c. kernel B4 vs plain twin: 1 and 128 real s2d8 frames, bf16 -------
    det_p = FaceBoxes(random_init_variables(0), dtype=torch.bfloat16,
                      device=dev, stem_mode="pallas")
    g = torch.Generator(device=dev).manual_seed(0)
    frames = torch.randint(0, 256, (BATCH, ch, cw, 3), generator=g,
                           device=dev).float()
    frames_s2d = space_to_depth(frames, det.stem_r).contiguous()
    hws = torch.tensor([[ch, cw]] * BATCH, dtype=torch.int32, device=dev)
    stem = det_p.net.conv1_s2d8
    k4, s_bias = stem.tap_weights(), stem.bias.detach()
    x_stem = (frames_s2d - eng._det_mean).to(torch.bfloat16)
    stem_stats = {}
    s_err = 0.0
    with torch.inference_mode():
        for b in (1, BATCH):
            xb = x_stem[:b]
            got = fused_stem1_s2d8(xb, k4, s_bias)
            want = fused_stem1_s2d8_reference(xb, k4, s_bias)
            torch.cuda.synchronize()
            torch.testing.assert_close(got.float(), want.float(), **STEM_TOL)
            err = (got.float() - want.float()).abs().max().item()
            differ = (got != want).float().mean().item()
            s_err = max(s_err, err)
            del got, want
            spread = time_spread(lambda: fused_stem1_s2d8(xb, k4, s_bias),
                                 20, torch, flush_buf.zero_)
            ms = spread[1]
            entry = time_ms(lambda: fused_stem1_s2d8(xb, k4, s_bias),
                            20 if b == 1 else 10, torch, flush_buf.zero_)
            plain = time_ms(lambda: fused_stem1_s2d8_reference(
                xb, k4, s_bias), 5, torch, flush_buf.zero_)
            # The library yardstick: cuDNN's bf16 conv with bias on the
            # pre-padded input, without the pool.
            xpad = F.pad(xb.permute(0, 3, 1, 2), (1, 0, 1, 0)).contiguous(
                memory_format=torch.channels_last)
            lib = time_spread(lambda: F.conv2d(xpad, stem.weight, stem.bias),
                              20, torch, flush_buf.zero_)[1]
            del xpad
            npos = b * xb.shape[1] * xb.shape[2]
            s_bound = bound(2 * (xb.numel() + k4.numel() + npos * 48)
                            + 4 * 192, 2 * npos * 768 * 192 + 9 * npos * 48,
                            BF16_FLOPS)
            stem_stats[b] = (ms, plain, lib) + s_bound + (spread, entry)
            log(f"stem_s2d8 B={b} ({tuple(xb.shape)} bf16): max_abs_err "
                f"{err:.3e}, {differ:.2e} of elements differ from the twin "
                f"(rtol {STEM_TOL['rtol']}, atol {STEM_TOL['atol']}) | "
                f"kernel min/median/max {spread[0]:.4f} / {spread[1]:.4f} / "
                f"{spread[2]:.4f} ms over 20 | entry point {entry:.4f} ms "
                f"(mean, host gaps inside) | plain {plain:.4f} ms | cuDNN "
                f"conv alone {lib:.4f} ms | bound {s_bound[0]:.4f} ms "
                f"({s_bound[1]}) | {s_bound[0] / ms:.3f} of bound, "
                f"{ms / lib:.3f}x the cuDNN conv | {card}")
    del flush_buf, x_stem
    torch.cuda.empty_cache()

    # -- 4. the serving path --------------------------------------------------
    kp_vert = pack.keypoints[0::3].long() // 3

    def check_faces(pts, verts, poses, what):
        if not 0 < len(pts) <= FACES:
            fail(f"{what}: {len(pts)} faces")
        for lm, v, (ang, t) in zip(pts, verts, poses):
            if lm.shape != (3, 68) or v.shape != (3, 53215) \
                    or ang.shape != (3,) or t.shape != (3,):
                fail(f"{what}: shapes {lm.shape} {v.shape} {ang.shape}")
            for a in (lm, v, ang, t):
                if not np.all(np.isfinite(a)):
                    fail(f"{what}: non-finite output")
            np.testing.assert_allclose(v[:, kp_vert.cpu().numpy()], lm,
                                       rtol=RTOL, atol=1e-2)

    def check_dense(o):
        """Finite outputs; the dense mesh against the plain twin on the
        path's own param62 and rois; landmarks equal to the dense mesh at
        the keypoint vertices. -> the dense mesh's max abs error."""
        for x in (o[2], o[3], o[4], o[5], o[6], o[7]):
            if not torch.isfinite(x).all():
                fail("process_batch: non-finite output")
        flat_p, flat_r = o[3].reshape(-1, 62), o[2].reshape(-1, 4)
        d = o[5]
        with torch.inference_mode():
            ref = rescale_to_roi(
                decode_dense_fused_reference(flat_p, basis, pack), flat_r)
        err = (d.reshape(ref.shape) - ref).abs().max().item()
        torch.testing.assert_close(d.reshape(ref.shape), ref, rtol=RTOL,
                                   atol=ATOL)
        torch.testing.assert_close(d[..., kp_vert], o[4], rtol=RTOL,
                                   atol=1e-2)
        return err

    torch.cuda.synchronize()

    # Launches count over the path's own calls: __call__ twice, then
    # process_batch; the checks and the timing below are not counted.
    decode_dense_fused.launches = 0
    t0 = time.perf_counter()
    frames_np = {hw: np.random.default_rng(1).integers(0, 256, (*hw, 3),
                                                       np.uint8)
                 for hw in (CANVAS, (480, 640))}
    n_xla = {}
    for hw, img in frames_np.items():
        pts, verts, poses = eng(img)
        check_faces(pts, verts, poses, f"__call__ {hw}")
        n_xla[hw] = len(pts)
        log(f"__call__ {hw[0]}x{hw[1]}: {len(pts)} faces, shapes "
            f"{pts[0].shape} {verts[0].shape}, finite")

    torch.cuda.reset_peak_memory_stats()
    out = eng.process_batch(frames, frames_s2d, hws)
    torch.cuda.synchronize()
    launches = decode_dense_fused.launches
    log(f"main path: fused_decode launched {launches} times "
        f"(__call__ x2, process_batch x1)")
    if launches <= 0:
        fail("the serving path never launched the fused_decode kernel")
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    scores, n_faces, rois, p62, lmk, dense, angles, t3d = out
    want_shapes = [(BATCH, FACES), (BATCH,), (BATCH, FACES, 4),
                   (BATCH, FACES, 62), (BATCH, FACES, 3, 68),
                   (BATCH, FACES, 3, 53215), (BATCH, FACES, 3),
                   (BATCH, FACES, 3)]
    if [tuple(x.shape) for x in out] != want_shapes:
        fail(f"process_batch shapes {[tuple(x.shape) for x in out]}")
    path_err = check_dense(out)
    max_err = max(max_err, path_err)
    log(f"process_batch B={BATCH}: faces/frame {n_faces.float().mean():.2f},"
        f" dense vs plain twin max_abs_err {path_err:.3e}, peak "
        f"{peak_gb:.2f} GiB, {time.perf_counter() - t0:.1f} s")

    # The same path with the fused stem: launches over its own calls.
    eng_p = FusedFrameEngine(api, detector=det_p, max_faces=FACES)
    fused_stem1_s2d8.launches = 0
    decode_dense_fused.launches = 0
    t0 = time.perf_counter()
    same_calls = 0
    for hw, img in frames_np.items():
        pts_p, verts_p, poses_p = eng_p(img)
        check_faces(pts_p, verts_p, poses_p, f"fused-stem __call__ {hw}")
        same_calls += len(pts_p) == n_xla[hw]
    out_p = eng_p.process_batch(frames, frames_s2d, hws)
    torch.cuda.synchronize()
    s_launches = fused_stem1_s2d8.launches
    log(f"fused-stem path: stem_s2d8 launched {s_launches} times, "
        f"fused_decode {decode_dense_fused.launches} times (__call__ x2, "
        f"process_batch x1), {time.perf_counter() - t0:.1f} s")
    if s_launches <= 0:
        fail("the fused-stem serving path never launched the stem kernel")
    if decode_dense_fused.launches <= 0:
        fail("the fused-stem serving path never launched fused_decode")
    if [tuple(x.shape) for x in out_p] != want_shapes:
        fail(f"fused-stem process_batch shapes "
             f"{[tuple(x.shape) for x in out_p]}")
    path_err_p = check_dense(out_p)
    max_err = max(max_err, path_err_p)
    # Agreement with the XLA-stem engine, printed only: the two stems round
    # to bf16 at different points.
    # Faces are matched to the nearest roi of the same frame: near-equal
    # scores may order the same faces differently.
    n_same = out_p[1] == n_faces
    dist = (out_p[2][:, :, None] - rois[:, None]).abs().amax(-1)
    dist = dist.masked_fill(~(scores > 0)[:, None], float("inf")).amin(-1)
    both = (out_p[0] > 0) & n_same[:, None]
    roi_diff = dist[both].max().item() if both.any() else float("nan")
    within_1px = (dist[both] <= 1.0).float().mean().item()
    log(f"fused-stem process_batch B={BATCH}: faces/frame "
        f"{out_p[1].float().mean():.2f}, dense vs plain twin max_abs_err "
        f"{path_err_p:.3e}; vs the XLA-stem engine: equal face counts on "
        f"{n_same.float().mean().item():.3f} of frames and {same_calls} of "
        f"{len(frames_np)} __call__ frames; each face's roi against the "
        f"nearest of the same frame: largest difference {roi_diff:.3f} px, "
        f"{within_1px:.3f} of faces within 1 px")
    del out_p

    # -- 5. the overlay path --------------------------------------------------
    imgs = {hw: np.random.default_rng(2).integers(0, 256, (*hw, 3), np.uint8)
            for hw in OVERLAY_FRAMES}
    # Launches count over the overlay path's own calls only.
    decode_dense_fused.launches = 0
    rasterize_mesh.launches = 0
    t0 = time.perf_counter()
    results = {hw: ov(img) for hw, img in imgs.items()}
    torch.cuda.synchronize()
    r_launches = rasterize_mesh.launches
    log(f"overlay path: raster_tiled launched {r_launches} times, "
        f"fused_decode {decode_dense_fused.launches} times (__call__ x"
        f"{len(imgs)}), {time.perf_counter() - t0:.1f} s")
    if r_launches <= 0:
        fail("the overlay path never launched the raster_tiled kernel")
    if decode_dense_fused.launches <= 0:
        fail("the overlay path never launched the fused_decode kernel")

    lit = {}
    with torch.inference_mode():
        for hw, img in imgs.items():
            pts, verts, poses, overlay = results[hw]
            if overlay.shape != img.shape or overlay.dtype != np.uint8:
                fail(f"overlay {hw}: {overlay.shape} {overlay.dtype}")
            check_faces(pts, verts, poses, f"overlay __call__ {hw}")
            want = eng(img)
            if len(want[0]) != len(pts):
                fail(f"overlay {hw}: {len(pts)} faces, FusedFrameEngine "
                     f"finds {len(want[0])}")
            for a, b in zip(pts + verts + [x for p_ in poses for x in p_],
                            want[0] + want[1]
                            + [x for p_ in want[2] for x in p_]):
                if not np.array_equal(a, b):
                    fail(f"overlay {hw}: faces differ from "
                         "FusedFrameEngine.__call__'s")
            # The same render through the plain twin, from the same outputs.
            canvas, packed, true_hw, scale = prepare_frame(img, det.stem_r,
                                                           dev)
            o = eng.process_batch(canvas[None], packed[None], true_hw[None])
            n, dn = int(o[1][0]), o[5][0]
            valid = torch.arange(FACES, device=dev) < n
            vl, lt = light_faces(dn.transpose(1, 2), valid, ov.tris_face,
                                 ov.rings, ov.light_cfg)
            lit[hw] = (vl.reshape(-1, 3), lt.reshape(-1, 3))
            raster_twins(*lit[hw][:1], ov.tris_all, lit[hw][1], ch, cw,
                         f"overlay {hw} meshes")
            zp, cp = rasterize_buffers_reference(lit[hw][0], ov.tris_all,
                                                 lit[hw][1], h=ch, w=cw)
            frame_u8 = canvas.clamp(0, 255).to(torch.uint8)
            plain = composite(frame_u8, zp, cp, ov.alpha)[0]
            hs, ws = true_hw.tolist()
            plain, drawn = plain[:hs, :ws], (zp > DEPTH_INIT)[:hs, :ws]
            if scale != 1.0:
                plain = _resize_linear(plain, *img.shape[:2]).to(torch.uint8)
            else:
                undrawn = ~drawn.cpu().numpy()
                if not np.array_equal(overlay[undrawn], img[undrawn]):
                    fail(f"overlay {hw}: undrawn pixels differ from the "
                         "frame")
            if not np.array_equal(overlay, plain.cpu().numpy()):
                fail(f"overlay {hw}: differs from the plain-twin render")
            log(f"overlay {hw[0]}x{hw[1]}: {n} faces, {overlay.shape} uint8, "
                f"{drawn.float().mean().item():.3f} of the canvas drawn, "
                f"faces equal FusedFrameEngine's, overlay equals the plain-"
                "twin render, kernel == twin on the path's meshes")

        # The deferred raster on the overlay's own lit meshes: launches
        # over these calls only, then the checks.
        rasterize_mesh_ids.launches = 0
        deferred = {hw: rasterize_buffers_tiled(v, ov.tris_all, c, h=ch,
                                                w=cw, deferred=True)
                    for hw, (v, c) in lit.items()}
        torch.cuda.synchronize()
        r3_launches = rasterize_mesh_ids.launches
        log(f"deferred path: raster ids launched {r3_launches} times over "
            f"{len(lit)} overlay frames' meshes")
        if r3_launches <= 0:
            fail("the deferred path never launched the raster ids kernel")
        for hw, (v, c) in lit.items():
            zd, cd = deferred[hw]
            zk, ck = rasterize_buffers_tiled(v, ov.tris_all, c, h=ch, w=cw)
            if not (torch.equal(zd, zk) and torch.equal(cd, ck)):
                fail(f"deferred {hw}: differs from the payload path")
            _, ids = rasterize_mesh_ids(v, ov.tris_all, h=ch, w=cw)
            tri, zv, _ = rasterize_triangles_tiled(v, ov.tris_all, h=ch,
                                                   w=cw)
            if not (torch.equal(tri, ids) and torch.equal(zv, zd)):
                fail(f"visibility {hw}: triangle ids differ from the ids "
                     "kernel's")
            log(f"deferred {hw[0]}x{hw[1]} meshes: zbuf and color equal the "
                f"payload path bit for bit; visibility ids equal the ids "
                f"kernel's ({(ids >= 0).float().mean().item():.3f} drawn)")
        del deferred

    # -- 6. end-to-end timing -------------------------------------------------
    # The XLA-stem and fused-stem engines in turns: xla, fused, fused, xla.
    e2e, e2e_p = {}, {}
    for b in (1, BATCH):
        a = (frames[:b], frames_s2d[:b], hws[:b])
        n = 10 if b == 1 else 5
        runs = {"xla": [], "fused": []}
        for which in ("xla", "fused", "fused", "xla"):
            e = eng if which == "xla" else eng_p
            runs[which].append(time_ms(lambda: e.process_batch(*a), n,
                                       torch))
        ms, ms_p = (sum(runs[k]) / 2 for k in ("xla", "fused"))
        e2e[b] = (ms, b * FACES / ms * 1e3)
        e2e_p[b] = (ms_p, b * FACES / ms_p * 1e3)
        log(f"end-to-end B={b} frames: XLA stem {ms:.3f} ms/call "
            f"({runs['xla']}), {e2e[b][1]:.1f} faces/s; fused stem "
            f"{ms_p:.3f} ms/call ({runs['fused']}), {e2e_p[b][1]:.1f} "
            f"faces/s | {card}")

    stages = {}
    with torch.inference_mode():
        for b in (1, BATCH):
            fr, s2d, hw, r = frames[:b], frames_s2d[:b], hws[:b], rois[:b]
            fp, fr4 = p62[:b].reshape(-1, 62), r.reshape(-1, 4)
            s, bx = eng.detect_candidates(s2d, hw)
            stages[str(b)] = {name: time_ms(fn, 3, torch) for name, fn in (
                ("detect", lambda: eng.detect_candidates(s2d, hw)),
                ("select (top-k + NMS)", lambda: eng.select_faces(s, bx)),
                ("crop + regress", lambda: eng.regress(fr, r)),
                ("decode tail", lambda: eng.tail(fp, fr4)),
                ("detect, fused stem", lambda: eng_p.detect_candidates(
                    s2d, hw)))}
            log(f"stages at B={b}: " + ", ".join(
                f"{k} {v:.3f} ms" for k, v in stages[str(b)].items())
                + f" | {card}")

    img = imgs[CANVAS]
    for _ in range(2):
        ov(img)
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        ov(img)
    overlay_ms = (time.perf_counter() - t0) * 1e3 / reps
    with torch.inference_mode():
        canvas, packed, true_hw, _ = prepare_frame(img, det.stem_r, dev)
        a = (canvas[None], packed[None], true_hw[None])
        o = eng.process_batch(*a)
        n, dn = int(o[1][0]), o[5][0]
        fb = next(b for b in _face_buckets(FACES) if b >= max(n, 1))
        vin = dn[:fb].transpose(1, 2)
        valid = torch.arange(fb, device=dev) < n
        vl, lt = light_faces(vin, valid, ov.tris_face, ov.rings, ov.light_cfg)
        tris = ov.tris_all[:fb * ntri]
        vl, lt = vl.reshape(-1, 3), lt.reshape(-1, 3)
        zb, col = rasterize_mesh(vl, tris, lt, h=ch, w=cw)
        frame_u8 = canvas.clamp(0, 255).to(torch.uint8)
        olay = composite(frame_u8, zb, col, ov.alpha)[0]
        lmk1, ang1, t3d1 = o[4][0], o[6][0], o[7][0]
        ov_stages = {name: time_ms(fn, 10, torch) for name, fn in (
            ("frame prep (prepare_frame)", lambda: prepare_frame(
                img, det.stem_r, dev)),
            ("serving (process_batch, B=1)", lambda: eng.process_batch(*a)),
            ("normals + light", lambda: light_faces(
                vin, valid, ov.tris_face, ov.rings, ov.light_cfg)),
            ("raster (B2, setup inside)", lambda: rasterize_mesh(
                vl, tris, lt, h=ch, w=cw)),
            ("blend + composite", lambda: composite(frame_u8, zb, col,
                                                    ov.alpha)),
            ("overlay to host", lambda: olay.cpu()),
            ("faces to host (unpack)", lambda: unpack_face_outputs(
                n, *(x.cpu().numpy() for x in (lmk1, dn, ang1, t3d1)), 1.0)))}
    log(f"overlay {ch}x{cw}, {n} faces (bucket {fb}): {overlay_ms:.3f} ms "
        f"per frame (__call__, host clock, mean of {reps}) | {card}")
    log("overlay stages: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in ov_stages.items())
        + f"; sum {sum(ov_stages.values()):.3f} ms | {card}")

    # The deferred raster beside the payload raster, on the 720x1088
    # overlay's lit meshes (all 8 faces), whole entry point each.
    with torch.inference_mode():
        v, c = lit[CANVAS]
        raster_ms = {name: time_ms(fn, 10, torch) for name, fn in (
            ("payload path (B2)", lambda: rasterize_buffers_tiled(
                v, ov.tris_all, c, h=ch, w=cw)),
            ("deferred path (B3)", lambda: rasterize_buffers_tiled(
                v, ov.tris_all, c, h=ch, w=cw, deferred=True)))}
    log("raster entry points, 720x1088 overlay meshes: " + ", ".join(
        f"{k} {v_:.3f} ms" for k, v_ in raster_ms.items())
        + f"; kernels alone B2 {r_spread[1]:.4f} ms, B3 {r3_spread[1]:.4f} "
        f"ms | {card}")
    raster_turns = raster_ab(args.parent, card) if args.parent else None

    # -- 7. device profile (opt-in) -------------------------------------------
    if args.profile:
        from synergynet_tpu_torch.core.profiling import profile_calls
        os.makedirs(args.profile, exist_ok=True)
        summary = {"card": card}
        for b in (1, BATCH):
            a = (frames[:b], frames_s2d[:b], hws[:b])
            n = 10 if b == 1 else 3
            p = profile_calls(lambda: eng.process_batch(*a), n,
                              os.path.join(args.profile, f"trace_b{b}.json"))
            summary[str(b)] = dict(p, calls=n, unprofiled_ms=e2e[b][0])
            log(f"profile B={b} ({n} calls): device busy {p['busy_ms']:.3f} "
                f"of {p['wall_ms']:.3f} ms per call, idle share "
                f"{p['idle_share']:.3f}, {p['ops']:.1f} device ops per call; "
                f"busy / unprofiled call {p['busy_ms'] / e2e[b][0]:.3f}"
                f" | {card}")
            for name, ms in p["top"]:
                log(f"  {ms:9.3f} ms  {name[:110]}")
        p = profile_calls(lambda: ov(img), 5, os.path.join(
            args.profile, "trace_overlay.json"), top=1000)
        split = raster_split(p["top"])
        summary["overlay"] = dict(p, calls=5, unprofiled_ms=overlay_ms,
                                  raster_device_ms=split)
        log(f"profile overlay {ch}x{cw} (5 calls): device busy "
            f"{p['busy_ms']:.3f} of {p['wall_ms']:.3f} ms per call, idle "
            f"share {p['idle_share']:.3f}, {p['ops']:.1f} device ops per "
            "call; raster launches, device ms per call: " + ", ".join(
                f"{k} {v_:.4f}" for k, v_ in split.items() if k != "other")
            + f" | {card}")
        for name, ms in p["top"][:10]:
            log(f"  {ms:9.3f} ms  {name[:110]}")
        with open(os.path.join(args.profile, "profile.json"), "w") as f:
            json.dump(summary, f, indent=1)

    # -- 8. the training path -------------------------------------------------
    training = training_phase(torch, dev, card, args.profile)

    # -- 9. the training data path --------------------------------------------
    data_path = data_phase(torch, dev, card, training)
    log("phase 9 (training data path, no kernel of B1-B4): " + json.dumps({
        "render_ms_1024": data_path["render"]["ms"],
        "step_ms_augment": data_path["augment"]["step_ms"],
        "step_ms_plain": data_path["augment"]["plain_step_ms"],
        "streaming_fit_crops_per_s":
            data_path["streaming"]["fit_crops_per_s"],
        "shaded_streaming_fit_crops_per_s":
            data_path["shaded_stream"]["fit_crops_per_s"],
        "resident_crops_per_s": data_path["resident"]["crops_per_s"],
        "generative_crops_per_s": data_path["generative"]["crops_per_s"],
        "resident_peak_gib": data_path["resident"]["peak_gib"],
        "generative_peak_gib": data_path["generative"]["peak_gib"]})
        + f" | {card}")

    # -- 10. the packaged API and the host renders ----------------------------
    api_path = api_phase(torch, dev, card)
    api_launches = api_path["launches"]

    # -- 11. model families and reference weights -----------------------------
    fam = families_phase(torch, dev, card, frames, frames_s2d, hws, det)
    sf = fam["stem_f32"]

    # -- 12. reference-data ingest, the evaluation CLI, the f32 engine --------
    ingest = ingest_eval_phase(torch, dev, card)

    log(f"chip_smoke: all phases in {time.perf_counter() - t_start:.1f} s")

    ms8, plain8, lib8, bound8, _, spread8, entry8 = kernel_stats[FACES]
    ms1k, plain1k, lib1k, bound1k, by1k, spread1k, entry1k = kernel_stats[
        FACES * BATCH]
    s_ms, s_plain, s_lib, s_bound, s_by, s_spread, s_entry = stem_stats[
        BATCH]
    spread_timing = ("ms: median of 20 L2-flushed runs on the device clock "
                     "(a device spin before each start event keeps the "
                     "host's launch overhead out), ms_min / ms_max beside "
                     "it; ms_entry: the entry point whole, mean of the "
                     "L2-flushed runs, CUDA events around the host's "
                     "launches (the series' earlier timing of ms)")
    raster_timing = (spread_timing + "; the mesh entry point (rasterize_mesh"
                     " / rasterize_mesh_ids), setup inside the kernel; "
                     "bound_ms: the mesh form, bound_records_ms: the "
                     "earlier plane-record form")
    print(json.dumps({"kernels": [{
        "name": "fused_decode", "route": "cuda",
        "source": "synergynet_tpu_torch/csrc/fused_decode.cu",
        "replaces": "synergynet_tpu/ops/fused_decode.py:66",
        "launches": launches,
        "launches_api": api_launches["B1 fused_decode"],
        "launches_eval": ingest["launches_b1"],
        "max_abs_err": max_err, "ms": ms1k, "plain_ms": plain1k, "bound_ms": bound1k,
        "bound_by": by1k, "library_ms": lib1k,
        "library": "torch.matmul (B,50)x(50,3*Npad) f32, no rotation",
        "timing": spread_timing + "; ms times the launch wrapper "
        "(_launch) without the (B, 62) prologue",
        "ms_min": spread1k[0], "ms_max": spread1k[2], "ms_entry": entry1k,
        "ms_entry_b8": entry8,
        "faces": FACES * BATCH, "ms_b8": ms8, "ms_min_b8": spread8[0],
        "ms_max_b8": spread8[2], "plain_ms_b8": plain8,
        "bound_ms_b8": bound8, "library_ms_b8": lib8}, {
        "name": "raster_tiled", "route": "cuda",
        "source": "synergynet_tpu_torch/csrc/raster_tiled.cu",
        "replaces": "synergynet_tpu/render/raster_tiled.py:179",
        "launches": r_launches,
        "launches_api": api_launches["B2 raster_tiled"],
        "max_abs_err": r_err,
        "ms": r_spread[1], "plain_ms": r_plain, "bound_ms": r_bounds[0][0],
        "bound_by": r_bounds[0][1], "library_ms": None,
        "timing": raster_timing, "ms_min": r_spread[0],
        "ms_max": r_spread[2], "ms_entry": r_entry,
        "bound_records_ms": r_bounds[1][0], "bbox_pixels": frags8,
        "drawn_share": drawn8 / (ch * cw), "triangles": FACES * ntri,
        "canvas": list(CANVAS)}, {
        "name": "raster_ids", "route": "cuda",
        "source": "synergynet_tpu_torch/csrc/raster_tiled.cu",
        "replaces": "synergynet_tpu/render/raster_tiled.py:524",
        "launches": r3_launches,
        "launches_api": api_launches["B3 raster_ids"],
        "max_abs_err": r3_err,
        "ms": r3_spread[1], "plain_ms": r3_plain,
        "bound_ms": r3_bounds[0][0], "bound_by": r3_bounds[0][1],
        "library_ms": None, "timing": raster_timing,
        "ms_min": r3_spread[0], "ms_max": r3_spread[2], "ms_entry": r3_entry,
        "bound_records_ms": r3_bounds[1][0], "triangles": FACES * ntri,
        "canvas": list(CANVAS)}, {
        "name": "stem_s2d8", "route": "cuda",
        "source": "synergynet_tpu_torch/csrc/stem_s2d8.cu",
        "replaces": "synergynet_tpu/detect/stem_pallas.py:76",
        "launches": s_launches,
        "launches_api": api_launches["B4 stem_s2d8"],
        "max_abs_err": s_err,
        "ms": s_ms, "plain_ms": s_plain, "bound_ms": s_bound,
        "bound_by": s_by, "library_ms": s_lib,
        "library": "F.conv2d bf16 + bias (cuDNN), conv only, no pool",
        "timing": spread_timing,
        "ms_min": s_spread[0], "ms_max": s_spread[2], "ms_entry": s_entry,
        "ms_entry_b1": stem_stats[1][6],
        "frames": BATCH, "ms_b1": stem_stats[1][0],
        "ms_min_b1": stem_stats[1][5][0], "ms_max_b1": stem_stats[1][5][2],
        "plain_ms_b1": stem_stats[1][1], "library_ms_b1": stem_stats[1][2],
        "bound_ms_b1": stem_stats[1][3]}, {
        "name": "stem_s2d8_f32", "route": "cuda",
        "source": "synergynet_tpu_torch/csrc/stem_s2d8.cu",
        "replaces": "synergynet_tpu/detect/stem_pallas.py:76",
        "entry": "B4's f32 entry, synergy_stem_s2d8_f32 (3xTF32 mma.sync "
        "under a TMA ring)",
        "launches": fam["launches_f32"],
        "max_abs_err": max(v["max_abs_err"] for v in sf.values()),
        "ms": sf[str(BATCH)]["ms"], "plain_ms": sf[str(BATCH)]["plain_ms"],
        "bound_ms": sf[str(BATCH)]["bound_ms"],
        "bound_by": sf[str(BATCH)]["bound_by"],
        "library_ms": sf[str(BATCH)]["library_ms"],
        "library": "F.conv2d f32 + bias (cuDNN, TF32 off), conv only, no "
        "pool", "timing": spread_timing,
        "ms_min": sf[str(BATCH)]["ms_min"], "ms_max": sf[str(BATCH)]["ms_max"],
        "frames": BATCH, "ms_b1": sf["1"]["ms"], "ms_min_b1": sf["1"]["ms_min"],
        "ms_max_b1": sf["1"]["ms_max"], "plain_ms_b1": sf["1"]["plain_ms"],
        "library_ms_b1": sf["1"]["library_ms"],
        "bound_ms_b1": sf["1"]["bound_ms"],
        "bound_fma_ms": sf[str(BATCH)]["bound_fma_ms"],
        "bound_fma_ms_b1": sf["1"]["bound_fma_ms"],
        "stall_shares": sf[str(BATCH)]["stall_shares"],
        "stall_shares_b1": sf["1"]["stall_shares"]}],
        "e2e_faces_per_s": {str(b): v[1] for b, v in e2e.items()},
        "e2e_ms": {str(b): v[0] for b, v in e2e.items()},
        "e2e_fused_stem_ms": {str(b): v[0] for b, v in e2e_p.items()},
        "stages_ms": stages, "overlay_ms": overlay_ms,
        "overlay_stages_ms": ov_stages, "raster_path_ms": raster_ms,
        "raster_ab": raster_turns, "training": training,
        "data_path": data_path, "api_host_render": api_path,
        "families": {k: v for k, v in fam.items() if k != "stem_f32"},
        "ingest_eval": ingest}),
        flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
