#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``synergynet_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--profile DIR] [--parent DIR]

Needs one NVIDIA Hopper card and the CUDA toolkit (nvcc); fails without
them, and fails when the port's package is not beside this script. Phases,
each fatal on failure:

1. the card: ``nvidia-smi`` name and power limit;
2. build every kernel of the serving, overlay, fused-stem and deferred
   paths from ``synergynet_tpu_torch/csrc`` (nvcc, sm_90a, one nvcc per
   source, all started together), greedy NMS's N1, the crop's C1, R1 and BN1
   included, and print the build seconds and ptxas resource lines;
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
   must be > 0, N1's and C1's too. On the card each call replays its batch size's
   captured program, whose replays credit the launches recorded at
   capture. Then the same calls and checks on a second engine whose
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
   ``chip_smoke.py --raster-worker`` in a process of its own (and, after
   phase 14, the same for greedy NMS: ``--nms-worker``);
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
   holds;
13. scale-out and detector training (``scaleout_phase``), each check
   printing its backend and world size: a process group of one rank over
   NCCL, where ``jit_train_step`` at the JAX default config (MobileNetV2
   1.0, bf16, batch 1024) is held against ``make_train_step`` from the
   same state (within ``CARD_VS_CPU_REL``; bit for bit printed) and both
   are timed in turns (the mesh wrapper's cost), ``shard_fused_engine``
   at 128 frames against ``process_batch``, and ``tp_dense_decode`` (B1,
   its launches the ``kernels`` line's ``launches_scaleout`` with the
   ranks') against ``decode_dense_fused``; ``dryrun_multichip(2)``: two
   ranks sharing the card over gloo with CUDA tensors, each stage (the
   sync-BN and the per-replica step, the TP decode with B1 on each of two
   vertex slabs, sharded serving, a generative epoch) held against one
   process; ``DetectorTrainer`` at 256x256, batch 8: one step card vs
   CPU (f32: the losses within ``DET_LOSS_REL``; float64: the update
   within ``DET_F64_REL``), 20 f32 steps with the loss falling, ms a step.
   Times by ``StageTimer`` (CUDA events), the peak by
   ``device_memory_stats``.
14. captured programs and kernel N1 (``programs_phase``, run after phase
   6): ``process_batch``'s replay against its eager body
   (``process_batch_eager``) at 1 and 128 frames for both stems (face
   scores, counts and rois equal; the meshes bit for bit, or within rtol
   1e-4 / atol 1e-3, and which held is printed); one replay of every
   captured program under ``set_sync_debug_mode("error")``; one call's
   outputs unchanged by the next; N1 against the fixpoint twin bit for bit
   on the path's own candidates at 1 and 128 frames and on every case of
   ``tests/nms_cases.py`` (a 2,048-long suppression chain, a crowd,
   padding duplicates, duplicates, IoU ties at 0.3 in f32, 64-box tile
   edges, invalid tiles, K = 2,112); N1's time (median of 20, L2
   flushed; also behind a ~10 ms spin, and warm) and its bits / walk
   device ms under ``torch.profiler`` (cold and warm) against the twin's
   time and its bound (the walk's steps over the SM clock, the bytes over
   3.35 TB/s); with ``--parent DIR`` the same N1 times of the parent's
   ``greedy_nms_mask`` and this tree's on these candidates, in turns
   (parent, this, this, parent), each ``chip_smoke.py --nms-worker`` in a
   process of its own; ``select_faces``' split (sort, N1,
   the rest); kernel C1 (the face crop) on the path's own rois at 128
   frames x 8 faces and at 1 frame: taps equal to its twin's, crops
   within 1e-4 of the twin on the card, its time (median of 20, L2
   flushed) against the twin's and its bound; the overlay through the graphs equal to the eager overlay at
   720x1088, 480x640 and 1080x1920; ms per call graph and eager in turns
   at 1 and 128 frames for both stems and ms per overlay frame; copy-in,
   replay and clone-out costs and each program's pool bytes; and one
   ``torch.profiler`` pass over a 128-frame replay and an overlay frame,
   whose kernel launches must equal the credited counters (with the
   replays' device busy time and idle share).
15. kernel R1, ResNeSt's split-attention radix combine (``splat_phase``):
   both entries at the served ResNeSt-50's seven distinct shapes (1,024
   faces, bf16, radix 2) against their twins, within one bf16 step; each
   entry's time (median of 20, L2 flushed) and the twins', summed over the
   16 blocks, against the bytes bound (each radix tensor read once, each
   combined tensor written once: 3.46 GB); beside them the same two steps
   in plain PyTorch on the radix tensor's channels-last view (the
   layout-only rewrite, no kernel of its own).
16. kernel BN1, the conv backbones' BatchNorm + activation + residual
   pass (``bnact_phase``): every BN site of the served MobileNetV2 (52)
   and ResNeSt-50 (51) at 1,024 faces in bf16 against the twin (the chain
   before BN1) bit for bit; BN1's time (median of 20, L2 flushed) and the
   twin's, summed over each backbone's sites, against the bytes bound
   (each operand read once, each result written once). Phase 14's trace
   counts BN1's launches in the replay against the credited table, and
   phase 11 the launches of the resnest50 and mobilenet_v2_1.4 calls.
   The served HRNetV2-W18's 243 sites at 256 pixels the same way, at the
   widths it stores (24, 40 and 272 channels where it publishes 18, 36
   and 270), all on BN1's 16-byte vectors.
17. kernel F1, HRNet's exchange unit (``hrfuse_phase``): every output of
   the served HRNetV2-W18's three exchange-unit shapes at 1,024 faces in
   bf16, at its stored widths, against the twin bit for bit; F1's time
   (median of 20, L2 flushed) and the twin's, summed over the net's 26
   outputs, against the bytes bound (each term read once at its
   resolution, the identity read once, the output written once); then
   the HRNetV2-W18 API at crop 256: its served net against the published
   one on the same weights (param62 and the pooled features within 0.1
   of their norm, bf16 rounding; fp8 reads 0.49), a
   128-frame ``process_batch`` credited 243 BN1 and 26 F1 launches a call;
   cuDNN's channel pads, traced: the served backbone's no more than its
   stem conv's input and filter, a replay's no more than those and the
   detector's own graph's.
18. kernels M1, G1 and M2, V-MoE-B/16's routed experts (``moe_phase``):
   at the served layer's shape (1,024 faces x 197 tokens of 768, 32
   experts, MLP 3,072) under a balanced and a skewed routing (expert 0
   holding half the rows), M1 (route and dispatch) and M2 (combine)
   against their twins on the card's tensors bit for bit, G1 (the grouped
   expert GEMM, two passes) within one bf16 step; each one's time (median
   of 20, L2 flushed) against its bound (``perfbench/counts/moe.py``), the
   twins' and ``torch._grouped_mm``'s at G1's offsets (a yardstick only);
   then a 128-frame ``process_batch`` through a seeded V-MoE-B/16 API at
   crop 224, credited 12 M1, 12 G1 and 6 M2 launches (a traced replay
   runs as many), tallying 2,420,736 routed rows; and the top-2 flips
   against the float32 reference at three benchmark seeds' weights.

Prints the kernels as one JSON line (B1-B4, N1, C1, R1, BN1, F1, M1, G1
and M2, each with its launches on its path, error against its twin, kernel, plain and library ms, and the least time
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

from perfbench.tracing import device_busy

FACES = 8
BATCH = 128
CANVAS = (720, 1088)
OVERLAY_FRAMES = ((720, 1088), (480, 640), (1080, 1920))
RTOL, ATOL = 1e-4, 1e-3     # the dense decode's tolerance (f32)
STEM_TOL = dict(rtol=1.6e-2, atol=1e-5)     # bf16's own tolerance
DEVICE = "cuda:0"
KERNELS = ("fused_decode", "raster_tiled", "stem_s2d8", "nms_greedy",
           "crop_bilinear", "split_attention", "bn_act", "hr_fuse", "moe")
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


def profile_calls(fn, n, trace_path, top=10):
    """Run ``fn()`` once to warm up, then ``n`` times under the profiler.

    Writes the Chrome trace to ``trace_path`` and returns per-call
    ``wall_ms`` (host clock over the window, device synchronised at its
    end), ``busy_ms``, ``idle_share`` = 1 - busy / wall, ``ops`` and the
    ``top`` device ops by time as ``[(name, ms per call), ...]``. The
    profiler itself slows the host, so ``wall_ms`` exceeds an unprofiled
    call's time."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    prof.export_chrome_trace(trace_path)
    with open(trace_path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    d = device_busy(events)
    wall_ms, busy_ms = wall * 1e3 / n, d["busy_us"] / 1e3 / n
    leaders = sorted(d["per_op_us"].items(), key=lambda kv: -kv[1])[:top]
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms, "ops": d["ops"] / n,
            "top": [(name, us / 1e3 / n) for name, us in leaders]}


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


def ab_turns(parent_dir, worker, describe, card):
    """A same-work A/B in turns (parent, this tree, this tree, parent),
    each turn ``chip_smoke.py --<worker> DIR`` in a process of its own,
    which prints one line ``<worker> {json}``; ``describe(turn)`` makes its
    log text. -> {"parent": [turn, turn], "change": [turn, turn]}."""
    here = os.path.dirname(os.path.abspath(__file__))
    tag = worker.replace("-", "_") + " "
    turns = {"parent": [], "change": []}
    for who in ("parent", "change", "change", "parent"):
        pkg = parent_dir if who == "parent" else here
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), f"--{worker}", pkg],
            capture_output=True, text=True, timeout=600)
        line = [ln for ln in proc.stdout.splitlines() if ln.startswith(tag)]
        if proc.returncode != 0 or not line:
            fail(f"{worker} A/B turn on {pkg} failed (exit {proc.returncode})"
                 f":\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        turn = json.loads(line[-1][len(tag):])
        turns[who].append(turn)
        log(f"{describe(turn, who)} | {card}")
    return turns


def raster_ab(parent_dir, card):
    """The raster entry points' same-work A/B (:func:`raster_worker`)."""
    return ab_turns(parent_dir, "raster-worker", lambda turn, who: (
        f"raster A/B {who} ({turn['form']}): " + "; ".join(
            f"{k} {turn[k]['ms']:.4f} ms ({turn[k]['ms_min']:.4f}-"
            f"{turn[k]['ms_max']:.4f}) on the device clock, entry "
            f"{turn[k]['ms_entry']:.4f} ms, launches "
            + ", ".join(f"{n} {ms:.4f}" for n, ms in
                        turn[k]["device_ms"].items())
            for k in ("payload", "ids"))), card)


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
    from synergynet_tpu_torch.ops import cuda_build
    from synergynet_tpu_torch.ops.fused_decode import (
        decode_dense_fused_reference)
    from synergynet_tpu_torch.pipeline import (SynergyNet3DMM,
                                               UVTextureMapper,
                                               preprocess_crops)
    from synergynet_tpu_torch.pipeline.api import _crops_on
    from synergynet_tpu_torch.render import (
        OVERLAY_LIGHT_CFG, RenderPipeline, add_weighted_u8, rasterize,
        rasterize_tiled, rasterize_triangles, render_overlay, render_texture)

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
    counters = {"B1 fused_decode": "synergy_fused_decode",
                "B2 raster_tiled": "synergy_raster_mesh",
                "B3 raster_ids": "synergy_raster_mesh_ids",
                "B4 stem_s2d8": "synergy_stem_s2d8"}
    for symbol in counters.values():
        cuda_build.launches[symbol] = 0
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
    launches = {k: cuda_build.launches[symbol]
                for k, symbol in counters.items()}
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
# BN1 launches a forward of the backbones that route through it (the
# served MobileNetV2 has 52 at every width).
BN1_SITES = {"resnest50": 51, "mobilenet_v2_1.4": 52, "mobilenet_v2": 52,
             "hrnetv2_w18": 243}
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
    frames in bf16, B1 launched in each and R1 32 times a call in
    resnest50's; the detector from a seeded
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
    from synergynet_tpu_torch.ops import cuda_build
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
        cuda_build.launches["synergy_fused_decode"] = 0
        got = api32.get_all_outputs(img, rects=API_RECTS)
        cuda_build.launches["synergy_splat_pool"] = 0
        cuda_build.launches["synergy_splat_combine"] = 0
        cuda_build.launches["synergy_bn_act"] = 0
        out = eng.process_batch(frames, frames_s2d, hws)
        torch.cuda.synchronize()
        launches = cuda_build.launches["synergy_fused_decode"]
        if launches <= 0:
            fail(f"phase 11 {arch}: never launched kernel B1")
        # R1 on the served path: a pool and a combine in each of the 16
        # split-attention blocks of every process_batch call.
        r1_launches = (cuda_build.launches["synergy_splat_pool"]
                       + cuda_build.launches["synergy_splat_combine"])
        if arch == "resnest50" and (r1_launches <= 0 or r1_launches % 32):
            fail(f"phase 11 resnest50: process_batch credited kernel R1 "
                 f"{r1_launches} launches, not a positive multiple of 32")
        # BN1 on the served path: every BN site of the two conv backbones
        # that route through it, none in the other families.
        bn1_launches = cuda_build.launches["synergy_bn_act"]
        sites = BN1_SITES.get(arch, 0)
        if not (bn1_launches > 0 and bn1_launches % sites == 0 if sites
                else bn1_launches == 0):
            fail(f"phase 11 {arch}: process_batch credited kernel BN1 "
                 f"{bn1_launches} launches, {sites} sites a call")
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
            "launches_b1": launches, "launches_r1": r1_launches,
            "launches_bn1": bn1_launches,
            "card_vs_cpu_err": err,
            "get_all_outputs_ms": ms_api,
            "get_all_outputs_faces_per_s": FACES / ms_api * 1e3,
            "process_batch_ms": ms_b,
            "process_batch_faces_per_s": b * FACES / ms_b * 1e3}
        log(f"phase 11 {arch} ({families[arch]['params_m']:.1f}M values in "
            f"a seeded best.pth.tar, imported): B1 launched "
            f"{launches} times, R1 {r1_launches}, BN1 {bn1_launches}; "
            f"get_all_outputs 8 rects f32 (TF32 off) card "
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
        cuda_build.launches["synergy_stem_s2d8_f32"] = 0
        raw_g, n_g = det.detect_raw(small)
        faces = det(small)
        torch.cuda.synchronize()
        f32_launches = cuda_build.launches["synergy_stem_s2d8_f32"]
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
    from synergynet_tpu_torch.ops import cuda_build
    from synergynet_tpu_torch.ops.fused_decode import (
        decode_dense_fast, decode_dense_fused_reference, get_decode_basis)
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
    cuda_build.launches["synergy_fused_decode"] = 0
    fast = {b: decode_dense_fast(p, pack) for b, p in params.items()}
    torch.cuda.synchronize()
    launches = cuda_build.launches["synergy_fused_decode"]
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

    # A fresh engine captures its program under the patch (``eng`` replays
    # the program it captured with the guard).
    real = unguarded()
    try:
        eng_t = FusedFrameEngine(eng.api, detector=eng.detector)
        n_t, rois_t, dense_t = engine_faces(torch, eng_t, img)
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
        e = eng_t if which == "f32_tf32_on" else eng
        real = unguarded() if which == "f32_tf32_on" else None
        try:
            turns[which].append(time_ms(lambda: e.process_batch(*args1),
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
    del eng, eng_t, cpu, eng16, api16
    torch.cuda.empty_cache()
    shutil.rmtree(tmp)                  # ~280 MB of written reference files
    secs = time.perf_counter() - t_phase
    out["seconds"] = secs
    out["launches_b1"] = launches
    log(f"phase 12 (ingest, the evaluation CLI, the f32 engine): {secs:.1f} s")
    return out


DET_STEPS = 20
DET_BATCH = 8
# One DetectorTrainer step, card against CPU, from the same seeded weights.
# f32: the losses within DET_LOSS_REL (one forward; cuDNN's f32 convs
# differ from the CPU's by up to ~1e-5, and a random-init BatchNorm net's
# gradient amplifies that to the whole size of some leaves' updates:
# 1.08x at worst, measured on an NVIDIA H100 80GB HBM3 at 700 W). float64:
# the update, the trace and the running statistics within DET_F64_REL of
# each leaf's scale, which holds the step's math.
DET_LOSS_REL = 1e-4
DET_F64_REL = 1e-6


def worst_flat_rel(got, want, sizes):
    """worst_rel over the leaves of two flat buffers split by ``sizes``."""
    names = [str(i) for i in range(len(sizes))]
    return worst_rel(dict(zip(names, got.split(sizes))),
                     dict(zip(names, want.split(sizes))))


def scaleout_phase(torch, dev, card, eng, frames, frames_s2d, hws,
                   backend="nccl"):
    """Scale-out and detector training on the card (phase 13): the
    mesh-bound step, sharded serving and the TP decode at world size 1
    over NCCL; two ranks sharing the card over gloo with CUDA tensors
    (``dryrun_multichip(2)``); DetectorTrainer card vs CPU. Returns the
    numbers for the JSON line."""
    import tempfile
    import torch.distributed as dist
    from synergynet_tpu_torch.core.config import Config
    from synergynet_tpu_torch.core.mesh import make_mesh
    from synergynet_tpu_torch.core.profiling import (StageTimer,
                                                     device_memory_stats)
    from synergynet_tpu_torch.detect import DetectorTrainer
    from synergynet_tpu_torch.detect import make_synthetic_detection_batch
    from synergynet_tpu_torch.detect.detector import random_init_variables
    from synergynet_tpu_torch.mm3d import load_param_pack
    from synergynet_tpu_torch.nn import SynergyNet
    from synergynet_tpu_torch.ops import cuda_build
    from synergynet_tpu_torch.ops.fused_decode import (build_decode_basis,
                                                       decode_dense_fused)
    from synergynet_tpu_torch.parallel import (shard_fused_engine,
                                               tp_dense_decode,
                                               warm_mesh_cliques)
    from synergynet_tpu_torch.parallel.dryrun import (STATE_REL,
                                                      dryrun_multichip)
    from synergynet_tpu_torch.train import (create_train_state,
                                            jit_train_step, lr_per_step,
                                            make_optimizer, make_train_step)
    t_phase = time.perf_counter()
    out = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    timer = StageTimer(device=dev)

    # -- 13a. world size 1 over NCCL ------------------------------------------
    build = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build")
    os.makedirs(build, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=build)
    dist.init_process_group(backend,
                            init_method=f"file://{tmp}/rendezvous",
                            world_size=1, rank=0)
    try:
        backend, world = dist.get_backend(), dist.get_world_size()
        mesh = make_mesh(device=dev)
        warm_mesh_cliques(mesh)
        where = f"{backend}, world size {world}, mesh {mesh.shape}"
        cfg = Config()
        t = cfg.train
        pack = load_param_pack()
        opt = make_optimizer(lr_per_step(t.base_lr, t.milestones, t.warmup,
                                         TRAIN_STEPS),
                             momentum=t.momentum, nesterov=t.nesterov,
                             weight_decay=t.weight_decay)
        g = np.random.default_rng(13)
        imgs = torch.from_numpy(g.integers(0, 256, (TRAIN_BATCH, 120, 120,
                                                    3), np.uint8)).to(dev)
        tgts = torch.from_numpy(g.normal(0, 0.5, (TRAIN_BATCH, 62)).astype(
            np.float32)).to(dev)
        states, steps = [], {}
        for name, make in (("make_train_step", lambda: make_train_step(
                pack, opt, device=dev)), ("jit_train_step", lambda:
                jit_train_step(pack, opt, mesh))):
            model = SynergyNet(dropout=0.0, dtype=getattr(
                torch, cfg.model.compute_dtype)).to(dev)
            st = create_train_state(model, torch.Generator(
                device=dev).manual_seed(0), opt)
            steps[name] = (make(), st)
            states.append(st)
        with torch.no_grad():
            for x, y in zip(states[0].tensors(), states[1].tensors()):
                if not torch.equal(x, y):
                    fail("phase 13: the two initial states differ")
        for name, (step, st) in steps.items():
            step(st, imgs, tgts)
        torch.cuda.synchronize()
        a, b = states
        sizes = [p.numel() for p in a.model.parameters()]
        bsizes = [x.numel() for x in a.model.buffers()]
        errs = {"params": worst_flat_rel(b.params, a.params, sizes),
                "trace": worst_flat_rel(b.trace, a.trace, sizes),
                "stats": worst_flat_rel(b.stats, a.stats, bsizes)}
        bitwise = all(torch.equal(x, y) for x, y in zip(a.tensors(),
                                                         b.tensors()))
        log(f"phase 13 [{where}]: jit_train_step vs make_train_step, one "
            f"step from one state (MobileNetV2 1.0, "
            f"{cfg.model.compute_dtype}, B={TRAIN_BATCH}): bit for bit "
            f"{bitwise}; worst leaf " + ", ".join(
                f"{k} {v[0]:.2e}" for k, v in errs.items())
            + f" (tolerance {CARD_VS_CPU_REL} of each leaf's scale)")
        if max(v[0] for v in errs.values()) > CARD_VS_CPU_REL:
            fail("phase 13: jit_train_step disagrees with make_train_step")
        for name, (step, st) in steps.items():     # warm, then in turns
            step(st, imgs, tgts)
        for _ in range(3):
            for name, (step, st) in steps.items():
                with timer.stage(name):
                    step(st, imgs, tgts)
        avg = timer.averages()
        step_ms = {k: avg[k] * 1e3 for k in steps}
        cost = step_ms["jit_train_step"] - step_ms["make_train_step"]
        log(f"phase 13 [{where}]: step ms (CUDA events, mean of 3 in turns)"
            f": make_train_step {step_ms['make_train_step']:.3f}, "
            f"jit_train_step {step_ms['jit_train_step']:.3f}, the mesh "
            f"wrapper {cost:+.3f} | {card}")
        out["world1"] = {"backend": backend, "world": world,
                         "step_bitwise": bitwise,
                         "step_rel": {k: v[0] for k, v in errs.items()},
                         "step_ms": step_ms}
        del steps, states, a, b, st, model
        torch.cuda.empty_cache()

        # sharded serving at 128 frames against process_batch
        run = shard_fused_engine(eng, mesh)
        got = run(frames, frames_s2d, hws)
        want = eng.process_batch(frames, frames_s2d, hws)
        serve_equal = all(torch.equal(x, y) for x, y in zip(got, want))
        if not serve_equal:
            if not torch.equal(got[1], want[1]):
                fail("phase 13: shard_fused_engine's face counts differ")
            for x, y in zip(got[4:6], want[4:6]):
                torch.testing.assert_close(x, y, rtol=RTOL, atol=ATOL)
        with timer.stage("shard_fused_engine"):
            run(frames, frames_s2d, hws)
        with timer.stage("process_batch"):
            eng.process_batch(frames, frames_s2d, hws)
        avg = timer.averages()
        log(f"phase 13 [{where}]: shard_fused_engine at {BATCH} frames vs "
            f"process_batch: bit for bit {serve_equal}; "
            f"{avg['shard_fused_engine'] * 1e3:.3f} vs "
            f"{avg['process_batch'] * 1e3:.3f} ms (one call each) | {card}")
        out["world1"]["serve_bitwise"] = serve_equal

        # the TP decode: one slab (the whole padded basis) on kernel B1
        p = torch.from_numpy(np.random.default_rng(14).normal(
            0, 1, (FACES * BATCH, 62)).astype(np.float32)).to(dev)
        cuda_build.launches["synergy_fused_decode"] = 0
        decode = tp_dense_decode(mesh, pack)
        slab, checksum = decode(p)
        torch.cuda.synchronize()
        launches_w1 = cuda_build.launches["synergy_fused_decode"]
        basis = build_decode_basis(pack).to(dev)
        whole = decode_dense_fused(p, basis, pack.to(dev))
        nver = basis.nver
        tp_equal = torch.equal(slab[:, :, :nver], whole)
        torch.testing.assert_close(slab[:, :, :nver], whole, rtol=RTOL,
                                   atol=ATOL)
        log(f"phase 13 [{where}]: tp_dense_decode, {FACES * BATCH} faces, "
            f"one slab of {slab.shape[2]} vertices: B1 launched "
            f"{launches_w1} time(s); against decode_dense_fused bit for bit "
            f"{tp_equal}, max_abs_err "
            f"{(slab[:, :, :nver] - whole).abs().max().item():.3e}")
        if launches_w1 == 0:
            fail("phase 13: tp_dense_decode never launched kernel B1")
        out["world1"]["tp_bitwise"] = tp_equal
        del slab, whole, basis
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)

    # -- 13b. two ranks sharing the card over gloo ----------------------------
    with timer.stage("dryrun_multichip(2)"):
        dr = dryrun_multichip(2, device=dev.type, backend="gloo",
                              timeout=300,
                              workdir=build)
    if dr["backend"] != "gloo" or dr["world"] != 2:
        fail(f"phase 13: dryrun ran over {dr['backend']} at {dr['world']}")
    if min(dr["tp_launches"]) == 0:
        fail("phase 13: a rank's vertex slab never launched kernel B1")
    log(f"phase 13 [gloo, world size 2, {dev.type.upper()} tensors, mesh "
        f"{dr['mesh']}]: "
        f"dryrun_multichip(2) against one process: sync-BN step worst leaf "
        + ", ".join(f"{k} {v:.2e}" for k, v in dr["sync_bn_rel"].items())
        + "; per-replica step " + ", ".join(
            f"{k} {v:.2e}" for k, v in dr["step_rel"].items())
        + f"; TP decode (2 slabs, B1 launches {dr['tp_launches']}) "
        f"max_abs_err {dr['tp_max_abs_err']:.3e} (bit for bit "
        f"{dr['tp_max_abs_err'] == 0.0}), checksum "
        f"{dr['tp_checksum_err']:.3e}; sharded serving "
        f"{dr['serve_faces']} faces, max_abs_err {dr['serve_max_abs_err']:.3e}"
        f"; generative epoch " + ", ".join(
            f"{k} {v:.2e}" for k, v in dr["gen_rel"].items())
        + f" (tolerance {STATE_REL}); "
        f"{timer.averages()['dryrun_multichip(2)']:.1f} s | {card}")
    out["two_ranks"] = dr

    # -- 13c. DetectorTrainer, card vs CPU ------------------------------------
    variables = random_init_variables(0)
    batch = make_synthetic_detection_batch(np.random.default_rng(7),
                                           DET_BATCH)
    cpu = torch.device("cpu")
    det = {}
    for dtype in (torch.float32, torch.float64):
        trainers = {d: DetectorTrainer(variables=variables, device=d,
                                       dtype=dtype) for d in (dev, cpu)}
        tc, tg = trainers[cpu], trainers[dev]
        init = tc.state.params.clone()
        losses = {d: tr.train_step(batch) for d, tr in trainers.items()}
        sizes = [p.numel() for p in tc.net.parameters()]
        bsizes = [x.numel() for x in tc.net.buffers()]
        det[str(dtype).split(".")[1]] = {
            "loss_rel": abs(losses[dev]["loss_total"] - losses[cpu][
                "loss_total"]) / abs(losses[cpu]["loss_total"]),
            "update": worst_flat_rel(tg.state.params.cpu() - init,
                                     tc.state.params - init, sizes)[0],
            "trace": worst_flat_rel(tg.state.trace.cpu(), tc.state.trace,
                                    sizes)[0],
            "stats": worst_flat_rel(tg.state.stats.cpu(), tc.state.stats,
                                    bsizes)[0]}
    f32, f64 = det["float32"], det["float64"]
    log(f"phase 13 DetectorTrainer {DET_BATCH}x256x256, one step card vs "
        f"CPU from the same seeded weights: f32 loss_total rel "
        f"{f32['loss_rel']:.2e} (tolerance {DET_LOSS_REL}; update, trace, "
        f"stats worst leaf {f32['update']:.2e}, {f32['trace']:.2e}, "
        f"{f32['stats']:.2e}: f32 rounding amplified, not held); float64 "
        f"update, trace, stats worst leaf {f64['update']:.2e}, "
        f"{f64['trace']:.2e}, {f64['stats']:.2e} (tolerance {DET_F64_REL} "
        "of each leaf's scale)")
    if f32["loss_rel"] > DET_LOSS_REL or max(
            f64[k] for k in ("update", "trace", "stats")) > DET_F64_REL:
        fail("phase 13: DetectorTrainer on the card disagrees with the CPU")
    tg = DetectorTrainer(variables=variables, device=dev)
    rng = np.random.default_rng(0)
    hist = []
    for _ in range(DET_STEPS):
        b = make_synthetic_detection_batch(rng, DET_BATCH)
        with timer.stage("detector_step"):
            hist.append(tg.step(*(torch.from_numpy(b[k]) for k in (
                "images", "boxes", "valid")))["loss_total"])
    hist = [float(x) for x in hist]
    det_ms = timer.averages()["detector_step"] * 1e3
    log(f"phase 13 DetectorTrainer on the card: {DET_STEPS} steps, loss "
        f"{hist[0]:.4f} -> {hist[-1]:.4f} (mean of the first and last 5: "
        f"{np.mean(hist[:5]):.4f} -> {np.mean(hist[-5:]):.4f}), "
        f"{det_ms:.3f} ms a step (CUDA events, mean of {DET_STEPS}, host "
        f"batch upload inside) | {card}")
    if not (np.isfinite(hist).all() and np.mean(hist[-5:]) < np.mean(
            hist[:5])):
        fail("phase 13: DetectorTrainer's loss did not fall")
    peak = device_memory_stats(dev).get("allocated_bytes.all.peak", 0)
    secs = time.perf_counter() - t_phase
    out["detector"] = {"card_vs_cpu": det, "step_ms": det_ms,
                       "loss_first": hist[0], "loss_last": hist[-1]}
    out.update(peak_gib=peak / 2 ** 30, seconds=secs,
               launches_b1=launches_w1 + sum(dr["tp_launches"]))
    log(f"phase 13 (scale-out and detector training): {secs:.1f} s, peak "
        f"{peak / 2 ** 30:.2f} GiB in this process (device_memory_stats) | "
        f"{card}")
    return out


# -- phase 14: captured programs and kernel N1 -------------------------------

OVERLAY_REPS = 10
# Kernel-name fragments in a profiler trace, per launch counter.
TRACE_NAMES = {"B1 fused_decode": "decode_kernel",
               "N1 nms_greedy": "nms_tile_walk_kernel",
               "C1 crop_bilinear": "crop_bilinear_kernel",
               "B4 stem_s2d8": "stem_kernel",
               "B2 raster_tiled": "resolve_mesh_kernel",
               "BN1 bn_act": "bnact_"}


def sm_clock_mhz():
    """The card's top SM clock (``nvidia-smi clocks.max.sm``), MHz."""
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60)
    return float(out.stdout.strip())


def n1_split(top):
    """N1's two kernels' device ms per call from ``profile_calls``'
    ``top`` list: the suppression bits and the walk (``nms_tile_*`` since
    the tiled redesign, ``nms_bits_kernel`` / ``nms_walk_kernel`` before
    it, as an earlier commit's turn of the A/B names them)."""
    return {part: sum(ms for name, ms in top
                      if "nms_" in name and f"{part}_kernel" in name)
            for part in ("bits", "walk")}


N1_AB_INPUTS = os.path.join("build", "chip_smoke_n1_inputs.pt")


def n1_times(torch, greedy_nms_mask, tb, tv, thr, flush, trace_dir, tag):
    """N1's entry on (tb, tv): device ms (min, median, max of 20 L2-flushed
    runs), the median warm (no flush), and the bits / walk device ms per
    call under ``torch.profiler``, cold (flushed before each call) and
    warm."""
    fn = lambda: greedy_nms_mask(tb, tv, thr)   # noqa: E731

    def cold():
        flush()
        fn()

    spread = time_spread(fn, 20, torch, flush)
    warm = time_spread(fn, 20, torch, lambda: None)
    split = {}
    for name, g in (("cold", cold), ("warm", fn)):
        prof = profile_calls(g, 5, os.path.join(
            trace_dir, f"n1_{tag}_{name}.json"), top=1000)
        split[name] = n1_split(prof["top"])
    return {"ms": spread[1], "ms_min": spread[0], "ms_max": spread[2],
            "ms_warm": warm[1], "split_cold": split["cold"],
            "split_warm": split["warm"]}


def nms_worker(pkg_dir):
    """One turn of N1's same-work A/B: import the package at ``pkg_dir``
    (this checkout, or a parent's), run its ``greedy_nms_mask`` on the
    phase-14 candidates saved at ``N1_AB_INPUTS`` (B=1 and B=128 frames of
    2,048), check the keep masks against the saved twin's, and print one
    JSON line of :func:`n1_times` per batch."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.abspath(pkg_dir))
    import torch
    from synergynet_tpu_torch.detect import nms
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a card")
    dev = torch.device(DEVICE)
    saved = torch.load(os.path.join(here, N1_AB_INPUTS))
    flush_buf = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    trace_dir = os.path.join(os.path.abspath(pkg_dir), "build")
    os.makedirs(trace_dir, exist_ok=True)
    out = {"package": os.path.abspath(nms.__file__)}
    with torch.inference_mode():
        for b, (tb, tv, want) in saved["inputs"].items():
            tb, tv = tb.to(dev), tv.to(dev)
            got = nms.greedy_nms_mask(tb, tv, saved["threshold"])
            if not torch.equal(got.cpu(), want):
                fail(f"N1 A/B turn on {pkg_dir}: B={b} differs from the twin")
            out[str(b)] = n1_times(torch, nms.greedy_nms_mask, tb, tv,
                                   saved["threshold"], flush_buf.zero_,
                                   trace_dir, f"b{b}")
    print("nms_worker " + json.dumps(out), flush=True)


def nms_ab(parent_dir, card):
    """N1's same-work A/B (:func:`nms_worker`)."""
    return ab_turns(parent_dir, "nms-worker", lambda turn, who: (
        f"N1 A/B {who}: " + "; ".join(
            f"B={b} {t['ms']:.4f} ms ({t['ms_min']:.4f}-{t['ms_max']:.4f}) "
            f"L2 flushed on the device clock, {t['ms_warm']:.4f} warm; "
            f"profiler bits / walk cold {t['split_cold']['bits']:.4f} / "
            f"{t['split_cold']['walk']:.4f}, warm "
            f"{t['split_warm']['bits']:.4f} / {t['split_warm']['walk']:.4f}"
            for b, t in turn.items() if b != "package")), card)


# C1 and its twin round every product and sum once, in the same order
# (tests/test_torch_gpu.py's CROP_ATOL): a few float32 ulps at 255.
C1_ATOL = 1e-4
# C1's least traffic a face: the 120 x 120 x 3 f32 crop written once and
# the roi read once (the source taps left out); operations: four taps a
# value, each a multiply and an add, and the weights of each output row
# and column (perfbench/counts/crop.py).
C1_BYTES_A_FACE = 120 * 120 * 3 * 4 + 4 * 4
C1_FLOPS_A_FACE = 120 * 120 * 3 * 4 * 2 + 4 * 120 * 4


def c1_checks(torch, dev, card, eng, frames, frames_s2d, hws):
    """Kernel C1 on the serving path's own rois (``process_batch``'s, 8 a
    frame) at 128 frames and at 1: its taps equal the twin's, its crops
    within ``C1_ATOL`` of the twin's on the card (and whether bit for bit),
    its time (min / median / max of 20 L2-flushed runs on the device
    clock) against the twin's and the bound."""
    from synergynet_tpu_torch.pipeline.device_crop import (
        crop_resize_bilinear, crop_resize_reference, crop_taps)
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    res = {}
    for b in (BATCH, 1):
        img = frames[:b]
        with torch.inference_mode():
            rois = eng.process_batch(img, frames_s2d[:b], hws[:b])[2]
            got = crop_resize_bilinear(img, rois)
            want = crop_resize_reference(img, rois)
            idx, f = crop_taps(rois, img.shape[1:3])
        torch.cuda.synchronize()
        widx, wf = crop_taps(rois.cpu(), img.shape[1:3])
        if not (torch.equal(idx.cpu(), widx) and torch.equal(f.cpu(), wf)):
            fail(f"phase 14 C1 B={b}: its taps differ from the twin's")
        err = float((got - want).abs().max())
        if err > C1_ATOL:
            fail(f"phase 14 C1 B={b}: crops differ from the twin by {err}")
        spread = time_spread(lambda: crop_resize_bilinear(img, rois), 20,
                             torch, flush.zero_)
        plain = time_ms(lambda: crop_resize_reference(img, rois),
                        3 if b > 1 else 10, torch, flush.zero_)
        faces = rois.shape[0] * rois.shape[1]
        bnd, by = bound(faces * C1_BYTES_A_FACE, faces * C1_FLOPS_A_FACE,
                        F32_FLOPS)
        res[str(b)] = {"faces": faces, "max_abs_err": err,
                       "bit_for_bit": bool(torch.equal(got, want)),
                       "ms": spread[1], "ms_min": spread[0],
                       "ms_max": spread[2], "plain_ms": plain,
                       "bound_ms": bnd, "bound_by": by}
        log(f"phase 14 C1 B={b} ({faces} faces of the path's rois): taps = "
            f"twin's, crops within {err:.3g} of the twin (bit for bit: "
            f"{res[str(b)]['bit_for_bit']}) | kernel min/median/max "
            f"{spread[0]:.4f} / {spread[1]:.4f} / {spread[2]:.4f} ms over 20 "
            f"(L2 flushed) | twin {plain:.4f} ms | bound {bnd:.4f} ms ({by}) "
            f"| {bnd / spread[1]:.3f} of bound | {card}")
    return res


# -- 15. kernel R1, ResNeSt's split-attention radix combine -------------------

# The served ResNeSt-50's split-attention blocks at 120 pixels (radix 2,
# cardinality 1): (H, W, c, blocks) of each distinct shape, 16 blocks.
SPLAT_SHAPES = ((30, 30, 64, 3), (30, 30, 128, 1), (15, 15, 128, 3),
                (15, 15, 256, 1), (8, 8, 256, 5), (8, 8, 512, 1),
                (4, 4, 512, 2))
SPLAT_RADIX = 2


def splat_layout_pool(torch, y, radix):
    """R1's pool in plain PyTorch on ``y``'s channels-last view (B, H W,
    radix, c): the radix sum rounded to ``y``'s dtype, its spatial mean
    accumulated in f32 and rounded once, as the twin does."""
    b, rc, h, w = y.shape
    v = y.permute(0, 2, 3, 1).view(b, h * w, radix, rc // radix)
    return v.sum(2).mean(1, dtype=torch.float32).to(y.dtype).view(
        b, rc // radix, 1, 1)


def splat_layout_combine(torch, y, logits, radix, groups):
    """R1's combine in plain PyTorch on ``y``'s channels-last view: the
    rSoftmax weights (B, 1, radix, c), then the weighted radix sum as an
    inner reduce over contiguous channels, written channels-last."""
    b, rc, h, w = y.shape
    c = rc // radix
    v = y.permute(0, 2, 3, 1).view(b, h * w, radix, c)
    atten = torch.softmax(logits.view(b, groups, radix, c // groups), dim=2)
    atten = atten.transpose(1, 2).reshape(b, 1, radix, c)
    return (v * atten).sum(2).view(b, h, w, c).permute(0, 3, 1, 2)


def splat_phase(torch, dev, card):
    """Kernel R1 (phase 15) at the served shapes, 1,024 faces in bf16: each
    entry against its twin (within one bf16 step), its time (min / median
    / max of 20 L2-flushed runs on the device clock) and the twin's (mean
    of 3), summed over the 16 blocks, against the bound: each radix tensor
    read once and each combined tensor written once (3.46 GB over 3.35
    TB/s; the two passes' own floor, the radix tensor read twice, beside
    it), and the layout-only rewrite's time (``splat_layout_pool`` +
    ``splat_layout_combine``, median of 20, L2 flushed) with its distance
    from the twin. Returns the numbers for the JSON line."""
    from synergynet_tpu_torch.ops import cuda_build
    from synergynet_tpu_torch.ops.split_attention import (
        radix_combine, radix_combine_reference, radix_pool,
        radix_pool_reference)

    def r1_launches():
        return (cuda_build.launches["synergy_splat_pool"]
                + cuda_build.launches["synergy_splat_combine"])

    t_phase = time.perf_counter()
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    faces, r = FACES * BATCH, SPLAT_RADIX
    before = r1_launches()
    total = {"pool_ms": 0.0, "combine_ms": 0.0, "plain_ms": 0.0,
             "layout_ms": 0.0, "min_bytes": 0, "two_pass_bytes": 0}
    shapes, worst, worst_layout = [], 0, 0
    g = torch.Generator(device=dev).manual_seed(15)
    for h, w, c, blocks in SPLAT_SHAPES:
        y = torch.relu(torch.randn((faces, r * c, h, w), generator=g,
                                   device=dev)).to(torch.bfloat16)
        y = y.contiguous(memory_format=torch.channels_last)
        logits = (2 * torch.randn((faces, r * c, 1, 1), generator=g,
                                  device=dev)).to(torch.bfloat16)
        def steps(got, want):
            return int((got.contiguous().view(torch.int16).int()
                        - want.contiguous().view(torch.int16).int()
                        ).abs().max())

        def layout():
            return (splat_layout_pool(torch, y, r),
                    splat_layout_combine(torch, y, logits, r, 1))

        with torch.inference_mode():
            want = (radix_pool_reference(y, r),
                    radix_combine_reference(y, logits, r, 1))
            for got, ref in zip((radix_pool(y, r),
                                 radix_combine(y, logits, r, 1)), want):
                n = steps(got, ref)
                if n > 1:
                    fail(f"phase 15 R1 at {h}x{w}x{r * c}: {n} bf16 "
                         f"steps from the twin")
                worst = max(worst, n)
            lay = layout()
            if not lay[1].is_contiguous(memory_format=torch.channels_last):
                fail("phase 15: the layout-only combine is not "
                     "channels-last")
            worst_layout = max(worst_layout, *map(steps, lay, want))
            pool = time_spread(lambda: radix_pool(y, r), 20, torch,
                               flush.zero_)
            comb = time_spread(lambda: radix_combine(y, logits, r, 1), 20,
                               torch, flush.zero_)
            lay_ms = time_spread(layout, 20, torch, flush.zero_)
            plain = time_ms(lambda: radix_combine_reference(
                y, logits, r, 1) + radix_pool_reference(y, r), 3, torch,
                flush.zero_)
        per = y.numel() * 2
        shapes.append({"h": h, "w": w, "radix_c": r * c, "blocks": blocks,
                       "pool_ms": pool, "combine_ms": comb,
                       "layout_ms": lay_ms, "plain_ms": plain})
        total["pool_ms"] += blocks * pool[1]
        total["combine_ms"] += blocks * comb[1]
        total["layout_ms"] += blocks * lay_ms[1]
        total["plain_ms"] += blocks * plain
        total["min_bytes"] += blocks * (per + per // r)
        total["two_pass_bytes"] += blocks * (2 * per + per // r)
        log(f"phase 15 R1 {faces} faces at {h}x{w}, radix x c {r * c} (x"
            f"{blocks}): pool min/median/max {pool[0]:.4f} / {pool[1]:.4f} "
            f"/ {pool[2]:.4f} ms, combine {comb[0]:.4f} / {comb[1]:.4f} / "
            f"{comb[2]:.4f} ms over 20 (L2 flushed) | layout-only "
            f"{lay_ms[1]:.4f} ms | twin {plain:.4f} ms | radix tensor "
            f"{per / 1e6:.1f} MB | {card}")
        del y, logits, want, lay
    torch.cuda.synchronize()
    ms = total["pool_ms"] + total["combine_ms"]
    bnd, _ = bound(total["min_bytes"], 0, BF16_FLOPS)
    bnd2, _ = bound(total["two_pass_bytes"], 0, BF16_FLOPS)
    out = dict(total, ms=ms, bound_ms=bnd, two_pass_bound_ms=bnd2,
               max_steps=worst, max_steps_layout=worst_layout, shapes=shapes,
               launches_phase15=r1_launches() - before)
    log(f"phase 15 R1, 16 blocks of the served ResNeSt-50 at {faces} faces: "
        f"pool {total['pool_ms']:.4f} + combine {total['combine_ms']:.4f} = "
        f"{ms:.4f} ms | layout-only rewrite {total['layout_ms']:.4f} ms "
        f"({worst_layout} bf16 steps from the twin) | twin "
        f"{total['plain_ms']:.4f} ms | bound {bnd:.4f} ms "
        f"({total['min_bytes'] / 1e9:.3f} GB once; two passes "
        f"{bnd2:.4f} ms) | {bnd / ms:.3f} of bound | within {worst} bf16 "
        f"step of the twin | {card}")
    log(f"phase 15 (kernel R1): {time.perf_counter() - t_phase:.1f} s")
    return out


# -- 16. kernel BN1, the conv backbones' BatchNorm + activation + residual ----

BN1_ARCHS = ("mobilenet_v2", "resnest50", "hrnetv2_w18")


def bnact_sites(torch, dev, arch):
    """The served backbone's BN1 sites at its served crop (120 pixels, 256
    for HRNetV2-W18) and stored widths, {(C, H, W, act, residual form):
    sites}, from one forward on the card with a tally in BN1's place."""
    import collections

    from synergynet_tpu_torch.nn.backbones import make_backbone
    from synergynet_tpu_torch.ops.bn_act import bn_act_sites
    model = make_backbone(arch).to(dev).eval()
    getattr(model, "pad_channels_", lambda: None)()     # as the API serves
    crop = getattr(model, "input_size", None) or 120
    return collections.Counter(bn_act_sites(
        model, torch.zeros((1, crop, crop, 3), device=dev)))


def bnact_phase(torch, dev, card):
    """Kernel BN1 (phase 16) at every site of the served MobileNetV2,
    ResNeSt-50 and HRNetV2-W18, 1,024 faces in bf16: against its twin bit for bit (the
    count of differing values), its time (min / median / max of 20
    L2-flushed runs on the device clock) and the twin's (the chain before
    BN1: ``F.batch_norm``, the clamps, the add; mean of 3), summed over
    each backbone's sites, against the bound: each operand read once and
    each result written once over 3.35 TB/s. Returns the numbers for the
    JSON line."""
    from synergynet_tpu_torch.nn.batchnorm import BatchNorm
    from synergynet_tpu_torch.ops import cuda_build
    from synergynet_tpu_torch.ops.bn_act import bn_act, bn_act_reference

    t_phase = time.perf_counter()
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    faces = FACES * BATCH
    g = torch.Generator(device=dev).manual_seed(16)

    def operand(c, h, w):
        x = 3 * torch.randn((faces, c, h, w), generator=g, device=dev)
        return x.to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)

    def drawn_bn(c):
        bn = BatchNorm(c).to(dev).eval()
        with torch.no_grad():
            bn.running_mean.normal_(generator=g)
            bn.running_var.uniform_(0.05, 2.0, generator=g)
            bn.weight.normal_(generator=g)
            bn.bias.normal_(generator=g)
        return bn

    before = cuda_build.launches["synergy_bn_act"]
    out = {}
    for arch in BN1_ARCHS:
        sites = bnact_sites(torch, dev, arch)
        total = {"ms": 0.0, "plain_ms": 0.0, "min_bytes": 0, "differ": 0,
                 "sites": sum(sites.values()), "shapes": []}
        for (c, h, w, act, form), n in sorted(sites.items()):
            x = operand(c, h, w)
            r = operand(c, h, w) if form != "none" else None
            bn = drawn_bn(c)
            rbn = drawn_bn(c) if form == "bn" else None

            def bn1():
                return bn_act(x, bn, act, r, rbn)

            def twin():
                return bn_act_reference(x, bn, act, r, rbn)

            with torch.inference_mode():
                differ = int((bn1() != twin()).sum())
                ms = time_spread(bn1, 20, torch, flush.zero_)
                plain = time_ms(twin, 3, torch, flush.zero_)
            nbytes = x.numel() * 2 * (2 if r is None else 3)
            total["ms"] += n * ms[1]
            total["plain_ms"] += n * plain
            total["min_bytes"] += n * nbytes
            total["differ"] += differ
            total["shapes"].append({"c": c, "h": h, "w": w, "act": act,
                                    "residual": form, "sites": n,
                                    "ms": ms, "plain_ms": plain,
                                    "differ": differ})
            log(f"phase 16 BN1 {arch} {faces} faces at {h}x{w}x{c}, {act}, "
                f"residual {form} (x{n}): min/median/max {ms[0]:.4f} / "
                f"{ms[1]:.4f} / {ms[2]:.4f} ms over 20 (L2 flushed), "
                f"{nbytes / ms[1] / 1e6:.0f} GB/s | twin {plain:.4f} ms | "
                f"{differ} values differ from the twin | {card}")
            del x, r
        if total["differ"]:
            fail(f"phase 16 BN1 {arch}: {total['differ']} values differ "
                 f"from the twin")
        bnd, _ = bound(total["min_bytes"], 0, BF16_FLOPS)
        total["bound_ms"] = bnd
        out[arch] = total
        log(f"phase 16 BN1, the {total['sites']} sites of the served {arch} "
            f"at {faces} faces: {total['ms']:.4f} ms | twin "
            f"{total['plain_ms']:.4f} ms | bound {bnd:.4f} ms "
            f"({total['min_bytes'] / 1e9:.3f} GB once) | "
            f"{bnd / total['ms']:.3f} of bound | bit for bit | {card}")
    torch.cuda.synchronize()
    out["launches_phase16"] = cuda_build.launches["synergy_bn_act"] - before
    log(f"phase 16 (kernel BN1): {time.perf_counter() - t_phase:.1f} s")
    return out


# -- 17. kernel F1, HRNet's exchange unit -------------------------------------

# Served against published HRNetV2-W18 in bf16: cuDNN runs other kernels
# on the stored widths than on its own padded copies, so the two round
# apart, ~0.03 of param62's norm on calibrated weights; the bf16 net reads
# 0.045 against the float32 reference and fp8 0.49 (the card tests).
HRNET_REL = 0.1
# cuDNN copies a conv's input and its filter into padded buffers where their
# channels are off a multiple of 8 (the published HRNet: 520 copies a
# forward, two for each conv reading 18, 36 or 270 channels), or copies
# neither, as the engine it picks goes; in the served HRNet only the stem
# conv's 3 image channels are off.
STEM_PADS = 2
# Modules of each branch count in the served HRNetV2-W18: stage 2's one
# unit of 2 branches, stage 3's four of 3, stage 4's three of 4.
HRNET_UNITS = {2: 1, 3: 4, 4: 3}
F1_OUTPUTS = 26


def pad_launches(torch, fn, path):
    """cuDNN's NHWC channel-pad launches (``nhwcAddPaddingKernel``) while
    ``fn`` runs, counted in the kernels of a profiler trace written to
    ``path``."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    n = trace_kernel_counts(path, {"pad": "nhwcAddPaddingKernel"})["pad"]
    os.remove(path)
    return n


def captured(torch, fn):
    """``fn`` captured in a CUDA graph after a warm-up call on a side
    stream -> the graph's replay."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def served_against_published(torch, dev, api, crops):
    """The API's served HRNet against the net at its published widths on
    the API's own weights: -> the worst relative L2 of param62 and of the
    pooled features over the crops."""
    from synergynet_tpu_torch.convert import synergy_state_dict
    from synergynet_tpu_torch.nn import SynergyNet
    from synergynet_tpu_torch.nn.layers import cast_layers_
    model = SynergyNet("hrnetv2_w18", dtype=torch.bfloat16)
    model.load_state_dict(synergy_state_dict(api.variables))
    model = cast_layers_(model, torch.bfloat16).to(dev).eval()
    with torch.inference_mode():
        want, wfeat = model(crops)
        got, feat = api.model(crops)

    def rel(a, b):
        return ((a - b).norm(dim=-1) / b.norm(dim=-1)).max().item()

    return rel(got, want), rel(feat, wfeat)


def hrfuse_phase(torch, dev, card, frames, frames_s2d, hws, det_bf16):
    """Kernel F1 (phase 17): every output of the served HRNetV2-W18's three
    exchange-unit shapes (branches at 64, 32, 16 and 8 of a 256 crop, at
    the stored widths), 1,024 faces in bf16, against its twin bit for bit
    (the count of differing values); its time (min / median / max of 20
    L2-flushed runs on the device clock) and the twin's (the module's
    BatchNorms, nearest upsamples, adds and ReLU; mean of 3), summed over
    the net's 26 outputs, against the bound: each term read once at its
    resolution, the identity read once and the output written once over
    3.35 TB/s. Then a bf16 HRNetV2-W18 API at crop 256 on the benchmark's
    seeded tree, its statistics calibrated on 16 of 64 crops: its served
    net against the published one on the 64 crops; one ``process_batch`` of
    the 128 frames, which must credit 243 BN1 and 26 F1 launches, and its
    time (mean of 3); cuDNN's channel pads, traced: the served backbone's
    at most its stem conv's two, a replay's at most those and the
    detector's own graph's. Returns the numbers for the JSON line."""
    from perfbench import weights
    from perfbench.reference.regressors import hrnetv2_w18 as ref
    from synergynet_tpu_torch.nn.backbones.hrnet import WIDTHS, stored
    from synergynet_tpu_torch.nn.batchnorm import BatchNorm
    from synergynet_tpu_torch.ops import cuda_build
    from synergynet_tpu_torch.ops.hr_fuse import hr_fuse, hr_fuse_reference
    from synergynet_tpu_torch.pipeline import (FusedFrameEngine,
                                               SynergyNet3DMM)

    t_phase = time.perf_counter()
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    faces = FACES * BATCH
    side = 64
    g = torch.Generator(device=dev).manual_seed(17)

    def operand(c, h):
        x = 2 * torch.randn((faces, c, h, h), generator=g, device=dev)
        return x.to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)

    def drawn_bn(c):
        bn = BatchNorm(c).to(dev).eval()
        with torch.no_grad():
            bn.running_mean.normal_(generator=g)
            bn.running_var.uniform_(0.05, 2.0, generator=g)
            bn.weight.normal_(generator=g)
            bn.bias.normal_(generator=g)
        return bn

    before = cuda_build.launches["synergy_hr_fuse"]
    out = {"ms": 0.0, "plain_ms": 0.0, "min_bytes": 0, "differ": 0,
           "outputs": 0, "shapes": []}
    for n, modules in HRNET_UNITS.items():
        for i in range(n):
            c = stored(WIDTHS[i])
            ident = operand(c, side // 2 ** i)
            terms = [(operand(c, side // 2 ** max(i, j)), drawn_bn(c),
                      2 ** (j - i) if j > i else 1)
                     for j in range(n) if j != i]

            def f1():
                return hr_fuse(ident, terms)

            def twin():
                return hr_fuse_reference(ident, terms)

            with torch.inference_mode():
                differ = int((f1() != twin()).sum())
                ms = time_spread(f1, 20, torch, flush.zero_)
                plain = time_ms(twin, 3, torch, flush.zero_)
            nbytes = 2 * (2 * ident.numel()
                          + sum(t.numel() for t, _, _ in terms))
            out["ms"] += modules * ms[1]
            out["plain_ms"] += modules * plain
            out["min_bytes"] += modules * nbytes
            out["differ"] += differ
            out["outputs"] += modules
            out["shapes"].append({"branches": n, "output": i, "c": c,
                                  "h": side // 2 ** i,
                                  "scales": [s for _, _, s in terms],
                                  "units": modules, "ms": ms,
                                  "plain_ms": plain, "differ": differ})
            log(f"phase 17 F1 {faces} faces, output {i} of {n} branches at "
                f"{side // 2 ** i}x{side // 2 ** i}x{c}, scales "
                f"{[s for _, _, s in terms]} (x{modules}): min/median/max "
                f"{ms[0]:.4f} / {ms[1]:.4f} / {ms[2]:.4f} ms over 20 (L2 "
                f"flushed), {nbytes / ms[1] / 1e6:.0f} GB/s | twin "
                f"{plain:.4f} ms | {differ} values differ from the twin | "
                f"{card}")
            del ident, terms
    if out["outputs"] != F1_OUTPUTS:
        fail(f"phase 17: {out['outputs']} exchange outputs, expected "
             f"{F1_OUTPUTS}")
    if out["differ"]:
        fail(f"phase 17 F1: {out['differ']} values differ from the twin")
    out["bound_ms"], _ = bound(out["min_bytes"], 0, BF16_FLOPS)
    log(f"phase 17 F1, the {F1_OUTPUTS} exchange outputs of the served "
        f"HRNetV2-W18 at {faces} faces: {out['ms']:.4f} ms | twin "
        f"{out['plain_ms']:.4f} ms | bound {out['bound_ms']:.4f} ms "
        f"({out['min_bytes'] / 1e9:.3f} GB once) | "
        f"{out['bound_ms'] / out['ms']:.3f} of bound | bit for bit | {card}")
    torch.cuda.synchronize()
    out["launches_phase17"] = cuda_build.launches["synergy_hr_fuse"] - before

    crops = (torch.randint(0, 256, (64, 256, 256, 3), generator=g,
                           device=dev).float() - 127.5) / 128.0
    tree = weights.draw(ref.spec(), 17, dev)
    weights.calibrate("hrnetv2_w18", tree, crops[:16])
    api = SynergyNet3DMM("hrnetv2_w18", weights.numpy_tree(tree),
                         dtype=torch.bfloat16, device=dev, crop=256)
    rel, rel_feat = served_against_published(torch, dev, api, crops)
    out["served_vs_published"] = {"param62_rel": rel, "feature_rel": rel_feat}
    log(f"phase 17 HRNetV2-W18 served at widths "
        f"{tuple(map(stored, WIDTHS))} against published on 64 crops, bf16: "
        f"param62 {rel:.4f}, pooled features {rel_feat:.4f} of their norm "
        f"(limit {HRNET_REL}) | {card}")
    if max(rel, rel_feat) >= HRNET_REL:
        fail("phase 17: the served HRNet strays from the published one")
    del crops, tree
    eng = FusedFrameEngine(api, detector=det_bf16, max_faces=FACES)
    cuda_build.launches["synergy_bn_act"] = 0
    cuda_build.launches["synergy_hr_fuse"] = 0
    res = eng.process_batch(frames, frames_s2d, hws)
    torch.cuda.synchronize()
    bn1, f1 = (cuda_build.launches["synergy_bn_act"],
               cuda_build.launches["synergy_hr_fuse"])
    if (bn1, f1) != (BN1_SITES["hrnetv2_w18"], F1_OUTPUTS):
        fail(f"phase 17: process_batch credited BN1 {bn1} and F1 {f1} "
             f"launches, not {BN1_SITES['hrnetv2_w18']} and {F1_OUTPUTS}")
    if not all(torch.isfinite(x).all() for x in res[2:]):
        fail("phase 17: non-finite process_batch outputs")
    ms_b = time_ms(lambda: eng.process_batch(frames, frames_s2d, hws), 3,
                   torch)
    crops = torch.zeros((frames.shape[0] * FACES, 256, 256, 3), device=dev)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_pads.json")
    with torch.inference_mode():
        parts = {
            "replay": (lambda: eng.process_batch(frames, frames_s2d, hws)),
            "backbone": (lambda: api.model(crops)),
            "detect_graph": captured(torch, lambda: eng.detect_candidates(
                frames_s2d, hws))}
        pads = {k: pad_launches(torch, fn, path) for k, fn in parts.items()}
    del crops, parts
    log(f"phase 17 HRNetV2-W18 cuDNN channel-pad launches: {pads} (the "
        f"stem conv's input and filter at most: {STEM_PADS}) | {card}")
    if pads["backbone"] > STEM_PADS:
        fail(f"phase 17: cuDNN pads {pads['backbone']} tensors in the "
             f"served backbone")
    if pads["replay"] > pads["detect_graph"] + STEM_PADS:
        fail(f"phase 17: cuDNN pads {pads['replay']} tensors in the replay, "
             f"{pads['detect_graph']} in the detector's own graph")
    out["process_batch"] = {
        "launches_bn1": bn1, "launches_f1": f1, "ms": ms_b,
        "faces_per_s": frames.shape[0] * FACES / ms_b * 1e3,
        "pad_launches": pads}
    log(f"phase 17 HRNetV2-W18 process_batch, {frames.shape[0]} frames at "
        f"crop 256: BN1 {bn1} and F1 {f1} launches credited a call; "
        f"{ms_b:.2f} ms a call (mean of 3), "
        f"{out['process_batch']['faces_per_s']:.0f} face slots/s | {card}")
    log(f"phase 17 (kernel F1): {time.perf_counter() - t_phase:.1f} s")
    return out


# -- phase 18: kernels M1, G1 and M2, V-MoE-B/16's routed experts --------------

MOE_WIDTH, MOE_EXPERTS, MOE_MLP, MOE_TOKENS_A_FACE = 768, 32, 3072, 197
MOE_LAYERS = 6
# G1 against its twin: both round an f32 sum once to bf16 (module doc of
# tests/test_torch_gpu.py's MOE_GEMM_TOL): one bf16 step.
MOE_GEMM_RTOL = 2 ** -7
VMOE_REL = 0.08
# The benchmark seeds whose weights the routing flips are counted on.
MOE_FLIP_SEEDS = (2600000011, 2600000027, 2600000043)


def moe_inputs(torch, dev, routing, t, seed):
    """bf16 tokens and an f32 lecun-normal router of the served widths;
    ``skewed``: every token ranks expert 0 first (half the rows)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    u = torch.randn((t, MOE_WIDTH), generator=g, device=dev)
    w = torch.randn((MOE_EXPERTS, MOE_WIDTH), generator=g,
                    device=dev) * MOE_WIDTH ** -0.5
    if routing == "skewed":
        u[:, 0] = u[:, 0].abs() + 4.0
        w[0, 0] = 4.0
    return u.to(torch.bfloat16), w


def moe_flips(torch, dev, card, seeds):
    """The expert choices of the served bf16 V-MoE-B/16 against the float32
    reference's on 64 seeded noise crops, with each benchmark seed's
    weights (``perfbench.weights.configuration_weights``): per MoE layer the
    share of tokens whose top two differ as a set, and whose order alone
    differs; and param62's largest relative error."""
    from perfbench import harness, weights
    from perfbench.reference.precision import Precision, exact_f32
    from perfbench.reference.regressors import vmoe_b16 as ref
    from synergynet_tpu_torch.nn.moe import MoeMlp
    from synergynet_tpu_torch.pipeline import SynergyNet3DMM
    root = os.path.dirname(os.path.abspath(__file__))
    cfg = harness.load_cell(root, "vmoe_b16.b128")[3]
    out = []
    for seed in seeds:
        ref_trees, trees = weights.configuration_weights(cfg, root, seed, dev)
        api = SynergyNet3DMM("vmoe_b16", trees["regressor"],
                             dtype=torch.bfloat16, device=dev, crop=224)
        del trees
        g = torch.Generator(device=dev).manual_seed(seed % 2 ** 31)
        x = (torch.randint(0, 256, (64, 224, 224, 3), generator=g,
                           device=dev).float() - 127.5) / 128.0
        got_routes, want_routes = [], []
        for m in api.model.modules():
            if isinstance(m, MoeMlp):
                m.routes = got_routes
        with torch.inference_mode():
            got, _ = api.model(x)
            with exact_f32():
                want = ref.forward(Precision("f32"), ref_trees["regressor"],
                                   x, want_routes)
        rel = ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()
        sets, order = [], []
        for a, b in zip(got_routes, want_routes):
            a = a.long()
            same_set = (a.sort(-1).values == b.sort(-1).values).all(-1)
            sets.append(1.0 - same_set.float().mean().item())
            order.append((same_set & (a != b).any(-1)).float().mean().item())
        out.append({"seed": seed, "param62_rel": rel,
                    "set_flip_share": sets, "order_flip_share": order})
        log(f"phase 18 routing flips, seed {seed}, 64 crops x 197 tokens: "
            f"top-2 set differs from f32 in "
            f"{[round(100 * s, 3) for s in sets]} % of tokens a MoE layer, "
            f"order alone in {[round(100 * s, 3) for s in order]} %; "
            f"param62 {rel:.4f} of its norm | {card}")
        del api, ref_trees, got_routes, want_routes
        torch.cuda.empty_cache()
    return out


def moe_phase(torch, dev, card, frames, frames_s2d, hws, det_bf16):
    """Kernels M1, G1 and M2 (phase 18) at the served V-MoE-B/16 layer's
    shape (1,024 faces x 197 tokens of 768, 32 experts, MLP 3,072), under a
    balanced seeded routing and a skewed one (expert 0 holding half the
    rows): M1 and M2 against their twins on the same card tensors bit for
    bit, G1's two passes within one bf16 step; each one's time (min /
    median / max of 20 L2-flushed runs on the device clock) against its
    bound (``perfbench/counts/moe.py``), the twins' times, and
    ``torch._grouped_mm`` at G1's offsets (no bias, no GELU: the library
    yardstick only; the port never calls it). Then a bf16 V-MoE-B/16 API at
    crop 224 on the benchmark's seeded tree: one ``process_batch`` of the
    128 frames credited 12 M1, 12 G1 and 6 M2 launches, the tallies 2T
    rows a MoE layer, a traced replay's kernels equal to the credits, its
    time (mean of 3); and the routing flips against the float32 reference
    at ``MOE_FLIP_SEEDS``' weights. Returns the numbers for the JSON
    line."""
    from perfbench.counts import moe as counts
    from perfbench import weights
    from perfbench.reference.regressors import vmoe_b16 as ref
    from synergynet_tpu_torch.core.profiling import recorder
    from synergynet_tpu_torch.mm3d.codec import full_fp32
    from synergynet_tpu_torch.ops import cuda_build
    from synergynet_tpu_torch.ops import moe as M
    from synergynet_tpu_torch.pipeline import (FusedFrameEngine,
                                               SynergyNet3DMM)

    t_phase = time.perf_counter()
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    t = FACES * BATCH * MOE_TOKENS_A_FACE
    d_, e_, h_ = MOE_WIDTH, MOE_EXPERTS, MOE_MLP
    g = torch.Generator(device=dev).manual_seed(18)
    w1 = (torch.randn((e_, d_, h_), generator=g, device=dev)
          * d_ ** -0.5).to(torch.bfloat16)
    b1 = (0.01 * torch.randn((e_, h_), generator=g, device=dev)).to(
        torch.bfloat16)
    w2 = (torch.randn((e_, h_, d_), generator=g, device=dev)
          * h_ ** -0.5).to(torch.bfloat16)
    b2 = (0.01 * torch.randn((e_, d_), generator=g, device=dev)).to(
        torch.bfloat16)
    z = torch.randn((t, d_), generator=g, device=dev).to(torch.bfloat16)
    m1_bytes = counts.dispatch_bytes(t, d_, e_, 2, "bfloat16")
    m1_ops = counts.router_flops(t, d_, e_)
    m2_bytes = counts.combine_bytes(t, d_, 2, "bfloat16")
    g1_ops = counts.gemm_flops(t, d_, h_, 2)
    out = {"tokens": t, "routing": {}}
    for routing in ("balanced", "skewed"):
        u, w = moe_inputs(torch, dev, routing, t, 180)
        with torch.inference_mode():
            d = M.moe_dispatch(u, w)
            twin = M.moe_dispatch_reference(u, w)
            m1_differ = sum(int((a != b).sum()) for a, b in zip(d, twin))
            counts_e = (d.offsets[1:] - d.offsets[:-1]).tolist()
            m1 = time_spread(lambda: M.moe_dispatch(u, w), 20, torch,
                             flush.zero_)
            m1_plain = time_ms(lambda: M.moe_dispatch_reference(u, w), 1,
                               torch)
            h = M.moe_gemm(d.x, w1, b1, d.offsets, d.tiles, True)
            y = M.moe_gemm(h, w2, b2, d.offsets, d.tiles, False)
            with full_fp32():
                h_twin = M.moe_gemm_reference(d.x, w1, b1, d.offsets, True)
                y_twin = M.moe_gemm_reference(h, w2, b2, d.offsets, False)
            g1_err = max(
                ((a.float() - b.float()).abs()
                 / (b.float().abs() * MOE_GEMM_RTOL + 1e-5)).max().item()
                for a, b in ((h, h_twin), (y, y_twin)))
            g1_differ = (h != h_twin).float().mean().item()
            g1a = time_spread(lambda: M.moe_gemm(d.x, w1, b1, d.offsets,
                                                 d.tiles, True), 20, torch,
                              flush.zero_)
            g1b = time_spread(lambda: M.moe_gemm(h, w2, b2, d.offsets,
                                                 d.tiles, False), 20, torch,
                              flush.zero_)
            with full_fp32():
                g1_plain = time_ms(lambda: (
                    M.moe_gemm_reference(d.x, w1, b1, d.offsets, True),
                    M.moe_gemm_reference(h, w2, b2, d.offsets, False)), 1,
                    torch)
            ends = d.offsets[1:].contiguous()
            try:
                lib = (time_spread(lambda: torch._grouped_mm(
                    d.x, w1, offs=ends, out_dtype=torch.bfloat16), 20, torch,
                    flush.zero_)[1]
                    + time_spread(lambda: torch._grouped_mm(
                        h, w2, offs=ends, out_dtype=torch.bfloat16), 20,
                        torch, flush.zero_)[1])
            except (RuntimeError, AttributeError, TypeError) as exc:
                lib = None
                log(f"phase 18 torch._grouped_mm: {exc!r}"[:300])
            m2_differ = int((M.moe_combine(z, y, d.slot, d.gate)
                             != M.moe_combine_reference(z, y, d.slot,
                                                        d.gate)).sum())
            m2 = time_spread(lambda: M.moe_combine(z, y, d.slot, d.gate), 20,
                             torch, flush.zero_)
            m2_plain = time_ms(lambda: M.moe_combine_reference(
                z, y, d.slot, d.gate), 3, torch)
        if m1_differ or m2_differ:
            fail(f"phase 18 {routing}: M1 differs from its twin in "
                 f"{m1_differ} values, M2 in {m2_differ}")
        if g1_err > 1.0:
            fail(f"phase 18 {routing}: G1 strays {g1_err:.2f} bf16 steps "
                 f"from its twin")
        if routing == "skewed" and counts_e[0] != t:
            fail(f"phase 18: the skewed routing gave expert 0 "
                 f"{counts_e[0]} rows, not {t}")
        m1_bound, m1_by = bound(m1_bytes, m1_ops, F32_FLOPS)
        m2_bound, _ = bound(m2_bytes, 0, BF16_FLOPS)
        g1_bound, _ = bound(0, g1_ops, BF16_FLOPS)
        g1_ms = g1a[1] + g1b[1]
        r = {"counts": counts_e, "m1_ms": m1, "m1_plain_ms": m1_plain,
             "m1_bound_ms": m1_bound, "m1_bound_by": m1_by,
             "g1_pass_ms": [g1a, g1b], "g1_ms": g1_ms,
             "g1_plain_ms": g1_plain, "g1_bound_ms": g1_bound,
             "g1_steps_from_twin": g1_err, "g1_share_differing": g1_differ,
             "library_ms": lib, "m2_ms": m2, "m2_plain_ms": m2_plain,
             "m2_bound_ms": m2_bound}
        out["routing"][routing] = r
        log(f"phase 18 {routing} routing ({t} tokens, busiest expert "
            f"{max(counts_e)} rows of {2 * t}): M1 min/median/max "
            f"{m1[0]:.4f} / {m1[1]:.4f} / {m1[2]:.4f} ms, bound "
            f"{m1_bound:.4f} ({m1_by}), {m1_bound / m1[1]:.3f} of bound, "
            f"bit for bit, twin {m1_plain:.1f} ms | G1 {g1a[1]:.4f} + "
            f"{g1b[1]:.4f} ms, bound {g1_bound:.4f}, "
            f"{g1_bound / g1_ms:.3f} of bound, {g1_err:.2f} bf16 steps "
            f"from the twin at most ({100 * g1_differ:.2f}% of H differ), "
            f"twin {g1_plain:.1f} ms, torch._grouped_mm "
            f"{'n/a' if lib is None else f'{lib:.4f}'} ms | M2 "
            f"{m2[1]:.4f} ms, bound {m2_bound:.4f}, "
            f"{m2_bound / m2[1]:.3f} of bound, bit for bit, twin "
            f"{m2_plain:.3f} ms | {card}")
        del u, w, d, twin, h, y, h_twin, y_twin
    del w1, b1, w2, b2, z
    torch.cuda.empty_cache()

    # -- the served net through process_batch ----------------------------------
    crops = (torch.randint(0, 256, (16, 224, 224, 3), generator=g,
                           device=dev).float() - 127.5) / 128.0
    tree = weights.draw(ref.spec(), 18, dev)
    weights.calibrate("vmoe_b16", tree, crops)
    api = SynergyNet3DMM("vmoe_b16", weights.numpy_tree(tree),
                         dtype=torch.bfloat16, device=dev, crop=224)
    del tree, crops
    eng = FusedFrameEngine(api, detector=det_bf16, max_faces=FACES)
    syms = ("synergy_moe_dispatch", "synergy_moe_gemm",
            "synergy_moe_combine")
    eng.process_batch(frames, frames_s2d, hws)            # captured
    torch.cuda.synchronize()
    recorder.reset()
    for s in syms:
        cuda_build.launches[s] = 0
    eng.process_batch(frames, frames_s2d, hws)
    torch.cuda.synchronize()
    credited = [cuda_build.launches[s] for s in syms]
    c = recorder.counters(f"process_batch.b{frames.shape[0]}",
                          eng.programs.engine)
    rows = MOE_LAYERS * 2 * frames.shape[0] * FACES * MOE_TOKENS_A_FACE
    if credited != [12, 12, 6] or c["moe_rows"] != rows:
        fail(f"phase 18: process_batch credited {credited} M1/G1/M2 "
             f"launches and tallied {c['moe_rows']} rows, not [12, 12, 6] "
             f"and {rows}")
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_moe.json")
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        eng.process_batch(frames, frames_s2d, hws)
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    traced = trace_kernel_counts(path, {s: s.replace("synergy_", "")
                                        for s in syms})
    if [traced[s] for s in syms] != credited:
        fail(f"phase 18: a traced replay ran {traced}, credited {credited}")
    ms_b = time_ms(lambda: eng.process_batch(frames, frames_s2d, hws), 3,
                   torch)
    load = c["moe_rows_max"] / (c["moe_rows"] / MOE_EXPERTS)
    out["process_batch"] = {
        "launches": dict(zip(syms, credited)), "moe_rows": c["moe_rows"],
        "moe_rows_max": c["moe_rows_max"], "load_max": load, "ms": ms_b,
        "faces_per_s": frames.shape[0] * FACES / ms_b * 1e3,
        "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30}
    log(f"phase 18 V-MoE-B/16 process_batch, {frames.shape[0]} frames at "
        f"crop 224: M1/G1/M2 launches {credited} credited = traced; "
        f"moe_rows {c['moe_rows']} (2T x 6 layers), busiest expert "
        f"{load:.3f}x the mean; {ms_b:.2f} ms a call (mean of 3), "
        f"{out['process_batch']['faces_per_s']:.0f} face slots/s | {card}")
    del eng, api
    torch.cuda.empty_cache()
    out["flips"] = moe_flips(torch, dev, card, MOE_FLIP_SEEDS)
    log(f"phase 18 (kernels M1, G1, M2): {time.perf_counter() - t_phase:.1f}"
        f" s")
    return out


def moe_kernels(moe, spread_timing):
    """Phase 18's kernels M1, G1 and M2 as entries of the JSON line: the
    balanced routing's numbers, the skewed routing's beside them."""
    bal, skew = moe["routing"]["balanced"], moe["routing"]["skewed"]
    timing = (spread_timing.split("; ms_entry")[0] + "; plain_ms: the twin "
              "on the card's tensors, one run (M2's: mean of 3); launches: "
              "phase 18's process_batch call through the V-MoE-B/16 API")
    common = {"route": "cuda", "note": "not a TPU kernel: the JAX package "
              "has no mixture of experts", "tokens": moe["tokens"],
              "timing": timing}
    pb = moe["process_batch"]["launches"]
    return [
        dict(common, name="moe_dispatch", kernel="M1",
             source="synergynet_tpu_torch/csrc/moe.cu",
             launches=pb["synergy_moe_dispatch"], differ=0,
             ms=bal["m1_ms"][1], ms_min=bal["m1_ms"][0],
             ms_max=bal["m1_ms"][2], plain_ms=bal["m1_plain_ms"],
             bound_ms=bal["m1_bound_ms"], bound_by=bal["m1_bound_by"],
             library_ms=None, ms_skewed=skew["m1_ms"][1]),
        dict(common, name="moe_gemm", kernel="G1",
             source="synergynet_tpu_torch/ops/moe_gemm_triton.py",
             launches=pb["synergy_moe_gemm"],
             bf16_steps_from_twin=bal["g1_steps_from_twin"],
             ms=bal["g1_ms"], pass_ms=bal["g1_pass_ms"],
             plain_ms=bal["g1_plain_ms"], bound_ms=bal["g1_bound_ms"],
             bound_by="operations", library_ms=bal["library_ms"],
             library="torch._grouped_mm at G1's offsets, both passes, no "
             "bias or GELU (a yardstick: the port never calls it)",
             ms_skewed=skew["g1_ms"], library_ms_skewed=skew["library_ms"]),
        dict(common, name="moe_combine", kernel="M2",
             source="synergynet_tpu_torch/csrc/moe.cu",
             launches=pb["synergy_moe_combine"], differ=0,
             ms=bal["m2_ms"][1], ms_min=bal["m2_ms"][0],
             ms_max=bal["m2_ms"][2], plain_ms=bal["m2_plain_ms"],
             bound_ms=bal["m2_bound_ms"], bound_by="bytes",
             library_ms=None, ms_skewed=skew["m2_ms"][1],
             process_batch=moe["process_batch"], flips=moe["flips"])]


def trace_kernel_counts(path, names):
    """Kernel launches per name fragment in a Chrome trace."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    kernels = [e["name"] for e in events
               if e.get("ph") == "X" and e.get("cat") == "kernel"]
    return {k: sum(frag in n for n in kernels) for k, frag in names.items()}


def programs_phase(torch, dev, card, eng, eng_p, ov, frames, frames_s2d, hws,
                   imgs):
    """The captured programs and kernel N1 on the card (phase 14): graph
    against eager, no hidden sync, fresh outputs, N1 against its twin and
    its time and bound, the overlay through the graphs, end-to-end times
    graph and eager in turns, copy-in / clone-out / replay costs, pool
    bytes, and one profiler pass whose kernel counts the credited counters
    must match. Returns the numbers for the JSON line."""
    from synergynet_tpu_torch.detect.detector import (NMS_THRESHOLD,
                                                      NMS_TOP_K, prepare_frame)
    from synergynet_tpu_torch.detect.nms import (greedy_nms_mask,
                                                 greedy_nms_mask_reference)
    from synergynet_tpu_torch.ops import cuda_build
    from synergynet_tpu_torch.ops.resize import _resize_linear
    from synergynet_tpu_torch.pipeline import unpack_face_outputs
    from tests.nms_cases import CASES, THRESHOLD, nms_case
    t_phase = time.perf_counter()
    out = {}
    engines = {"xla": eng, "fused": eng_p}
    sel = ("face_scores", "n_faces", "rois")
    mesh = ("param62", "lmk", "dense", "angles", "t3d")

    # -- 14a. graph against eager at B=1 and B=128, both stems ---------------
    agree = {}
    with torch.inference_mode():
        for name, e in engines.items():
            for b in (1, BATCH):
                a = (frames[:b], frames_s2d[:b], hws[:b])
                got = e.process_batch(*a)
                want = e.process_batch_eager(*a)
                for k, g, w in zip(sel, got[:3], want[:3]):
                    if not torch.equal(g, w):
                        fail(f"phase 14 {name} B={b}: graph {k} differs from "
                             "the eager body's")
                bitwise = all(torch.equal(g, w)
                              for g, w in zip(got[3:], want[3:]))
                if not bitwise:
                    for k, g, w in zip(mesh, got[3:], want[3:]):
                        torch.testing.assert_close(g, w, rtol=RTOL,
                                                   atol=ATOL)
                agree[f"{name}_b{b}"] = "bit for bit" if bitwise else (
                    f"within rtol {RTOL} / atol {ATOL}")
                del got, want
    log(f"phase 14 graph vs eager: selection (face_scores, n_faces, rois) "
        f"equal at B=1 and B={BATCH} for both stems; param62, lmk, dense, "
        f"angles, t3d: {agree}")
    out["graph_vs_eager"] = agree

    # -- 14b. fresh outputs ---------------------------------------------------
    with torch.inference_mode():
        first = eng.process_batch(frames[:1], frames_s2d[:1], hws[:1])
        kept = [x.clone() for x in first]
        second = eng.process_batch(frames[1:2], frames_s2d[1:2], hws[1:2])
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(first, kept)):
            fail("phase 14: a call's outputs changed at the next call")
        if torch.equal(first[3], second[3]):
            fail("phase 14: two frames gave the same param62")
        del first, kept, second

    # -- 14c. no hidden sync: one replay of every program ---------------------
    caches = {"xla": eng.programs, "fused": eng_p.programs,
              "overlay": ov.programs}
    n_programs = 0
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.inference_mode():
            for cache in caches.values():
                for prog in cache.programs.values():
                    prog([x.clone() for x in prog.inputs])
                    n_programs += 1
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log(f"phase 14 sync-debug 'error': one replay (copy in, replay, clone "
        f"out) of each of {n_programs} programs, no synchronising call")
    out["sync_clean_programs"] = n_programs

    # -- 14d. N1 against its twin, bit for bit --------------------------------
    def path_candidates(b):
        with torch.inference_mode():
            s, bx = eng.detect_candidates(frames_s2d[:b], hws[:b])
            top, idx = torch.sort(s, dim=-1, descending=True, stable=True)
            top, idx = top[:, :NMS_TOP_K], idx[:, :NMS_TOP_K]
            tb = torch.gather(bx, 1, idx[..., None].expand(-1, -1, 4))
            return tb.contiguous(), top > 0.0

    cands = {b: path_candidates(b) for b in (1, BATCH)}
    cases = {f"path B={BATCH}": cands[BATCH], "path B=1": cands[1]}
    for name in CASES:
        bx, v = nms_case(name)
        cases[name] = (torch.tensor(bx, device=dev),
                       torch.tensor(v, device=dev))
    n1_cases = {}
    for name, (tb, tv) in cases.items():
        got = greedy_nms_mask(tb, tv, THRESHOLD)
        want = greedy_nms_mask_reference(tb, tv, THRESHOLD)
        bad = int((got != want).sum())
        if bad:
            fail(f"phase 14 N1 {name}: {bad} keep flags differ from the twin")
        n1_cases[name] = {"frames": tb.shape[0], "k": tb.shape[1],
                          "kept": int(got.sum())}
    log(f"phase 14 N1 = twin bit for bit on {n1_cases}")
    out["n1_cases"] = n1_cases
    # The path's candidates and the twin's masks, for the --parent A/B.
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    torch.save({"threshold": NMS_THRESHOLD, "inputs": {
        b: (tb.cpu(), tv.cpu(),
            greedy_nms_mask_reference(tb, tv, NMS_THRESHOLD).cpu())
        for b, (tb, tv) in cands.items()}},
        os.path.join(here, N1_AB_INPUTS))

    # -- 14e. N1's time, its twin's and its bound -----------------------------
    clock = sm_clock_mhz()
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    prof_dir = os.path.join(here, "build", "chip_smoke_programs")
    os.makedirs(prof_dir, exist_ok=True)
    n1 = {}
    for b, (tb, tv) in cands.items():
        t = n1_times(torch, greedy_nms_mask, tb, tv, NMS_THRESHOLD,
                     flush.zero_, prof_dir, f"b{b}")
        plain = time_ms(lambda: greedy_nms_mask_reference(
            tb, tv, NMS_THRESHOLD), 3 if b > 1 else 10, torch, flush.zero_)
        k = tb.shape[1]
        keep = greedy_nms_mask(tb, tv, NMS_THRESHOLD)
        # Operations: the walk's dependent steps (last valid box + 1 in the
        # longest frame) at one SM cycle each; and the IoUs that the
        # reference's loop (cpu_nms.pyx) evaluates, each kept box against
        # the valid boxes after it, 15 f32 operations each in the twin's
        # order. Bytes: boxes and valid read once, keep written once.
        steps = int((torch.arange(1, k + 1, device=dev) * tv).amax())
        after = tv.flip(-1).cumsum(-1).flip(-1) - tv.long()
        ious = int((after * keep).sum())
        t_walk = steps / (clock * 1e3)
        t_iou = ious * 15 / F32_FLOPS * 1e3
        nbytes = b * k * (16 + 1 + 1)
        t_bytes = nbytes / HBM_BPS * 1e3
        n1[b] = dict(t, plain_ms=plain,
                     bound_ms=max(t_walk, t_iou, t_bytes),
                     bound_by="bytes" if t_bytes > max(t_walk, t_iou)
                     else "operations",
                     bound_walk_ms=t_walk, bound_iou_ms=t_iou,
                     bound_bytes_ms=t_bytes, walk_steps=steps, ious=ious,
                     kept=int(keep.sum()))
        log(f"phase 14 N1 B={b} (K={k}): kernel min/median/max "
            f"{t['ms_min']:.4f} / {t['ms']:.4f} / {t['ms_max']:.4f} ms over "
            f"20 (L2 flushed; {t['ms_warm']:.4f} warm; profiler bits / walk "
            f"cold {t['split_cold']['bits']:.4f} / "
            f"{t['split_cold']['walk']:.4f}, warm "
            f"{t['split_warm']['bits']:.4f} / {t['split_warm']['walk']:.4f})"
            f" | twin {plain:.4f} ms | bound {n1[b]['bound_ms']:.4f} ms "
            f"({n1[b]['bound_by']}: {steps} walk steps at {clock:.0f} MHz = "
            f"{t_walk:.4f} ms; {ious} IoUs at f32 peak = {t_iou:.4f} ms; "
            f"{nbytes / 1e6:.1f} MB = {t_bytes:.4f} ms) | "
            f"{n1[b]['bound_ms'] / t['ms']:.3f} of bound | {n1[b]['kept']} "
            f"kept | {card}")
    del flush
    out["n1"] = {str(b): v for b, v in n1.items()}

    # select_faces split at B=1 and B=128: the top-k sort, N1, the rest.
    split = {}
    with torch.inference_mode():
        for b in (1, BATCH):
            s, bx = eng.detect_candidates(frames_s2d[:b], hws[:b])
            tb, tv = cands[b]
            whole = time_ms(lambda: eng.select_faces(s, bx), 10, torch)
            sort = time_ms(lambda: torch.sort(s, dim=-1, descending=True,
                                              stable=True), 10, torch)
            nms = time_ms(lambda: greedy_nms_mask(tb, tv, NMS_THRESHOLD), 10,
                          torch)
            split[str(b)] = {"select_faces": whole, "sort": sort, "n1": nms,
                             "rest": whole - sort - nms}
            log(f"phase 14 select_faces B={b}: {whole:.3f} ms (top-k sort "
                f"{sort:.3f}, N1 entry {nms:.3f}, the rest "
                f"{whole - sort - nms:.3f}; CUDA events, mean of 10) | {card}")
    out["select_split_ms"] = split

    # -- 14e. C1 against its twin, its time and its bound ---------------------
    out["c1"] = c1_checks(torch, dev, card, eng, frames, frames_s2d, hws)

    # -- 14f. the overlay through the graphs equals the eager overlay ---------
    def eager_overlay(img):
        canvas, packed, true_hw, scale = prepare_frame(img, 8, dev)
        o = eng.process_batch_eager(canvas[None], packed[None],
                                    true_hw[None])
        n = int(o[1][0])
        overlay, _ = ov.render(canvas.clamp(0, 255).to(torch.uint8),
                               o[5][0], n)
        hs, ws = true_hw.tolist()
        overlay = overlay[:hs, :ws]
        if scale != 1.0:
            overlay = _resize_linear(overlay, *img.shape[:2]).to(torch.uint8)
        faces = unpack_face_outputs(n, *(x[0].cpu().numpy() for x in (
            o[4], o[5], o[6], o[7])), scale)
        return faces, overlay.cpu().numpy()

    with torch.inference_mode():
        for hw, img in imgs.items():
            pts, _, _, got = ov(img)
            (pts_e, _, _), want = eager_overlay(img)
            if len(pts) != len(pts_e) or not np.array_equal(got, want):
                fail(f"phase 14 overlay {hw}: the graphs' overlay differs "
                     "from the eager overlay")
    log(f"phase 14 overlay at {list(imgs)}: graphs = eager bit for bit")

    # -- 14g. end-to-end times, graph and eager in turns ----------------------
    e2e = {}
    with torch.inference_mode():
        for name, e in engines.items():
            for b in (1, BATCH):
                a = (frames[:b], frames_s2d[:b], hws[:b])
                n = 10 if b == 1 else 5
                runs = {"graph": [], "eager": []}
                for which in ("graph", "eager", "eager", "graph"):
                    fn = e.process_batch if which == "graph" else \
                        e.process_batch_eager
                    runs[which].append(time_ms(lambda: fn(*a), n, torch))
                g, x = (float(np.mean(runs[k])) for k in ("graph", "eager"))
                e2e[f"{name}_b{b}"] = {"graph_ms": g, "eager_ms": x,
                                       "graph_runs": runs["graph"],
                                       "eager_runs": runs["eager"],
                                       "graph_faces_per_s": b * FACES / g
                                       * 1e3}
                log(f"phase 14 end-to-end {name} stem B={b}: graph {g:.3f} "
                    f"ms/call {runs['graph']}, eager {x:.3f} ms/call "
                    f"{runs['eager']} (CUDA events, mean of {n}, turns "
                    f"g/e/e/g); graph {b * FACES / g * 1e3:.1f} faces/s | "
                    f"{card}")
        img = imgs[CANVAS]
        ov_runs = {"graph": [], "eager": []}
        for which in ("graph", "eager", "eager", "graph"):
            fn = ov if which == "graph" else eager_overlay
            for _ in range(2):
                fn(img)
            t0 = time.perf_counter()
            for _ in range(OVERLAY_REPS):
                fn(img)
            ov_runs[which].append((time.perf_counter() - t0) * 1e3
                                  / OVERLAY_REPS)
    ov_g, ov_e = (float(np.mean(ov_runs[k])) for k in ("graph", "eager"))
    log(f"phase 14 overlay {CANVAS[0]}x{CANVAS[1]}: graphs {ov_g:.3f} ms per "
        f"frame {ov_runs['graph']}, eager {ov_e:.3f} {ov_runs['eager']} "
        f"(host clock, numpy in and out, mean of {OVERLAY_REPS}, turns "
        f"g/e/e/g) | {card}")
    out["e2e"] = e2e
    out["overlay_ms"] = {"graph": ov_g, "eager": ov_e, "runs": ov_runs}

    # -- 14h. copy-in, replay, clone-out; pool bytes --------------------------
    costs, pools = {}, {}
    with torch.inference_mode():
        for cname, cache in caches.items():
            for (key, sig), prog in cache.programs.items():
                label = f"{cname} {key} {sig[0][0]}"
                pools[label] = prog.pool_bytes
                if cname == "overlay" or sig[0][0][0] not in (1, BATCH):
                    continue
                # Distinct sources: a tensor copied onto itself is a no-op.
                ins = [x.clone() for x in prog.inputs]
                costs[label] = {
                    "copy_in": time_ms(lambda: [s.copy_(x) for s, x in zip(
                        prog.inputs, ins)], 10, torch),
                    "replay": time_ms(prog.graph.replay, 10, torch),
                    "clone_out": time_ms(lambda: [o.clone() for o in
                                                  prog.outputs], 10, torch)}
    log("phase 14 program costs, ms (CUDA events, mean of 10): "
        + "; ".join(f"{k}: " + ", ".join(f"{n} {v:.4f}" for n, v in c.items())
                    for k, c in costs.items()) + f" | {card}")
    log("phase 14 pool bytes (reserved by each capture): " + "; ".join(
        f"{k} {v / 2 ** 20:.1f} MiB" for k, v in pools.items()))
    out["program_costs_ms"] = costs
    out["pool_bytes"] = pools

    # -- 14i. one profiler pass: trace counts against credited counters -------
    counters = {"B1 fused_decode": "synergy_fused_decode",
                "N1 nms_greedy": "synergy_nms_greedy",
                "C1 crop_bilinear": "synergy_crop_bilinear",
                "B4 stem_s2d8": "synergy_stem_s2d8",
                "B2 raster_tiled": "synergy_raster_mesh",
                "BN1 bn_act": "synergy_bn_act"}
    a = (frames, frames_s2d, hws)
    checks = {}
    with torch.inference_mode():
        for label, fn in (
                (f"fused stem B={BATCH} replay", lambda: eng_p.process_batch(
                    *a)),
                (f"overlay {CANVAS[0]}x{CANVAS[1]}",
                 lambda: ov(imgs[CANVAS]))):
            fn()
            torch.cuda.synchronize()
            before = {k: cuda_build.launches[symbol]
                      for k, symbol in counters.items()}
            path = os.path.join(prof_dir, f"trace_{len(checks)}.json")
            prof = profile_calls(fn, 1, path, top=1000)
            # profile_calls warms up once, then runs once under the profiler.
            credited = {k: (cuda_build.launches[symbol] - before[k]) // 2
                        for k, symbol in counters.items()}
            seen = trace_kernel_counts(path, TRACE_NAMES)
            if seen != credited:
                fail(f"phase 14 {label}: trace kernel counts {seen} differ "
                     f"from the credited counters {credited}")
            checks[label] = {"trace": seen, "credited": credited,
                             "busy_ms": prof["busy_ms"],
                             "wall_ms": prof["wall_ms"],
                             "idle_share": prof["idle_share"],
                             "device_ops": prof["ops"],
                             "n1_device_ms": n1_split(prof["top"])}
            log(f"phase 14 profiler, {label}: kernel launches in the trace "
                f"{seen} = credited {credited}; device busy "
                f"{prof['busy_ms']:.3f} of {prof['wall_ms']:.3f} ms, idle "
                f"share {prof['idle_share']:.3f}, {prof['ops']:.0f} device "
                f"ops; N1 device ms {checks[label]['n1_device_ms']} | {card}")
        for b in (1, BATCH):
            ab = (frames[:b], frames_s2d[:b], hws[:b])
            p = profile_calls(lambda: eng.process_batch(*ab), 3, os.path.join(
                prof_dir, f"trace_xla_b{b}.json"), top=1000)
            checks[f"xla B={b} replay, 3 calls"] = {
                "busy_ms": p["busy_ms"], "wall_ms": p["wall_ms"],
                "idle_share": p["idle_share"], "device_ops": p["ops"],
                "n1_device_ms": n1_split(p["top"]),
                "top": p["top"][:8]}
            log(f"phase 14 profiler, XLA stem B={b} replay: device busy "
                f"{p['busy_ms']:.3f} of {p['wall_ms']:.3f} ms per call, idle "
                f"share {p['idle_share']:.3f}, {p['ops']:.1f} device ops per "
                f"call; N1 device ms {n1_split(p['top'])}; leading ops "
                + ", ".join(f"{n[:40]} {ms:.3f}" for n, ms in p["top"][:5])
                + f" | {card}")
    out["profile"] = checks
    shutil.rmtree(prof_dir, ignore_errors=True)
    secs = time.perf_counter() - t_phase
    out["seconds"] = secs
    log(f"phase 14 (captured programs and kernel N1): {secs:.1f} s")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile process_batch and one overlay frame; "
                    "traces go to DIR")
    ap.add_argument("--parent", metavar="DIR",
                    help="a checkout of the parent commit: time its raster "
                    "entry points and its greedy NMS against this tree's, "
                    "in turns")
    ap.add_argument("--raster-worker", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--nms-worker", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.raster_worker:
        raster_worker(args.raster_worker)
        return
    if args.nms_worker:
        nms_worker(args.nms_worker)
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
    # process_batch; the checks and the timing below are not counted. Each
    # call replays its batch size's captured program (the first call of a
    # size captures it), and the replay credits the launches recorded at
    # capture.
    cuda_build.launches["synergy_fused_decode"] = 0
    cuda_build.launches["synergy_nms_greedy"] = 0
    cuda_build.launches["synergy_crop_bilinear"] = 0
    cuda_build.launches["synergy_bn_act"] = 0
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
    launches = cuda_build.launches["synergy_fused_decode"]
    n1_launches = cuda_build.launches["synergy_nms_greedy"]
    c1_launches = cuda_build.launches["synergy_crop_bilinear"]
    bn1_launches = cuda_build.launches["synergy_bn_act"]
    log(f"main path: fused_decode launched {launches} times, nms_greedy "
        f"{n1_launches} times, crop_bilinear {c1_launches} times, bn_act "
        f"{bn1_launches} times (__call__ x2, process_batch x1)")
    if launches <= 0:
        fail("the serving path never launched the fused_decode kernel")
    if n1_launches <= 0:
        fail("the serving path never launched the nms_greedy kernel")
    if c1_launches <= 0:
        fail("the serving path never launched the crop_bilinear kernel")
    # BN1: each of the default MobileNetV2's 52 BN sites in every forward.
    bn1_sites = BN1_SITES["mobilenet_v2"]
    if bn1_launches <= 0 or bn1_launches % bn1_sites:
        fail(f"the serving path credited kernel BN1 {bn1_launches} "
             f"launches, not a positive multiple of {bn1_sites}")
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
    cuda_build.launches["synergy_stem_s2d8"] = 0
    cuda_build.launches["synergy_fused_decode"] = 0
    t0 = time.perf_counter()
    same_calls = 0
    for hw, img in frames_np.items():
        pts_p, verts_p, poses_p = eng_p(img)
        check_faces(pts_p, verts_p, poses_p, f"fused-stem __call__ {hw}")
        same_calls += len(pts_p) == n_xla[hw]
    out_p = eng_p.process_batch(frames, frames_s2d, hws)
    torch.cuda.synchronize()
    s_launches = cuda_build.launches["synergy_stem_s2d8"]
    b1_launches = cuda_build.launches["synergy_fused_decode"]
    log(f"fused-stem path: stem_s2d8 launched {s_launches} times, "
        f"fused_decode {b1_launches} times (__call__ x2, "
        f"process_batch x1), {time.perf_counter() - t0:.1f} s")
    if s_launches <= 0:
        fail("the fused-stem serving path never launched the stem kernel")
    if b1_launches <= 0:
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
    cuda_build.launches["synergy_fused_decode"] = 0
    cuda_build.launches["synergy_raster_mesh"] = 0
    t0 = time.perf_counter()
    results = {hw: ov(img) for hw, img in imgs.items()}
    torch.cuda.synchronize()
    r_launches = cuda_build.launches["synergy_raster_mesh"]
    b1_launches = cuda_build.launches["synergy_fused_decode"]
    log(f"overlay path: raster_tiled launched {r_launches} times, "
        f"fused_decode {b1_launches} times (__call__ x"
        f"{len(imgs)}), {time.perf_counter() - t0:.1f} s")
    if r_launches <= 0:
        fail("the overlay path never launched the raster_tiled kernel")
    if b1_launches <= 0:
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
        cuda_build.launches["synergy_raster_mesh_ids"] = 0
        deferred = {hw: rasterize_buffers_tiled(v, ov.tris_all, c, h=ch,
                                                w=cw, deferred=True)
                    for hw, (v, c) in lit.items()}
        torch.cuda.synchronize()
        r3_launches = cuda_build.launches["synergy_raster_mesh_ids"]
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

    # -- 14. captured programs and kernel N1 ----------------------------------
    programs = programs_phase(torch, dev, card, eng, eng_p, ov, frames,
                              frames_s2d, hws, imgs)
    n1 = programs["n1"]
    c1 = programs["c1"]
    n1_turns = nms_ab(args.parent, card) if args.parent else None

    # -- 7. device profile (opt-in) -------------------------------------------
    if args.profile:
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

    # -- 13. scale-out and detector training ----------------------------------
    scaleout = scaleout_phase(torch, dev, card, eng, frames, frames_s2d, hws)

    # -- 15. kernel R1 at the served ResNeSt-50's shapes ----------------------
    r1 = splat_phase(torch, dev, card)

    # -- 16. kernel BN1 at the served conv backbones' sites -------------------
    bn1 = bnact_phase(torch, dev, card)

    # -- 17. kernel F1 at the served HRNetV2-W18's exchange units -------------
    f1 = hrfuse_phase(torch, dev, card, frames, frames_s2d, hws, det)

    # -- 18. kernels M1, G1 and M2 at the served V-MoE-B/16's layer ----------
    moe = moe_phase(torch, dev, card, frames, frames_s2d, hws, det)

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
        "launches_scaleout": scaleout["launches_b1"],
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
        "stall_shares_b1": sf["1"]["stall_shares"]}, {
        "name": "nms_greedy", "route": "cuda",
        "source": "synergynet_tpu_torch/csrc/nms_greedy.cu",
        "replaces": "synergynet_tpu/detect/nms.py:69",
        "note": "not a TPU kernel: the counterpart of greedy_nms_mask's "
        "lax.while_loop, which XLA compiles; N1 lets a CUDA graph capture "
        "greedy NMS",
        "launches": n1_launches, "max_abs_err": 0.0,
        "ms": n1[str(BATCH)]["ms"], "plain_ms": n1[str(BATCH)]["plain_ms"],
        "bound_ms": n1[str(BATCH)]["bound_ms"],
        "bound_by": n1[str(BATCH)]["bound_by"], "library_ms": None,
        "timing": spread_timing.split("; ms_entry")[0]
        + "; split_ms: the bits and walk kernels' device ms per call under "
        "torch.profiler, L2 flushed before each call"
        + "; plain_ms: the fixpoint twin, mean of 3 (B=1: 10); bound_ms: "
        "the largest of the walk's dependent steps (last valid box + 1 in "
        "the longest frame) at one SM cycle each, the reference loop's IoUs "
        "(each kept box against the valid boxes after it) at 15 f32 "
        "operations each over 67 TFLOP/s, and the bytes (boxes and valid "
        "in, keep out) over 3.35 TB/s",
        "ms_min": n1[str(BATCH)]["ms_min"], "ms_max": n1[str(BATCH)]["ms_max"],
        "bound_walk_ms": n1[str(BATCH)]["bound_walk_ms"],
        "bound_iou_ms": n1[str(BATCH)]["bound_iou_ms"],
        "bound_bytes_ms": n1[str(BATCH)]["bound_bytes_ms"],
        "frames": BATCH, "k": 2048, "ms_b1": n1["1"]["ms"],
        "ms_min_b1": n1["1"]["ms_min"], "ms_max_b1": n1["1"]["ms_max"],
        "split_ms": n1[str(BATCH)]["split_cold"],
        "split_ms_b1": n1["1"]["split_cold"],
        "plain_ms_b1": n1["1"]["plain_ms"],
        "bound_ms_b1": n1["1"]["bound_ms"],
        "bound_by_b1": n1["1"]["bound_by"]}, {
        "name": "crop_bilinear", "route": "cuda",
        "source": "synergynet_tpu_torch/csrc/crop_bilinear.cu",
        "replaces": "synergynet_tpu/pipeline/device_crop.py:26",
        "note": "not a TPU kernel: the counterpart of crop_resize_bilinear's "
        "four-tap gather, which XLA compiles; C1 replaces the port's two "
        "dense f32 interpolation products",
        "launches": c1_launches,
        "max_abs_err": max(v["max_abs_err"] for v in c1.values()),
        "ms": c1[str(BATCH)]["ms"], "plain_ms": c1[str(BATCH)]["plain_ms"],
        "bound_ms": c1[str(BATCH)]["bound_ms"],
        "bound_by": c1[str(BATCH)]["bound_by"], "library_ms": None,
        "timing": spread_timing.split("; ms_entry")[0]
        + "; plain_ms: the twin on the card, mean of 3 (B=1: 10); "
        "bound_ms: the crops written and the rois read once over 3.35 "
        "TB/s (the source taps left out), or the bilinear operations over "
        "67 TFLOP/s, the larger",
        "ms_min": c1[str(BATCH)]["ms_min"], "ms_max": c1[str(BATCH)]["ms_max"],
        "faces": c1[str(BATCH)]["faces"], "ms_b1": c1["1"]["ms"],
        "ms_min_b1": c1["1"]["ms_min"], "ms_max_b1": c1["1"]["ms_max"],
        "plain_ms_b1": c1["1"]["plain_ms"],
        "bound_ms_b1": c1["1"]["bound_ms"],
        "bit_for_bit": all(v["bit_for_bit"] for v in c1.values())}, {
        "name": "split_attention", "route": "cuda",
        "source": "synergynet_tpu_torch/csrc/split_attention.cu",
        "replaces": "synergynet_tpu/nn/backbones/resnest.py SplAtConv2d",
        "note": "not a TPU kernel: the JAX package leaves the radix "
        "combine to XLA; R1 replaces the port's two radix reduces, spatial "
        "mean and 5-D broadcast product",
        "launches": fam["families"]["resnest50"]["launches_r1"],
        "launches_phase15": r1["launches_phase15"],
        "max_bf16_steps": r1["max_steps"],
        "ms": r1["ms"], "pool_ms": r1["pool_ms"],
        "combine_ms": r1["combine_ms"], "plain_ms": r1["plain_ms"],
        "layout_ms": r1["layout_ms"],
        "max_bf16_steps_layout": r1["max_steps_layout"],
        "bound_ms": r1["bound_ms"], "bound_by": "bytes",
        "two_pass_bound_ms": r1["two_pass_bound_ms"], "library_ms": None,
        "timing": spread_timing.split("; ms_entry")[0]
        + "; ms: the medians of both entries summed over ResNeSt-50's 16 "
        "blocks; plain_ms: the twins on the card, mean of 3 a shape; "
        "layout_ms: both steps in plain PyTorch on the channels-last view, "
        "median of 20 a shape; launches: phase 11's resnest50 "
        "process_batch call (launches_phase15: phase 15's own calls)",
        "faces": FACES * BATCH, "shapes": r1["shapes"]}, {
        "name": "bn_act", "route": "cuda",
        "source": "synergynet_tpu_torch/csrc/bn_act.cu",
        "replaces": "nn/backbones/mobilenet_v2.py and resnest.py: "
        "F.batch_norm in eval, F.relu, torch.minimum and the residual add",
        "note": "not a TPU kernel: the JAX package leaves BatchNorm, the "
        "activation and the residual add to XLA, which fuses them into the "
        "convolution; BN1 replaces the port's separate passes",
        "launches": bn1_launches,
        "launches_profile": programs["profile"][
            f"fused stem B={BATCH} replay"]["credited"]["BN1 bn_act"],
        "launches_resnest50": fam["families"]["resnest50"]["launches_bn1"],
        "launches_phase16": bn1["launches_phase16"],
        "differ": sum(bn1[a]["differ"] for a in BN1_ARCHS),
        "ms": {a: bn1[a]["ms"] for a in BN1_ARCHS},
        "plain_ms": {a: bn1[a]["plain_ms"] for a in BN1_ARCHS},
        "bound_ms": {a: bn1[a]["bound_ms"] for a in BN1_ARCHS},
        "bound_by": "bytes", "library_ms": None,
        "timing": spread_timing.split("; ms_entry")[0]
        + "; ms: the medians summed over each backbone's sites; plain_ms: "
        "the twin (the chain before BN1) on the card, mean of 3 a site; "
        "launches: the main path's own calls (__call__ x2, process_batch "
        "x1); launches_profile: phase 14's fused-stem replay, credited and "
        "seen in its trace; launches_resnest50: phase 11's process_batch "
        "call",
        "faces": FACES * BATCH,
        "sites": {a: bn1[a]["shapes"] for a in BN1_ARCHS}}, {
        "name": "hr_fuse", "route": "cuda",
        "source": "synergynet_tpu_torch/csrc/hr_fuse.cu",
        "replaces": "nn/backbones/hrnet.py's exchange outputs: each term's "
        "F.batch_norm in eval, F.interpolate (nearest), the adds and F.relu",
        "note": "not a TPU kernel: the JAX package has no HRNet; XLA would "
        "fuse the exchange unit into the convolutions around it",
        "launches": f1["process_batch"]["launches_f1"],
        "launches_phase17": f1["launches_phase17"],
        "differ": f1["differ"], "ms": f1["ms"],
        "plain_ms": f1["plain_ms"], "bound_ms": f1["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "timing": spread_timing.split("; ms_entry")[0]
        + "; ms: the medians summed over the net's 26 exchange outputs; "
        "plain_ms: the twin on the card, mean of 3 an output; launches: "
        "phase 17's process_batch call through the HRNetV2-W18 API",
        "faces": FACES * BATCH, "shapes": f1["shapes"],
        "process_batch": f1["process_batch"]},
        *moe_kernels(moe, spread_timing)],
        "e2e_faces_per_s": {str(b): v[1] for b, v in e2e.items()},
        "e2e_ms": {str(b): v[0] for b, v in e2e.items()},
        "e2e_fused_stem_ms": {str(b): v[0] for b, v in e2e_p.items()},
        "stages_ms": stages, "overlay_ms": overlay_ms,
        "overlay_stages_ms": ov_stages, "raster_path_ms": raster_ms,
        "raster_ab": raster_turns, "n1_ab": n1_turns, "training": training,
        "data_path": data_path, "api_host_render": api_path,
        "families": {k: v for k, v in fam.items() if k != "stem_f32"},
        "ingest_eval": ingest, "scaleout": scaleout,
        "programs": programs}),
        flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
