#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``synergynet_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py [--profile DIR]

Needs one NVIDIA Hopper card and the CUDA toolkit (nvcc); fails without
them, and fails when the port's package is not beside this script. Phases,
each fatal on failure:

1. the card: ``nvidia-smi`` name and power limit;
2. build every kernel of the serving path from ``synergynet_tpu_torch/csrc``
   (nvcc, sm_90a) and print the build seconds and ptxas resource lines;
3. each kernel against its plain PyTorch twin on the card, at the serving
   path's shapes (fused decode: 8 and 1024 faces on the full 53,215-vertex
   basis, f32), with kernel and plain times (CUDA events, L2 flushed
   between launches, as the serving path finds it cold);
4. the serving path at full width — MobileNetV2 1.0 on the shipped trained
   weights, bf16; the seeded random-init bf16 FaceBoxes detector; 8 faces
   per 720x1088 frame: ``FusedFrameEngine.__call__`` on a 720x1088 and a
   480x640 frame, ``process_batch`` on 128 frames; output shapes, finite
   values, landmarks equal to the dense mesh at the keypoint vertices, and
   the dense mesh against the plain twin on the path's own param62; every
   kernel's launch count over these calls (and only these) must be > 0;
5. end-to-end faces/s at 1 and 128 frames per call (CUDA events, after
   warm-up) and a per-stage breakdown at both;
6. with ``--profile DIR`` only: ``process_batch`` at 1 and 128 frames under
   ``torch.profiler`` — device busy time, idle share, device ops per call
   and the leading ops — with the Chrome traces and a summary in DIR.

Prints the kernels as one JSON line, the card's name and power limit, and
last ``{"ok": true, "device": {...}}``.
"""

import argparse
import json
import os
import subprocess
import sys
import time

FACES = 8
BATCH = 128
CANVAS = (720, 1088)
RTOL, ATOL = 1e-4, 1e-3     # the dense decode's tolerance (f32)
DEVICE = "cuda:0"


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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile process_batch; traces go to DIR")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a card")
    from synergynet_tpu_torch.detect import FaceBoxes
    from synergynet_tpu_torch.detect.net import space_to_depth
    from synergynet_tpu_torch.mm3d import rescale_to_roi
    from synergynet_tpu_torch.ops import cuda_build
    from synergynet_tpu_torch.ops.fused_decode import (
        decode_dense_fused, decode_dense_fused_reference)
    from synergynet_tpu_torch.pipeline import (FusedFrameEngine,
                                               SynergyNet3DMM)

    dev = torch.device(DEVICE)
    card = card_line()
    log(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | {torch.cuda.get_device_name(0)}")

    # -- 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    cuda_build.load_kernel_library("fused_decode")
    info = cuda_build.build_info("fused_decode")
    log(f"build fused_decode: nvcc {info['seconds']:.2f} s, load "
        f"{time.perf_counter() - t0:.2f} s total")
    for line in info["ptxas"]:
        log(f"  {line}")

    # -- 3. kernel vs plain twin at the path's shapes ------------------------
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
        ms = time_ms(lambda: decode_dense_fused(p, basis, pack), 20, torch,
                     flush_buf.zero_)
        plain = time_ms(lambda: decode_dense_fused_reference(p, basis, pack),
                        20, torch, flush_buf.zero_)
        kernel_stats[b] = (ms, plain)
        log(f"fused_decode B={b}: max_abs_err {err:.3e} (rtol {RTOL}, atol "
            f"{ATOL}) | kernel {ms:.4f} ms | plain {plain:.4f} ms | {card}")
    del flush_buf
    torch.cuda.empty_cache()

    # -- 4. the serving path --------------------------------------------------
    det = FaceBoxes(dtype=torch.bfloat16, device=dev, seed=0)
    eng = FusedFrameEngine(api, detector=det, max_faces=FACES)
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

    g = torch.Generator(device=dev).manual_seed(0)
    ch, cw = CANVAS
    frames = torch.randint(0, 256, (BATCH, ch, cw, 3), generator=g,
                           device=dev).float()
    frames_s2d = space_to_depth(frames, det.stem_r).contiguous()
    hws = torch.tensor([[ch, cw]] * BATCH, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()

    # Launches count over the path's own calls: __call__ twice, then
    # process_batch; the checks and the timing below are not counted.
    decode_dense_fused.launches = 0
    t0 = time.perf_counter()
    frames_np = {hw: np.random.default_rng(1).integers(0, 256, (*hw, 3),
                                                       np.uint8)
                 for hw in (CANVAS, (480, 640))}
    for hw, img in frames_np.items():
        pts, verts, poses = eng(img)
        check_faces(pts, verts, poses, f"__call__ {hw}")
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
    for x in (rois, p62, lmk, dense, angles, t3d):
        if not torch.isfinite(x).all():
            fail("process_batch: non-finite output")
    flat_p, flat_r = p62.reshape(-1, 62), rois.reshape(-1, 4)
    with torch.inference_mode():
        dense_ref = rescale_to_roi(
            decode_dense_fused_reference(flat_p, basis, pack), flat_r)
    path_err = (dense.reshape(dense_ref.shape) - dense_ref).abs().max().item()
    torch.testing.assert_close(dense.reshape(dense_ref.shape), dense_ref,
                               rtol=RTOL, atol=ATOL)
    max_err = max(max_err, path_err)
    torch.testing.assert_close(dense[..., kp_vert], lmk, rtol=RTOL, atol=1e-2)
    del dense_ref
    log(f"process_batch B={BATCH}: faces/frame {n_faces.float().mean():.2f},"
        f" dense vs plain twin max_abs_err {path_err:.3e}, peak "
        f"{peak_gb:.2f} GiB, {time.perf_counter() - t0:.1f} s")

    # -- 5. end-to-end timing ---------------------------------------------------
    e2e = {}
    for b in (1, BATCH):
        a = (frames[:b], frames_s2d[:b], hws[:b])
        ms = time_ms(lambda: eng.process_batch(*a), 10 if b == 1 else 5,
                     torch)
        e2e[b] = (ms, b * FACES / ms * 1e3)
        log(f"end-to-end B={b} frames: {ms:.3f} ms/call, "
            f"{e2e[b][1]:.1f} faces/s | {card}")

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
                ("decode tail", lambda: eng.tail(fp, fr4)))}
            log(f"stages at B={b}: " + ", ".join(
                f"{k} {v:.3f} ms" for k, v in stages[str(b)].items())
                + f" | {card}")

    # -- 6. device profile (opt-in) -------------------------------------------
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
        with open(os.path.join(args.profile, "profile.json"), "w") as f:
            json.dump(summary, f, indent=1)

    ms8, plain8 = kernel_stats[FACES]
    ms1k, plain1k = kernel_stats[FACES * BATCH]
    print(json.dumps({"kernels": [{
        "name": "fused_decode", "route": "cuda",
        "source": "synergynet_tpu_torch/csrc/fused_decode.cu",
        "replaces": "synergynet_tpu/ops/fused_decode.py:66",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms1k, "plain_ms": plain1k, "faces": FACES * BATCH,
        "ms_b8": ms8, "plain_ms_b8": plain8}],
        "e2e_faces_per_s": {str(b): v[1] for b, v in e2e.items()},
        "e2e_ms": {str(b): v[0] for b, v in e2e.items()},
        "stages_ms": stages}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
