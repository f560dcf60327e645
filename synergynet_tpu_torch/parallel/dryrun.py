"""A dry run of the port's scale-out paths on ``n`` ranks, held against the
same work in one process.

    python -m synergynet_tpu_torch.parallel.dryrun N [--device cpu]

The port's counterpart of ``__graft_entry__.dryrun_multichip``
(``__graft_entry__.py:90-193``): :func:`dryrun_multichip` starts ``n``
ranks (:mod:`synergynet_tpu_torch.parallel.launch`) on a ``(data, model)``
mesh, ``n_model`` 2 where ``n`` is even and at least 4, as there, and each
rank runs its stages:

1. the full-width MobileNetV2 train step (the shipped trained weights)
   with BatchNorm synchronized over the data group, and again from the
   same weights with per-replica BatchNorm (``bn_groups`` = the data
   size), at 2 crops a data row;
2. the tensor-parallel dense decode (on a 1 x n mesh when the main mesh
   has one model column), kernel B1 on each vertex slab on the card;
3. sharded serving: ``FusedFrameEngine.process_batch`` on one 720x1088
   frame a data row;
4. a one-step device-generative resident epoch at 2 crops a data row,
   from the state stage 1 left.

The parent then does the same work in one process of the port on the same
device: ``make_train_step`` with ``bn_groups`` 1 and d on the global
batch, the whole
decode, ``process_batch`` on all the frames, and the generative step on
the global batch the ranks drew. It raises ``AssertionError`` on any
difference beyond the tolerances below, and returns the measured ones.
The nets are f32 with TF32 off and the head's dropout at 0, so both sides
compute the same function. The rank functions live here, so a rank
imports only the port.
"""

from __future__ import annotations

import tempfile
from typing import Dict

import numpy as np
import torch

# Largest difference of a state leaf, rank against one process, over the
# leaf's scale (its largest |value|, at least 1e-2 of the largest leaf's):
# the two sides sum the same per-row gradients in another order.
STATE_REL = 1e-3
DENSE_TOL = dict(rtol=1e-4, atol=1e-3)     # the dense decode's (f32)
ROW_CROPS = 2
FRAME_SEED = 5          # a frame whose detector scores keep clear of 0.5
LR = 0.01


def _mesh_shape(n: int):
    n_model = 2 if n % 2 == 0 and n >= 4 else 1
    return n // n_model, n_model


def _setup(device):
    """Model, optimizer and pack, identical on every rank and the parent:
    the shipped trained weights (a random-init BatchNorm net's gradient
    moves by percents for a 1e-7 change of its input, so two reduction
    orders could not be held to ``STATE_REL``)."""
    from synergynet_tpu_torch.convert import synergy_state_dict
    from synergynet_tpu_torch.core.checkpoint import (load_trained_variables,
                                                      shipped_trained_path)
    from synergynet_tpu_torch.mm3d import load_param_pack
    from synergynet_tpu_torch.nn import SynergyNet
    from synergynet_tpu_torch.train import TrainState, make_optimizer
    pack = load_param_pack()
    opt = make_optimizer(lambda count: LR)
    model = SynergyNet(dropout=0.0)
    model.load_state_dict(synergy_state_dict(load_trained_variables(
        shipped_trained_path())))
    return pack, opt, TrainState(model.to(device))


def _train_batch(d: int):
    rng = np.random.default_rng(0)
    b = ROW_CROPS * d
    return (rng.integers(0, 256, (b, 120, 120, 3), np.uint8),
            rng.normal(0, 0.5, (b, 62)).astype(np.float32))


def _decode_params(d: int):
    return np.random.default_rng(1).normal(
        0, 1, (2 * d, 62)).astype(np.float32)


def _frames(d: int, device):
    from synergynet_tpu_torch.detect.detector import CANVAS, prepare_frame
    img = np.random.default_rng(FRAME_SEED).integers(
        0, 256, CANVAS + (3,), np.uint8)
    canvas, packed, hw, _ = prepare_frame(img, 8, device)
    rep = lambda x: x[None].expand(d, *x.shape).contiguous()  # noqa: E731
    return rep(canvas), rep(packed), rep(hw)


def _gen_params(d: int):
    from synergynet_tpu_torch.data.synthetic import sample_params
    return sample_params(np.random.default_rng(3), ROW_CROPS * d)


def _engine(device):
    from synergynet_tpu_torch.detect import FaceBoxes
    from synergynet_tpu_torch.pipeline import (FusedFrameEngine,
                                               SynergyNet3DMM)
    api = SynergyNet3DMM(variables="trained", device=device)
    return FusedFrameEngine(api, detector=FaceBoxes(device=device),
                            max_faces=2)


def _state_dict(st) -> Dict[str, torch.Tensor]:
    return {k: getattr(st, k).detach().cpu().clone()
            for k in ("params", "stats", "trace", "count", "step")}


def rank_main(device: str) -> dict:
    """One rank's stages (run inside a process group)."""
    import torch.distributed as dist
    from synergynet_tpu_torch.core.mesh import (DATA_AXIS, make_mesh,
                                                replicate, shard_batch)
    from synergynet_tpu_torch.mm3d.codec import full_fp32
    from synergynet_tpu_torch.ops.cuda_build import launches
    from synergynet_tpu_torch.parallel import (shard_fused_engine,
                                               tp_dense_decode,
                                               warm_mesh_cliques)
    from synergynet_tpu_torch.train import (jit_train_step,
                                            make_generative_epoch_program,
                                            shard_resident_params)
    n = dist.get_world_size()
    n_data, n_model = _mesh_shape(n)
    mesh = make_mesh(n_data, n_model, device=device)
    warm_mesh_cliques(mesh)
    tp_mesh = mesh if n_model > 1 else make_mesh(1, n, device=device)
    warm_mesh_cliques(tp_mesh)
    d, row, dev = mesh.shape[DATA_AXIS], mesh.data_index, mesh.device
    out = {"rank": mesh.rank, "row": row, "mesh": dict(mesh.shape),
           "backend": dist.get_backend(), "world": n}
    rows = slice(row * ROW_CROPS, (row + 1) * ROW_CROPS)

    # 1. the step with synchronized, then with per-replica BatchNorm
    images, target = _train_batch(d)
    for bn_groups in (1, d):
        pack, opt, state = _setup(dev)
        replicate(mesh, state)
        step = jit_train_step(pack, opt, mesh, bn_groups=bn_groups)
        with full_fp32():
            _, m = step(state, *shard_batch(mesh, (images[rows],
                                                   target[rows])))
        out[f"step_bn{bn_groups}"] = _state_dict(state)

    # 2. the tensor-parallel dense decode
    b1 = "synergy_fused_decode"
    before = launches[b1]
    decode = tp_dense_decode(tp_mesh, pack)
    p62 = _decode_params(tp_mesh.shape[DATA_AXIS])
    tp_rows = slice(tp_mesh.data_index * 2, (tp_mesh.data_index + 1) * 2)
    slab, checksum = decode(torch.from_numpy(p62[tp_rows]).to(dev))
    out["tp"] = {"slab": slab.cpu(), "checksum": checksum.cpu(),
                 "range": decode.vertex_range,
                 "launches": launches[b1] - before,
                 "row": tp_mesh.data_index}

    # 3. sharded serving
    engine = _engine(dev)
    before = launches[b1]
    outs = shard_fused_engine(engine, mesh)(*_frames(d, dev))
    out["serve"] = [x.cpu() for x in outs]
    out["serve_launches"] = launches[b1] - before

    # 4. a one-step generative resident epoch
    out["gen_start"] = _state_dict(state)
    params = _gen_params(d)
    epoch = make_generative_epoch_program(pack, opt, mesh, ROW_CROPS * d,
                                          seed=3)
    with full_fp32():
        _, gm = epoch(state, shard_resident_params(mesh, params), 1, 1)
    out["gen"] = _state_dict(state)
    out["gen_loss"] = gm["loss_total"]
    return out


def _leaf_rel(got: torch.Tensor, want: torch.Tensor, sizes) -> float:
    """The largest per-leaf max |got - want| over the leaf's scale."""
    wl = torch.split(want.double(), sizes)
    gl = torch.split(got.double(), sizes)
    top = max(float(w.abs().max()) for w in wl if w.numel())
    worst = 0.0
    for g, w in zip(gl, wl):
        if w.numel():
            scale = max(float(w.abs().max()), 1e-2 * top, 1e-30)
            worst = max(worst, float((g - w).abs().max()) / scale)
    return worst


def _state_errors(got: dict, st, model) -> Dict[str, float]:
    p_sizes = [p.numel() for p in model.parameters()]
    b_sizes = [b.numel() for b in model.buffers()]
    errs = {"params": _leaf_rel(got["params"], st.params.cpu(), p_sizes),
            "trace": _leaf_rel(got["trace"], st.trace.cpu(), p_sizes),
            "stats": _leaf_rel(got["stats"], st.stats.cpu(), b_sizes)}
    if int(got["count"]) != int(st.count) or int(got["step"]) != int(
            st.step):
        raise AssertionError("count / step differ from one process")
    return errs


def _load_state(st, saved: dict) -> None:
    with torch.no_grad():
        for k, v in saved.items():
            getattr(st, k).copy_(v)


def dryrun_multichip(n: int, device: str = "cuda",
                     backend: str = None, timeout: float = 600.0,
                     workdir: str = None) -> dict:
    """Run the four stages on ``n`` ranks and hold them against one process
    on ``device`` (the card unless the caller asks for the CPU). Ranks
    join over NCCL when each has a card of its own, else over gloo (CUDA
    tensors included). Returns the mesh, the backend, each stage's largest
    difference and the ranks' B1 launches."""
    from synergynet_tpu_torch.core.device import resolve_device
    from synergynet_tpu_torch.mm3d.codec import full_fp32
    from synergynet_tpu_torch.ops.fused_decode import (DecodeBasis,
                                                       build_decode_basis,
                                                       decode_dense_fused)
    from synergynet_tpu_torch.parallel.launch import run_ranks
    from synergynet_tpu_torch.train import make_train_step
    from synergynet_tpu_torch.train.resident import (generative_batch,
                                                     generative_order)
    dev = resolve_device(device)
    if backend is None:
        backend = ("nccl" if dev.type == "cuda"
                   and n <= torch.cuda.device_count() else "gloo")
    with tempfile.TemporaryDirectory(dir=workdir) as tmp:
        ranks = run_ranks("synergynet_tpu_torch.parallel.dryrun:rank_main",
                          n, tmp, {"device": dev.type}, backend=backend,
                          timeout=timeout)
    d, n_model = _mesh_shape(n)
    report = {"n": n, "mesh": ranks[0]["mesh"], "backend": backend,
              "world": ranks[0]["world"]}
    if {r["backend"] for r in ranks} != {backend}:
        raise AssertionError(f"ranks ran over {[r['backend'] for r in ranks]}")

    # 1. one process on the global batch, bn_groups 1 and d
    images, target = _train_batch(d)
    for bn_groups, key in ((1, "sync_bn_rel"), (d, "step_rel")):
        pack, opt, st = _setup(dev)
        with full_fp32():
            make_train_step(pack, opt, bn_groups=bn_groups, device=dev)(
                st, torch.from_numpy(images), torch.from_numpy(target))
        errs = [_state_errors(r[f"step_bn{bn_groups}"], st, st.model)
                for r in ranks]
        report[key] = {k: max(e[k] for e in errs) for k in errs[0]}

    # 2. the whole decode (pad vertices included for the checksum)
    p62 = torch.from_numpy(_decode_params(1 if n_model == 1 else d)).to(dev)
    basis = build_decode_basis(pack)
    full = decode_dense_fused(p62, DecodeBasis(
        basis.w.to(dev), basis.u.to(dev), basis.npad), pack.to(dev)).cpu()
    tp_err, ck_err = 0.0, 0.0
    for r in ranks:
        lo, hi = r["tp"]["range"]
        rows = slice(r["tp"]["row"] * 2, r["tp"]["row"] * 2 + 2)
        want = full[rows, :, lo:hi]
        torch.testing.assert_close(r["tp"]["slab"], want, **DENSE_TOL)
        torch.testing.assert_close(r["tp"]["checksum"],
                                   full[rows].sum(dim=2), rtol=1e-4,
                                   atol=1e-3 * basis.npad)
        tp_err = max(tp_err, float((r["tp"]["slab"] - want).abs().max()))
        ck_err = max(ck_err, float((r["tp"]["checksum"]
                                    - full[rows].sum(dim=2)).abs().max()))
    report.update(tp_max_abs_err=tp_err, tp_checksum_err=ck_err,
                  tp_launches=[r["tp"]["launches"] for r in ranks])

    # 3. process_batch on every frame at once
    want = [x.cpu() for x in _engine(dev).process_batch(*_frames(d, dev))]
    serve_err = 0.0
    for r in ranks:
        rows = slice(r["row"], r["row"] + 1)
        got = r["serve"]
        if not torch.equal(got[1], want[1][rows]):
            raise AssertionError("sharded serving: face counts differ")
        for i in (2, 4, 5):           # rois, landmarks, dense meshes
            torch.testing.assert_close(got[i], want[i][rows], **DENSE_TOL)
            serve_err = max(serve_err, float(
                (got[i] - want[i][rows]).abs().max()))
    report["serve_max_abs_err"] = serve_err
    report["serve_faces"] = int(want[1].sum())
    report["serve_launches"] = [r["serve_launches"] for r in ranks]

    # 4. the generative step on the global batch the ranks drew
    _load_state(st, ranks[0]["gen_start"])
    params = torch.from_numpy(_gen_params(d)).to(dev)
    nl = ROW_CROPS
    render_pack = pack._replace(u=pack.u[:0], w_shp=pack.w_shp[:0],
                                w_exp=pack.w_exp[:0]).to(dev)
    parts = []
    for row in range(d):
        idx = torch.from_numpy(generative_order(3, 1, nl, row)).to(dev)
        parts.append(generative_batch(params[row * nl:(row + 1) * nl], idx,
                                      render_pack, 3, 1, idx + row * nl))
    with full_fp32():
        make_train_step(pack, opt, device=dev)(
            st, torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))
    errs = [_state_errors(r["gen"], st, st.model) for r in ranks]
    report["gen_rel"] = {k: max(e[k] for e in errs) for k in errs[0]}
    report["gen_loss"] = ranks[0]["gen_loss"]
    for key in ("sync_bn_rel", "step_rel", "gen_rel"):
        if max(report[key].values()) > STATE_REL:
            raise AssertionError(f"{key} {report[key]} > {STATE_REL}")
    return report


if __name__ == "__main__":
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n", type=int)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    print(dryrun_multichip(a.n, a.device))
