"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs a CUDA card and skips without one. The file imports
neither JAX nor the repo's conftest fixtures, so on a machine with a card
and no JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import contextlib

import numpy as np
import pytest
import torch

from synergynet_tpu_torch.mm3d import load_param_pack
from synergynet_tpu_torch.mm3d.codec import full_fp32
from synergynet_tpu_torch.ops import (build_decode_basis, decode_dense_fused,
                                      decode_dense_fused_reference)
from synergynet_tpu_torch.ops.cuda_build import launches
from tests.nms_cases import CASES as NMS_CASES

torch.set_num_threads(2)


def _counts(*symbols):
    """The launch table's counts of the C entries ``symbols``."""
    return tuple(launches[s] for s in symbols)

RTOL, ATOL = 1e-4, 1e-3     # the dense decode's tolerance (f32)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def full(cuda):
    pack = load_param_pack().to(cuda)
    return pack, build_decode_basis(pack).to(cuda)


# Face counts on both sides of the few-faces tile (8 faces, also the switch
# between the two tilings), of the many-faces tile (32 faces) and of the
# four tiles a block walks (128 faces).
DECODE_FACES = [1, 7, 8, 9, 16, 17, 31, 32, 33, 37, 127, 128, 129, 1024,
                1031]


@pytest.mark.gpu
@pytest.mark.parametrize("b", DECODE_FACES)
def test_fused_decode_matches_plain_twin(cuda, full, b):
    pack, basis = full
    rng = np.random.default_rng(b)
    p = torch.tensor(rng.normal(0, 1, (b, 62)).astype(np.float32),
                     device=cuda)
    before = launches["synergy_fused_decode"]
    got = decode_dense_fused(p, basis, pack)
    torch.cuda.synchronize()
    assert launches["synergy_fused_decode"] == before + 1
    assert got.shape == (b, 3, 53215)
    torch.testing.assert_close(got, decode_dense_fused_reference(p, basis,
                                                                 pack),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [5, 19])
def test_fused_decode_ragged_small_basis(cuda, b):
    """A vertex count that is not a tile multiple, with padding columns,
    under both tilings."""
    rng = np.random.default_rng(0)
    nver, npad = 97, 128
    w = torch.zeros((3, npad, 50))
    w[:, :nver] = torch.tensor(rng.normal(0, 3, (3, nver, 50)),
                               dtype=torch.float32)
    u = torch.zeros((3, npad))
    u[:, :nver] = torch.tensor(rng.normal(60, 20, (3, nver)),
                               dtype=torch.float32)
    from synergynet_tpu_torch.ops import DecodeBasis
    basis = DecodeBasis(w.to(cuda), u.to(cuda), nver)
    pack = load_param_pack().to(cuda)
    p = torch.tensor(rng.normal(0, 1, (b, 62)).astype(np.float32),
                     device=cuda)
    got = decode_dense_fused(p, basis, pack)
    torch.testing.assert_close(got, decode_dense_fused_reference(p, basis,
                                                                 pack),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [8, 1024])
def test_fused_decode_is_deterministic(cuda, full, b):
    pack, basis = full
    rng = np.random.default_rng(100 + b)
    p = torch.tensor(rng.normal(0, 1, (b, 62)).astype(np.float32),
                     device=cuda)
    assert torch.equal(decode_dense_fused(p, basis, pack),
                       decode_dense_fused(p, basis, pack))


@pytest.mark.gpu
def test_fused_decode_rejects_what_it_does_not_take(cuda, full):
    pack, basis = full
    p = torch.zeros((2, 62), dtype=torch.float64, device=cuda)
    with pytest.raises(TypeError):
        decode_dense_fused(p, basis, pack)
    p = torch.zeros((2, 62), device=cuda)
    with pytest.raises(ValueError):
        decode_dense_fused(p, basis._replace(w=basis.w.cpu()), pack)


# -- kernel B2: the z-buffer rasterizer -------------------------------------

def _raster_cases(rng, h=96, w=160):
    """Stress meshes on an (h, w) canvas: (name, verts (V, 3), tris (T, 3)
    int32, colors (V, 3))."""
    v = rng.uniform([0, 0, -5], [w, h, 5], (300, 3)).astype(np.float32)
    t = rng.integers(0, 300, (400, 3)).astype(np.int32)
    c = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    cases = [("random", v, t, c)]
    # every triangle twice: exact depth ties, the lower index must win
    cases.append(("ties", v, np.concatenate([t, t[::-1]]), c))
    d = v.copy()
    d[:30, :2] = d[0, :2]                          # zero-area triangles
    d[30:60, 1] = d[30:60, 0] * 0.5                # collinear triangles
    td = np.concatenate([t, rng.integers(0, 60, (100, 3))]).astype(np.int32)
    cases.append(("degenerate", d, td, c))
    g = np.asarray([[-20, -20, 1], [3 * w, -10, 1], [-10, 3 * h, 1],
                    [10, 10, 2], [w - 10, 20, 2], [20, h - 10, 2]],
                   np.float32)
    cases.append(("giant", np.concatenate([v, g]),
                  np.concatenate([t, [[300, 301, 302], [303, 304, 305]]]
                                 ).astype(np.int32),
                  np.concatenate([c, rng.uniform(0, 1, (6, 3))]
                                 ).astype(np.float32)))
    p = v.copy()
    p[150:] += 1e7                                 # parked half
    cases.append(("parked", p, t, c))
    o = v.copy()
    o[:, 0] += 1e30                                # far off the canvas
    cases.append(("offcanvas", o, t, c))
    cases.append(("empty", v, t[:0], c))
    return cases


def _full_width_mesh(cuda, faces=8, seed=0):
    """8 decoded BFM meshes in rois spread over the 720x1088 canvas, with
    random per-vertex colors."""
    from synergynet_tpu_torch.mm3d import rescale_to_roi
    pack = load_param_pack().to(cuda)
    basis = build_decode_basis(pack).to(cuda)
    rng = np.random.default_rng(seed)
    p = torch.tensor(rng.normal(0, 1, (faces, 62)).astype(np.float32),
                     device=cuda)
    size = rng.uniform(80, 600, faces)
    x0 = rng.uniform(0, 1088 - size)
    y0 = rng.uniform(0, 720 - size)
    rois = torch.tensor(np.stack([x0, y0, x0 + size, y0 + size], 1),
                        dtype=torch.float32, device=cuda)
    dense = rescale_to_roi(decode_dense_fused_reference(p, basis, pack), rois)
    nver = dense.shape[2]
    verts = dense.transpose(1, 2).reshape(-1, 3).contiguous()
    tri = pack.tri.T.long()
    tris = (tri[None] + torch.arange(faces, device=cuda)[:, None, None]
            * nver).reshape(-1, 3).contiguous()
    colors = torch.tensor(rng.uniform(0, 1, (faces * nver, 3)),
                          dtype=torch.float32, device=cuda)
    return verts, tris, colors


def _record_visibility(verts, tris, h, w):
    """The visibility path's record route, as the JAX package runs it:
    records whose payload planes are the triangle id and w0, through the
    payload kernel's twin. -> (tri_id, zbuf, w0)."""
    from synergynet_tpu_torch.render import rasterize_records_reference
    from synergynet_tpu_torch.render.raster_tiled import _visibility_records
    rec = _visibility_records(verts, tris, h=h, w=w)
    z, pay = rasterize_records_reference(rec, 2, h=h, w=w)
    drawn = z > -1e8
    tri = torch.where(drawn, pay[..., 0].to(torch.int32),
                      torch.full_like(z, -1, dtype=torch.int32))
    return tri, z, torch.where(drawn, pay[..., 1], torch.zeros_like(z))


def _assert_raster_twins(verts, tris, pay, h, w):
    """Both mesh kernels against their twins, bit for bit: B2 (zbuf,
    payloads), B3 (zbuf, ids, w0), the visibility path against its record
    route, and the deferred path against the payload path (3 payloads)."""
    from synergynet_tpu_torch.render import (
        rasterize_buffers_reference, rasterize_buffers_tiled, rasterize_mesh,
        rasterize_mesh_ids, rasterize_mesh_ids_reference,
        rasterize_triangles_tiled)
    before = _counts("synergy_raster_mesh", "synergy_raster_mesh_ids")
    z, p = rasterize_mesh(verts, tris, pay, h=h, w=w)
    z3, ids, w0 = rasterize_mesh_ids(verts, tris, h=h, w=w, w0=True)
    torch.cuda.synchronize()
    assert _counts("synergy_raster_mesh", "synergy_raster_mesh_ids") == (
        before[0] + 1, before[1] + 1)
    zr, pr = rasterize_buffers_reference(verts, tris, pay, h=h, w=w)
    assert z.shape == (h, w) and p.shape == (h, w, pay.shape[1])
    assert torch.equal(z, zr) and torch.equal(p, pr)
    want = rasterize_mesh_ids_reference(verts, tris, h=h, w=w, w0=True)
    assert all(torch.equal(a, b) for a, b in zip((z3, ids, w0), want))
    assert torch.equal(z3, z) and ((ids >= 0) == (z > -1e8)).all()
    tri, zv, w0v = rasterize_triangles_tiled(verts, tris, h=h, w=w)
    assert all(torch.equal(a, b) for a, b in zip(
        (tri, zv, w0v), _record_visibility(verts, tris, h, w)))
    assert torch.equal(tri, ids) and torch.equal(w0v, w0)
    if pay.shape[1] == 3:
        zd, cd = rasterize_buffers_tiled(verts, tris, pay, h=h, w=w,
                                         deferred=True)
        assert torch.equal(zd, z) and torch.equal(cd, p)
    return z


INDEX_TYPES = [torch.int32, torch.int64]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", INDEX_TYPES)
@pytest.mark.parametrize("case", range(7))
def test_raster_kernel_matches_plain_twin_on_stress_meshes(cuda, case, dtype):
    name, v, t, c = _raster_cases(np.random.default_rng(case))[case]
    v, t, c = (torch.tensor(a, device=cuda) for a in (v, t, c))
    z = _assert_raster_twins(v, t.to(dtype), c, 96, 160)
    drawn = (z > -1e8).sum().item()
    if name in ("offcanvas", "empty"):
        assert drawn == 0
    else:
        assert drawn > 0


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(7))
def test_raster_kernels_match_plain_twins_on_full_canvas_stress_meshes(
        cuda, case):
    """The stress meshes scaled to the overlay's 720x1088 canvas: the
    giant triangle spans it, the others are ~7x larger than at 96x160."""
    name, v, t, c = _raster_cases(np.random.default_rng(case), 720,
                                  1088)[case]
    v, t, c = (torch.tensor(a, device=cuda) for a in (v, t, c))
    z = _assert_raster_twins(v, t, c, 720, 1088)
    assert ((z > -1e8).sum().item() == 0) == (name in ("offcanvas", "empty"))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", INDEX_TYPES)
@pytest.mark.parametrize("n_payload", [1, 2, 3, 4, 5])
def test_raster_kernel_payload_counts(cuda, n_payload, dtype):
    _, v, t, _ = _raster_cases(np.random.default_rng(9))[2]
    rng = np.random.default_rng(n_payload)
    pay = torch.tensor(rng.normal(0, 3, (len(v), n_payload)),
                       dtype=torch.float32, device=cuda)
    v, t = (torch.tensor(a, device=cuda) for a in (v, t))
    _assert_raster_twins(v, t.to(dtype), pay, 96, 160)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", INDEX_TYPES)
def test_raster_kernel_matches_plain_twin_at_full_width(cuda, dtype):
    verts, tris, colors = _full_width_mesh(cuda)
    assert tris.shape == (8 * 105840, 3)
    z = _assert_raster_twins(verts, tris.to(dtype), colors, 720, 1088)
    assert (z > -1e8).float().mean().item() > 0.05


@pytest.mark.gpu
def test_raster_kernels_repeat_bit_identical(cuda):
    """Launch after launch on the same mesh, the atomics' order changes
    and the buffers do not."""
    from synergynet_tpu_torch.render import rasterize_mesh, rasterize_mesh_ids
    verts, tris, colors = _full_width_mesh(cuda, seed=2)
    tris = tris.int()
    first = rasterize_mesh(verts, tris, colors, h=720, w=1088)
    first_ids = rasterize_mesh_ids(verts, tris, h=720, w=1088, w0=True)
    for _ in range(3):
        again = rasterize_mesh(verts, tris, colors, h=720, w=1088)
        assert all(torch.equal(a, b) for a, b in zip(first, again))
        again = rasterize_mesh_ids(verts, tris, h=720, w=1088, w0=True)
        assert all(torch.equal(a, b) for a, b in zip(first_ids, again))


_TRAP_SCRIPT = """
import sys, torch
from synergynet_tpu_torch.render import rasterize_mesh, rasterize_mesh_ids
v = torch.rand((10, 3), device="cuda") * 8
t = torch.tensor([[0, 1, {index}]], dtype=torch.{dtype}, device="cuda")
try:
    if "{entry}" == "ids":
        rasterize_mesh_ids(v, t, h=8, w=8, w0=True)
    else:
        rasterize_mesh(v, t, v.clone(), h=8, w=8)
    torch.cuda.synchronize()
except RuntimeError as e:
    print("kernel failed:", e)
    sys.exit(3)
print("kernel ran")
"""


@pytest.mark.gpu
@pytest.mark.parametrize("entry,dtype,index", [
    ("payloads", "int32", 2), ("payloads", "int32", 10),
    ("ids", "int32", -1), ("payloads", "int64", 2 ** 33),
    ("ids", "int64", 10)])
def test_raster_kernel_traps_on_out_of_range_index(cuda, entry, dtype,
                                                   index):
    """A triangle index outside [0, V) traps the kernel instead of reading
    outside the vertices; in a child process, since a trap ends the CUDA
    context. Index 2 is the control, which runs."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-c", _TRAP_SCRIPT.format(entry=entry, dtype=dtype,
                                                   index=index)],
        cwd=root, capture_output=True, text=True, timeout=300)
    if index == 2:
        assert proc.returncode == 0 and "kernel ran" in proc.stdout, \
            proc.stderr
    else:
        assert proc.returncode == 3, (proc.stdout, proc.stderr)
        assert "kernel failed" in proc.stdout


@pytest.mark.gpu
def test_card_paths_build_no_plane_records(cuda, monkeypatch):
    """The overlay, deferred and visibility paths on the card: the record
    builders raise if called, and no (T, >= 13) tensor is stacked."""
    from synergynet_tpu_torch.detect import FaceBoxes
    from synergynet_tpu_torch.detect.detector import random_init_variables
    from synergynet_tpu_torch.pipeline import (FusedFrameEngine,
                                               FusedOverlayEngine,
                                               SynergyNet3DMM)
    from synergynet_tpu_torch.render import raster_tiled

    def refuse(*args, **kwargs):
        raise AssertionError("a plane record was built on the card")

    for name in ("plane_records", "compact_records", "_visibility_records"):
        monkeypatch.setattr(raster_tiled, name, refuse)
    stack = torch.stack
    ntri = []

    def checked_stack(tensors, dim=0, **kwargs):
        out = stack(tensors, dim, **kwargs)
        if out.dim() == 2 and out.shape[0] in ntri and out.shape[1] >= 13:
            raise AssertionError(f"a {tuple(out.shape)} record was stacked")
        return out

    monkeypatch.setattr(torch, "stack", checked_stack)
    api = SynergyNet3DMM(variables="trained", dtype=torch.bfloat16,
                         device=cuda)
    ov = FusedOverlayEngine(FusedFrameEngine(
        api, detector=FaceBoxes(random_init_variables(0),
                               dtype=torch.bfloat16, device=cuda),
        max_faces=8))
    ntri.extend(ov.tris_all.shape[0] // 8 * f for f in (1, 2, 4, 8))
    assert ov.tris_all.dtype == torch.int32
    img = np.random.default_rng(2).integers(0, 256, (720, 1088, 3), np.uint8)
    before = launches["synergy_raster_mesh"]
    pts, _, _, overlay = ov(img)
    assert len(pts) > 0 and overlay.shape == img.shape
    assert launches["synergy_raster_mesh"] == before + 1
    verts, tris, colors = _full_width_mesh(cuda, seed=3)
    tris = tris.int()
    ntri.append(tris.shape[0])
    before = launches["synergy_raster_mesh_ids"]
    z, c = raster_tiled.rasterize_buffers_tiled(verts, tris, colors, h=720,
                                                w=1088, deferred=True)
    tri, zv, w0 = raster_tiled.rasterize_triangles_tiled(verts, tris, h=720,
                                                         w=1088)
    torch.cuda.synchronize()
    assert launches["synergy_raster_mesh_ids"] == before + 2
    assert torch.equal(z, zv) and ((tri >= 0) == (z > -1e8)).all()
    with pytest.raises(AssertionError):
        raster_tiled.rasterize_buffers_reference(verts, tris, colors, h=720,
                                                 w=1088)


@pytest.mark.gpu
def test_raster_kernel_rejects_what_it_does_not_take(cuda):
    from synergynet_tpu_torch.render import (rasterize_buffers_tiled,
                                             rasterize_mesh)
    _, v, t, c = _raster_cases(np.random.default_rng(0))[0]
    v, t, c = (torch.tensor(a, device=cuda) for a in (v, t, c))
    with pytest.raises(TypeError):
        rasterize_buffers_tiled(v.double(), t, c, h=32, w=32)
    with pytest.raises(ValueError):
        rasterize_buffers_tiled(v, t.cpu(), c, h=32, w=32)
    with pytest.raises(ValueError):
        rasterize_buffers_tiled(v.T.contiguous().T, t, c, h=32, w=32)
    with pytest.raises(ValueError):
        rasterize_mesh(v, t, torch.cat([c, c], 1), h=32, w=32)
    with pytest.raises(ValueError):
        rasterize_mesh(v, t, torch.cat([c, c], 1)[:, ::2], h=32, w=32)
    with pytest.raises(ValueError):
        rasterize_mesh(v, t, c.cpu(), h=32, w=32)


# -- kernel B3: depth + winning triangle id, the deferred path ---------------

@pytest.mark.gpu
@pytest.mark.parametrize("case", range(7))
def test_raster_ids_kernel_matches_plain_twin_on_stress_meshes(cuda, case):
    """The ids entry with and without w0: the same depth and ids."""
    from synergynet_tpu_torch.render import rasterize_mesh_ids
    _, v, t, _ = _raster_cases(np.random.default_rng(case))[case]
    v, t = (torch.tensor(a, device=cuda) for a in (v, t))
    z, ids = rasterize_mesh_ids(v, t, h=96, w=160)
    z3, ids3, _ = rasterize_mesh_ids(v, t, h=96, w=160, w0=True)
    assert torch.equal(z, z3) and torch.equal(ids, ids3)
    assert ((ids >= 0) == (z > -1e8)).all()


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(7))
def test_deferred_equals_payload_path_on_stress_meshes(cuda, case):
    from synergynet_tpu_torch.render import rasterize_buffers_tiled
    _, v, t, c = _raster_cases(np.random.default_rng(case))[case]
    v, t, c = (torch.tensor(a, device=cuda) for a in (v, t, c))
    zd, cd = rasterize_buffers_tiled(v, t, c, h=96, w=160, deferred=True)
    zk, ck = rasterize_buffers_tiled(v, t, c, h=96, w=160)
    assert torch.equal(zd, zk) and torch.equal(cd, ck)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", INDEX_TYPES)
def test_deferred_equals_payload_path_at_full_width(cuda, dtype):
    from synergynet_tpu_torch.render import rasterize_buffers_tiled
    verts, tris, colors = _full_width_mesh(cuda, seed=1)
    tris = tris.to(dtype)
    zd, cd = rasterize_buffers_tiled(verts, tris, colors, h=720, w=1088,
                                     deferred=True)
    zk, ck = rasterize_buffers_tiled(verts, tris, colors, h=720, w=1088)
    assert torch.equal(zd, zk) and torch.equal(cd, ck)


@pytest.mark.gpu
def test_raster_ids_rejects_what_it_does_not_take(cuda):
    from synergynet_tpu_torch.render import rasterize_mesh_ids
    _, v, t, _ = _raster_cases(np.random.default_rng(0))[0]
    v, t = (torch.tensor(a, device=cuda) for a in (v, t))
    with pytest.raises(TypeError):
        rasterize_mesh_ids(v.double(), t, h=32, w=32)
    with pytest.raises(TypeError):
        rasterize_mesh_ids(v, t.float(), h=32, w=32)
    with pytest.raises(ValueError):
        rasterize_mesh_ids(v, t[:, ::2], h=32, w=32)
    with pytest.raises(ValueError):
        rasterize_mesh_ids(v, t.cpu(), h=32, w=32)
    with pytest.raises(ValueError):
        rasterize_mesh_ids(v, t, h=0, w=32)


# -- kernel B4: the fused s2d8 stem -------------------------------------------

STEM_TOL = dict(rtol=1.6e-2, atol=1e-5)     # bf16's own tolerance


def _stem_case(cuda, b, h8, w8, seed=0):
    """Seeded bf16 s2d8 frames (a mean-subtracted image's spread), taps and
    bias, on the card."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = (torch.randn((b, h8, w8, 192), generator=g, device=cuda) * 60
         ).to(torch.bfloat16)
    k4 = (torch.randn((4, 192, 192), generator=g, device=cuda) * 0.02
          ).to(torch.bfloat16)
    bias = (torch.randn((192,), generator=g, device=cuda) * 0.5
            ).to(torch.bfloat16)
    return x, k4, bias


# Full frames; shapes on both sides of the 15 x 17 output tile; one row,
# one column, one pixel; more tiles than the card has blocks at once, so
# blocks walk several tiles through the load ring.
STEM_SHAPES = [(2, 90, 136), (3, 7, 17), (1, 1, 136), (2, 31, 35), (1, 1, 1),
               (1, 14, 16), (1, 15, 17), (1, 16, 18), (2, 29, 33),
               (1, 30, 1), (64, 16, 18)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", STEM_SHAPES)
def test_stem_kernel_matches_plain_twin(cuda, shape):
    from synergynet_tpu_torch.detect.stem_fused import (
        fused_stem1_s2d8, fused_stem1_s2d8_reference)
    x, k4, bias = _stem_case(cuda, *shape)
    before = launches["synergy_stem_s2d8"]
    got = fused_stem1_s2d8(x, k4, bias)
    torch.cuda.synchronize()
    assert launches["synergy_stem_s2d8"] == before + 1
    assert got.shape == (*shape, 48) and got.dtype == torch.bfloat16
    want = fused_stem1_s2d8_reference(x, k4, bias)
    torch.testing.assert_close(got.float(), want.float(), **STEM_TOL)
    assert (got.float() > 0).float().mean() > 0.2


@pytest.mark.gpu
def test_stem_kernel_at_128_full_frames(cuda):
    """128 full frames of small integers and weights on a 2**-7 grid: every
    f32 sum of the conv is exact in any order, so the kernel must equal the
    exact result (the conv in f64, ReLU, pool, one bf16 rounding) bit for
    bit, and the plain twin within bf16's tolerance."""
    import torch.nn.functional as F
    from synergynet_tpu_torch.detect.net import phase_maxpool_s2d8
    from synergynet_tpu_torch.detect.stem_fused import (
        fused_stem1_s2d8, fused_stem1_s2d8_reference)
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randint(-16, 17, (128, 90, 136, 192), generator=g,
                      device=cuda).to(torch.bfloat16)
    k4 = (torch.randint(-8, 9, (4, 192, 192), generator=g, device=cuda)
          * 2.0 ** -7).to(torch.bfloat16)
    bias = (torch.randint(-64, 65, (192,), generator=g, device=cuda)
            * 2.0 ** -7).to(torch.bfloat16)
    got = fused_stem1_s2d8(x, k4, bias)
    w = k4.double().reshape(2, 2, 192, 192).permute(3, 2, 0, 1)
    exact = []
    for xb in x.split(16):
        y = F.conv2d(F.pad(xb.double().permute(0, 3, 1, 2), (1, 0, 1, 0)), w,
                     bias.double())
        exact.append(phase_maxpool_s2d8(F.relu(y), 48).permute(0, 2, 3, 1)
                     .to(torch.bfloat16))
    assert torch.equal(got, torch.cat(exact))
    torch.testing.assert_close(
        got.float(), fused_stem1_s2d8_reference(x, k4, bias).float(),
        **STEM_TOL)


@pytest.mark.gpu
def test_stem_kernel_at_128_random_frames_within_f32_order_of_exact(cuda):
    """128 full frames of random data, where f32 sums of 768 products
    depend on their order. The exact result is the conv in f64, ReLU and
    the pool; each pooled f32 value may differ from it by at most
    n * 2u * (sum of |terms|) over the window (n = 769 terms with the
    bias, u = 2**-24, doubled for an accumulator that truncates), so its
    one bf16 rounding lies between the roundings of exact -/+ that bound.
    The kernel and the plain twin (cuDNN in f32) must both lie there; where
    they differ from each other by more than bf16's tolerance, it is
    rounding order, not a wrong sum."""
    import torch.nn.functional as F
    from synergynet_tpu_torch.detect.net import phase_maxpool_s2d8
    from synergynet_tpu_torch.detect.stem_fused import (
        fused_stem1_s2d8, fused_stem1_s2d8_reference)
    x, k4, bias = _stem_case(cuda, 128, 90, 136)
    got = fused_stem1_s2d8(x, k4, bias)
    twin = fused_stem1_s2d8_reference(x, k4, bias)
    w = k4.double().reshape(2, 2, 192, 192).permute(3, 2, 0, 1)
    gamma = 769 * 2.0 * 2.0 ** -24
    outside = 0
    for i, xb in enumerate(x.split(16)):
        xp = F.pad(xb.double().permute(0, 3, 1, 2), (1, 0, 1, 0))
        exact = phase_maxpool_s2d8(F.relu(F.conv2d(xp, w, bias.double())),
                                   48).permute(0, 2, 3, 1)
        mag = F.conv2d(xp.abs(), w.abs(), bias.double().abs())
        err = phase_maxpool_s2d8(mag, 48).permute(0, 2, 3, 1) * gamma
        lo = (exact - err).to(torch.bfloat16).double()
        hi = (exact + err).to(torch.bfloat16).double()
        for name, out in (("kernel", got), ("twin", twin)):
            o = out[16 * i:16 * (i + 1)].double()
            assert bool(((o >= lo) & (o <= hi)).all()), name
        g, t = got[16 * i:16 * (i + 1)].float(), twin[16 * i:16 * (i + 1)
                                                      ].float()
        outside += int(((g - t).abs() > STEM_TOL["atol"]
                        + STEM_TOL["rtol"] * t.abs()).sum())
    # The disagreements beyond bf16's tolerance are rare.
    assert outside <= got.numel() * 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 90, 136), (16, 90, 136)])
def test_stem_kernel_is_deterministic(cuda, shape):
    from synergynet_tpu_torch.detect.stem_fused import fused_stem1_s2d8
    x, k4, bias = _stem_case(cuda, *shape, seed=6)
    assert torch.equal(fused_stem1_s2d8(x, k4, bias),
                       fused_stem1_s2d8(x, k4, bias))


@pytest.mark.gpu
def test_stem_net_mode_runs_the_kernel(cuda):
    from synergynet_tpu_torch.detect.net import StemS2D8
    stem = StemS2D8().to(cuda, torch.bfloat16)
    with torch.no_grad():
        stem.weight.normal_(0, 0.02)
        stem.bias.normal_(0, 0.5)
        x = (torch.randn((2, 192, 16, 40), device=cuda) * 60).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        before = launches["synergy_stem_s2d8"]
        got = stem(x, "pallas")
        assert launches["synergy_stem_s2d8"] == before + 1
        with full_fp32():
            want = stem.float()(x.float(), "xla")
    # The f32 XLA stem on the same bf16 values; the kernel rounds its
    # pooled result to bf16 once.
    torch.testing.assert_close(got.float(), want, **STEM_TOL)


@pytest.mark.gpu
def test_stem_kernel_rejects_what_it_does_not_take(cuda):
    from synergynet_tpu_torch.detect.stem_fused import fused_stem1_s2d8
    x, k4, bias = _stem_case(cuda, 1, 4, 8)
    with pytest.raises(TypeError):
        fused_stem1_s2d8(x.float(), k4, bias)
    with pytest.raises(TypeError):
        fused_stem1_s2d8(x, k4.float(), bias)
    with pytest.raises(ValueError):
        fused_stem1_s2d8(x[..., :96].contiguous(), k4, bias)
    with pytest.raises(ValueError):
        fused_stem1_s2d8(x[:, :, ::2], k4, bias)
    with pytest.raises(ValueError):
        fused_stem1_s2d8(x, k4.cpu(), bias)
    with pytest.raises(ValueError):
        fused_stem1_s2d8(x, k4, bias, cout=24)


# -- kernel B4's f32 entry (fault C10) ------------------------------------------

def _stem_case_f32(cuda, b, h8, w8, seed=0):
    """Seeded f32 s2d8 frames, taps and bias on the card."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn((b, h8, w8, 192), generator=g, device=cuda) * 60
    k4 = torch.randn((4, 192, 192), generator=g, device=cuda) * 0.02
    bias = torch.randn((192,), generator=g, device=cuda) * 0.5
    return x, k4, bias


# 1, 2 and 128 full 720x1088 frames; tiles cut by the canvas edge (for an
# earlier 7 x 15 output tile: its ragged last row and column, one row, one
# column, one pixel); then the kernel's 15 x 17 tile cut one past its edge
# (one more conv row and column than a tile), ragged in both directions
# (29 x 33, 46 x 69, 91 x 137), and many small frames, so that a block
# walks hundreds of tiles through its ring.
STEM_F32_SHAPES = [(1, 90, 136), (2, 90, 136), (128, 90, 136), (3, 7, 17),
                   (1, 1, 1), (2, 31, 35), (1, 8, 16), (1, 30, 1),
                   (1, 15, 17), (2, 14, 136),
                   (1, 16, 18), (2, 29, 33), (1, 46, 69), (3, 91, 137),
                   (500, 15, 17), (1000, 1, 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", STEM_F32_SHAPES)
def test_stem_f32_kernel_matches_plain_twin(cuda, shape):
    """Both sum the same 768 f32 products (+ bias) per conv value in other
    orders, so they differ by summation order only: no more than 1e-5 of
    the output's largest magnitude."""
    from synergynet_tpu_torch.detect.stem_fused import (
        fused_stem1_s2d8, fused_stem1_s2d8_reference)
    x, k4, bias = _stem_case_f32(cuda, *shape)
    before = _counts("synergy_stem_s2d8", "synergy_stem_s2d8_f32")
    got = fused_stem1_s2d8(x, k4, bias)
    torch.cuda.synchronize()
    assert _counts("synergy_stem_s2d8", "synergy_stem_s2d8_f32") == (
        before[0], before[1] + 1)
    assert got.shape == (*shape, 48) and got.dtype == torch.float32
    want = fused_stem1_s2d8_reference(x, k4, bias)
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)
    assert (got > 0).float().mean() > 0.2


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 128])
def test_stem_f32_tolerance_rejects_one_tf32_pass(cuda, b):
    """The unchanged 1e-5 of the scale tells the kernel's three TF32 passes
    from one: cuDNN's conv with TF32 on, followed by the twin's ReLU and
    pool, lies outside it on the same data, while the kernel lies inside."""
    import torch.nn.functional as F

    from synergynet_tpu_torch.detect.net import phase_maxpool_s2d8
    from synergynet_tpu_torch.detect.stem_fused import (
        fused_stem1_s2d8, fused_stem1_s2d8_reference)
    x, k4, bias = _stem_case_f32(cuda, b, 90, 136)
    want = fused_stem1_s2d8_reference(x, k4, bias)
    limit = 1e-5 * want.abs().max().item()
    got = fused_stem1_s2d8(x, k4, bias)
    assert (got - want).abs().max().item() <= limit
    w = k4.reshape(2, 2, 192, 192).permute(3, 2, 0, 1)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        y = F.conv2d(F.pad(x.permute(0, 3, 1, 2), (1, 0, 1, 0)), w, bias)
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    once = phase_maxpool_s2d8(F.relu(y), 48).permute(0, 2, 3, 1)
    assert (once - want).abs().max().item() > limit


@pytest.mark.gpu
def test_stem_f32_stamps_leave_the_output_alone(cuda):
    """The clock64-stamped build gives the plain build's output bit for bit
    and fills every warp's stamps: waits, products and epilogue within its
    total."""
    from synergynet_tpu_torch.detect.stem_fused import _launch
    x, k4, bias = _stem_case_f32(cuda, 2, 90, 136)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    stamps = torch.zeros(sms * 8 * 4, dtype=torch.int64, device=cuda)
    got = _launch(x, k4, bias, stamps=stamps)
    assert torch.equal(got, _launch(x, k4, bias))
    s = stamps.view(-1, 4)
    s = s[s[:, 3] > 0]
    assert len(s) == sms // 6 * 6 * 8
    assert (s[:, 1] > 0).all() and (s[:, :3].sum(1) <= s[:, 3]).all()
    with pytest.raises(ValueError):
        _launch(x, k4, bias, stamps=stamps[:8])
    with pytest.raises(ValueError):
        _launch(x.bfloat16(), k4.bfloat16(), bias, stamps=stamps)


@pytest.mark.gpu
def test_stem_takes_bf16_or_f32_only(cuda):
    from synergynet_tpu_torch.detect.stem_fused import fused_stem1_s2d8
    x, k4, bias = _stem_case_f32(cuda, 1, 4, 8)
    with pytest.raises(TypeError):
        fused_stem1_s2d8(x.double(), k4.double(), bias)
    with pytest.raises(TypeError):
        fused_stem1_s2d8(x.half(), k4.half(), bias)
    with pytest.raises(TypeError):
        fused_stem1_s2d8(x, k4.to(torch.bfloat16), bias)


def _seeded_faceboxes_pth(tmp_path):
    from synergynet_tpu_torch.detect.torch_import import \
        seeded_faceboxes_state_dict
    path = str(tmp_path / "FaceBoxesProd.pth")
    torch.save({"module." + k: v for k, v in
                seeded_faceboxes_state_dict(0).items()}, path)
    return path


@pytest.mark.gpu
def test_f32_fused_stem_detector_card_matches_cpu(cuda, tmp_path):
    """Fault C10: an f32 FaceBoxes(stem_mode="pallas") from reference-layout
    weights runs B4's f32 entry on the card and gives the CPU's faces, face
    for face, on a frame whose candidate scores keep 1e-3 clear of the 0.5
    threshold (chip_smoke.py's DET_FRAME)."""
    from synergynet_tpu_torch.detect import FaceBoxes
    from synergynet_tpu_torch.detect.detector import (VIS_THRESHOLD,
                                                      prepare_frame)
    path = _seeded_faceboxes_pth(tmp_path)
    card = FaceBoxes(weights_path=path, device=cuda, stem_mode="pallas")
    cpu = FaceBoxes(weights_path=path, device="cpu", stem_mode="pallas")
    img = np.random.default_rng(1).integers(0, 256, (120, 160, 3), np.uint8)
    _, packed, hw, _ = prepare_frame(img, 8, "cpu")
    with torch.inference_mode():
        s, _ = cpu.candidates(packed[None], hw[None])
    assert (s[s > 0] - VIS_THRESHOLD).abs().min() > 1e-3
    before = launches["synergy_stem_s2d8_f32"]
    raw_g, n_g = card.detect_raw(img)
    assert launches["synergy_stem_s2d8_f32"] == before + 1
    raw_c, n_c = cpu.detect_raw(img)
    assert n_g == n_c > 0
    np.testing.assert_allclose(raw_g[:n_g, :4], raw_c[:n_c, :4], rtol=1e-4,
                               atol=0.05)
    np.testing.assert_allclose(raw_g[:n_g, 4], raw_c[:n_c, 4], rtol=0,
                               atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mobilenet_1", "resnet50",
                                  "resnext50_32x4d", "ghostnet", "resnest50",
                                  "mobilenet_v2_1.4"])
def test_imported_family_card_matches_cpu(cuda, arch, tmp_path):
    """chip_smoke.py phase 11's families: a reference-layout best.pth.tar
    from a seed, imported and served by SynergyNet3DMM in f32 (TF32 off)
    on the card, against the CPU at the API's chain tolerance; the decode
    tail launches B1."""
    from synergynet_tpu_torch.nn.torch_import import (
        expected_torch_shapes, load_synergynet_variables,
        seeded_torch_state_dict)
    from synergynet_tpu_torch.pipeline import SynergyNet3DMM
    sd = seeded_torch_state_dict(expected_torch_shapes(arch), 7)
    path = str(tmp_path / "best.pth.tar")
    torch.save({"state_dict": {"module." + k: v for k, v in sd.items()}},
               path)
    tree = load_synergynet_variables(path, arch=arch)
    pack = load_param_pack()
    img = np.random.default_rng(3).integers(0, 256, (240, 320, 3), np.uint8)
    rects = [[40.0, 50.0, 140.0, 160.0, 0.99], [-20.5, 150.5, 60.5, 260.5],
             [250.0, -30.0, 340.0, 70.0]]
    before = launches["synergy_fused_decode"]
    got = SynergyNet3DMM(variables=tree, arch=arch, pack=pack,
                         device=cuda).get_all_outputs(img, rects=rects)
    assert launches["synergy_fused_decode"] > before
    want = SynergyNet3DMM(variables=tree, arch=arch, pack=pack,
                          device="cpu").get_all_outputs(img, rects=rects)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-2)


# -- blend_uint8 on the card ---------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("alpha", [0.3, 0.6, 1.0])
def test_blend_uint8_card_cast_equals_cpu(cuda, alpha):
    """Colours outside [0, 1] and NaN: the card's f32 sum and saturating
    cast give the CPU's bytes."""
    from synergynet_tpu_torch.render import DEPTH_INIT, blend_uint8
    colours = torch.tensor([-0.5, 0.0, 0.5, 1.0, 1.2, 2.0, float("nan")])
    g = torch.Generator().manual_seed(4)
    bg = torch.randint(0, 256, (6, 7, 3), generator=g, dtype=torch.uint8)
    color = colours[None, :, None].expand(6, 7, 3).contiguous()
    zbuf = torch.zeros(6, 7)
    zbuf[5, ::2] = DEPTH_INIT
    for reverse in (False, True):
        want = blend_uint8(bg, zbuf, color, alpha, reverse=reverse)
        got = blend_uint8(bg.to(cuda), zbuf.to(cuda), color.to(cuda), alpha,
                          reverse=reverse)
        assert torch.equal(got.cpu(), want)


# -- the training step on the card ---------------------------------------------

TRAIN_REL = 1e-3     # chip_smoke.py's CARD_VS_CPU_REL


def _leaf_rel(got, want):
    top = max(float(w.abs().max()) for w in want.values())
    return max(float((got[k].cpu() - w).abs().max())
               / max(float(w.abs().max()), 1e-2 * top, 1e-30)
               for k, w in want.items())


def _train_setup(b=8, seed=5):
    from synergynet_tpu_torch.convert import synergy_state_dict
    from synergynet_tpu_torch.core.checkpoint import (load_trained_variables,
                                                      shipped_trained_path)
    from synergynet_tpu_torch.data import make_crops_with_params
    from synergynet_tpu_torch.train import lr_per_step, make_optimizer
    syn = make_crops_with_params(b, seed=seed)
    opt = make_optimizer(lr_per_step(0.08, (48, 64), 5, 8),
                         weight_decay=5e-4)
    trained = synergy_state_dict(load_trained_variables(
        shipped_trained_path()))
    return (torch.from_numpy(syn["images"]), torch.from_numpy(syn["params"]),
            opt, trained)


def _one_step(device, imgs, tgts, opt, trained, accum=1):
    from synergynet_tpu_torch.nn import SynergyNet
    from synergynet_tpu_torch.train import TrainState, make_train_step
    model = SynergyNet(dropout=0.0).to(device)
    model.load_state_dict(trained)
    st = TrainState(model, 5e-4)
    before = st.params.clone()
    _, m = make_train_step(load_param_pack(), opt, accum_steps=accum,
                           device=device)(st, imgs, tgts)
    named = [k for k, _ in model.named_parameters()]
    sizes = [p.numel() for p in model.parameters()]
    split = lambda t: dict(zip(named, t.cpu().split(sizes)))  # noqa: E731
    return (split(st.params - before), split(st.trace),
            {k: v.cpu() for k, v in model.named_buffers()}, m)


@pytest.mark.gpu
@pytest.mark.parametrize("accum", [1, 2])
def test_train_step_card_matches_cpu(cuda, accum):
    """One fp32 step (TF32 off) at batch 8 from the trained weights, dropout
    0, on the card and on the CPU: the update, the momentum and the running
    statistics within 1e-3 of each leaf's scale (reductions run in another
    order on the card; measured 3.3e-5 on an NVIDIA H100 80GB HBM3 at
    700.00 W), the loss within rtol 1e-4; with
    ``accum_steps=2`` too."""
    imgs, tgts, opt, trained = _train_setup()
    with full_fp32():
        card = _one_step(cuda, imgs, tgts, opt, trained, accum)
        cpu = _one_step(torch.device("cpu"), imgs, tgts, opt, trained, accum)
    for i in range(3):
        assert _leaf_rel(card[i], cpu[i]) <= TRAIN_REL, i
    assert abs(float(card[3]["loss_total"]) - float(cpu[3]["loss_total"])) \
        <= 1e-4 * abs(float(cpu[3]["loss_total"]))
    assert float(card[3]["skipped"]) == 0.0


@pytest.fixture(scope="module")
def card_step(cuda):
    from synergynet_tpu_torch.nn import SynergyNet
    from synergynet_tpu_torch.train import create_train_state, make_train_step
    imgs, tgts, opt, _ = _train_setup(64)
    gen = torch.Generator(device=cuda).manual_seed(0)
    st = create_train_state(SynergyNet(dtype=torch.bfloat16).to(cuda), gen,
                            opt)
    step = make_train_step(load_param_pack(), opt, device=cuda)
    return st, step, imgs.to(cuda), tgts.to(cuda), gen


@pytest.mark.gpu
def test_train_step_makes_no_host_sync(card_step):
    st, step, imgs, tgts, gen = card_step
    step(st, imgs, tgts, gen)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _, m = step(st, imgs, tgts, gen)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert m["skipped"].device.type == "cuda"
    assert torch.isfinite(m["loss_total"])


@pytest.mark.gpu
def test_train_step_skips_a_nan_batch_on_the_card(card_step):
    st, step, imgs, tgts, gen = card_step
    bad = imgs.float().sub(127.5).div(128.0)
    bad[3, 60, 60, 1] = float("nan")
    keep = [x.clone() for x in (st.params, st.stats, st.trace, st.count)]
    n = int(st.step)
    _, m = step(st, bad, tgts, gen)
    assert float(m["skipped"]) == 1.0 and int(st.step) == n + 1
    for a, b in zip(keep, (st.params, st.stats, st.trace, st.count)):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_checkpoint_saved_on_the_card_resumes_on_the_cpu(cuda, tmp_path):
    from synergynet_tpu_torch.core.config import Config
    from synergynet_tpu_torch.train import Trainer
    cfg = Config()
    cfg.data.synthetic_size = 64
    cfg.train.batch_size = 32
    cfg.train.num_workers = 2
    cfg.train.snapshot_dir = str(tmp_path)
    card = Trainer(cfg, device=cuda)
    card.fit(1)
    cfg.train.resume = card.ckpt_path(1)
    cpu = Trainer(cfg, device="cpu")
    assert cpu.start_epoch == 2
    for k in ("params", "stats", "trace", "count", "step"):
        assert torch.equal(getattr(cpu.state, k), getattr(card.state,
                                                           k).cpu()), k


# -- the training data path: keyed draws, shaded render, device augment,
# -- resident epochs (no kernel of B1-B4 on it) --------------------------

def _shaded_inputs(n=64, seed=3):
    from synergynet_tpu_torch.data import sample_params
    return torch.from_numpy(sample_params(np.random.default_rng(seed), n))


@pytest.mark.gpu
def test_keyed_draws_card_equals_cpu_bit_for_bit(cuda):
    from synergynet_tpu_torch.data import keyed
    from synergynet_tpu_torch.data.shaded import shaded_draws
    idx = torch.cat([torch.tensor([680000, 2 ** 31 + 7]),
                     torch.arange(1024)])
    for key in (keyed.make_key(0), keyed.make_key(7, 3, 1)):
        assert torch.equal(keyed.bits(key, idx.to(cuda), 1000).cpu(),
                           keyed.bits(key, idx, 1000))
        for a, b in zip(shaded_draws(key, idx.to(cuda)),
                        shaded_draws(key, idx)):
            assert torch.equal(a.cpu(), b)


@pytest.mark.gpu
def test_shaded_render_card_within_one_level_of_cpu(cuda):
    """The same params and keys rendered on the card and on the CPU: uint8
    within 1 (fp32 products and exponentials round differently), the
    dots exact."""
    from synergynet_tpu_torch.data.shaded import (_dot_mask,
                                                  render_shaded_crops)
    from synergynet_tpu_torch.mm3d import decode_landmarks
    params = _shaded_inputs()
    pack = load_param_pack()
    idx = torch.arange(100, 164)
    cpu = render_shaded_crops(params, pack, 11, idx)
    card = render_shaded_crops(params.to(cuda), pack.to(cuda), 11,
                               idx.to(cuda)).cpu()
    diff = (card.int() - cpu.int()).abs()
    assert int(diff.max()) <= 1 and float((diff > 0).float().mean()) < 1e-3
    dots = _dot_mask(decode_landmarks(params, pack), 120)
    assert torch.equal(card[dots], cpu[dots])


@pytest.mark.gpu
@pytest.mark.parametrize("perm", range(6))
def test_augment_core_card_matches_cpu(cuda, perm):
    from synergynet_tpu_torch.data.device_augment import (_PERMS,
                                                          augment_from)
    rng = np.random.default_rng(perm)
    imgs = torch.from_numpy(rng.integers(0, 256, (16, 120, 120, 3),
                                         np.uint8))
    f = torch.from_numpy(rng.uniform(0.6, 1.4, (16, 3)).astype(np.float32))
    occ = torch.from_numpy(rng.random(16) < 0.5)
    kind = torch.from_numpy(rng.integers(0, 7, 16))
    cpu = augment_from(imgs, f, _PERMS[perm], occ, kind)
    card = augment_from(imgs.to(cuda), f.to(cuda), _PERMS[perm],
                        occ.to(cuda), kind.to(cuda))
    torch.testing.assert_close(card.cpu(), cpu, rtol=0, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("generative", [False, True])
def test_resident_epoch_syncs_only_for_its_metrics(cuda, tmp_path,
                                                   monkeypatch, generative):
    """A second resident epoch under ``set_sync_debug_mode("error")``: no
    host sync but the epoch's one metrics read (device augmentation on)."""
    from synergynet_tpu_torch.core.config import Config
    from synergynet_tpu_torch.data import make_crops_with_params
    from synergynet_tpu_torch.train import (Trainer, fit_resident,
                                            fit_resident_generative,
                                            resident)
    cfg = Config()
    cfg.data.synthetic_size = 128
    cfg.data.device_augment = True
    cfg.data.streaming = generative
    cfg.data.appearance = "shaded" if generative else "dots"
    cfg.train.batch_size = 32
    cfg.train.save_val_freq = 100
    cfg.train.snapshot_dir = str(tmp_path)
    tr = Trainer(cfg, device=cuda)
    reads = []

    def read(sums, steps):
        torch.cuda.set_sync_debug_mode(0)
        reads.append(steps)
        return real(sums, steps)
    real = resident.epoch_metrics
    monkeypatch.setattr(resident, "epoch_metrics", read)

    def arm(epoch, metrics):
        if epoch == 1:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
    try:
        if generative:
            history = fit_resident_generative(tr, tr.dataset.params,
                                              epochs=2, log_fn=arm)
        else:
            data = make_crops_with_params(128, seed=0)
            history = fit_resident(tr, data["images"], data["params"],
                                   epochs=2, log_fn=arm)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert reads == [4, 4] and int(tr.state.step) == 8
    assert all(np.isfinite(v) for h in history.values() for v in h.values())
    assert history[2]["skipped"] == 0.0


@pytest.mark.gpu
def test_bare_cuda_resolves_to_the_indexed_card(cuda, tmp_path):
    """``device="cuda"`` (the entry points' default) names the card the
    state lands on, so the Trainer's step takes that state."""
    from synergynet_tpu_torch.core.config import Config
    from synergynet_tpu_torch.core.device import resolve_device
    from synergynet_tpu_torch.train import Trainer
    assert resolve_device("cuda") == torch.zeros(1, device="cuda").device
    cfg = Config()
    cfg.data.synthetic_size = 32
    cfg.train.batch_size = 16
    cfg.train.num_workers = 2
    cfg.train.snapshot_dir = str(tmp_path)
    tr = Trainer(cfg, device="cuda")
    assert tr.device == tr.state.device
    assert np.isfinite(tr.fit(1)[1]["loss_total"])


@pytest.mark.gpu
def test_data_paths_render_on_the_card(cuda):
    """``make_shaded_crops`` and the streaming dataset on the card: the two
    agree pixel for pixel (padded 256-crop chunks on both), and with the
    CPU's within one level."""
    from synergynet_tpu_torch.data import GeneratedCropDataset
    from synergynet_tpu_torch.data.shaded import make_shaded_crops
    pack = load_param_pack()
    card = make_shaded_crops(300, pack, seed=6, device=cuda)
    ds = GeneratedCropDataset(300, pack, seed=6, appearance="shaded",
                              device=cuda)
    order = np.random.default_rng(0).permutation(300)
    for part in np.array_split(order, 3):
        np.testing.assert_array_equal(ds.generate_images(part),
                                      card["images"][part])
    cpu = make_shaded_crops(300, pack, seed=6, device="cpu")
    np.testing.assert_allclose(card["landmarks"], cpu["landmarks"], rtol=0,
                               atol=1e-3)
    diff = np.abs(card["images"].astype(np.int32) - cpu["images"])
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


# -- the packaged API and the host renders on the card -------------------------

CHAIN = dict(rtol=1e-4, atol=1e-2)   # param62's 1e-4 chained through decode


def _frame(hw, seed):
    return np.random.default_rng(seed).integers(0, 256, (*hw, 3), np.uint8)


def _edge_rois():
    """Square rois over every edge and corner of a 720x1088 frame, inside
    it, at .5 coordinates, and an identity 120 px crop."""
    r = [[-40, 300, 100, 440], [1000, 200, 1150, 350], [500, -60, 620, 60],
         [400, 650, 520, 770], [-50, -50, 90, 90], [1030, 680, 1110, 760],
         [200, 100, 440, 340], [610.5, 300.5, 851.5, 541.5],
         [10.5, 500.5, 70.5, 560.5], [300, 300, 420, 420]]
    return [np.asarray(x, np.float64) for x in r]


@pytest.mark.gpu
@pytest.mark.parametrize("interpolation", ["lanczos4", "linear"])
def test_preprocess_crops_card_equals_cpu(cuda, interpolation):
    from synergynet_tpu_torch.pipeline import preprocess_crops
    img = _frame((720, 1088), 3)
    got = preprocess_crops(img, _edge_rois(), interpolation, device=cuda)
    want = preprocess_crops(img, _edge_rois(), interpolation, device="cpu")
    assert got.shape == (10, 120, 120, 3) and np.array_equal(got, want)


@pytest.fixture(scope="module")
def apis_card_cpu(cuda):
    from synergynet_tpu_torch.pipeline import SynergyNet3DMM
    return (SynergyNet3DMM(variables="trained", device=cuda),
            SynergyNet3DMM(variables="trained", device="cpu"))


RECTS8 = [[60.0 + 130 * i, 80.0 + 60 * (i % 3), 180.0 + 130 * i,
           230.0 + 60 * (i % 3), 0.9] for i in range(8)]


@pytest.mark.gpu
@pytest.mark.parametrize("interpolation", ["lanczos4", "linear"])
def test_get_all_outputs_card_matches_cpu(cuda, apis_card_cpu,
                                          interpolation):
    """The API's default precision, f32 with TF32 off: the card's faces
    within CHAIN of the CPU's, the dense decode through kernel B1."""
    card, cpu = apis_card_cpu
    img = _frame((720, 1088), 5)
    before = launches["synergy_fused_decode"]
    got = card.get_all_outputs(img, rects=RECTS8,
                               interpolation=interpolation)
    assert launches["synergy_fused_decode"] == before + 1
    want = cpu.get_all_outputs(img, rects=RECTS8,
                               interpolation=interpolation)
    assert len(got[0]) == len(want[0]) == 8
    for i in range(8):
        np.testing.assert_allclose(got[0][i], want[0][i], **CHAIN)
        np.testing.assert_allclose(got[1][i], want[1][i], **CHAIN)
        for k in range(2):
            np.testing.assert_allclose(got[2][i][k], want[2][i][k], **CHAIN)


@pytest.fixture(scope="module")
def bfm_faces(apis_card_cpu):
    """Three BFM meshes decoded on the CPU (the third overlapping the
    others) on a 240x320 frame, and the topology."""
    _, cpu = apis_card_cpu
    img = _frame((240, 320), 0)
    rects = [[40., 50., 140., 160.], [150., 60., 240., 150.],
             [100., 100., 200., 200.]]
    _, verts, _ = cpu.get_all_outputs(img, rects=rects)
    return img, verts, load_param_pack().tri.numpy()


def _assert_render_close(got, want, bg):
    """The same pixels drawn (the raster kernel equals its twin bit for
    bit); colours within one uint8 step (the light's last bit can differ
    between the card's and the CPU's reductions)."""
    assert np.array_equal((got != bg).any(-1), (want != bg).any(-1))
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.gpu
@pytest.mark.parametrize("textured", [False, True])
def test_render_pipeline_card_equals_cpu(cuda, bfm_faces, textured):
    from synergynet_tpu_torch.render import OVERLAY_LIGHT_CFG, RenderPipeline
    img, verts, tri = bfm_faces
    v = np.ascontiguousarray(verts[0].T)
    tex = (np.random.default_rng(1).uniform(0, 1, v.shape).astype(np.float32)
           if textured else None)
    before = launches["synergy_raster_mesh"]
    got = RenderPipeline(device=cuda, **OVERLAY_LIGHT_CFG)(v, tri.T, img,
                                                           texture=tex)
    assert launches["synergy_raster_mesh"] == before + 1
    want = RenderPipeline(device="cpu", **OVERLAY_LIGHT_CFG)(v, tri.T, img,
                                                             texture=tex)
    _assert_render_close(got, want, img)


@pytest.mark.gpu
def test_render_overlay_card_equals_cpu(cuda, bfm_faces):
    from synergynet_tpu_torch.render import (OVERLAY_LIGHT_CFG,
                                             RenderPipeline, render_overlay)
    img, verts, tri = bfm_faces
    before = launches["synergy_raster_mesh"]
    ov, solid = render_overlay(img, verts, tri)     # the default: the card
    assert launches["synergy_raster_mesh"] == before + len(verts)
    ov_c, solid_c = render_overlay(img, verts, tri, pipeline=RenderPipeline(
        device="cpu", **OVERLAY_LIGHT_CFG))
    _assert_render_close(solid, solid_c, img)
    assert np.abs(ov.astype(int) - ov_c.astype(int)).max() <= 1


@pytest.mark.gpu
@pytest.mark.parametrize("bilinear", [True, False])
def test_render_texture_card_equals_cpu(cuda, bfm_faces, bilinear):
    from synergynet_tpu_torch.pipeline import UVTextureMapper
    from synergynet_tpu_torch.render import render_texture
    img, verts, tri = bfm_faces
    m = UVTextureMapper.synthetic(verts[0].shape[1])
    uv = (np.stack([m.coord_v, m.coord_u], 1) / 255.0).astype(np.float32)
    tex = np.random.default_rng(2).integers(0, 256, (256, 256, 3), np.uint8)
    v = np.ascontiguousarray(verts[0].T)
    before = launches["synergy_raster_mesh"]
    got = render_texture(v, tri.T, uv, tex, img, alpha=0.8, bilinear=bilinear,
                         device=cuda)
    assert launches["synergy_raster_mesh"] == before + 1
    want = render_texture(v, tri.T, uv, tex, img, alpha=0.8,
                          bilinear=bilinear, device="cpu")
    assert np.array_equal(got, want)


@pytest.mark.gpu
def test_rasterize_apis_card_equal_cpu(cuda, bfm_faces):
    """rasterize / rasterize_tiled (B2) and rasterize_triangles (B3) on the
    card equal their CPU twins bit for bit, on all three meshes at once."""
    from synergynet_tpu_torch.render import (rasterize, rasterize_tiled,
                                             rasterize_triangles)
    img, verts, tri = bfm_faces
    n = tri.shape[1]
    v = np.concatenate([x.T for x in verts]).astype(np.float32)
    t = np.concatenate([tri.T + i * verts[0].shape[1]
                        for i in range(len(verts))]).astype(np.int32)
    c = np.random.default_rng(4).uniform(0, 1, v.shape).astype(np.float32)
    assert t.shape == (3 * n, 3)
    b2, b3 = _counts("synergy_raster_mesh", "synergy_raster_mesh_ids")
    for fn in (rasterize, rasterize_tiled):
        got = fn(v, t, c, bg=img, alpha=0.7, reverse=True, device=cuda)
        assert np.array_equal(got, fn(v, t, c, bg=img, alpha=0.7,
                                      reverse=True, device="cpu"))
    got = rasterize_triangles(v, t, h=240, w=320, device=cuda)
    want = rasterize_triangles(v, t, h=240, w=320, device="cpu")
    for g, w_ in zip(got, want):
        assert torch.equal(g.cpu(), w_)
    assert launches["synergy_raster_mesh"] == b2 + 2
    assert launches["synergy_raster_mesh_ids"] == b3 + 1


BOXES = dict(rtol=1e-4, atol=0.05)      # f32 logits' 1e-4 through exp(0.2 x)


@pytest.mark.gpu
def test_host_detector_card_matches_cpu(cuda):
    """The default detector (f32, TF32 off) on the card gives the CPU's
    faces: equal counts, boxes within BOXES, scores within 1e-4, on a
    720x1088 frame whose candidate scores all keep 1e-3 clear of the
    visibility threshold."""
    from synergynet_tpu_torch.detect import FaceBoxes
    from synergynet_tpu_torch.detect.detector import (VIS_THRESHOLD,
                                                      prepare_frame)
    card, cpu = FaceBoxes(device=cuda), FaceBoxes(device="cpu")
    img = _frame((720, 1088), 5)
    _, packed, true_hw, _ = prepare_frame(img, 8, "cpu")
    with torch.inference_mode():
        scores, _ = cpu.candidates(packed[None], true_hw[None])
    assert (scores[scores > 0] - VIS_THRESHOLD).abs().min() > 1e-3
    got, n = card.detect_raw(img)
    want, n_cpu = cpu.detect_raw(img)
    assert n == n_cpu > 0 and got.shape == want.shape
    np.testing.assert_allclose(got[:n, :4], want[:n, :4], **BOXES)
    np.testing.assert_allclose(got[:n, 4], want[:n, 4], rtol=0, atol=1e-4)
    assert card(img) == [list(map(float, got[i])) for i in range(n)]


@pytest.mark.gpu
def test_host_detector_launches_the_stem_kernel(cuda):
    """FaceBoxes(stem_mode="pallas").__call__ runs kernel B4 once per frame,
    which gives its twin's stem on the CPU for the call's own stem input;
    its faces agree with the XLA stem's within bf16's rounding."""
    from synergynet_tpu_torch.detect import FaceBoxes
    from synergynet_tpu_torch.detect.detector import (prepare_frame,
                                                      random_init_variables)
    from synergynet_tpu_torch.detect.stem_fused import (
        fused_stem1_s2d8, fused_stem1_s2d8_reference)
    variables = random_init_variables(0)
    dets = {mode: FaceBoxes(variables, dtype=torch.bfloat16, device=cuda,
                            stem_mode=mode) for mode in ("xla", "pallas")}
    img = _frame((480, 640), 8)
    before = launches["synergy_stem_s2d8"]
    faces = dets["pallas"](img)
    assert launches["synergy_stem_s2d8"] == before + 1
    raw, count = dets["pallas"].detect_raw(img)
    assert raw.shape == (750, 5) and count == len(faces) > 0
    assert np.isfinite(raw).all()
    xla = dets["xla"](img)
    assert launches["synergy_stem_s2d8"] == before + 2
    assert abs(len(xla) - len(faces)) <= max(2, len(faces) // 20)
    stem = dets["pallas"].net.conv1_s2d8
    _, packed, _, _ = prepare_frame(img, 8, cuda)
    x = (packed[None] - dets["pallas"].mean).to(torch.bfloat16)
    with torch.inference_mode():
        got = fused_stem1_s2d8(x, stem.tap_weights(), stem.bias.detach())
        want = fused_stem1_s2d8_reference(x.cpu(), stem.tap_weights().cpu(),
                                          stem.bias.detach().cpu())
    torch.testing.assert_close(got.cpu().float(), want.float(), **STEM_TOL)


# -- C11: the f32 serving engine computes with TF32 off ----------------------------

ENGINE_MESH = dict(rtol=1e-4, atol=1e-3)     # the dense decode's tolerance


def _engine_faces(engine, img):
    """``engine.process_batch`` on one frame -> (n faces, rois (n, 4),
    dense meshes (n, 3, N)) as numpy."""
    from synergynet_tpu_torch.detect.detector import prepare_frame
    canvas, packed, hw, _ = prepare_frame(img, engine.detector.stem_r,
                                          engine.api.device)
    out = engine.process_batch(canvas[None], packed[None], hw[None])
    n = int(out[1][0])
    return n, out[2][0, :n].cpu().numpy(), out[5][0, :n].cpu().numpy()


@pytest.fixture(scope="module")
def f32_engines(cuda):
    from synergynet_tpu_torch.pipeline import FusedFrameEngine, SynergyNet3DMM
    return tuple(FusedFrameEngine(SynergyNet3DMM(variables="trained",
                                                 device=d))
                 for d in (cuda, "cpu"))


@pytest.mark.gpu
def test_f32_engine_card_matches_cpu(cuda, f32_engines):
    """FusedFrameEngine(SynergyNet3DMM(variables="trained")), f32 with its
    default f32 detector, on the card gives the CPU's faces on a 720x1088
    frame whose candidate scores keep 1.48e-3 clear of 0.5 (phase 10's):
    equal counts, rois within BOXES, meshes within the dense decode's
    tolerance; the TF32 flags are as they were after the call."""
    card, cpu = f32_engines
    img = _frame((720, 1088), 5)
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    n, rois, dense = _engine_faces(card, img)
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == before
    n_cpu, rois_cpu, dense_cpu = _engine_faces(cpu, img)
    assert n == n_cpu > 0
    np.testing.assert_allclose(rois, rois_cpu, **BOXES)
    np.testing.assert_allclose(dense, dense_cpu, **ENGINE_MESH)


@pytest.mark.gpu
def test_f32_engine_tolerance_sees_one_tf32_pass(cuda, f32_engines,
                                                 monkeypatch):
    """The same comparison with the engine's guard removed and TF32 forced
    on for cuBLAS and cuDNN (the fault C11 repaired) falls outside it: a
    face count, a roi or a mesh differs beyond the tolerance."""
    import contextlib

    from synergynet_tpu_torch.pipeline import api as api_module
    card, cpu = f32_engines
    img = _frame((720, 1088), 5)
    n_cpu, rois_cpu, dense_cpu = _engine_faces(cpu, img)
    monkeypatch.setattr(api_module, "full_fp32_if",
                        lambda dtype: contextlib.nullcontext())
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    # A fresh engine captures its program under the patch (the fixture's
    # engine replays the program it captured with the guard).
    card = api_module.FusedFrameEngine(card.api, detector=card.detector)
    n, rois, dense = _engine_faces(card, img)
    assert n != n_cpu or not (np.allclose(rois, rois_cpu, **BOXES) and
                              np.allclose(dense, dense_cpu, **ENGINE_MESH))


# -- scale-out and detector training -------------------------------------------

def tp_rank(n_faces: int) -> dict:
    """A rank of a 1 x world mesh on card 0: its vertex slab through B1."""
    from synergynet_tpu_torch.core.mesh import make_mesh
    from synergynet_tpu_torch.parallel import (tp_dense_decode,
                                               warm_mesh_cliques)
    mesh = make_mesh(n_data=1, n_model=2)
    warm_mesh_cliques(mesh)
    p = torch.tensor(np.random.default_rng(3).normal(
        0, 1, (n_faces, 62)).astype(np.float32), device=mesh.device)
    before = launches["synergy_fused_decode"]
    decode = tp_dense_decode(mesh, load_param_pack())
    slab, checksum = decode(p)
    return {"slab": slab.cpu(), "checksum": checksum.cpu(),
            "range": decode.vertex_range,
            "launches": launches["synergy_fused_decode"] - before}


@pytest.mark.gpu
@pytest.mark.parametrize("n_faces", [8, 1024])
def test_tp_dense_decode_slabs_equal_the_whole_decode(cuda, full, tmp_path,
                                                      n_faces):
    """Two ranks sharing the card over gloo, each launching B1 on its half
    of the padded basis: the slabs side by side are the whole decode, bit
    for bit (each vertex's arithmetic is its own); the checksum is the sum
    over both slabs."""
    from synergynet_tpu_torch.parallel.launch import run_ranks
    pack, basis = full
    ranks = run_ranks(f"{__name__}:tp_rank", 2, str(tmp_path),
                      {"n_faces": n_faces}, backend="gloo", timeout=120)
    p = torch.tensor(np.random.default_rng(3).normal(
        0, 1, (n_faces, 62)).astype(np.float32), device=cuda)
    whole = decode_dense_fused(p, basis, pack).cpu()
    slabs = torch.cat([r["slab"] for r in ranks], dim=2)
    assert [r["range"] for r in ranks] == [(0, 26624), (26624, 53248)]
    assert all(r["launches"] == 1 for r in ranks)
    assert torch.equal(slabs[:, :, :whole.shape[2]], whole)
    assert torch.equal(ranks[0]["checksum"], ranks[1]["checksum"])
    torch.testing.assert_close(ranks[0]["checksum"], slabs.sum(dim=2),
                               rtol=1e-5, atol=1e-2)


@pytest.mark.gpu
def test_nccl_world_of_one_step_equals_the_plain_step(cuda, tmp_path):
    """``jit_train_step`` on a 1x1 mesh inside a one-rank NCCL group (the
    gradient and metrics all_reduced through NCCL) against
    ``make_train_step`` from the same state, full width, fp32 with TF32
    off: within 1e-5 of each leaf's scale (cuDNN's backward may sum in
    another order from call to call)."""
    import torch.distributed as dist
    from synergynet_tpu_torch.core.mesh import make_mesh
    from synergynet_tpu_torch.nn import SynergyNet
    from synergynet_tpu_torch.train import (create_train_state,
                                            jit_train_step, make_optimizer,
                                            make_train_step)
    opt = make_optimizer(lambda c: 0.01, weight_decay=5e-4)
    pack = load_param_pack()
    rng = np.random.default_rng(0)
    img = torch.tensor(rng.integers(0, 256, (32, 120, 120, 3), np.uint8),
                       device=cuda)
    tgt = torch.tensor(rng.normal(0, 0.5, (32, 62)).astype(np.float32),
                       device=cuda)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(device=cuda)
        assert dist.get_backend() == "nccl" and mesh.data_group is not None
        states = []
        with full_fp32():
            for step in (make_train_step(pack, opt, device=cuda),
                         jit_train_step(pack, opt, mesh)):
                st = create_train_state(SynergyNet(dropout=0.0).to(cuda),
                                        torch.Generator(cuda).manual_seed(0),
                                        opt)
                _, m = step(st, img, tgt)
                states.append((st, float(m["loss_total"])))
    finally:
        dist.destroy_process_group()
    (a, la), (b, lb) = states
    assert la == lb
    for x, y in zip(a.tensors(), b.tensors()):
        scale = max(float(y.abs().max()), 1e-30)
        assert float((x - y).abs().max()) <= 1e-5 * scale


@pytest.mark.gpu
def test_detector_trainer_card_matches_cpu(cuda):
    """One DetectorTrainer step (256x256, batch 8, TF32 off) on the card
    and on the CPU from the same seeded weights. f32: the losses within
    1e-4 (a random-init BatchNorm net's gradient amplifies cuDNN's f32
    rounding to the size of some leaves' updates, so those are not held).
    float64: the update, trace and running statistics within 1e-6 of each
    leaf's scale. Then 10 f32 card steps lower the loss."""
    from synergynet_tpu_torch.detect import (DetectorTrainer,
                                             make_synthetic_detection_batch)
    from synergynet_tpu_torch.detect.detector import random_init_variables
    v = random_init_variables(0)
    batch = make_synthetic_detection_batch(np.random.default_rng(7), 8)
    for dtype in (torch.float32, torch.float64):
        tg = DetectorTrainer(variables=v, device=cuda, dtype=dtype)
        tc = DetectorTrainer(variables=v, device="cpu", dtype=dtype)
        init = tc.state.params.clone()
        lg, lc = tg.train_step(batch), tc.train_step(batch)
        for k in lc:
            assert abs(lg[k] - lc[k]) <= 1e-4 * abs(lc[k]), k
        if dtype == torch.float32:
            continue
        sizes = [p.numel() for p in tc.net.parameters()]
        bsizes = [b.numel() for b in tc.net.buffers()]
        for got, want, sz in (
                (tg.state.params.cpu() - init, tc.state.params - init, sizes),
                (tg.state.trace.cpu(), tc.state.trace, sizes),
                (tg.state.stats.cpu(), tc.state.stats, bsizes)):
            leaves = list(zip(got.split(sz), want.split(sz)))
            top = max(float(w.abs().max()) for _, w in leaves)
            for g, w in leaves:
                scale = max(float(w.abs().max()), 1e-2 * top)
                assert float((g - w).abs().max()) <= 1e-6 * scale
    tg = DetectorTrainer(variables=v, device=cuda)
    hist = tg.fit_synthetic(steps=10, batch=8, seed=1)
    losses = [h["loss_total"] for h in hist]
    assert np.isfinite(losses).all() and np.mean(losses[-3:]) < np.mean(
        losses[:3])


# -- kernel N1 (greedy NMS) and the captured programs ------------------------

def _nms_inputs(cuda, case, k=2048, seed=0):
    from tests.nms_cases import nms_case
    boxes, valid = nms_case(case, k=k, seed=seed)
    return torch.tensor(boxes, device=cuda), torch.tensor(valid, device=cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("case", NMS_CASES)
def test_nms_kernel_matches_plain_twin(cuda, case):
    """N1 equals the fixpoint twin bit for bit, on the card and on the
    CPU; one launch a call."""
    from synergynet_tpu_torch.detect.nms import (greedy_nms_mask,
                                                 greedy_nms_mask_reference)
    boxes, valid = _nms_inputs(cuda, case)
    before = launches["synergy_nms_greedy"]
    got = greedy_nms_mask(boxes, valid, 0.3)
    torch.cuda.synchronize()
    assert launches["synergy_nms_greedy"] == before + 1
    assert got.dtype == torch.bool and got.shape == valid.shape
    assert torch.equal(got, greedy_nms_mask_reference(boxes, valid, 0.3))
    assert torch.equal(got.cpu(), greedy_nms_mask_reference(
        boxes.cpu(), valid.cpu(), 0.3))


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 128])
def test_nms_kernel_matches_plain_twin_on_frames(cuda, b):
    """B frames of 2,048 crowded candidates, each with its own valid count,
    and a 2,048-long chain in the first frame."""
    from synergynet_tpu_torch.detect.nms import (greedy_nms_mask,
                                                 greedy_nms_mask_reference)
    from tests.nms_cases import chain_boxes, random_boxes
    rng = np.random.default_rng(b)
    boxes = np.stack([random_boxes(rng, 2048, span=160.0) for _ in range(b)])
    boxes[0] = chain_boxes(2048)
    valid = np.arange(2048)[None] < rng.integers(0, 2049, (b, 1))
    valid[0] = True
    tb, tv = torch.tensor(boxes, device=cuda), torch.tensor(valid, device=cuda)
    got = greedy_nms_mask(tb, tv, 0.3)
    want = greedy_nms_mask_reference(tb, tv, 0.3)
    assert torch.equal(got, want)
    assert torch.equal(got[0].cpu(), torch.arange(2048) % 3 == 0)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [100, 16384])
def test_nms_kernel_matches_plain_twin_at_k(cuda, k):
    """Spread boxes of which about half are kept, at K = 100 and at N1's cap
    K = 16,384, where a tile's row holds 256 words (eight of the walk's
    chunks) and the walk's shared memory is largest."""
    from synergynet_tpu_torch.detect.nms import (greedy_nms_mask,
                                                 greedy_nms_mask_reference)
    from tests.nms_cases import random_boxes
    rng = np.random.default_rng(k)
    span = 600.0 * (k / 2048) ** 0.5
    boxes = np.stack([random_boxes(rng, k, span=span) for _ in range(2)])
    valid = np.ones((2, k), bool)
    valid[1] = rng.uniform(size=k) < 0.9
    tb, tv = torch.tensor(boxes, device=cuda), torch.tensor(valid, device=cuda)
    got = greedy_nms_mask(tb, tv, 0.3)
    want = greedy_nms_mask_reference(tb, tv, 0.3)
    assert torch.equal(got, want)
    share = float(want.float().mean())
    assert 0.3 < share < 0.7


@pytest.mark.gpu
def test_nms_kernel_inside_a_captured_graph(cuda):
    """N1 captured in a CUDA graph (after one eager call, as the programs
    warm up), then replayed on new boxes and valid flags copied into the
    captured inputs: each replay equals the twin on those inputs."""
    from synergynet_tpu_torch.detect.nms import (greedy_nms_mask,
                                                 greedy_nms_mask_reference)
    from tests.nms_cases import nms_case
    boxes, valid = nms_case("crowd")
    tb, tv = torch.tensor(boxes, device=cuda), torch.tensor(valid, device=cuda)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        greedy_nms_mask(tb, tv, 0.3)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = greedy_nms_mask(tb, tv, 0.3)
    for seed in (1, 2, 3):
        b, v = nms_case("crowd", seed=seed)
        tb.copy_(torch.tensor(b, device=cuda))
        tv.copy_(torch.tensor(v, device=cuda))
        graph.replay()
        want = greedy_nms_mask_reference(tb, tv, 0.3)
        assert torch.equal(out, want)
        assert int(want.sum()) > 0


@pytest.mark.gpu
def test_nms_kernel_rejects_what_it_does_not_take(cuda):
    from synergynet_tpu_torch.detect.nms import N1_MAX_K, greedy_nms_mask
    boxes, valid = _nms_inputs(cuda, "ragged")
    with pytest.raises(TypeError):
        greedy_nms_mask(boxes.double(), valid)
    with pytest.raises(TypeError):
        greedy_nms_mask(boxes.half(), valid)
    with pytest.raises(ValueError):
        greedy_nms_mask(boxes, valid.cpu())
    with pytest.raises(ValueError):
        greedy_nms_mask(boxes[:, :50], valid)
    big = N1_MAX_K + 1
    with pytest.raises(ValueError, match="at most"):
        greedy_nms_mask(torch.zeros((1, big, 4), device=cuda),
                        torch.ones((1, big), dtype=torch.bool, device=cuda))
    # At the cap it runs.
    keep = greedy_nms_mask(torch.zeros((1, N1_MAX_K, 4), device=cuda),
                           torch.ones((1, N1_MAX_K), dtype=torch.bool,
                                      device=cuda))
    assert int(keep.sum()) == 1


# -- kernel C1: the face crop -------------------------------------------------

# C1 and its twin round every product and sum once, in the same order, so
# they should agree bit for bit; 1e-4 on 0-255 values (a few float32 ulps at
# 255) admits rounding and nothing more, while a tap moved by one pixel moves
# a value on noise by tens.
CROP_ATOL = 1e-4


def _crop_rois(rng, b, n, hw=(720, 1088)):
    """(b, n, 4) f32 rois like the serving path's square rois, plus rows
    that are padding (zeros), empty, negative, wholly off the frame, on
    .5 pixels, or with whole-pixel sample coordinates (extents 40 and 360)."""
    h, w = hw
    side = rng.uniform(0, 500, (b, n))
    cx = rng.uniform(-100, w + 100, (b, n))
    cy = rng.uniform(-100, h + 100, (b, n))
    rois = np.stack([cx - side / 2, cy - side / 2, cx + side / 2,
                     cy + side / 2], -1)
    special = [[0, 0, 0, 0], [300, 200, 300, 200], [500, 400, 480, 380],
               [-900, -900, -500, -500], [w + 10, 5, w + 200, 195],
               [100.5, 200.5, 260.5, 360.5], [40, 50, 80, 90],
               [-100, -120, 260, 240]]
    for i, r in enumerate(special[:n]):
        rois[i % b, i] = r
    return rois.astype(np.float32)


# (frames, rois a frame, output side, channels): the serving path's two
# shapes, then the scalar-store path (side x channels not a multiple of 4)
# and one channel.
C1_SHAPES = [(128, 8, 120, 3), (1, 8, 120, 3), (2, 5, 33, 3), (3, 4, 32, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", C1_SHAPES, ids=lambda s: "x".join(map(
    str, s)))
def test_crop_kernel_matches_plain_twin(cuda, shape):
    """C1's taps equal the twin's, and its crops the twin's within
    CROP_ATOL, on 720x1088 noise frames; one launch a call."""
    from synergynet_tpu_torch.pipeline.device_crop import (
        crop_resize_bilinear, crop_resize_reference, crop_taps)
    b, n, s, c = shape
    rng = np.random.default_rng(b * 100 + s)
    rois = torch.tensor(_crop_rois(rng, b, n), device=cuda)
    g = torch.Generator(device=cuda).manual_seed(b)
    frames = torch.rand((b, 720, 1088, c), generator=g, device=cuda) * 255
    before = launches["synergy_crop_bilinear"]
    got = crop_resize_bilinear(frames, rois, s)
    torch.cuda.synchronize()
    assert launches["synergy_crop_bilinear"] == before + 1
    assert got.shape == (b, n, s, s, c) and got.dtype == torch.float32
    idx, f = crop_taps(rois, (720, 1088), s)
    want_idx, want_f = crop_taps(rois.cpu(), (720, 1088), s)
    assert torch.equal(idx.cpu(), want_idx) and torch.equal(f.cpu(), want_f)
    want = crop_resize_reference(frames, rois, s)
    torch.testing.assert_close(got, want, rtol=0, atol=CROP_ATOL)
    if b <= 2:                  # the twin on the card equals it on the CPU
        assert torch.equal(want.cpu(), crop_resize_reference(
            frames.cpu(), rois.cpu(), s))
    # rois wholly off the frame along an axis crop to zeros
    off = (idx < 0).all(-1).all(-1).any(-1)
    assert bool(off.any())
    assert int(got[off].abs().sum()) == 0


@pytest.mark.gpu
def test_crop_kernel_inside_a_captured_graph(cuda):
    """C1 captured in a CUDA graph (after one eager call), replayed on new
    frames and rois copied into the captured inputs: each replay equals the
    twin on those inputs."""
    from synergynet_tpu_torch.pipeline.device_crop import (
        crop_resize_bilinear, crop_resize_reference)
    rng = np.random.default_rng(7)
    frames = torch.zeros((2, 720, 1088, 3), device=cuda)
    rois = torch.tensor(_crop_rois(rng, 2, 8), device=cuda)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        crop_resize_bilinear(frames, rois)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = crop_resize_bilinear(frames, rois)
    for seed in (1, 2):
        frames.copy_(torch.rand(frames.shape, device=cuda) * 255)
        rois.copy_(torch.tensor(_crop_rois(np.random.default_rng(seed), 2,
                                           8), device=cuda))
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(out, crop_resize_reference(frames, rois),
                                   rtol=0, atol=CROP_ATOL)


@pytest.mark.gpu
def test_crop_kernel_rejects_what_it_does_not_take(cuda):
    from synergynet_tpu_torch.pipeline.device_crop import (
        C1_MAX_SIZE, crop_resize_bilinear)
    frames = torch.zeros((2, 64, 80, 3), device=cuda)
    rois = torch.tensor(_crop_rois(np.random.default_rng(0), 2, 3, (64, 80)),
                        device=cuda)
    before = launches["synergy_crop_bilinear"]
    with pytest.raises(TypeError):
        crop_resize_bilinear(frames.double(), rois)
    with pytest.raises(TypeError):
        crop_resize_bilinear(frames.half(), rois)
    with pytest.raises(TypeError):
        crop_resize_bilinear(frames, rois.double())
    with pytest.raises(ValueError, match="contiguous"):
        crop_resize_bilinear(frames.transpose(1, 2), rois)
    with pytest.raises(ValueError, match="contiguous"):
        crop_resize_bilinear(frames, rois.transpose(0, 1).contiguous()
                             .transpose(0, 1))
    with pytest.raises(ValueError):
        crop_resize_bilinear(frames, rois.cpu())
    with pytest.raises(ValueError):
        crop_resize_bilinear(frames.cpu(), rois)
    with pytest.raises(ValueError):
        crop_resize_bilinear(frames, rois[:1])
    for side in (0, C1_MAX_SIZE + 1):
        with pytest.raises(ValueError, match="C1 takes"):
            crop_resize_bilinear(frames, rois, side)
    assert launches["synergy_crop_bilinear"] == before
    # At the cap it runs.
    out = crop_resize_bilinear(frames, rois, C1_MAX_SIZE)
    torch.cuda.synchronize()
    assert out.shape == (2, 3, C1_MAX_SIZE, C1_MAX_SIZE, 3)


def _engines_under_test(cuda):
    from synergynet_tpu_torch.detect import FaceBoxes
    from synergynet_tpu_torch.detect.detector import random_init_variables
    from synergynet_tpu_torch.pipeline import FusedFrameEngine, SynergyNet3DMM
    api = SynergyNet3DMM(variables="trained", dtype=torch.bfloat16,
                         device=cuda)
    v = random_init_variables(0)
    out = {"xla": FusedFrameEngine(api, detector=FaceBoxes(
               v, dtype=torch.bfloat16, device=cuda), max_faces=8),
           "fused": FusedFrameEngine(api, detector=FaceBoxes(
               v, dtype=torch.bfloat16, device=cuda, stem_mode="pallas"),
               max_faces=8),
           "f32": FusedFrameEngine(SynergyNet3DMM(variables="trained",
                                                  device=cuda))}
    return out


@pytest.fixture(scope="module")
def graph_engines(cuda):
    return _engines_under_test(cuda)


def _batch(cuda, b, seed):
    from synergynet_tpu_torch.detect.net import space_to_depth
    g = torch.Generator(device=cuda).manual_seed(seed)
    frames = torch.randint(0, 256, (b, 720, 1088, 3), generator=g,
                           device=cuda).float()
    hws = torch.tensor([[720, 1088], [600, 900]] * b, dtype=torch.int32,
                       device=cuda)[:b]
    return frames, space_to_depth(frames, 8).contiguous(), hws


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["xla", "fused", "f32"])
@pytest.mark.parametrize("b", [1, 4])
def test_graph_replay_equals_eager_body(cuda, graph_engines, which, b):
    """process_batch on the card replays its batch size's captured program:
    its outputs equal the eager body's bit for bit, and the launch
    counters credit one call's launches per replay (the crop's C1 among
    them)."""
    eng = graph_engines[which]
    args = _batch(cuda, b, seed=b)
    want = eng.process_batch_eager(*args)
    symbols = ("synergy_fused_decode", "synergy_nms_greedy",
               "synergy_stem_s2d8", "synergy_crop_bilinear")
    before = _counts(*symbols)
    got = eng.process_batch(*args)
    torch.cuda.synchronize()
    assert any(k[1][0][0] == (b, 720, 1088, 3)
               for k in eng.programs.programs)
    after = _counts(*symbols)
    assert after == (before[0] + 1, before[1] + 1,
                     before[2] + (which == "fused"), before[3] + 1)
    assert int(got[1].sum()) > 0
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    again = eng.process_batch(*args)
    assert launches["synergy_fused_decode"] == after[0] + 1
    for g, w in zip(again, want):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_graph_outputs_survive_the_next_call(cuda, graph_engines):
    eng = graph_engines["xla"]
    a, b = _batch(cuda, 1, seed=11), _batch(cuda, 1, seed=12)
    first = eng.process_batch(*a)
    kept = [x.clone() for x in first]
    second = eng.process_batch(*b)
    torch.cuda.synchronize()
    assert not torch.equal(first[3], second[3])
    for x, y in zip(first, kept):
        assert torch.equal(x, y)


@pytest.mark.gpu
def test_graph_replay_makes_no_host_sync(cuda, graph_engines):
    """A replay (copy in, replay, clone out) and the eager body, with
    greedy NMS on N1, pass under sync-debug "error"."""
    eng = graph_engines["fused"]
    args = _batch(cuda, 2, seed=3)
    eng.process_batch(*args)                 # set-up outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = eng.process_batch(*args)
        eager = eng.process_batch_eager(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for g, w in zip(got, eager):
        assert torch.equal(g, w)


@pytest.mark.gpu
def test_graph_threads_get_their_own_frames(cuda, graph_engines):
    """Eight threads calling process_batch at once, with a short switch
    interval, serialize on the program's static buffers: each gets its own
    frames' results."""
    import sys
    import threading
    eng = graph_engines["xla"]
    batches = [_batch(cuda, 1, seed=20 + i) for i in range(8)]
    wants = [eng.process_batch_eager(*a) for a in batches]
    eng.process_batch(*batches[0])
    torch.cuda.synchronize()
    results, errors = {}, []

    def worker(i):
        try:
            for r in range(5):
                results[(i, r)] = eng.process_batch(*batches[i])
            torch.cuda.synchronize()
        except Exception as e:          # reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(results) == 40
    for (i, _), out in results.items():
        for g, w in zip(out, wants[i]):
            assert torch.equal(g, w)


@pytest.mark.gpu
def test_replay_stamps_eight_points_a_call(cuda, graph_engines, tmp_path):
    """At B=128 each replay leaves one ring row of eight stamps whose seven
    intervals sum to within 3% of the call's CUDA-event time; the counters
    read the calls, the static buffers' bytes and what was served; a stage
    called alone stamps nothing; under the profiler a call shows the
    ``synergy.*`` spans and eight ``stage_stamp`` kernels."""
    from synergynet_tpu_torch.core.profiling import recorder
    from synergynet_tpu_torch.pipeline.api import BATCH_STAGES
    eng, b = graph_engines["fused"], 128
    key, name = f"process_batch.b{b}", eng.programs.engine
    args = _batch(cuda, b, seed=17)
    out = eng.process_batch(*args)           # the capture
    torch.cuda.synchronize()
    st = recorder.counters(key, name)
    assert st["captures"] == 1 and st["pool_bytes"] > 0
    recorder.reset()
    times, served = [], 0
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = eng.process_batch(*args)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
        served += int(out[1].sum())
    rows = recorder.stage_rows(key, name)
    assert len(rows) == 3
    for (call, ms), t in zip(rows, times):
        assert call is None and list(ms) == list(BATCH_STAGES)
        assert all(v > 0 for v in ms.values())
        assert abs(sum(ms.values()) - t) <= 0.03 * t, (ms, t)
    c = recorder.counters(key, name)
    nbytes = [sum(x.numel() * x.element_size() for x in xs)
              for xs in (args, out)]
    assert c["calls"] == 3
    assert c["bytes_in"] == 3 * nbytes[0] and c["bytes_out"] == 3 * nbytes[1]
    assert c["frames"] == 3 * b
    assert c["valid"] >= c["kept"] >= c["faces"] == served > 0
    seq, = [p.sequence for p in recorder.programs(key, name)]
    before = seq.buf.clone()
    with torch.inference_mode():
        eng.regress(args[0], out[2])
        eng.detect_candidates(args[1], args[2])
        eng.process_batch_eager(*args)
    torch.cuda.synchronize()
    assert torch.equal(seq.buf, before)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        eng.process_batch(*args)
        torch.cuda.synchronize()
    import json
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert sum(e.get("cat") == "kernel" and "stage_stamp" in e["name"]
               for e in events) == 8
    names = {e.get("name") for e in events}
    for span in ("synergy.process_batch", "synergy.copy_in",
                 "synergy.replay", "synergy.clone_out"):
        assert span in names
    assert recorder.stage_rows(key, name)[-1][0] is not None


@pytest.mark.gpu
@pytest.mark.parametrize("hw", [(720, 1088), (480, 640), (1080, 1920)])
def test_overlay_through_graphs_equals_eager_overlay(cuda, graph_engines, hw):
    """FusedOverlayEngine on the card (the engine's one-frame program, then
    its face bucket's render program) equals the eager overlay bit for
    bit; one B2 launch a call."""
    from synergynet_tpu_torch.detect.detector import prepare_frame
    from synergynet_tpu_torch.ops.resize import _resize_linear
    from synergynet_tpu_torch.pipeline import FusedOverlayEngine
    eng = graph_engines["xla"]
    ov = FusedOverlayEngine(eng)
    img = _frame(hw, 2)
    before = launches["synergy_raster_mesh"]
    pts, verts, poses, overlay = ov(img)
    assert launches["synergy_raster_mesh"] == before + 1
    assert ov.programs.programs
    canvas, packed, true_hw, scale = prepare_frame(img, 8, cuda)
    with torch.inference_mode():
        out = eng.process_batch_eager(canvas[None], packed[None],
                                      true_hw[None])
        n = int(out[1][0])
        want, _ = ov.render(canvas.clamp(0, 255).to(torch.uint8),
                            out[5][0], n)
        want = want[:int(true_hw[0]), :int(true_hw[1])]
        if scale != 1.0:
            want = _resize_linear(want, *hw).to(torch.uint8)
    assert n == len(pts) > 0
    assert np.array_equal(overlay, want.cpu().numpy())
    again = ov(img)[3]
    assert np.array_equal(again, overlay)


# -- the Vision Transformer regressor ----------------------------------------

# ViT-B/16 in bf16 against the float32 reference at the published widths:
# bf16 rounds every GEMM operand, each block's output and the residual
# stream at 2^-9 relative, which over 12 blocks reads a few % of the 62
# parameters' norm; the same reference in fp8 e4m3 (2^-4) reads far more,
# and must fall outside.
VIT_REL = 0.08


@pytest.mark.gpu
def test_vit_b16_card_matches_the_f32_reference(cuda):
    """``vit_b16`` at its published widths, bf16 on the card, against the
    benchmark's plain float32 reference (TF32 off) on 16 seeded crops."""
    from perfbench import weights
    from perfbench.reference.nets import merge
    from perfbench.reference.precision import Precision, exact_f32
    from perfbench.reference.regressors import vit_b16 as ref
    from synergynet_tpu_torch.convert import synergy_state_dict
    from synergynet_tpu_torch.nn import SynergyNet
    from synergynet_tpu_torch.nn.layers import cast_layers_
    tree = weights.draw(ref.spec(), 11, cuda)
    model = SynergyNet("vit_b16", dtype=torch.bfloat16)
    model.load_state_dict(synergy_state_dict(weights.numpy_tree(tree)))
    model = cast_layers_(model, torch.bfloat16).to(cuda).eval()
    g = torch.Generator(device=cuda).manual_seed(0)
    x = (torch.randint(0, 256, (16, 224, 224, 3), generator=g,
                       device=cuda).float() - 127.5) / 128.0
    t = merge(tree["params"], tree["batch_stats"])["backbone"]
    with torch.no_grad():
        got, feat = model(x)
        with exact_f32():
            want = ref.forward(Precision("f32"), t, x)
            fp8 = ref.forward(Precision("fp8"), t, x)

    def rel(a):
        return ((a - want).norm(dim=-1) / want.norm(dim=-1)).max().item()

    assert feat.shape == (16, 768) and got.dtype == torch.float32
    assert rel(got) < VIT_REL < rel(fp8), (rel(got), rel(fp8))


@pytest.mark.gpu
def test_attention_runs_flash_attention_and_nothing_else(cuda):
    """The attention function on the card launches FlashAttention's forward
    kernel (the name the benchmark reads) and no math-backend GEMM or
    softmax, equals the CPU path within bf16's rounding of the result, and
    raises where FlashAttention cannot run (f32) instead of falling
    back."""
    from torch.autograd import DeviceType

    from synergynet_tpu_torch.nn.attention import attention
    g = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn((4, 197, 3, 12, 64), generator=g, device=cuda,
                      dtype=torch.bfloat16)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    attention(q, k, v)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = attention(q, k, v)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    assert any("flash_fwd" in n for n in names), names
    assert not any("gemm" in n.lower() or "softmax" in n.lower()
                   for n in names), names
    want = attention(q.cpu(), k.cpu(), v.cpu())
    torch.testing.assert_close(out.cpu().float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    with pytest.raises(RuntimeError):
        attention(q.float(), k.float(), v.float())


@pytest.mark.gpu
def test_vit_process_batch_captures_at_224(cuda):
    """``process_batch`` of 2 canvases through a seeded ViT-B/16 API at
    crop 224: captured and replayed, equal to the eager body bit for bit,
    the attention's launches credited 12 a replay, BN1's none."""
    from synergynet_tpu_torch.detect import FaceBoxes
    from synergynet_tpu_torch.detect.detector import random_init_variables
    from synergynet_tpu_torch.pipeline import FusedFrameEngine, SynergyNet3DMM
    api = SynergyNet3DMM("vit_b16", dtype=torch.bfloat16, device=cuda,
                         crop=224)
    eng = FusedFrameEngine(api, detector=FaceBoxes(
        random_init_variables(0), dtype=torch.bfloat16, device=cuda,
        stem_mode="pallas"), max_faces=8)
    args = _batch(cuda, 2, seed=5)
    want = eng.process_batch_eager(*args)
    before = _counts("attention", "synergy_bn_act")
    got = eng.process_batch(*args)                # captured, then replayed
    again = eng.process_batch(*args)
    torch.cuda.synchronize()
    assert _counts("attention", "synergy_bn_act") == (before[0] + 2 * 12,
                                                      before[1])
    assert int(got[1].sum()) > 0
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, w) and torch.equal(a, w)


# -- kernel R1: ResNeSt's split-attention radix combine -----------------------

# (radix, cardinality) pairs that RESNEST_LAYERS and RESNEST_FAST_VARIANTS
# build.
SPLAT_VARIANTS = [(2, 1), (1, 1), (4, 1), (1, 2), (2, 2), (1, 4)]
# The served ResNeSt-50's split-attention shapes at 120 pixels (radix 2):
# (H, W, c) of its four stages, each at the first block's and the other
# blocks' extent.
SPLAT_SHAPES = [(30, 30, 64), (30, 30, 128), (15, 15, 128), (15, 15, 256),
                (8, 8, 256), (8, 8, 512), (4, 4, 512)]


def _splat_inputs(cuda, b, radix, c, h, w, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    y = torch.relu(torch.randn((b, radix * c, h, w), generator=g,
                               device=cuda)).to(dtype)
    logits = 2 * torch.randn((b, radix * c, 1, 1), generator=g, device=cuda)
    return (y.contiguous(memory_format=torch.channels_last),
            logits.to(dtype))


def _assert_r1_close(got, want):
    """f32: R1 and the twin differ by the order of the spatial sum alone,
    a few f32 roundings (rtol 1e-5). bf16: that order moves a rounded mean
    by at most one bf16 step; the combine rounds where the twin rounds."""
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
    else:
        steps = (got.contiguous().view(torch.int16).int()
                 - want.contiguous().view(torch.int16).int()).abs()
        assert int(steps.max()) <= 1, int(steps.max())


def _check_r1(cuda, b, radix, groups, c, h, w, dtype, seed):
    from synergynet_tpu_torch.ops.split_attention import (
        radix_combine, radix_combine_reference, radix_pool,
        radix_pool_reference)
    y, logits = _splat_inputs(cuda, b, radix, c, h, w, dtype, seed)
    before = _counts("synergy_splat_pool", "synergy_splat_combine")
    pooled = radix_pool(y, radix)
    out = radix_combine(y, logits, radix, groups)
    torch.cuda.synchronize()
    assert _counts("synergy_splat_pool", "synergy_splat_combine") == (
        before[0] + 1, before[1] + 1)
    assert pooled.shape == (b, c, 1, 1)
    assert out.is_contiguous(memory_format=torch.channels_last)
    _assert_r1_close(pooled, radix_pool_reference(y, radix))
    _assert_r1_close(out, radix_combine_reference(y, logits, radix, groups))
    assert torch.equal(radix_pool(y, radix), pooled)        # deterministic
    assert torch.equal(radix_combine(y, logits, radix, groups), out)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("radix,groups", SPLAT_VARIANTS)
def test_splat_kernel_matches_twin_every_variant(cuda, radix, groups, dtype):
    """Every radix and cardinality, at 3 faces of 7 x 5 positions and 24
    channels a group: a batch, an extent and a width that fill no tile."""
    _check_r1(cuda, 3, radix, groups, 24 * groups, 7, 5, dtype,
              seed=10 * radix + groups)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("h,w,c", SPLAT_SHAPES)
def test_splat_kernel_matches_twin_at_served_shapes(cuda, h, w, c, dtype):
    _check_r1(cuda, 3, 2, 1, c, h, w, dtype, seed=c + h)


@pytest.mark.gpu
@pytest.mark.parametrize("radix,groups", [(2, 1), (1, 2), (4, 1)])
def test_splat_gradient_is_the_twins(cuda, radix, groups):
    """Under autograd R1 runs in a Function whose backward recomputes the
    twin: the gradients equal the twin's own bit for bit."""
    from synergynet_tpu_torch.ops.split_attention import (
        radix_combine, radix_combine_reference, radix_pool,
        radix_pool_reference)
    y, logits = _splat_inputs(cuda, 3, radix, 8 * groups, 6, 5,
                              torch.float32, seed=radix)
    g = torch.Generator(device=cuda).manual_seed(1)
    gp = torch.randn((3, 8 * groups, 1, 1), generator=g, device=cuda)
    gc = torch.randn((3, 8 * groups, 6, 5), generator=g, device=cuda)

    def grads(pool, combine):
        yy = y.detach().requires_grad_()
        ll = logits.detach().requires_grad_()
        ((pool(yy, radix) * gp).sum()
         + (combine(yy, ll, radix, groups) * gc).sum()).backward()
        return yy.grad, ll.grad

    before = _counts("synergy_splat_pool", "synergy_splat_combine")
    got = grads(radix_pool, radix_combine)
    assert _counts("synergy_splat_pool", "synergy_splat_combine") == (
        before[0] + 1, before[1] + 1)
    want = grads(radix_pool_reference, radix_combine_reference)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
def test_splat_rejects_what_it_does_not_take(cuda):
    from synergynet_tpu_torch.ops.split_attention import (radix_combine,
                                                          radix_pool)
    y, logits = _splat_inputs(cuda, 2, 2, 16, 4, 4, torch.bfloat16, seed=0)
    with pytest.raises(TypeError):
        radix_pool(y.half(), 2)
    with pytest.raises(ValueError):                  # not channels-last
        radix_pool(y.contiguous(), 2)
    with pytest.raises(ValueError):                  # 4 channels a branch
        radix_pool(y[:, :8].contiguous(memory_format=torch.channels_last), 2)
    with pytest.raises(ValueError):
        radix_combine(y, logits[:, :16], 2, 1)
    with pytest.raises(TypeError):
        radix_combine(y, logits.float(), 2, 1)
    with pytest.raises(ValueError):
        radix_combine(y, logits, 2, 3)


@pytest.mark.gpu
def test_splat_wrapper_and_kernel_share_one_limit(cuda):
    """The wrapper's checks and the C entries' own refuse the same shapes:
    at ``R1_MAX_WEIGHTS`` weights R1 runs and matches the twin; one vector
    past it, or a branch of c not a multiple of 16 bytes, the wrapper
    raises and each C entry, called past the wrapper, returns
    cudaErrorInvalidValue (1)."""
    import ctypes

    from synergynet_tpu_torch.ops.cuda_build import launch
    from synergynet_tpu_torch.ops.split_attention import (
        R1_MAX_WEIGHTS, radix_combine, radix_pool)
    _check_r1(cuda, 1, 2, 1, R1_MAX_WEIGHTS // 2, 1, 1, torch.bfloat16,
              seed=3)
    for c in (R1_MAX_WEIGHTS // 2 + 8, 12):
        y, logits = _splat_inputs(cuda, 1, 2, c, 1, 1, torch.bfloat16,
                                  seed=4)
        with pytest.raises(ValueError):
            radix_pool(y, 2)
        with pytest.raises(ValueError):
            radix_combine(y, logits, 2, 1)
        out = torch.empty((1, c), dtype=y.dtype, device=cuda)
        with pytest.raises(RuntimeError, match="CUDA error 1$"):
            launch("split_attention", "synergy_splat_pool",
                   [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5, y.device,
                   y, out, 1, 1, 2, c, 2)
        with pytest.raises(RuntimeError, match="CUDA error 1$"):
            launch("split_attention", "synergy_splat_combine",
                   [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6, y.device,
                   y, logits.view(1, 2 * c), out, 1, 1, 2, c, 1, 2)


@pytest.mark.gpu
def test_resnest_process_batch_credits_r1_a_replay(cuda):
    """``process_batch`` of 2 canvases through a seeded bf16 ResNeSt-50:
    captured and replayed, equal to the eager body bit for bit, R1
    credited 32 launches a replay (16 blocks, a pool and a combine each)."""
    from synergynet_tpu_torch.detect import FaceBoxes
    from synergynet_tpu_torch.detect.detector import random_init_variables
    from synergynet_tpu_torch.pipeline import FusedFrameEngine, SynergyNet3DMM
    api = SynergyNet3DMM("resnest50", dtype=torch.bfloat16, device=cuda)
    eng = FusedFrameEngine(api, detector=FaceBoxes(
        random_init_variables(0), dtype=torch.bfloat16, device=cuda,
        stem_mode="pallas"), max_faces=8)
    args = _batch(cuda, 2, seed=7)
    want = eng.process_batch_eager(*args)
    before = sum(_counts("synergy_splat_pool", "synergy_splat_combine"))
    got = eng.process_batch(*args)                # captured, then replayed
    again = eng.process_batch(*args)
    torch.cuda.synchronize()
    assert sum(_counts("synergy_splat_pool", "synergy_splat_combine")) \
        == before + 2 * 32
    assert int(got[1].sum()) > 0
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, w) and torch.equal(a, w)


# -- kernel BN1: the conv backbones' BatchNorm + activation + residual -------

BN1_FORMS = [(act, res) for act in ("none", "relu", "relu6")
             for res in ("none", "raw", "bn")]


def _bn1_bn(cuda, c, seed):
    from synergynet_tpu_torch.nn.batchnorm import BatchNorm
    g = torch.Generator(device=cuda).manual_seed(seed)
    bn = BatchNorm(c).to(cuda).eval()
    with torch.no_grad():
        bn.running_mean.copy_(torch.randn(c, generator=g, device=cuda))
        bn.running_var.copy_(torch.rand(c, generator=g, device=cuda) * 2
                             + 0.05)
        bn.weight.copy_(torch.randn(c, generator=g, device=cuda))
        bn.bias.copy_(torch.randn(c, generator=g, device=cuda))
    return bn


def _bn1_operand(cuda, b, c, h, w, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = 3 * torch.randn((b, c, h, w), generator=g, device=cuda)
    return x.to(dtype).contiguous(memory_format=torch.channels_last)


def _bn1_twin_flags(dtype):
    """The twin on the card computes as the served chain computed before
    BN1: a bf16 ``F.batch_norm`` runs PyTorch's channels-last transform; an
    f32 one goes to cuDNN unless it is disabled, so f32 holds BN1 to the
    same transform with cuDNN off (and to cuDNN's within f32 rounding,
    ``test_bn1_f32_within_rounding_of_cudnn``)."""
    if dtype == torch.float32:
        return torch.backends.cudnn.flags(enabled=False)
    return contextlib.nullcontext()


def _check_bn1(cuda, b, c, h, w, dtype, act, res, seed):
    """BN1 against its twin on one site shape, bit for bit; -> BN1's
    output."""
    from synergynet_tpu_torch.ops.bn_act import bn_act, bn_act_reference
    x = _bn1_operand(cuda, b, c, h, w, dtype, seed)
    r = _bn1_operand(cuda, b, c, h, w, dtype, seed + 1) \
        if res != "none" else None
    bn = _bn1_bn(cuda, c, seed + 2)
    rbn = _bn1_bn(cuda, c, seed + 3) if res == "bn" else None
    before = launches["synergy_bn_act"]
    with torch.inference_mode():
        got = bn_act(x, bn, act, r, rbn)
        with _bn1_twin_flags(dtype):
            want = bn_act_reference(x, bn, act, r, rbn)
    torch.cuda.synchronize()
    assert launches["synergy_bn_act"] == before + 1
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    differ = int((got != want).sum())
    assert differ == 0, f"{differ} of {got.numel()} values differ"
    assert torch.equal(bn_act(x, bn, act, r, rbn), got)     # deterministic
    return got


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("act,res", BN1_FORMS)
def test_bn1_kernel_matches_twin_every_form(cuda, act, res, dtype):
    """Every activation and residual form at 3 faces of 7 x 5 positions and
    40 channels: a batch, an extent and a width that fill no tile."""
    _check_bn1(cuda, 3, 40, 7, 5, dtype, act, res, seed=len(act) + len(res))


def _bn1_served_sites(cuda):
    """The distinct BN1 sites of the served MobileNetV2 and ResNeSt-50 at
    120 pixels: (arch, C, H, W, act, residual form), from one forward of
    each on the card with a tally in BN1's place."""
    from synergynet_tpu_torch.nn.backbones import mobilenet_v2
    from synergynet_tpu_torch.nn.backbones.resnest import make_resnest
    from synergynet_tpu_torch.ops.bn_act import bn_act_sites
    sites = set()
    for arch in ("mobilenet_v2", "resnest50"):
        model = (mobilenet_v2.MobileNetV2() if arch == "mobilenet_v2"
                 else make_resnest(arch)).to(cuda).eval()
        sites.update((arch, *s) for s in bn_act_sites(
            model, torch.zeros((1, 120, 120, 3), device=cuda)))
    return sorted(sites)


@pytest.fixture(scope="module")
def bn1_sites(cuda):
    return _bn1_served_sites(cuda)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [1, 5])
def test_bn1_kernel_matches_twin_at_served_sites(cuda, bn1_sites, b, dtype):
    """Every distinct site of both served backbones (60 x 60 down to 4 x 4,
    15 x 15 among them, 16 to 2,048 channels, ResNeSt's projected shortcut
    under its own BatchNorm), at 1 and 5 faces."""
    assert {s[2] for s in bn1_sites} == {60, 30, 15, 8, 4}
    assert {s[1] for s in bn1_sites} >= {16, 1280, 2048}
    assert any(s[-1] == "bn" for s in bn1_sites)
    for k, (_, c, h, w, act, res) in enumerate(bn1_sites):
        _check_bn1(cuda, b, c, h, w, dtype, act, res, seed=10 * k + b)


@pytest.mark.gpu
def test_bn1_f32_within_rounding_of_cudnn(cuda):
    """cuDNN's f32 eval BatchNorm, which served the f32 regressor before
    BN1, rounds its own way: BN1 stays within f32 rounding of it (rtol
    1e-6), and the test says how many values differ."""
    from synergynet_tpu_torch.ops.bn_act import bn_act, bn_act_reference
    x = _bn1_operand(cuda, 4, 64, 15, 15, torch.float32, seed=1)
    bn = _bn1_bn(cuda, 64, seed=2)
    with torch.inference_mode():
        got = bn_act(x, bn, "relu6")
        with torch.backends.cudnn.flags(enabled=True):
            want = bn_act_reference(x, bn, "relu6")
    torch.cuda.synchronize()
    differ = int((got != want).sum())
    print(f"BN1 f32 against cuDNN: {differ} of {got.numel()} values differ")
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("res", ["none", "raw", "bn"])
def test_bn1_gradient_is_the_twins(cuda, res):
    """Under autograd BN1 runs in a Function whose backward recomputes the
    twin: the gradients of x, the residual and the affine parameters equal
    the twin's own bit for bit."""
    from synergynet_tpu_torch.ops.bn_act import bn_act, bn_act_reference
    g = torch.Generator(device=cuda).manual_seed(4)
    grad = torch.randn((3, 16, 6, 5), generator=g, device=cuda)

    def grads(fn):
        bn, rbn = _bn1_bn(cuda, 16, 1), _bn1_bn(cuda, 16, 2)
        x = _bn1_operand(cuda, 3, 16, 6, 5, torch.float32, 3)
        x.requires_grad_()
        r = _bn1_operand(cuda, 3, 16, 6, 5, torch.float32, 4) \
            if res != "none" else None
        if r is not None:
            r.requires_grad_()
        with _bn1_twin_flags(torch.float32):
            out = fn(x, bn, "relu6", r, rbn if res == "bn" else None)
            (out * grad).sum().backward()
        return [t.grad for t in (x, r, bn.weight, bn.bias, rbn.weight,
                                 rbn.bias) if t is not None]

    before = launches["synergy_bn_act"]
    got = grads(bn_act)
    assert launches["synergy_bn_act"] == before + 1
    want = grads(bn_act_reference)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)


@pytest.mark.gpu
def test_bn1_rejects_what_it_does_not_take(cuda):
    """The wrapper raises before a launch; the C entry, called past it,
    refuses a row off 4 bytes (an odd count in bf16) and an unknown form
    with cudaErrorInvalidValue (1)."""
    import ctypes

    from synergynet_tpu_torch.ops.bn_act import bn_act
    from synergynet_tpu_torch.ops.cuda_build import launch
    x = _bn1_operand(cuda, 2, 16, 4, 4, torch.bfloat16, 0)
    bn = _bn1_bn(cuda, 16, 1)
    before = launches["synergy_bn_act"]
    with pytest.raises(TypeError):
        bn_act(x.half(), bn, "relu")
    with pytest.raises(ValueError):
        bn_act(x.contiguous(), bn, "relu")
    with pytest.raises(ValueError):
        bn_act(x, bn, "relu", x[:, :, :2])
    with pytest.raises(ValueError):
        bn_act(x, bn.cpu(), "relu")
    with pytest.raises(ValueError):
        bn_act(x[:, :13].contiguous(memory_format=torch.channels_last), bn,
               "relu")
    assert launches["synergy_bn_act"] == before
    bn = bn.to(cuda)
    out = torch.empty_like(x)
    args = ([ctypes.c_void_p] * 7 + [ctypes.c_float]
            + [ctypes.c_void_p] * 4 + [ctypes.c_float, ctypes.c_longlong]
            + [ctypes.c_int] * 4)
    stats = [bn.running_mean, bn.running_var, bn.weight, bn.bias, 1e-5]
    for c, act, res in ((13, 1, 0), (16, 3, 0), (16, 1, 3), (16, 1, 1)):
        # (16, 1, 1): a residual form without a residual pointer
        with pytest.raises(RuntimeError, match="CUDA error 1$"):
            launch("bn_act", "synergy_bn_act", args, cuda, x, None, out,
                   *stats, *stats, 2 * 4 * 4, c, act, res, 2)


def _conv_engine(cuda, arch):
    from synergynet_tpu_torch.detect import FaceBoxes
    from synergynet_tpu_torch.detect.detector import random_init_variables
    from synergynet_tpu_torch.pipeline import FusedFrameEngine, SynergyNet3DMM
    api = (SynergyNet3DMM(variables="trained", dtype=torch.bfloat16,
                          device=cuda) if arch == "mobilenet_v2"
           else SynergyNet3DMM(arch, dtype=torch.bfloat16, device=cuda))
    return FusedFrameEngine(api, detector=FaceBoxes(
        random_init_variables(0), dtype=torch.bfloat16, device=cuda,
        stem_mode="pallas"), max_faces=8)


@pytest.mark.gpu
@pytest.mark.parametrize("arch,sites", [("mobilenet_v2", 52),
                                        ("resnest50", 51)])
def test_conv_process_batch_replay_equals_the_chain_before_bn1(cuda, arch,
                                                               sites):
    """``process_batch`` of 2 canvases through the served bf16 backbone:
    its replay equals, bit for bit, the replay of an engine whose blocks
    run the twin (the chain before BN1), and BN1 is credited ``sites``
    launches a replay (52 in MobileNetV2, 51 in ResNeSt-50)."""
    from synergynet_tpu_torch.nn.backbones import mobilenet_v2, resnest
    from synergynet_tpu_torch.ops.bn_act import bn_act_reference
    args = _batch(cuda, 2, seed=9)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mobilenet_v2, "bn_act", bn_act_reference)
        mp.setattr(resnest, "bn_act", bn_act_reference)
        chain = _conv_engine(cuda, arch)
        before = launches["synergy_bn_act"]
        want = chain.process_batch(*args)             # captured, replayed
        want = chain.process_batch(*args)
        assert launches["synergy_bn_act"] == before
    eng = _conv_engine(cuda, arch)
    got = eng.process_batch(*args)
    before = launches["synergy_bn_act"]
    again = eng.process_batch(*args)
    torch.cuda.synchronize()
    assert launches["synergy_bn_act"] == before + sites
    assert int(got[1].sum()) > 0
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, w) and torch.equal(a, w)


# -- HRNetV2-W18: BN1 at narrow rows, kernel F1, the served backbone ---------

def _hrnet_sites(cuda, padded=False):
    """The distinct BN1 sites of HRNetV2-W18 at 256 pixels, at its published
    widths or as served (``padded``): (C, H, W, act, residual form), from
    one forward on the card with a tally in BN1's place."""
    from synergynet_tpu_torch.nn.backbones.hrnet import HRNet
    from synergynet_tpu_torch.ops.bn_act import bn_act_sites
    model = HRNet().to(cuda).eval()
    if padded:
        model.pad_channels_()
    return sorted(set(bn_act_sites(
        model, torch.zeros((1, 256, 256, 3), device=cuda))))


@pytest.fixture(scope="module")
def hrnet_sites(cuda):
    return _hrnet_sites(cuda)


# Rows off 16 bytes: (dtype, C) -> the vector BN1 moves.
BN1_NARROW = [(torch.bfloat16, 18), (torch.bfloat16, 36),
              (torch.bfloat16, 270), (torch.float32, 9),
              (torch.float32, 6)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,c", BN1_NARROW)
@pytest.mark.parametrize("act,res", BN1_FORMS)
def test_bn1_narrow_rows_match_twin_every_form(cuda, act, res, dtype, c):
    """Rows off 16 bytes, every form: 18 and 270 bf16 channels move 4-byte
    vectors, 36 8-byte ones; 9 f32 channels 4-byte ones, 6 8-byte ones."""
    _check_bn1(cuda, 3, c, 7, 5, dtype, act, res, seed=c + len(act))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b", [1, 5])
def test_bn1_kernel_matches_twin_at_hrnet_sites(cuda, hrnet_sites, b, dtype):
    """Every distinct site of the served HRNetV2-W18 (128 x 128 down to 8 x
    8, 18 to 270 channels, the projected shortcut of layer1), at 1 and 5
    faces."""
    assert {s[0] for s in hrnet_sites} == {18, 36, 64, 72, 144, 256, 270}
    assert {s[1] for s in hrnet_sites} == {128, 64, 32, 16, 8}
    assert any(s[-1] == "bn" for s in hrnet_sites)
    for k, (c, h, w, act, res) in enumerate(hrnet_sites):
        _check_bn1(cuda, b, c, h, w, dtype, act, res, seed=10 * k + b)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 5])
def test_bn1_kernel_matches_twin_at_served_hrnet_sites(cuda, b):
    """Every distinct site of HRNetV2-W18 as served, its branches stored at
    24 and 40 channels and its head at 272: all on 16-byte rows in bf16."""
    sites = _hrnet_sites(cuda, padded=True)
    assert {s[0] for s in sites} == {24, 40, 64, 72, 144, 256, 272}
    for k, (c, h, w, act, res) in enumerate(sites):
        _check_bn1(cuda, b, c, h, w, torch.bfloat16, act, res,
                   seed=10 * k + b)


@pytest.mark.gpu
def test_bn1_refuses_odd_bf16_rows(cuda):
    """An odd channel count in bf16 (a row off 4 bytes): the wrapper
    raises before a launch, the C entry returns cudaErrorInvalidValue."""
    import ctypes

    from synergynet_tpu_torch.ops.bn_act import bn_act
    from synergynet_tpu_torch.ops.cuda_build import launch
    x = _bn1_operand(cuda, 2, 17, 4, 4, torch.bfloat16, 0)
    bn = _bn1_bn(cuda, 17, 1)
    before = launches["synergy_bn_act"]
    with pytest.raises(ValueError, match="multiple of 2"):
        bn_act(x, bn, "relu")
    assert launches["synergy_bn_act"] == before
    args = ([ctypes.c_void_p] * 7 + [ctypes.c_float]
            + [ctypes.c_void_p] * 4 + [ctypes.c_float, ctypes.c_longlong]
            + [ctypes.c_int] * 4)
    stats = [bn.running_mean, bn.running_var, bn.weight, bn.bias, 1e-5]
    with pytest.raises(RuntimeError, match="CUDA error 1$"):
        launch("bn_act", "synergy_bn_act", args, cuda, x, None,
               torch.empty_like(x), *stats, *stats, 2 * 4 * 4, 17, 1, 0, 2)


HRNET_WIDTHS = (18, 36, 72, 144)
HRNET_STORED = (24, 40, 72, 144)        # as the served net stores them


def _f1_unit(cuda, b, n, i, dtype, side=64, seed=0, widths=HRNET_WIDTHS):
    """Output i of an n-branch exchange unit at branch 0's extent ``side``:
    the identity and (raw, BatchNorm, scale) for each j != i in order."""
    c = widths[i]
    h = side // 2 ** i
    ident = _bn1_operand(cuda, b, c, h, h, dtype, seed)
    terms = []
    for j in range(n):
        if j != i:
            hj = side // 2 ** max(i, j)
            terms.append((_bn1_operand(cuda, b, c, hj, hj, dtype,
                                       seed + 1 + j),
                          _bn1_bn(cuda, c, seed + 11 + j),
                          2 ** (j - i) if j > i else 1))
    return ident, terms


def _check_f1(cuda, b, n, i, dtype, seed, widths=HRNET_WIDTHS):
    """F1 against its twin on one exchange output, bit for bit."""
    from synergynet_tpu_torch.ops.hr_fuse import hr_fuse, hr_fuse_reference
    ident, terms = _f1_unit(cuda, b, n, i, dtype, seed=seed, widths=widths)
    before = launches["synergy_hr_fuse"]
    with torch.inference_mode():
        got = hr_fuse(ident, terms)
        with _bn1_twin_flags(dtype):
            want = hr_fuse_reference(ident, terms)
    torch.cuda.synchronize()
    assert launches["synergy_hr_fuse"] == before + 1
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    differ = int((got != want).sum())
    assert differ == 0, f"{differ} of {got.numel()} values differ"
    assert torch.equal(hr_fuse(ident, terms), got)          # deterministic


# The exchange outputs of the served net: stage 2's unit (2 branches),
# stage 3's four (3) and stage 4's three (4) share three shapes.
F1_UNITS = [(n, i) for n in (2, 3, 4) for i in range(n)]


@pytest.mark.gpu
@pytest.mark.parametrize("widths", [HRNET_WIDTHS, HRNET_STORED],
                         ids=["published", "stored"])
@pytest.mark.parametrize("n,i", F1_UNITS)
def test_f1_kernel_matches_twin_at_served_units(cuda, n, i, widths):
    """Every output of the three exchange-unit shapes at 1,024 faces of 256
    pixels in bf16 (branches at 64, 32, 16 and 8; 1 to 3 terms at scales
    1, 2, 4 and 8), at the published widths and as the served net stores
    them."""
    _check_f1(cuda, 1024, n, i, torch.bfloat16, seed=10 * n + i,
              widths=widths)


@pytest.mark.gpu
@pytest.mark.parametrize("n,i", F1_UNITS)
@pytest.mark.parametrize("b", [1, 3])
def test_f1_kernel_matches_twin_f32(cuda, n, i, b):
    """The same in f32 (18 and 36 channels on 8- and 16-byte vectors), the
    twin's BatchNorm with cuDNN off, as BN1's."""
    _check_f1(cuda, b, n, i, torch.float32, seed=10 * n + i + b)


@pytest.mark.gpu
def test_f1_gradient_is_the_twins(cuda):
    """Under autograd F1 runs in a Function whose backward recomputes the
    twin: the gradients of the identity, each raw term and each BatchNorm's
    affine parameters equal the twin's own bit for bit."""
    from synergynet_tpu_torch.ops.hr_fuse import hr_fuse, hr_fuse_reference

    def grads(fn):
        ident, terms = _f1_unit(cuda, 2, 4, 1, torch.float32, side=16,
                                seed=3)
        leaves = [ident.requires_grad_()]
        for raw, bn, _ in terms:
            leaves += [raw.requires_grad_(), bn.weight, bn.bias]
        with _bn1_twin_flags(torch.float32):
            out = fn(ident, terms)
            (out * out.detach().cos()).sum().backward()
        return [t.grad for t in leaves]

    before = launches["synergy_hr_fuse"]
    got = grads(hr_fuse)
    assert launches["synergy_hr_fuse"] == before + 1
    want = grads(hr_fuse_reference)
    assert len(got) == len(want) == 10
    for a, b in zip(got, want):
        assert a is not None and torch.equal(a, b)


@pytest.mark.gpu
def test_f1_rejects_what_it_does_not_take(cuda):
    """The wrapper raises before a launch; the C entry, called past it,
    refuses an odd bf16 row, no terms, a scale of 3 or one that does not
    divide the extent, and more terms ahead of the identity than terms,
    with cudaErrorInvalidValue (1)."""
    import ctypes

    from synergynet_tpu_torch.ops.cuda_build import launch
    from synergynet_tpu_torch.ops.hr_fuse import MAX_TERMS, hr_fuse
    ident, terms = _f1_unit(cuda, 2, 2, 0, torch.bfloat16, side=16)
    before = launches["synergy_hr_fuse"]
    with pytest.raises(TypeError):
        hr_fuse(ident.half(), terms)
    with pytest.raises(ValueError):
        hr_fuse(ident.contiguous(), terms)
    with pytest.raises(ValueError):
        hr_fuse(ident, [])
    with pytest.raises(ValueError):
        hr_fuse(ident, [(terms[0][0].cpu(), terms[0][1], 2)])
    assert launches["synergy_hr_fuse"] == before
    raw, bn, _ = terms[0]
    term = [raw, bn.running_mean, bn.running_var, bn.weight, bn.bias, 1e-5]
    argtypes = ([ctypes.c_void_p] * 2
                + ([ctypes.c_void_p] * 5 + [ctypes.c_float, ctypes.c_int])
                * MAX_TERMS + [ctypes.c_int] * 7)
    empty = [None] * 5 + [0.0, 1]
    out = torch.empty_like(ident)
    for c, n, before_, scale, h in ((17, 1, 0, 2, 16), (18, 0, 0, 2, 16),
                                    (18, 1, 0, 3, 16), (18, 1, 0, 2, 15),
                                    (18, 1, 2, 2, 16)):
        with pytest.raises(RuntimeError, match="CUDA error 1$"):
            launch("hr_fuse", "synergy_hr_fuse", argtypes, cuda, ident, out,
                   *term, scale, *empty, *empty, n, before_, 2, h, 16, c, 2)


# HRNetV2-W18 in bf16 against the float32 reference at the published
# widths: bf16 rounds every conv operand and output, each BatchNorm and
# each exchange sum at 2^-9 relative, which over ~300 convs reads a few %
# of the 62 parameters' norm; the same reference in fp8 e4m3 (2^-4) reads
# far more, and must fall outside.
HRNET_REL = 0.1


@pytest.mark.gpu
def test_hrnet_card_matches_the_f32_reference(cuda):
    """``hrnetv2_w18`` at its published widths, bf16 on the card, against
    the benchmark's plain float32 reference (TF32 off) on 16 seeded crops
    of 256, the tree drawn and its statistics calibrated as the benchmark
    does."""
    from perfbench import weights
    from perfbench.reference.nets import merge
    from perfbench.reference.precision import Precision, exact_f32
    from perfbench.reference.regressors import hrnetv2_w18 as ref
    from synergynet_tpu_torch.convert import synergy_state_dict
    from synergynet_tpu_torch.nn import SynergyNet
    from synergynet_tpu_torch.nn.layers import cast_layers_
    g = torch.Generator(device=cuda).manual_seed(0)
    x = (torch.randint(0, 256, (16, 256, 256, 3), generator=g,
                       device=cuda).float() - 127.5) / 128.0
    tree = weights.draw(ref.spec(), 11, cuda)
    weights.calibrate("hrnetv2_w18", tree, x)
    model = SynergyNet("hrnetv2_w18", dtype=torch.bfloat16)
    model.load_state_dict(synergy_state_dict(weights.numpy_tree(tree)))
    model = cast_layers_(model, torch.bfloat16).to(cuda).eval()
    t = merge(tree["params"], tree["batch_stats"])["backbone"]
    counts = _counts("synergy_bn_act", "synergy_hr_fuse")
    with torch.no_grad():
        got, feat = model(x)
        with exact_f32():
            want = ref.forward(Precision("f32"), t, x)
            fp8 = ref.forward(Precision("fp8"), t, x)
    assert _counts("synergy_bn_act", "synergy_hr_fuse") == (
        counts[0] + 243, counts[1] + 26)

    def rel(a):
        return ((a - want).norm(dim=-1) / want.norm(dim=-1)).max().item()

    print(f"HRNetV2-W18 bf16 against f32: {rel(got):.4f}, fp8 "
          f"{rel(fp8):.4f}")
    assert feat.shape == (16, 270) and got.dtype == torch.float32
    assert rel(got) < HRNET_REL < rel(fp8), (rel(got), rel(fp8))


# cuDNN copies a conv's input and its filter into padded buffers where their
# channels are off a multiple of 8, or copies neither, as the engine it
# picks goes: in the served HRNet only the stem conv's 3 image channels are
# off, so at most these two copies.
STEM_PADS = 2


def _pad_kernels(fn, path):
    """cuDNN's NHWC channel-pad launches (``nhwcAddPaddingKernel``) while
    ``fn`` runs on the card: the kernels of a profiler trace written to
    ``path``."""
    import json
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return sum(e.get("cat") == "kernel" and "nhwcAddPaddingKernel" in
               e.get("name", "") for e in events)


@pytest.mark.gpu
def test_hrnet_served_layout_equals_the_published_net(cuda, tmp_path):
    """HRNetV2-W18 in bf16 on the card as the API serves it (every width
    stored at a multiple of 8 channels, ``pad_channels_``) against the net
    at its published widths, the same calibrated tree and 16 crops of 256.
    cuDNN runs other kernels on 24- and 40-channel inputs than on its own
    padded copies of 18 and 36, so the two round apart (~0.03 of the 62
    parameters' norm on an H100): each within ``HRNET_REL`` of the other
    and of the float32 reference. cuDNN pads the published net's narrow
    branches before its convolutions (two copies a conv); the served net's
    only at the stem's 3 image channels."""
    import copy

    from perfbench import weights
    from perfbench.reference.nets import merge
    from perfbench.reference.precision import Precision, exact_f32
    from perfbench.reference.regressors import hrnetv2_w18 as ref
    from synergynet_tpu_torch.convert import synergy_state_dict
    from synergynet_tpu_torch.nn import SynergyNet
    from synergynet_tpu_torch.nn.layers import cast_layers_
    g = torch.Generator(device=cuda).manual_seed(1)
    x = (torch.randint(0, 256, (16, 256, 256, 3), generator=g,
                       device=cuda).float() - 127.5) / 128.0
    tree = weights.draw(ref.spec(), 12, cuda)
    weights.calibrate("hrnetv2_w18", tree, x)
    model = SynergyNet("hrnetv2_w18", dtype=torch.bfloat16)
    model.load_state_dict(synergy_state_dict(weights.numpy_tree(tree)))
    model = cast_layers_(model, torch.bfloat16).to(cuda).eval()
    served = copy.deepcopy(model)
    served.backbone.pad_channels_()
    t = merge(tree["params"], tree["batch_stats"])["backbone"]
    with torch.no_grad():
        want, wfeat = model(x)
        got, feat = served(x)
        with exact_f32():
            f32 = ref.forward(Precision("f32"), t, x)
        trace = tmp_path / "trace.json"
        pads = {"published": _pad_kernels(lambda: model(x), trace),
                "served": _pad_kernels(lambda: served(x), trace)}

    def rel(a, b):
        return ((a - b).norm(dim=-1) / b.norm(dim=-1)).max().item()

    print(f"HRNetV2-W18 served against published (bf16): param62 "
          f"{rel(got, want):.4f}, feature {rel(feat, wfeat):.4f}; against "
          f"f32: {rel(got, f32):.4f} (published {rel(want, f32):.4f}); "
          f"cuDNN pads {pads}")
    assert feat.shape == (16, 270) and got.shape == (16, 62)
    assert rel(got, want) < HRNET_REL and rel(feat, wfeat) < HRNET_REL
    assert rel(got, f32) < HRNET_REL
    assert pads["served"] <= STEM_PADS < pads["published"], pads


@pytest.fixture(scope="module")
def hrnet_engine(cuda):
    from synergynet_tpu_torch.detect import FaceBoxes
    from synergynet_tpu_torch.detect.detector import random_init_variables
    from synergynet_tpu_torch.pipeline import FusedFrameEngine, SynergyNet3DMM
    api = SynergyNet3DMM("hrnetv2_w18", dtype=torch.bfloat16, device=cuda,
                         crop=256)
    return FusedFrameEngine(api, detector=FaceBoxes(
        random_init_variables(0), dtype=torch.bfloat16, device=cuda,
        stem_mode="pallas"), max_faces=8)


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 4])
def test_hrnet_process_batch_replay_equals_eager_body(cuda, hrnet_engine, b):
    """``process_batch`` of b canvases through a seeded bf16 HRNetV2-W18 API
    at crop 256: captured and replayed, equal to the eager body bit for
    bit, BN1 credited 243 launches a replay and F1 26."""
    eng = hrnet_engine
    args = _batch(cuda, b, seed=20 + b)
    want = eng.process_batch_eager(*args)
    before = _counts("synergy_bn_act", "synergy_hr_fuse")
    got = eng.process_batch(*args)                # captured, then replayed
    again = eng.process_batch(*args)
    torch.cuda.synchronize()
    assert _counts("synergy_bn_act", "synergy_hr_fuse") == (
        before[0] + 2 * 243, before[1] + 2 * 26)
    assert eng.api.crop == 256
    assert int(got[1].sum()) > 0
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, w) and torch.equal(a, w)


@pytest.mark.gpu
def test_hrnet_replay_pads_the_stem_alone(cuda, hrnet_engine, tmp_path):
    """A traced ``process_batch`` replay of 2 canvases through the served
    HRNetV2-W18: cuDNN pads no tensor there but those it pads in the
    detector run alone and the stem conv's two at most, and BN1 and F1 are
    credited 243 and 26 launches."""
    eng = hrnet_engine
    frames, frames_s2d, hws = _batch(cuda, 2, seed=31)
    eng.process_batch(frames, frames_s2d, hws)            # captured
    trace = tmp_path / "trace.json"
    before = _counts("synergy_bn_act", "synergy_hr_fuse")
    replay = _pad_kernels(lambda: eng.process_batch(frames, frames_s2d, hws),
                          trace)
    assert _counts("synergy_bn_act", "synergy_hr_fuse") == (
        before[0] + 243, before[1] + 26)
    with torch.inference_mode():
        detect = _pad_kernels(lambda: eng.detect_candidates(frames_s2d, hws),
                              trace)
    assert eng.api.model.backbone.padded
    assert replay <= detect + STEM_PADS, (replay, detect)


# -- kernels M1, G1 and M2: V-MoE's routed experts ------------------------------

# The served V-MoE-B/16 layer: 128 canvases x 8 faces x 197 tokens of 768,
# 32 experts, MLP 3072.
MOE_TOKENS, MOE_WIDTH, MOE_EXPERTS, MOE_MLP = 1024 * 197, 768, 32, 3072


def _moe_inputs(cuda, routing, seed=0, t=MOE_TOKENS):
    """Layer-normed-like bf16 tokens and an f32 lecun-normal router; with
    ``routing`` "skewed" every token ranks expert 0 first, so expert 0
    holds half the 2T rows."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    u = torch.randn((t, MOE_WIDTH), generator=g, device=cuda)
    w = torch.randn((MOE_EXPERTS, MOE_WIDTH), generator=g,
                    device=cuda) * MOE_WIDTH ** -0.5
    if routing == "skewed":
        u[:, 0] = u[:, 0].abs() + 4.0
        w[0, 0] = 4.0
    return u.to(torch.bfloat16), w


def _dispatches_equal(got, want):
    for name, a, b in zip(got._fields, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), (name, int((a != b).sum()))


@pytest.mark.gpu
@pytest.mark.parametrize("routing", ["balanced", "skewed"])
def test_moe_dispatch_kernel_matches_twin_bit_for_bit(cuda, routing):
    """M1 at the served shape (201,728 tokens, 768 wide, 32 experts) against
    its twin run on the same card tensors: experts, gates, slots, offsets,
    tiles, the dispatched rows and the stats, bit for bit; two launches."""
    from synergynet_tpu_torch.ops.moe import (moe_dispatch,
                                              moe_dispatch_reference)
    u, w = _moe_inputs(cuda, routing)
    before = launches["synergy_moe_dispatch"]
    got = moe_dispatch(u, w)
    torch.cuda.synchronize()
    assert launches["synergy_moe_dispatch"] == before + 2
    want = moe_dispatch_reference(u, w)
    _dispatches_equal(got, want)
    counts = (got.offsets[1:] - got.offsets[:-1]).tolist()
    assert got.stats.tolist() == [2 * MOE_TOKENS, max(counts)]
    if routing == "skewed":
        assert counts[0] == MOE_TOKENS
    else:
        assert max(counts) < 4 * 2 * MOE_TOKENS // MOE_EXPERTS, counts


@pytest.mark.gpu
@pytest.mark.parametrize("t", [1, 3, 1000])
def test_moe_dispatch_kernel_matches_twin_at_small_counts(cuda, t):
    """Fewer tokens than blocks, and a ragged last block: bit for bit."""
    from synergynet_tpu_torch.ops.moe import (moe_dispatch,
                                              moe_dispatch_reference)
    u, w = _moe_inputs(cuda, "balanced", seed=t, t=t)
    _dispatches_equal(moe_dispatch(u, w), moe_dispatch_reference(u, w))


@pytest.mark.gpu
def test_moe_dispatch_kernel_ties_to_the_lower_expert(cuda):
    """Zero tokens tie all 32 experts: experts 0 and 1, gates 1/32."""
    from synergynet_tpu_torch.ops.moe import moe_dispatch
    u = torch.zeros((64, MOE_WIDTH), dtype=torch.bfloat16, device=cuda)
    _, w = _moe_inputs(cuda, "balanced")
    d = moe_dispatch(u, w)
    assert d.expert.tolist() == [[0, 1]] * 64
    assert (d.gate == 1 / 32).all()


@pytest.mark.gpu
@pytest.mark.parametrize("routing", ["balanced", "skewed"])
def test_moe_combine_kernel_matches_twin_bit_for_bit(cuda, routing):
    """M2 at the served shape against its twin on the same card tensors,
    bit for bit, on M1's slots and gates; one launch."""
    from synergynet_tpu_torch.ops.moe import (moe_combine,
                                              moe_combine_reference,
                                              moe_dispatch)
    u, w = _moe_inputs(cuda, routing, seed=1)
    d = moe_dispatch(u, w)
    g = torch.Generator(device=cuda).manual_seed(2)
    y = torch.randn((2 * MOE_TOKENS, MOE_WIDTH), generator=g,
                    device=cuda).to(torch.bfloat16)
    z = torch.randn((MOE_TOKENS, MOE_WIDTH), generator=g,
                    device=cuda).to(torch.bfloat16)
    before = launches["synergy_moe_combine"]
    got = moe_combine(z, y, d.slot, d.gate)
    torch.cuda.synchronize()
    assert launches["synergy_moe_combine"] == before + 1
    want = moe_combine_reference(z, y, d.slot, d.gate)
    assert torch.equal(got, want), int((got != want).sum())


# G1 accumulates each row's products in f32 in wgmma's order, its twin in
# cuBLAS's (TF32 off), and both round the f32 result once to bf16: the f32
# sums agree to ~1e-6 relative, so an output differs from the twin's by at
# most one bf16 step (2^-8 relative, where a sum falls by a rounding
# boundary), and most are equal.
MOE_GEMM_TOL = dict(rtol=2 ** -7, atol=1e-5)


def _gemm_pair(cuda, x, w, b, offsets, tiles, gelu):
    from synergynet_tpu_torch.ops.moe import moe_gemm, moe_gemm_reference
    before = launches["synergy_moe_gemm"]
    got = moe_gemm(x, w, b, offsets, tiles, gelu)
    torch.cuda.synchronize()
    assert launches["synergy_moe_gemm"] == before + 1
    with full_fp32():
        want = moe_gemm_reference(x, w, b, offsets, gelu)
    return got, want


@pytest.mark.gpu
@pytest.mark.parametrize("routing", ["balanced", "skewed"])
def test_moe_gemm_kernel_matches_twin(cuda, routing):
    """G1's two passes at the served shape on M1's offsets, each against
    the twin on the same input, within one bf16 step."""
    from synergynet_tpu_torch.ops.moe import moe_dispatch
    u, w = _moe_inputs(cuda, routing, seed=3)
    d = moe_dispatch(u, w)
    g = torch.Generator(device=cuda).manual_seed(4)
    w1 = (torch.randn((MOE_EXPERTS, MOE_WIDTH, MOE_MLP), generator=g,
                      device=cuda) * MOE_WIDTH ** -0.5).to(torch.bfloat16)
    b1 = (torch.randn((MOE_EXPERTS, MOE_MLP), generator=g, device=cuda)
          * 0.01).to(torch.bfloat16)
    w2 = (torch.randn((MOE_EXPERTS, MOE_MLP, MOE_WIDTH), generator=g,
                      device=cuda) * MOE_MLP ** -0.5).to(torch.bfloat16)
    b2 = (torch.randn((MOE_EXPERTS, MOE_WIDTH), generator=g, device=cuda)
          * 0.01).to(torch.bfloat16)
    h, want_h = _gemm_pair(cuda, d.x, w1, b1, d.offsets, d.tiles, True)
    torch.testing.assert_close(h.float(), want_h.float(), **MOE_GEMM_TOL)
    y, want_y = _gemm_pair(cuda, want_h, w2, b2, d.offsets, d.tiles, False)
    torch.testing.assert_close(y.float(), want_y.float(), **MOE_GEMM_TOL)
    share = (h != want_h).float().mean().item()
    print(f"G1 {routing}: {share:.2e} of H differ from the twin")
    assert share < 0.05


@pytest.mark.gpu
@pytest.mark.parametrize("counts", [[0, 0, 1000, 0], [1000, 0, 0, 0],
                                    [0, 0, 0, 1000], [0, 1, 999, 0],
                                    [129, 0, 127, 744]])
def test_moe_gemm_kernel_takes_empty_experts_and_one_with_every_row(
        cuda, counts):
    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn((1000, 256), generator=g, device=cuda).to(torch.bfloat16)
    w = (torch.randn((4, 256, 512), generator=g, device=cuda) / 16).to(
        torch.bfloat16)
    b = torch.randn((4, 512), generator=g, device=cuda).to(torch.bfloat16)
    c = torch.tensor(counts)
    bm = 128
    offsets = torch.cat([c.new_zeros(1), c.cumsum(0)]).to(torch.int32)
    tiles = torch.cat([c.new_zeros(1), ((c + bm - 1) // bm).cumsum(0)]).to(
        torch.int32)
    got, want = _gemm_pair(cuda, x, w, b, offsets.to(cuda), tiles.to(cuda),
                           False)
    torch.testing.assert_close(got.float(), want.float(), **MOE_GEMM_TOL)


@pytest.mark.gpu
def test_moe_layer_captures_with_no_host_sync(cuda):
    """The served layer (M1, G1 twice, M2) on 2,048 tokens: no host sync
    under ``set_sync_debug_mode("error")``, captured into a CUDA graph,
    whose replay equals the eager call bit for bit on new tokens, and the
    twins' layer within one bf16 step of the norm (G1's rounding)."""
    from synergynet_tpu_torch.nn.moe import MoeMlp
    from synergynet_tpu_torch.nn.synergy import init_synergy_
    from synergynet_tpu_torch.nn.layers import cast_layers_
    from synergynet_tpu_torch.ops.moe import moe_mlp_reference
    layer = MoeMlp(MOE_WIDTH, MOE_MLP, MOE_EXPERTS)
    init_synergy_(layer, torch.Generator().manual_seed(0))
    layer = cast_layers_(layer, torch.bfloat16).to(cuda).eval()
    g = torch.Generator(device=cuda).manual_seed(6)
    z = torch.randn((2, 1024, MOE_WIDTH), generator=g, device=cuda).to(
        torch.bfloat16)
    u = torch.randn((2, 1024, MOE_WIDTH), generator=g, device=cuda).to(
        torch.bfloat16)
    with torch.inference_mode():
        layer(z, u)                                  # builds and compiles
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eager = layer(z, u)
            side = torch.cuda.Stream(cuda)
            side.wait_stream(torch.cuda.current_stream(cuda))
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side):
                out = layer(z, u)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.current_stream(cuda).wait_stream(side)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
        z.copy_(torch.randn_like(z, dtype=torch.float32).to(torch.bfloat16))
        u.copy_(torch.randn_like(u, dtype=torch.float32).to(torch.bfloat16))
        graph.replay()
        want = layer(z, u)
        torch.cuda.synchronize()
        assert torch.equal(out, want)
        w1, w2 = layer.Dense_0, layer.Dense_1
        with full_fp32():
            twin, _ = moe_mlp_reference(
                z.reshape(-1, MOE_WIDTH), u.reshape(-1, MOE_WIDTH),
                layer.Router.weight, w1.weight, w1.bias, w2.weight, w2.bias)
        rel = ((want.reshape(-1, MOE_WIDTH) - twin).float().norm()
               / twin.float().norm()).item()
    assert rel < 2 ** -7, rel


@pytest.mark.gpu
def test_moe_under_autograd_launches_the_kernels_with_the_twins_gradient(
        cuda, monkeypatch):
    """Where autograd records the call the kernels still run forward: the
    bf16 V-MoE-B/16 net's grad-enabled forward on 2 crops of 224 credits
    12 M1, 12 G1 and 6 M2 launches, as a served call, and its backward
    reaches every expert. One served layer on 2,048 tokens: its output
    equals the no-grad call's bit for bit, and the gradients of tokens,
    router and experts match the twins' layer's (the backward recomputes
    the twins on the same inputs)."""
    from synergynet_tpu_torch.nn import SynergyNet
    from synergynet_tpu_torch.nn import moe as nn_moe
    from synergynet_tpu_torch.nn.layers import cast_layers_
    from synergynet_tpu_torch.nn.synergy import init_synergy_
    from synergynet_tpu_torch.ops import moe as ops
    net = SynergyNet("vmoe_b16", dtype=torch.bfloat16)
    init_synergy_(net, torch.Generator().manual_seed(0))
    net = cast_layers_(net, torch.bfloat16).to(cuda).eval()
    g = torch.Generator(device=cuda).manual_seed(12)
    x = torch.randn((2, 224, 224, 3), generator=g, device=cuda)
    syms = ("synergy_moe_dispatch", "synergy_moe_gemm", "synergy_moe_combine")
    before = _counts(*syms)
    params, _ = net(x)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_counts(*syms), before)) == (12, 12, 6)
    params.float().square().sum().backward()
    layers = [m for m in net.modules() if isinstance(m, nn_moe.MoeMlp)]
    assert len(layers) == 6
    for m in layers:
        for p in (m.Router.weight, m.Dense_0.weight, m.Dense_1.bias):
            assert p.grad is not None and torch.isfinite(p.grad).all()

    layer = layers[-1]
    z, u = (torch.randn((1, 2048, MOE_WIDTH), generator=g, device=cuda).to(
        torch.bfloat16).requires_grad_() for _ in range(2))
    leaves = [z, u, layer.Router.weight, layer.Dense_0.weight,
              layer.Dense_0.bias, layer.Dense_1.weight, layer.Dense_1.bias]
    with torch.no_grad():
        plain = layer(z, u)
    before = _counts(*syms)
    out = layer(z, u)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_counts(*syms), before)) == (2, 2, 1)
    assert torch.equal(out, plain)
    grad = torch.randn(out.shape, generator=g, device=cuda).to(out.dtype)
    got = torch.autograd.grad(out, leaves, grad)

    monkeypatch.setattr(nn_moe, "moe_mlp", ops.moe_mlp_reference)
    want = torch.autograd.grad(layer(z, u), leaves, grad)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        torch.testing.assert_close(a.float(), b.float(), **MOE_GEMM_TOL)


# V-MoE-B/16 in bf16 against the float32 reference at the published widths,
# on the served crops of a captured process_batch: as ViT-B/16 (VIT_REL),
# plus the tokens whose top two change experts between bf16 and f32 near a
# tie; the same reference in fp8 must fall outside.
VMOE_REL = 0.08


@pytest.fixture(scope="module")
def vmoe_engine(cuda):
    """A bf16 V-MoE-B/16 API at crop 224 on the benchmark's seeded tree,
    its head calibrated on 16 crops as the benchmark does, behind a seeded
    bf16 detector; and the reference's tree."""
    from perfbench import weights
    from perfbench.reference.nets import merge
    from perfbench.reference.regressors import vmoe_b16 as ref
    from synergynet_tpu_torch.detect import FaceBoxes
    from synergynet_tpu_torch.detect.detector import random_init_variables
    from synergynet_tpu_torch.pipeline import FusedFrameEngine, SynergyNet3DMM
    g = torch.Generator(device=cuda).manual_seed(0)
    x = (torch.randint(0, 256, (16, 224, 224, 3), generator=g,
                       device=cuda).float() - 127.5) / 128.0
    tree = weights.draw(ref.spec(), 11, cuda)
    weights.calibrate("vmoe_b16", tree, x)
    api = SynergyNet3DMM("vmoe_b16", weights.numpy_tree(tree),
                         dtype=torch.bfloat16, device=cuda, crop=224)
    eng = FusedFrameEngine(api, detector=FaceBoxes(
        random_init_variables(0), dtype=torch.bfloat16, device=cuda,
        stem_mode="pallas"), max_faces=8)
    return eng, merge(tree["params"], tree["batch_stats"])["backbone"]


@pytest.mark.gpu
def test_vmoe_process_batch_replay_matches_the_f32_reference(cuda,
                                                             vmoe_engine):
    """``process_batch`` of 2 canvases (16 face slots) replayed from its
    captured graph: its param62 against the float32 reference (TF32 off)
    on the same crops within VMOE_REL, the fp8 reference outside; the
    replay equal to the eager body bit for bit; M1, G1 and M2 credited 12,
    12 and 6 launches a replay; the tallies 2T rows a MoE layer."""
    from perfbench.reference.precision import Precision, exact_f32
    from perfbench.reference.regressors import vmoe_b16 as ref
    from synergynet_tpu_torch.core.profiling import recorder
    from synergynet_tpu_torch.pipeline.device_crop import crop_resize_bilinear
    eng, t = vmoe_engine
    args = _batch(cuda, 2, seed=9)
    want_eager = eng.process_batch_eager(*args)
    syms = ("synergy_moe_dispatch", "synergy_moe_gemm",
            "synergy_moe_combine", "attention")
    eng.process_batch(*args)                        # captured
    recorder.reset()
    before = _counts(*syms)
    got = eng.process_batch(*args)
    torch.cuda.synchronize()
    assert _counts(*syms) == (before[0] + 12, before[1] + 12,
                              before[2] + 6, before[3] + 12)
    for g, w in zip(got, want_eager):
        assert torch.equal(g, w)
    c = recorder.counters("process_batch.b2", eng.programs.engine)
    assert c["moe_rows"] == 6 * 2 * 16 * 197
    assert 2 * 16 * 197 * 6 // 32 <= c["moe_rows_max"] <= 6 * 16 * 197
    rois, param62 = got[2].reshape(-1, 4), got[3].reshape(-1, 62)
    crops = crop_resize_bilinear(args[0], got[2], 224).reshape(-1, 224, 224,
                                                                3)
    x = (crops - 127.5) / 128.0
    with torch.no_grad(), exact_f32():
        want = ref.forward(Precision("f32"), t, x)
        fp8 = ref.forward(Precision("fp8"), t, x)

    def rel(a):
        return ((a - want).norm(dim=-1) / want.norm(dim=-1)).max().item()

    print(f"V-MoE-B/16 process_batch bf16 against f32: {rel(param62):.4f}, "
          f"fp8 {rel(fp8):.4f}")
    assert rois.shape == (16, 4)
    assert rel(param62) < VMOE_REL < rel(fp8), (rel(param62), rel(fp8))


@pytest.mark.gpu
def test_vmoe_traced_replay_launches_what_it_credits(cuda, vmoe_engine,
                                                    tmp_path):
    """A traced replay of the V-MoE program runs 12 ``moe_dispatch``, 12
    ``moe_gemm`` and 6 ``moe_combine`` kernels, as the launch table
    credits, and no library grouped GEMM."""
    import json
    eng, _ = vmoe_engine
    args = _batch(cuda, 2, seed=10)
    eng.process_batch(*args)
    syms = ("synergy_moe_dispatch", "synergy_moe_gemm",
            "synergy_moe_combine")
    before = _counts(*syms)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        eng.process_batch(*args)
        torch.cuda.synchronize()
    credited = tuple(a - b for a, b in zip(_counts(*syms), before))
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    traced = tuple(sum(frag in k for k in kernels)
                   for frag in ("moe_dispatch", "moe_gemm", "moe_combine"))
    assert traced == credited == (12, 12, 6), (traced, credited)
    assert not any("grouped" in k.lower() for k in kernels)
