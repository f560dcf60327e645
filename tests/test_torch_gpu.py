"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here needs a CUDA card and skips without one. The file imports
neither JAX nor the repo's conftest fixtures, so on a machine with a card
and no JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py
"""

import numpy as np
import pytest
import torch

from synergynet_tpu_torch.mm3d import load_param_pack
from synergynet_tpu_torch.mm3d.codec import full_fp32
from synergynet_tpu_torch.ops import (build_decode_basis, decode_dense_fused,
                                      decode_dense_fused_reference)

torch.set_num_threads(2)

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
    before = decode_dense_fused.launches
    got = decode_dense_fused(p, basis, pack)
    torch.cuda.synchronize()
    assert decode_dense_fused.launches == before + 1
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
    before = rasterize_mesh.launches, rasterize_mesh_ids.launches
    z, p = rasterize_mesh(verts, tris, pay, h=h, w=w)
    z3, ids, w0 = rasterize_mesh_ids(verts, tris, h=h, w=w, w0=True)
    torch.cuda.synchronize()
    assert (rasterize_mesh.launches, rasterize_mesh_ids.launches) == (
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
    from synergynet_tpu_torch.render import (raster_tiled, rasterize_mesh,
                                             rasterize_mesh_ids)

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
    before = rasterize_mesh.launches
    pts, _, _, overlay = ov(img)
    assert len(pts) > 0 and overlay.shape == img.shape
    assert rasterize_mesh.launches == before + 1
    verts, tris, colors = _full_width_mesh(cuda, seed=3)
    tris = tris.int()
    ntri.append(tris.shape[0])
    before = rasterize_mesh_ids.launches
    z, c = raster_tiled.rasterize_buffers_tiled(verts, tris, colors, h=720,
                                                w=1088, deferred=True)
    tri, zv, w0 = raster_tiled.rasterize_triangles_tiled(verts, tris, h=720,
                                                         w=1088)
    torch.cuda.synchronize()
    assert rasterize_mesh_ids.launches == before + 2
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
    before = fused_stem1_s2d8.launches
    got = fused_stem1_s2d8(x, k4, bias)
    torch.cuda.synchronize()
    assert fused_stem1_s2d8.launches == before + 1
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
    from synergynet_tpu_torch.detect.stem_fused import fused_stem1_s2d8
    stem = StemS2D8().to(cuda, torch.bfloat16)
    with torch.no_grad():
        stem.weight.normal_(0, 0.02)
        stem.bias.normal_(0, 0.5)
        x = (torch.randn((2, 192, 16, 40), device=cuda) * 60).to(
            torch.bfloat16).contiguous(memory_format=torch.channels_last)
        before = fused_stem1_s2d8.launches
        got = stem(x, "pallas")
        assert fused_stem1_s2d8.launches == before + 1
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
    before = (fused_stem1_s2d8.launches, fused_stem1_s2d8.launches_f32)
    got = fused_stem1_s2d8(x, k4, bias)
    torch.cuda.synchronize()
    assert (fused_stem1_s2d8.launches, fused_stem1_s2d8.launches_f32) == (
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
    from synergynet_tpu_torch.detect.stem_fused import fused_stem1_s2d8
    path = _seeded_faceboxes_pth(tmp_path)
    card = FaceBoxes(weights_path=path, device=cuda, stem_mode="pallas")
    cpu = FaceBoxes(weights_path=path, device="cpu", stem_mode="pallas")
    img = np.random.default_rng(1).integers(0, 256, (120, 160, 3), np.uint8)
    _, packed, hw, _ = prepare_frame(img, 8, "cpu")
    with torch.inference_mode():
        s, _ = cpu.candidates(packed[None], hw[None])
    assert (s[s > 0] - VIS_THRESHOLD).abs().min() > 1e-3
    before = fused_stem1_s2d8.launches_f32
    raw_g, n_g = card.detect_raw(img)
    assert fused_stem1_s2d8.launches_f32 == before + 1
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
    before = decode_dense_fused.launches
    got = SynergyNet3DMM(variables=tree, arch=arch, pack=pack,
                         device=cuda).get_all_outputs(img, rects=rects)
    assert decode_dense_fused.launches > before
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
    before = decode_dense_fused.launches
    got = card.get_all_outputs(img, rects=RECTS8,
                               interpolation=interpolation)
    assert decode_dense_fused.launches == before + 1
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
    from synergynet_tpu_torch.render import (OVERLAY_LIGHT_CFG,
                                             RenderPipeline, rasterize_mesh)
    img, verts, tri = bfm_faces
    v = np.ascontiguousarray(verts[0].T)
    tex = (np.random.default_rng(1).uniform(0, 1, v.shape).astype(np.float32)
           if textured else None)
    before = rasterize_mesh.launches
    got = RenderPipeline(device=cuda, **OVERLAY_LIGHT_CFG)(v, tri.T, img,
                                                           texture=tex)
    assert rasterize_mesh.launches == before + 1
    want = RenderPipeline(device="cpu", **OVERLAY_LIGHT_CFG)(v, tri.T, img,
                                                             texture=tex)
    _assert_render_close(got, want, img)


@pytest.mark.gpu
def test_render_overlay_card_equals_cpu(cuda, bfm_faces):
    from synergynet_tpu_torch.render import (OVERLAY_LIGHT_CFG,
                                             RenderPipeline, rasterize_mesh,
                                             render_overlay)
    img, verts, tri = bfm_faces
    before = rasterize_mesh.launches
    ov, solid = render_overlay(img, verts, tri)     # the default: the card
    assert rasterize_mesh.launches == before + len(verts)
    ov_c, solid_c = render_overlay(img, verts, tri, pipeline=RenderPipeline(
        device="cpu", **OVERLAY_LIGHT_CFG))
    _assert_render_close(solid, solid_c, img)
    assert np.abs(ov.astype(int) - ov_c.astype(int)).max() <= 1


@pytest.mark.gpu
@pytest.mark.parametrize("bilinear", [True, False])
def test_render_texture_card_equals_cpu(cuda, bfm_faces, bilinear):
    from synergynet_tpu_torch.pipeline import UVTextureMapper
    from synergynet_tpu_torch.render import rasterize_mesh, render_texture
    img, verts, tri = bfm_faces
    m = UVTextureMapper.synthetic(verts[0].shape[1])
    uv = (np.stack([m.coord_v, m.coord_u], 1) / 255.0).astype(np.float32)
    tex = np.random.default_rng(2).integers(0, 256, (256, 256, 3), np.uint8)
    v = np.ascontiguousarray(verts[0].T)
    before = rasterize_mesh.launches
    got = render_texture(v, tri.T, uv, tex, img, alpha=0.8, bilinear=bilinear,
                         device=cuda)
    assert rasterize_mesh.launches == before + 1
    want = render_texture(v, tri.T, uv, tex, img, alpha=0.8,
                          bilinear=bilinear, device="cpu")
    assert np.array_equal(got, want)


@pytest.mark.gpu
def test_rasterize_apis_card_equal_cpu(cuda, bfm_faces):
    """rasterize / rasterize_tiled (B2) and rasterize_triangles (B3) on the
    card equal their CPU twins bit for bit, on all three meshes at once."""
    from synergynet_tpu_torch.render import (rasterize, rasterize_mesh,
                                             rasterize_mesh_ids,
                                             rasterize_tiled,
                                             rasterize_triangles)
    img, verts, tri = bfm_faces
    n = tri.shape[1]
    v = np.concatenate([x.T for x in verts]).astype(np.float32)
    t = np.concatenate([tri.T + i * verts[0].shape[1]
                        for i in range(len(verts))]).astype(np.int32)
    c = np.random.default_rng(4).uniform(0, 1, v.shape).astype(np.float32)
    assert t.shape == (3 * n, 3)
    b2, b3 = rasterize_mesh.launches, rasterize_mesh_ids.launches
    for fn in (rasterize, rasterize_tiled):
        got = fn(v, t, c, bg=img, alpha=0.7, reverse=True, device=cuda)
        assert np.array_equal(got, fn(v, t, c, bg=img, alpha=0.7,
                                      reverse=True, device="cpu"))
    got = rasterize_triangles(v, t, h=240, w=320, device=cuda)
    want = rasterize_triangles(v, t, h=240, w=320, device="cpu")
    for g, w_ in zip(got, want):
        assert torch.equal(g.cpu(), w_)
    assert rasterize_mesh.launches == b2 + 2
    assert rasterize_mesh_ids.launches == b3 + 1


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
    before = fused_stem1_s2d8.launches
    faces = dets["pallas"](img)
    assert fused_stem1_s2d8.launches == before + 1
    raw, count = dets["pallas"].detect_raw(img)
    assert raw.shape == (750, 5) and count == len(faces) > 0
    assert np.isfinite(raw).all()
    xla = dets["xla"](img)
    assert fused_stem1_s2d8.launches == before + 2
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
    n, rois, dense = _engine_faces(card, img)
    assert n != n_cpu or not (np.allclose(rois, rois_cpu, **BOXES) and
                              np.allclose(dense, dense_cpu, **ENGINE_MESH))
