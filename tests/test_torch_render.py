"""The port's render modules against the JAX package, on the same seeded
inputs: one-ring normals, Phong lighting, plane records, the z-buffer
resolve (the plain twin of kernel B2) and the uint8 blend.

Tolerances: normals and light at rtol 1e-5 / atol 1e-6 (the JAX package's
own ring-vs-segment tolerance), NaN on the same rows; plane records at
rtol 1e-5 / atol 1e-4 (XLA contracts some of the setup's multiply-adds
into FMAs, eager torch rounds each), bbox columns exact. The resolve:
zbuf within 1e-4 on >= 99.5% of pixels -- a knife-edge pixel flips where
XLA's FMA contraction moves u or v across 0 -- and color within 1e-4 where
the depth agrees.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synergynet_tpu.render import lighting as jl
from synergynet_tpu.render import normals as jn
from synergynet_tpu.render.raster import blend_uint8 as jax_blend
from synergynet_tpu.render.raster_tiled import (_BBOX0, _clamp_and_bins,
                                                _plane_setup)
from synergynet_tpu.render.raster_tiled import \
    rasterize_buffers_tiled as jax_raster
from synergynet_tpu.render.raster_tiled import replication_for
from synergynet_tpu_torch.mm3d import load_param_pack
from synergynet_tpu_torch.render import (
    DEPTH_INIT, OVERLAY_LIGHT_CFG, blend_uint8, compute_vertex_light,
    get_normal_rings, one_ring_table, plane_records,
    rasterize_buffers_reference, rasterize_buffers_tiled, rasterize_mesh,
    rasterize_mesh_ids, rasterize_records_reference)
from synergynet_tpu_torch.render.raster_tiled import BBOX0, PAYLOAD0
from tests.oracles import oracle_rasterize
from tests.test_raster_tiled import random_mesh

torch.set_num_threads(2)

LIGHT = dict(rtol=1e-5, atol=1e-6)
REC = dict(rtol=1e-5, atol=1e-4)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _orphan_mesh(seed):
    """A random mesh whose last 5 vertices belong to no triangle."""
    rng = np.random.default_rng(seed)
    verts, tris, colors = random_mesh(rng, nver=65, ntri=100)
    tris = tris % 60
    return verts, tris, colors


@pytest.mark.parametrize("which", ["bfm", "random"])
def test_one_ring_table_matches(which):
    if which == "bfm":
        tris = load_param_pack().tri.numpy().T
        nver = 53215
    else:
        _, tris, _ = _orphan_mesh(0)
        nver = 65
    got = one_ring_table(tris, nver)
    want = np.asarray(jn.one_ring_table(tris, nver))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert one_ring_table(torch.from_numpy(tris), nver) is got   # cached


@pytest.mark.parametrize("seed", [0, 1])
def test_normals_and_light_match(seed):
    verts, tris, _ = _orphan_mesh(seed)
    rings = one_ring_table(tris, len(verts))
    want_n = np.asarray(jn.get_normal_rings(
        jnp.asarray(verts), jnp.asarray(tris), jnp.asarray(rings.numpy())))
    tv, tt = _t(verts, tris)
    got_n = get_normal_rings(tv, tt.long(), rings.long())
    ok = np.isfinite(want_n).all(1)
    assert not ok[-5:].any() and ok.sum() > 40      # orphans are NaN
    np.testing.assert_array_equal(np.isfinite(got_n.numpy()).all(1), ok)
    np.testing.assert_allclose(got_n.numpy()[ok], want_n[ok], **LIGHT)

    for cfg in (OVERLAY_LIGHT_CFG, {}):
        want = np.asarray(jl.compute_vertex_light(
            jnp.asarray(verts), jnp.asarray(want_n), **cfg))
        got = compute_vertex_light(tv, torch.from_numpy(want_n.copy()),
                                   **cfg)
        assert got.shape == want.shape and got.dtype == torch.float32
        np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(want))
        np.testing.assert_allclose(got.numpy()[ok], want[ok], **LIGHT)


def test_batched_light_is_per_face():
    """Leading face dims normalise each face on its own, as a vmap."""
    verts, tris, _ = _orphan_mesh(2)
    stack = np.stack([verts, verts * 1.7 + 30.0]).astype(np.float32)
    rings = one_ring_table(tris, len(verts)).long()
    tv, tt = _t(stack, tris)
    n = get_normal_rings(tv, tt.long(), rings)
    got = compute_vertex_light(tv, n, **OVERLAY_LIGHT_CFG)
    for f in range(2):
        one = compute_vertex_light(tv[f], get_normal_rings(tv[f], tt.long(),
                                                           rings),
                                   **OVERLAY_LIGHT_CFG)
        torch.testing.assert_close(got[f], one, equal_nan=True)


def _cases():
    """The random_mesh cases of test_raster_tiled.py: (name, verts, tris,
    colors, h, w)."""
    out = []
    for seed in (0, 1, 2):
        rng = np.random.default_rng(seed)
        out.append((f"random{seed}", *random_mesh(rng, nver=80, ntri=150),
                    32, 32))
    tie_v = np.asarray([[2, 2, 3.0], [26, 2, 3.0], [2, 26, 3.0]] * 2,
                       np.float32)
    tie_c = np.asarray([[1, 0, 0]] * 3 + [[0, 0, 1]] * 3, np.float32)
    out.append(("ties", tie_v, np.asarray([[0, 1, 2], [3, 4, 5]], np.int32),
                tie_c, 28, 28))
    giant_v = np.asarray([
        [5.0, 5.0, 1.0], [195.0, 5.0, 1.0], [5.0, 195.0, 1.0],
        [60.0, 60.0, 5.0], [80.0, 60.0, 5.0], [60.0, 80.0, 5.0]], np.float32)
    giant_c = np.asarray([[1, 0, 0]] * 3 + [[0, 1, 0]] * 3, np.float32)
    out.append(("giant", giant_v, np.asarray([[0, 1, 2], [3, 4, 5]],
                                             np.int32), giant_c, 200, 200))
    rng = np.random.default_rng(7)
    v, t, c = random_mesh(rng)
    v[:, 0] += 500.0
    out.append(("offcanvas", v, t, c, 48, 64))
    rng = np.random.default_rng(8)
    v, t, c = random_mesh(rng, nver=60, ntri=90)
    v[50:53] = [[3.5, 3.5, 1.0], [9.5, 9.5, 2.0], [15.5, 15.5, 3.0]]
    v[53] = v[54] = v[55] = [20.25, 7.75, 4.0]
    t[:4] = [[50, 51, 52], [53, 54, 55], [52, 51, 50], [0, 0, 0]]
    out.append(("degenerate", v, t, c, 32, 32))
    rng = np.random.default_rng(21)
    nf, t1, v1 = 4, 120, 50
    tris = rng.integers(0, v1, (t1, 3)).astype(np.int32)
    verts, cols = [], []
    for _ in range(nf):
        off = rng.uniform([0, 0, 0], [160, 56, 5])
        verts.append(rng.uniform(0, 40, (v1, 3)) + off)
        cols.append(rng.uniform(0, 1, (v1, 3)))
    tris_all = (tris[None] + (np.arange(nf, dtype=np.int32) * v1
                              )[:, None, None]).reshape(-1, 3)
    out.append(("multiface", np.concatenate(verts).astype(np.float32),
                tris_all, np.concatenate(cols).astype(np.float32), 96, 200))
    return out


CASES = _cases()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plane_records_match(case):
    _, verts, tris, colors, h, w = case
    want = _plane_setup(jnp.asarray(verts), jnp.asarray(tris),
                        [jnp.asarray(colors[:, k]) for k in range(3)])
    want, _ = _clamp_and_bins(want, h=h, w=w, ry=1, rx=1, bbox0=_BBOX0)
    want = np.asarray(want)
    got = plane_records(*_t(verts, tris, colors), h=h, w=w).numpy()
    assert got.shape == (len(tris), PAYLOAD0 + 9)
    np.testing.assert_allclose(got[:, :9], want[:, :9], **REC)
    np.testing.assert_allclose(got[:, PAYLOAD0:], want[:, 9:18], **REC)
    np.testing.assert_array_equal(got[:, BBOX0:BBOX0 + 4],
                                  want[:, _BBOX0:_BBOX0 + 4])


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_reference_matches_jax_kernel(case):
    _, verts, tris, colors, h, w = case
    ry, rx = replication_for(verts, tris)
    zj, cj = jax_raster(verts, tris, colors, h=h, w=w, ry=ry, rx=rx,
                        interpret=True)
    zj, cj = np.asarray(zj), np.asarray(cj)
    zt, ct = rasterize_buffers_reference(*_t(verts, tris, colors), h=h, w=w)
    assert zt.shape == (h, w) and ct.shape == (h, w, 3)
    same = np.abs(zt.numpy() - zj) <= 1e-4
    assert same.mean() >= 0.995
    np.testing.assert_allclose(ct.numpy()[same], cj[same], atol=1e-4)
    # the CPU entry point is the plain twin, and counts no launch
    before = rasterize_mesh.launches
    z2, c2 = rasterize_buffers_tiled(*_t(verts, tris, colors), h=h, w=w)
    assert rasterize_mesh.launches == before
    assert torch.equal(z2, zt) and torch.equal(c2, ct)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_matches_oracle(seed):
    rng = np.random.default_rng(seed)
    verts, tris, colors = random_mesh(rng)
    bg = rng.integers(0, 255, (32, 32, 3), np.uint8)
    want, _ = oracle_rasterize(bg, verts, tris, colors)
    zbuf, color = rasterize_buffers_reference(*_t(verts, tris, colors),
                                              h=32, w=32)
    got = blend_uint8(torch.from_numpy(bg), zbuf, color, 1.0).numpy()
    diff = np.abs(got.astype(int) - want.astype(int))
    assert (diff > 1).mean() < 0.003
    assert (diff > 0).mean() < 0.03


def test_tie_rules():
    """Equal depths: the lower triangle index wins, and -0.0 ties +0.0;
    a NaN depth never draws; below DEPTH_INIT never draws."""
    v = np.asarray([[2, 2, 0.0], [26, 2, 0.0], [2, 26, 0.0]] * 4,
                   np.float32)
    v[3:6, 2] = -0.0
    v[6:9, 2] = np.nan
    v[9:12, 2] = -2e8
    c = np.repeat(np.eye(4, 3, dtype=np.float32), 3, axis=0)
    c[9:12] = 1.0
    for order in ([0, 1, 2, 3], [3, 2, 1, 0], [1, 0, 2, 3]):
        tris = np.asarray([[3 * k, 3 * k + 1, 3 * k + 2] for k in order],
                          np.int32)
        zbuf, color = rasterize_buffers_reference(*_t(v, tris, c), h=28,
                                                  w=28)
        drawn = zbuf > DEPTH_INIT
        assert drawn.sum() > 200
        assert (zbuf[drawn] == 0).all()
        first = order.index(0) < order.index(1)
        want = c[0] if first else c[3]
        assert (color[drawn] == torch.from_numpy(want)).all(), order


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_records_entry_is_the_plain_twin_on_cpu(dtype):
    """The mesh entry of kernel B2 on a CPU tensor is the record route
    (plane records, then the record resolve), for either index type and
    1-5 payloads; no triangles draw nothing."""
    verts, tris, colors = random_mesh(np.random.default_rng(4))
    v, t, c = _t(verts, tris, colors)
    t = t.to(dtype)
    pay = torch.cat([c, c[:, :2] * 2.0 - 0.5], 1)
    for p in range(1, 6):
        rec = plane_records(v, t, pay[:, :p].contiguous(), h=32, w=32)
        a = rasterize_mesh(v, t, pay[:, :p].contiguous(), h=32, w=32)
        b = rasterize_records_reference(rec, p, h=32, w=32)
        assert a[1].shape == (32, 32, p)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    z, c = rasterize_mesh(v, t[:0], pay[:, :3].contiguous(), h=8, w=16)
    assert (z == DEPTH_INIT).all() and (c == 0).all()
    assert z.shape == (8, 16) and c.shape == (8, 16, 3)


def test_entry_rejects_what_it_does_not_take():
    verts, tris, colors = _t(*random_mesh(np.random.default_rng(4)))
    with pytest.raises(TypeError):
        rasterize_buffers_tiled(verts.double(), tris, colors, h=8, w=8)
    with pytest.raises(TypeError):
        rasterize_buffers_tiled(verts, tris.float(), colors, h=8, w=8)
    with pytest.raises(ValueError):
        rasterize_buffers_tiled(verts.T.contiguous().T, tris, colors,
                                h=8, w=8)
    with pytest.raises(ValueError):
        rasterize_buffers_tiled(verts, tris, colors[:-1], h=8, w=8)


@pytest.mark.parametrize("entry", ["payloads", "ids"])
def test_mesh_entries_reject_what_the_kernels_do_not_take(entry):
    """Both mesh entries check, on any device, what their kernels take on
    trust: dtypes, shapes, 1-5 payloads, contiguity, one device and 32-bit
    extents."""
    v, t, c = _t(*random_mesh(np.random.default_rng(5)))

    def run(v, t, c=c, h=8, w=8):
        if entry == "payloads":
            return rasterize_mesh(v, t, c, h=h, w=w)
        return rasterize_mesh_ids(v, t, h=h, w=w, w0=True)

    run(v, t)
    bad = [(TypeError, (v.double(), t)), (TypeError, (v, t.float())),
           (TypeError, (v, t.to(torch.int16))),
           (ValueError, (v[:, :2].contiguous(), t)),
           (ValueError, (v, t[:, :2].contiguous())),
           (ValueError, (v.T.contiguous().T, t)),
           (ValueError, (v, t.T.contiguous().T)),
           (ValueError, (v.to("meta"), t)),
           (ValueError, (v, t.to("meta")))]
    if entry == "payloads":
        bad += [(TypeError, (v, t, c.double())),
                (ValueError, (v, t, c[:-1])),
                (ValueError, (v, t, c[:, :0])),
                (ValueError, (v, t, torch.cat([c, c], 1))),
                (ValueError, (v, t, torch.cat([c, c], 1)[:, ::2])),
                (ValueError, (v, t, c.to("meta")))]
    for err, args in bad:
        with pytest.raises(err):
            run(*args)
    for h, w in ((0, 8), (8, 0), (2 ** 16, 2 ** 15)):
        with pytest.raises(ValueError):
            run(v, t, h=h, w=w)


def test_blend_uint8_exact():
    rng = np.random.default_rng(3)
    bg = rng.integers(0, 256, (24, 40, 3), np.uint8)
    zbuf = np.where(rng.uniform(size=(24, 40)) < 0.5, DEPTH_INIT,
                    rng.normal(size=(24, 40))).astype(np.float32)
    color = rng.uniform(0, 1, (24, 40, 3)).astype(np.float32)
    for alpha in (1.0, 0.6, 0.25):
        want = np.asarray(jax_blend(jnp.asarray(bg), jnp.asarray(zbuf),
                                    jnp.asarray(color), alpha))
        got = blend_uint8(*_t(bg, zbuf, color), alpha)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("alpha", [0.3, 0.6, 1.0])
def test_blend_uint8_saturates_as_jax(alpha, reverse):
    """Colours outside [0, 1] and NaN: the f32 sum and XLA's saturating
    cast (NaN -> 0), bit for bit, with and without the row flip."""
    colours = np.array([-0.5, 0.0, 0.5, 1.0, 1.2, 2.0, np.nan], np.float32)
    rng = np.random.default_rng(5)
    bg = rng.integers(0, 256, (4, 7, 3), np.uint8)
    bg[0] = 100
    color = np.broadcast_to(colours[None, :, None], (4, 7, 3)).copy()
    zbuf = np.zeros((4, 7), np.float32)
    zbuf[3, ::2] = DEPTH_INIT
    want = np.asarray(jax_blend(jnp.asarray(bg), jnp.asarray(zbuf),
                                jnp.asarray(color), alpha, reverse=reverse))
    got = blend_uint8(*_t(bg, zbuf, color), alpha, reverse=reverse)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
