"""The port's host render APIs and mesh outputs against the JAX package, on
the CPU, on the same seeded meshes (the wrappers run the kernels' plain
twins here).

- ``get_normal`` and its parts within rtol / atol 1e-5, NaN on the same
  rows (the segment sum and the ring gather add in different orders);
- ``rasterize``, ``rasterize_triangles`` and ``rasterize_tiled`` on meshes
  whose JAX fragment window covers every triangle: the uint8 image within
  one step on >= 99.5% of pixels and undrawn pixels exact, triangle ids
  equal on >= 99.5% of pixels (a pixel on an edge or a depth tie can fall
  the other way: the JAX window path evaluates per-fragment dot products,
  the port affine planes), depth and w0 within rtol / atol 1e-4 where the
  ids agree.
  On a mesh with a triangle over 32 px the port draws it whole, as the
  reference's sequential z-buffer does (``tests/oracles.py``), where the
  JAX window path crops it;
- ``RenderPipeline``, ``render_overlay`` and ``render_texture`` (on the
  synthetic BFM meshes the trained regressor decodes) within one uint8
  step on >= 99.5% of pixels, with equal coverage: a lit color that
  differs in the last bit can truncate to the next uint8 step;
- the obj writers byte-identical; ``UVTextureMapper`` and
  ``load_uv_assets`` equal.
"""

import filecmp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synergynet_tpu.pipeline import outputs as jout
from synergynet_tpu.render import lighting as jlight
from synergynet_tpu.render import normals as jnorm
from synergynet_tpu.render import raster as jraster
from synergynet_tpu.render import texture as jtex
from synergynet_tpu.render.overlay import render_overlay as jax_overlay
from synergynet_tpu.render.raster_tiled import \
    rasterize_tiled as jax_rasterize_tiled
from synergynet_tpu_torch.mm3d import load_param_pack
from synergynet_tpu_torch.pipeline import (SynergyNet3DMM, UVTextureMapper,
                                           load_uv_assets, write_obj,
                                           write_obj_with_colors,
                                           write_obj_with_colors_texture)
from synergynet_tpu_torch.render import (
    OVERLAY_LIGHT_CFG, RenderPipeline, accumulate_vertex_normals,
    add_weighted_u8, get_normal, get_tri_normal, get_ver_normal, rasterize,
    rasterize_buffers, rasterize_mesh, rasterize_texture_buffers,
    rasterize_tiled, rasterize_triangles, render_overlay, render_texture)
from tests.oracles import oracle_rasterize
from tests.test_raster_tiled import random_mesh

torch.set_num_threads(2)

NORMAL = dict(rtol=1e-5, atol=1e-5)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _assert_image_close(got, want, bg):
    """Within one uint8 step on >= 99.5% of pixels, the same pixels drawn,
    undrawn pixels exact."""
    assert got.shape == want.shape and got.dtype == np.uint8
    drawn_g, drawn_w = (got != bg).any(-1), (want != bg).any(-1)
    assert (drawn_g == drawn_w).mean() >= 0.995
    both_undrawn = ~drawn_g & ~drawn_w
    assert np.array_equal(got[both_undrawn], want[both_undrawn])
    diff = np.abs(got.astype(int) - want.astype(int)).max(-1)
    assert (diff <= 1).mean() >= 0.995


# -- normals -------------------------------------------------------------------

def _mesh_with_orphans(seed):
    rng = np.random.default_rng(seed)
    verts, tris, _ = random_mesh(rng, nver=65, ntri=100)
    return verts, tris % 60


@pytest.mark.parametrize("seed", [0, 1])
def test_normals_match_jax(seed):
    verts, tris = _mesh_with_orphans(seed)
    jv, jt = jnp.asarray(verts), jnp.asarray(tris)
    tv, tt = _t(verts, tris)
    for normalize in (False, True):
        np.testing.assert_allclose(
            get_tri_normal(tv, tt, normalize).numpy(),
            np.asarray(jnorm.get_tri_normal(jv, jt, normalize)), **NORMAL)
    tri_n = get_tri_normal(tv, tt)
    jtri_n = jnorm.get_tri_normal(jv, jt)
    np.testing.assert_allclose(
        accumulate_vertex_normals(tri_n, tt, 65).numpy(),
        np.asarray(jnorm.accumulate_vertex_normals(jtri_n, jt, 65)),
        **NORMAL)
    np.testing.assert_allclose(
        get_ver_normal(tri_n, tt, 65).numpy(),
        np.asarray(jnorm.get_ver_normal(jtri_n, jt, 65)), **NORMAL)
    got = get_normal(tv, tt).numpy()
    want = np.asarray(jnorm.get_normal(jv, jt))
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[60:]).all()
    np.testing.assert_allclose(got, want, equal_nan=True, **NORMAL)


def test_get_normal_on_the_bfm_topology_is_reproducible():
    pack = load_param_pack()
    tris = torch.from_numpy(pack.tri.numpy().T.copy())
    rng = np.random.default_rng(3)
    verts = torch.tensor(rng.normal(0, 30, (pack.nver, 3)),
                         dtype=torch.float32)
    a, b = get_normal(verts, tris), get_normal(verts, tris.long())
    torch.testing.assert_close(a, b, rtol=0, atol=0, equal_nan=True)
    want = np.asarray(jnorm.get_normal(jnp.asarray(verts.numpy()),
                                       jnp.asarray(tris.numpy())))
    np.testing.assert_allclose(a.numpy(), want, equal_nan=True, **NORMAL)


# -- the reference-compatible rasterizer ---------------------------------------

def _covered_mesh(seed, h=32, w=32):
    rng = np.random.default_rng(seed)
    verts, tris, colors = random_mesh(rng, nver=80, ntri=150)
    assert jraster.window_for(verts, tris) <= (32, 32)
    return verts, tris, colors, rng.integers(0, 255, (h, w, 3), np.uint8)


@pytest.mark.parametrize("alpha,reverse", [(1.0, False), (0.6, True)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rasterize_matches_jax_window_path(seed, alpha, reverse):
    verts, tris, colors, bg = _covered_mesh(seed)
    want = jraster.rasterize(verts, tris, colors, bg=bg, alpha=alpha,
                             reverse=reverse)
    got = rasterize(verts, tris, colors, bg=bg, alpha=alpha,
                    reverse=reverse, device="cpu")
    _assert_image_close(got, want, bg)
    blank = rasterize(verts, tris, colors, height=32, width=32,
                      device="cpu")
    want_blank = jraster.rasterize(verts, tris, colors, height=32, width=32)
    _assert_image_close(blank, want_blank, np.zeros_like(bg))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rasterize_tiled_matches_jax(seed):
    """Against the JAX package's tiled kernel, in interpret mode."""
    verts, tris, colors, bg = _covered_mesh(seed)
    want = jax_rasterize_tiled(verts, tris, colors, bg=bg, alpha=0.7)
    got = rasterize_tiled(verts, tris, colors, bg=bg, alpha=0.7,
                          device="cpu")
    _assert_image_close(got, want, bg)
    assert np.array_equal(got, rasterize(verts, tris, colors, bg=bg,
                                         alpha=0.7, device="cpu"))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rasterize_triangles_matches_jax(seed):
    verts, tris, _, _ = _covered_mesh(seed)
    ti, z, w0 = (np.asarray(x) for x in jraster.rasterize_triangles(
        jnp.asarray(verts), jnp.asarray(tris), h=32, w=32, win_h=32,
        win_w=32))
    gi, gz, gw0 = (x.numpy() for x in rasterize_triangles(
        verts, tris, h=32, w=32, device="cpu"))
    assert gi.dtype == np.int32 and gz.dtype == gw0.dtype == np.float32
    same = gi == ti
    assert same.mean() >= 0.995
    np.testing.assert_allclose(gz[same], z[same], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gw0[same], w0[same], rtol=1e-4, atol=1e-4)
    zb, color = rasterize_buffers(verts, tris, np.ones_like(verts), h=32,
                                  w=32, device="cpu")
    assert torch.equal(zb, torch.from_numpy(gz))


def test_a_triangle_over_the_window_renders_whole():
    """A 190 px triangle: the JAX window (capped at 32 px) crops it, the
    port draws it whole, like the reference's sequential z-buffer."""
    verts = np.asarray([[5.0, 5.0, 1.0], [195.0, 5.0, 1.0], [5.0, 195.0, 1.0],
                        [60.0, 60.0, 5.0], [80.0, 60.0, 5.0],
                        [60.0, 80.0, 5.0]], np.float32)
    tris = np.asarray([[0, 1, 2], [3, 4, 5]], np.int32)
    colors = np.asarray([[1, 0, 0]] * 3 + [[0, 1, 0]] * 3, np.float32)
    bg = np.zeros((200, 200, 3), np.uint8)
    assert jraster.window_for(verts, tris) == (32, 32)
    want, _ = oracle_rasterize(bg, verts, tris, colors)
    got = rasterize(verts, tris, colors, bg=bg, device="cpu")
    cropped = jraster.rasterize(verts, tris, colors, bg=bg)
    diff = np.abs(got.astype(int) - want.astype(int))
    assert (diff > 1).mean() < 0.003
    drawn = (got != bg).any(-1).sum()
    assert drawn > 15000 > (cropped != bg).any(-1).sum()
    ids, _, _ = rasterize_triangles(verts, tris, h=200, w=200, device="cpu")
    assert (ids.numpy() >= 0).sum() == drawn


def test_window_and_tiled_knobs_raise():
    verts, tris, colors, bg = _covered_mesh(0)
    with pytest.raises(ValueError, match="window"):
        rasterize(verts, tris, colors, bg=bg, window=(8, 8), device="cpu")
    with pytest.raises(ValueError, match="window"):
        rasterize_triangles(verts, tris, h=32, w=32, win_h=4, win_w=4,
                            device="cpu")
    with pytest.raises(ValueError, match="window"):
        rasterize_buffers(verts, tris, colors, h=32, w=32, win_h=8,
                          device="cpu")
    pipe = RenderPipeline(device="cpu")
    with pytest.raises(ValueError, match="window"):
        pipe(verts, tris, bg, window=(4, 4))
    with pytest.raises(ValueError, match="tiled"):
        pipe(verts, tris, bg, tiled=True)
    uv = colors[:, :2]
    with pytest.raises(ValueError, match="window"):
        render_texture(verts, tris, uv, bg, bg, window=(4, 4), device="cpu")
    with pytest.raises(ValueError, match="window"):
        rasterize_texture_buffers(verts, tris, uv, bg, h=32, w=32, win_h=4,
                                  device="cpu")


# -- the lit renders on BFM meshes -----------------------------------------------

@pytest.fixture(scope="module")
def faces():
    """Three decoded BFM meshes on a 240x320 frame, the third overlapping
    the other two, and the topology."""
    api = SynergyNet3DMM("trained", device="cpu")
    img = np.random.default_rng(0).integers(0, 256, (240, 320, 3), np.uint8)
    rects = [[40., 50., 140., 160.], [150., 60., 240., 150.],
             [100., 100., 200., 200.]]
    _, verts, _ = api.get_all_outputs(img, rects=rects)
    return img, verts, load_param_pack().tri.numpy()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("textured", [False, True])
def test_render_pipeline_matches_jax(seed, textured):
    verts, tris, colors, bg = _covered_mesh(seed)
    tex = colors if textured else None
    pipe, jpipe = RenderPipeline(device="cpu"), jlight.RenderPipeline()
    got = pipe(verts, tris, bg, texture=tex)
    _assert_image_close(got, jpipe(verts, tris, bg, texture=tex), bg)
    _assert_image_close(got, jpipe(verts, tris, bg, texture=tex, tiled=True),
                        bg)
    pipe.update_light_pos((3, -2, 4))
    jpipe.update_light_pos((3, -2, 4))
    _assert_image_close(pipe(verts, tris, bg, texture=tex),
                        jpipe(verts, tris, bg, texture=tex), bg)


def test_render_pipeline_on_a_bfm_mesh_matches_jax(faces):
    img, verts, tri = faces
    v = np.ascontiguousarray(verts[0].T)
    got = RenderPipeline(device="cpu", **OVERLAY_LIGHT_CFG)(v, tri.T, img)
    want = jlight.RenderPipeline(**OVERLAY_LIGHT_CFG)(v, tri.T, img)
    _assert_image_close(got, want, img)
    assert (got != img).any(-1).mean() > 0.1


@pytest.mark.parametrize("textured", [False, True])
def test_render_overlay_matches_jax(faces, textured):
    """Each face over the previous result (the third overdraws the others
    where they overlap), then one addWeighted blend."""
    img, verts, tri = faces
    tex = (np.random.default_rng(1).uniform(0, 1, (verts[0].shape[1], 3))
           .astype(np.float32) if textured else None)
    jov, jsolid = jax_overlay(img, verts, tri, texture=tex)
    ov, solid = render_overlay(img, verts, tri, texture=tex,
                               pipeline=RenderPipeline(device="cpu",
                                                       **OVERLAY_LIGHT_CFG))
    _assert_image_close(solid, jsolid, img)
    assert np.array_equal((solid != img).any(-1), (jsolid != img).any(-1))
    np.testing.assert_array_equal(ov, add_weighted_u8(img, 0.4, solid, 0.6))
    diff = np.abs(ov.astype(int) - jov.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 0.02
    none, no_solid = render_overlay(img, [], tri, with_solid=False,
                                    pipeline=RenderPipeline(device="cpu"))
    assert no_solid is None and np.array_equal(
        none, jax_overlay(img, [], tri)[0])


@pytest.mark.parametrize("alpha,reverse,bilinear", [
    (1.0, False, True), (0.5, True, True), (1.0, False, False)])
def test_render_texture_matches_jax(faces, alpha, reverse, bilinear):
    img, verts, tri = faces
    mapper = UVTextureMapper.synthetic(verts[0].shape[1])
    uv = (np.stack([mapper.coord_v, mapper.coord_u], 1) / 255.0).astype(
        np.float32)
    texture = np.random.default_rng(2).integers(0, 256, (256, 256, 3),
                                                np.uint8)
    v = np.ascontiguousarray(verts[0].T)
    want = jtex.render_texture(v, tri.T, uv, texture, img, alpha=alpha,
                               reverse=reverse, bilinear=bilinear)
    got = render_texture(v, tri.T, uv, texture, img, alpha=alpha,
                         reverse=reverse, bilinear=bilinear, device="cpu")
    _assert_image_close(got, want, img)
    zb, color = rasterize_texture_buffers(v, tri.T, uv, texture, h=240,
                                          w=320, bilinear=bilinear,
                                          device="cpu")
    zk, _ = rasterize_mesh(*_t(v, tri.T.astype(np.int32), uv), h=240, w=320)
    assert torch.equal(zb, zk) and color.shape == (240, 320, 3)
    assert float(color.min()) >= 0.0 and float(color.max()) <= 1.0


# -- mesh outputs ----------------------------------------------------------------

def test_obj_writers_are_byte_identical(tmp_path):
    rng = np.random.default_rng(0)
    v = rng.normal(0, 50, (3, 40)).astype(np.float32)
    t = rng.integers(1, 41, (3, 60)).astype(np.int32)
    c8 = rng.integers(0, 256, (40, 3)).astype(np.uint8)
    cf = rng.uniform(0, 1, (40, 3)).astype(np.float32)
    uv = rng.uniform(0, 1, (40, 2)).astype(np.float32)
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    pairs = []
    for d, mod in (("j", jout), ("t", None)):
        wo = jout.write_obj if mod else write_obj
        wc = jout.write_obj_with_colors if mod else write_obj_with_colors
        wt = (jout.write_obj_with_colors_texture if mod
              else write_obj_with_colors_texture)
        base = tmp_path / d
        pairs.append([wo(str(base / "plain"), v, t),
                      wc(str(base / "col.obj"), v, t, c8),
                      wt(str(base / "tex"), v, t, cf, uv),
                      wt(str(base / "tex2.obj"), v, t, c8, uv,
                         mtl_name="m.mtl", texture_name="t.png")])
    for pj, pt in zip(*pairs):
        assert pj.replace("/j/", "/t/") == pt
        assert filecmp.cmp(pj, pt, shallow=False)
    for name in ("tex.mtl", "m.mtl"):
        assert filecmp.cmp(tmp_path / "j" / name, tmp_path / "t" / name,
                           shallow=False)


def test_uv_texture_mapper_matches_jax():
    nver = load_param_pack().nver
    m, jm = UVTextureMapper.synthetic(nver), jout.UVTextureMapper.synthetic(
        nver)
    assert np.array_equal(m.coord_u, jm.coord_u)
    assert np.array_equal(m.coord_v, jm.coord_v)
    assert np.array_equal(m.keep_ind, jm.keep_ind)
    tex = np.random.default_rng(0).integers(0, 256, (256, 256, 3), np.uint8)
    for flip in (True, False):
        assert np.array_equal(m.colors_from_texture(tex, flip),
                              jm.colors_from_texture(tex, flip))
    verts = np.random.default_rng(1).normal(0, 1, (3, nver)).astype(
        np.float32)
    colors = m.colors_from_texture(tex)
    for got, want in zip(m.trim(verts, colors), jm.trim(verts, colors)):
        assert np.array_equal(got, want)
    small = UVTextureMapper(np.full((10, 2), 0.5), keep_ind=np.arange(4),
                            tri_deletion=np.ones((3, 2), np.int32))
    assert small.trim(np.zeros((3, 10)))[2].shape == (3, 2)
    with pytest.raises(ValueError, match="keep_ind"):
        UVTextureMapper(np.zeros((4, 2))).trim(np.zeros((3, 4)))


def test_load_uv_assets_matches_jax(tmp_path, monkeypatch):
    monkeypatch.delenv("SYNERGY_3DMM_DATA", raising=False)
    fallback, jfallback = load_uv_assets(), jout.load_uv_assets()
    assert np.array_equal(fallback.coord_u, jfallback.coord_u)
    rng = np.random.default_rng(3)
    np.save(tmp_path / "BFM_UV.npy", rng.uniform(0, 1, (30, 2)))
    np.save(tmp_path / "keptInd.npy", np.arange(5, 25))
    np.save(tmp_path / "deletedTri.npy", rng.integers(1, 20, (3, 7)))
    for loaded in ([load_uv_assets(str(tmp_path)),
                    jout.load_uv_assets(str(tmp_path))],):
        got, want = loaded
        for attr in ("coord_u", "coord_v", "keep_ind", "tri_deletion"):
            assert np.array_equal(getattr(got, attr), getattr(want, attr))
    monkeypatch.setenv("SYNERGY_3DMM_DATA", str(tmp_path))
    assert np.array_equal(load_uv_assets().keep_ind, np.arange(5, 25))
