"""The port's deferred-payload raster (the plain twin of kernel B3), its
ids resolve and the visibility path against the JAX package in interpret
mode, on the same seeded meshes, and against the port's own payload path
and record routes.

Tolerances. The winning triangle id must be equal everywhere. Depth and
payloads are not bit-equal across the two packages: XLA contracts some of
the record setup's and the kernel's multiply-adds into FMAs, and the port
rounds each operation, which moves a depth plane's value by up to ~1e-3
of itself where its terms cancel. So depth is held at rtol 1e-3 / atol
1e-4, colors at atol 1e-4 (``tests/test_raster_tiled.py``'s deferred
tolerance) and w0 at atol 1e-4 (the plane records' own tolerance in
``tests/test_torch_render.py``). Inside the port, the deferred path equals
the payload path bit for bit, and the visibility path's ids equal the ids
resolve's, and the visibility path (ids twin plus w0) equals its record
route (``_visibility_records`` through the payload twin) bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synergynet_tpu.render.raster_tiled import (_CBBOX0, _clamp_and_bins,
                                                _launch_compact,
                                                _plane_setup_compact,
                                                _prepare_compact)
from synergynet_tpu.render.raster_tiled import \
    rasterize_buffers_tiled as jax_raster
from synergynet_tpu.render.raster_tiled import \
    rasterize_triangles_tiled as jax_visibility
from synergynet_tpu.render.raster_tiled import replication_for
from synergynet_tpu_torch.ops.cuda_build import launches
from synergynet_tpu_torch.render import (
    DEPTH_INIT, compact_records, eval_deferred_payloads,
    rasterize_buffers_tiled, rasterize_ids_reference, rasterize_mesh_ids,
    rasterize_records_reference, rasterize_triangles_tiled)
from synergynet_tpu_torch.render.raster_tiled import (PAYLOAD0,
                                                      _visibility_records)
from tests.test_raster_tiled import random_mesh
from tests.test_torch_render import CASES

torch.set_num_threads(2)

DEPTH = dict(rtol=1e-3, atol=1e-4)
PAYLOAD = dict(rtol=0, atol=1e-4)

# The random_mesh cases of test_raster_tiled.py's deferred test, then the
# edge cases of test_torch_render.py.
MESHES = [(f"random_mesh{s}",
           *random_mesh(np.random.default_rng(s), nver=80, ntri=150), 32, 32)
          for s in (0, 11)] + [c for c in CASES if c[0] in (
              "ties", "giant", "degenerate", "multiface", "offcanvas")]
IDS = [m[0] for m in MESHES]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_deferred_matches_jax_deferred(mesh):
    _, v, t, c, h, w = mesh
    ry, rx = replication_for(v, t)
    zj, cj = jax_raster(v, t, c, h=h, w=w, ry=ry, rx=rx, interpret=True,
                        deferred=True)
    zt, ct = rasterize_buffers_tiled(*_t(v, t, c), h=h, w=w, deferred=True)
    assert zt.shape == (h, w) and ct.shape == (h, w, 3)
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), **DEPTH)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **PAYLOAD)
    # The port's deferred path is its payload path, bit for bit.
    zk, ck = rasterize_buffers_tiled(*_t(v, t, c), h=h, w=w)
    assert torch.equal(zt, zk) and torch.equal(ct, ck)


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_ids_twin_matches_jax_compact_kernel(mesh):
    """The JAX compact records, in the port's layout, through the port's
    ids resolve and through ``_launch_compact``: the same winners."""
    _, v, t, c, h, w = mesh
    ry, rx = replication_for(v, t)
    rec, _ = _plane_setup_compact(jnp.asarray(v), jnp.asarray(t),
                                  [jnp.asarray(c[:, k]) for k in range(3)])
    c2b, ccount, packed = _prepare_compact(rec, t.shape[0], h=h, w=w,
                                           ry=ry, rx=rx)
    zj, idj, _ = _launch_compact(c2b, ccount, packed, h=h, w=w,
                                 interpret=True)
    clamped, _ = _clamp_and_bins(rec, h=h, w=w, ry=1, rx=1, bbox0=_CBBOX0)
    clamped = np.asarray(clamped)
    ported = np.concatenate([clamped[:, :9], clamped[:, 10:14]], 1)
    assert ported.shape[1] == PAYLOAD0
    zt, idt = rasterize_ids_reference(*_t(ported), h=h, w=w)
    assert idt.dtype == torch.int32 and idt.shape == (h, w)
    np.testing.assert_array_equal(idt.numpy(), np.asarray(idj))
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), **DEPTH)
    # The mesh entry of kernel B3 on the CPU: the twin on the port's own
    # records, with the same winners; it counts no launch.
    before = launches["synergy_raster_mesh_ids"]
    zm, idm = rasterize_mesh_ids(*_t(v, t), h=h, w=w)
    assert launches["synergy_raster_mesh_ids"] == before
    np.testing.assert_array_equal(idm.numpy(), np.asarray(idj))
    np.testing.assert_allclose(zm.numpy(), np.asarray(zj), **DEPTH)


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_visibility_matches_jax(mesh):
    _, v, t, _, h, w = mesh
    ry, rx = replication_for(v, t)
    tj, zj, w0j = jax_visibility(v, t, h=h, w=w, ry=ry, rx=rx,
                                 interpret=True)
    tv, tt = _t(v, t)
    tri, zbuf, w0 = rasterize_triangles_tiled(tv, tt, h=h, w=w)
    assert tri.dtype == torch.int32 and tri.shape == (h, w)
    np.testing.assert_array_equal(tri.numpy(), np.asarray(tj))
    np.testing.assert_allclose(zbuf.numpy(), np.asarray(zj), **DEPTH)
    np.testing.assert_allclose(w0.numpy(), np.asarray(w0j), **PAYLOAD)
    # The ids entry without w0 resolves the same winners.
    z_ids, ids = rasterize_mesh_ids(tv, tt, h=h, w=w)
    assert torch.equal(ids, tri) and torch.equal(z_ids, zbuf)
    drawn = zbuf > DEPTH_INIT
    assert ((tri >= 0) == drawn).all() and (w0[~drawn] == 0).all()


VIS_MESHES = MESHES + [
    (f"seed{s}", *random_mesh(np.random.default_rng(s), nver=60, ntri=200),
     24, 40) for s in (31, 32, 33)]


@pytest.mark.parametrize("mesh", VIS_MESHES, ids=[m[0] for m in VIS_MESHES])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_visibility_ids_route_equals_record_route(mesh, dtype):
    """The port's visibility path (the ids resolve, then w0 of the winner)
    equals the JAX package's route, the payload resolve on records whose
    planes are the triangle id and w0 (``_visibility_records``), bit for
    bit."""
    name, v, t, _, h, w = mesh
    tv, tt = _t(v, t)
    tt = tt.to(dtype)
    tri, zbuf, w0 = rasterize_triangles_tiled(tv, tt, h=h, w=w)
    rec = _visibility_records(tv, tt, h=h, w=w)
    zr, pay = rasterize_records_reference(rec, 2, h=h, w=w)
    drawn = zr > DEPTH_INIT
    assert drawn.any() == (name != "offcanvas")
    assert torch.equal(zbuf, zr)
    assert torch.equal(tri, torch.where(drawn, pay[..., 0].to(torch.int32),
                                        torch.full_like(tri, -1)))
    assert torch.equal(w0, torch.where(drawn, pay[..., 1],
                                       torch.zeros_like(w0)))


def test_eval_deferred_payloads_edges():
    """No triangles: zeros of the payload count; undrawn pixels read 0."""
    tri = torch.full((4, 6), -1, dtype=torch.int32)
    drawn = torch.zeros((4, 6), dtype=torch.bool)
    out = eval_deferred_payloads(tri, drawn, torch.zeros((0, 3, 3)))
    assert out.shape == (4, 6, 3) and (out == 0).all()
    planes = torch.tensor([[[1.0, 2.0, 3.0]], [[0.5, -1.0, 4.0]]])
    tri[1, 2], drawn[1, 2] = 1, True
    out = eval_deferred_payloads(tri, drawn, planes)
    assert out.shape == (4, 6, 1)
    assert out[1, 2, 0] == 0.5 * 2 - 1.0 * 1 + 4.0
    assert out.sum() == out[1, 2, 0]
