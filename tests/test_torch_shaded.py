"""The port's shaded synthetic crops against the JAX package's.

The render pieces (blob fields, shading, dot mask) take the same seeded
landmarks in both packages; the fields and colours agree to rtol 1e-5 /
atol 1e-5 (fp32 products summed in another order) and the dot mask
exactly. Whole crops take JAX's own light, base and noise, drawn here with
``jax.random`` exactly as ``_render_one`` draws them, through the port's
render core: the uint8 pixels may differ by 1 where a value rounds at a
half, on at most 0.1% of them, and the dots are equal.

The port draws its lighting and noise from its own keyed hash, not from
threefry, so the crops of a seed are the port's own; the tests hold those
draws bit-stable per (key, index), and the materialized and streaming
crops pixel-identical (fault C5), and n = 0 returns empty arrays (C4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synergynet_tpu.data import shaded as jshaded
from synergynet_tpu.data.synthetic import sample_params as jsample
from synergynet_tpu.mm3d import decode_landmarks as jdecode
from synergynet_tpu.mm3d import load_param_pack as jload_pack
from synergynet_tpu_torch.data import GeneratedCropDataset, keyed
from synergynet_tpu_torch.data import shaded as tshaded
from synergynet_tpu_torch.data.synthetic import (make_crops_with_params,
                                                 make_synthetic_aflw2000)
from synergynet_tpu_torch.mm3d import load_param_pack

torch.set_num_threads(2)

FIELD_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def pack():
    return load_param_pack()


def _landmarks(n, seed):
    """Decoded landmarks of seeded params (the JAX decode; the port's
    agrees to ~1e-5 px, test_torch_mm3d.py)."""
    p = jsample(np.random.default_rng(seed), n)
    return np.array(jdecode(jnp.asarray(p), jload_pack()))


def _jax_draws(key, idx, size=120):
    """The per-crop draws of ``shaded._render_one``, as it draws them."""
    def one(k):
        kl, kb, kn = jax.random.split(k, 3)
        lxy = jax.random.uniform(kl, (2,), minval=-0.6, maxval=0.6)
        light = jnp.concatenate([lxy, jnp.ones((1,), jnp.float32)])
        light = light / jnp.linalg.norm(light)
        base = jax.random.randint(kb, (1, 1, 3), 40, 90, jnp.int32)
        noise = jax.random.randint(kn, (size, size, 3), 0, 30, jnp.int32)
        return light, base.reshape(3), noise
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(idx)
    return [np.asarray(a) for a in jax.vmap(one)(keys)]


@pytest.mark.parametrize("seed", [0, 3])
def test_fields_shade_and_dots_match_jax(seed):
    lmk = _landmarks(8, seed)
    want = jax.vmap(lambda l: jshaded._blob_fields(l, 120))(jnp.asarray(lmk))
    got = tshaded._blob_fields(torch.from_numpy(lmk), 120)
    for name, w, g in zip(("cover", "zfield", "tint"), want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **FIELD_TOL)
    light = np.random.default_rng(seed).normal(size=(8, 3)).astype(
        np.float32)
    light /= np.linalg.norm(light, axis=1, keepdims=True)
    want_c = jax.vmap(jshaded._shade)(want[1], want[2], jnp.asarray(light))
    got_c = tshaded._shade(got[1], got[2], torch.from_numpy(light))
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c),
                               **FIELD_TOL)
    want_m = jax.vmap(lambda l: jshaded._dot_mask(l, 120))(jnp.asarray(lmk))
    np.testing.assert_array_equal(
        tshaded._dot_mask(torch.from_numpy(lmk), 120).numpy(),
        np.asarray(want_m))


def test_dot_mask_clips_and_rounds_as_jax():
    """Rounded half to even, clipped to [0, size - 2], out of bounds too."""
    lmk = np.asarray([[[2.4, 7.6, -5.0, 30.0, 2.5, 3.5],
                       [3.0, 0.0, 4.0, 9.9, 6.5, 6.5],
                       [0.0] * 6]], np.float32)
    want = np.asarray(jshaded._dot_mask(jnp.asarray(lmk[0]), 10))
    got = tshaded._dot_mask(torch.from_numpy(lmk), 10)[0].numpy()
    np.testing.assert_array_equal(got, want)
    assert got[6:8, 2:4].all() and got[6:8, 4:6].all()


@pytest.mark.parametrize("seed", [1, 4])
def test_crops_match_jax_with_jax_draws(seed):
    n = 16
    lmk = _landmarks(n, seed)
    key, idx = jax.random.PRNGKey(seed), jnp.arange(n, dtype=jnp.int32)
    want = np.asarray(jshaded._render_shaded(jnp.asarray(lmk), key, idx=idx))
    light, base, noise = _jax_draws(key, idx)
    got = tshaded.render_from(torch.from_numpy(lmk), torch.from_numpy(light),
                              torch.from_numpy(base).long(),
                              torch.from_numpy(noise).long()).numpy()
    assert got.shape == want.shape == (n, 120, 120, 3)
    assert got.dtype == np.uint8
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3
    dots = np.asarray(jax.vmap(lambda l: jshaded._dot_mask(l, 120))(
        jnp.asarray(lmk)))
    np.testing.assert_array_equal(got[dots], want[dots])
    np.testing.assert_array_equal(
        got[dots], np.broadcast_to(np.asarray(tshaded.DOT_BGR, np.uint8),
                                   got[dots].shape))


def test_keyed_draws_are_stable_per_key_and_index():
    key = keyed.make_key(5)
    a = keyed.bits(key, torch.tensor([3, 17, 5, 900000]), 40)
    b = keyed.bits(key, torch.tensor([900000, 5, 17, 3, 8]), 40)
    torch.testing.assert_close(a, b[[3, 2, 1, 0]], rtol=0, atol=0)
    assert a.dtype == torch.int64 and 0 <= int(a.min()) and \
        int(a.max()) < 2 ** 32
    assert not torch.equal(a, keyed.bits(keyed.make_key(6), torch.tensor(
        [3, 17, 5, 900000]), 40))
    assert keyed.make_key(5, 0) != keyed.make_key(5, 1) != keyed.make_key(5)
    lxy, base, noise = tshaded.shaded_draws(key, torch.arange(64))
    l2, b2, n2 = tshaded.shaded_draws(key, torch.arange(63, -1, -1))
    for x, y in ((lxy, l2), (base, b2), (noise, n2)):
        torch.testing.assert_close(x, y.flip(0), rtol=0, atol=0)
    assert float(lxy.min()) >= -0.6 and float(lxy.max()) < 0.6
    light = tshaded.light_from(lxy)
    torch.testing.assert_close(light[:, :2] / light[:, 2:], lxy)
    torch.testing.assert_close(light.norm(dim=1), torch.ones(64))
    assert set(base.unique().tolist()) <= set(range(40, 90))
    assert set(noise.unique().tolist()) == set(range(30))


def test_crop_is_the_same_in_any_batch(pack):
    """A crop's pixels depend on its (key, index) only, not on its batch
    or its place in it."""
    lmk = torch.from_numpy(_landmarks(6, 2))
    idx = torch.tensor([10, 11, 12, 13, 14, 15])
    whole = tshaded._render_shaded(lmk, 9, idx)
    order = torch.tensor([4, 0, 5, 2])
    part = tshaded._render_shaded(lmk[order], 9, idx[order])
    torch.testing.assert_close(part, whole[order], rtol=0, atol=0)
    params = torch.from_numpy(jsample(np.random.default_rng(2), 6))
    torch.testing.assert_close(
        tshaded.render_shaded_crops(params, pack, 9, idx),
        tshaded._render_shaded(
            torch.from_numpy(tshaded.decode_chunked(params.numpy(), pack,
                                                    "cpu")), 9, idx),
        rtol=0, atol=0)


def test_render_looks_like_a_lit_surface(pack):
    """As the JAX test: the surface covers much of the crop, its shading
    varies, and another key gives other lighting and background."""
    params = torch.from_numpy(jsample(np.random.default_rng(5), 4))
    img = tshaded.render_shaded_crops(params, pack, 0).numpy()
    assert (img.max(-1) > 119).mean() > 0.25
    assert img[img.max(-1) > 119].astype(np.float32).std() > 10.0
    other = tshaded.render_shaded_crops(params, pack, 9).numpy()
    assert (other != img).mean() > 0.1


def test_make_shaded_crops_contract(pack):
    """n % 256 != 0 (a padded last chunk), the dots contract's keys and
    shapes, the parameters of the JAX package's seed, and
    ``make_crops_with_params(appearance="shaded")`` delegating."""
    d = tshaded.make_shaded_crops(260, pack, seed=2, device="cpu")
    assert d["images"].shape == (260, 120, 120, 3)
    assert d["images"].dtype == np.uint8
    assert d["params"].shape == (260, 62) and d["landmarks"].shape == (
        260, 3, 68)
    np.testing.assert_array_equal(d["params"],
                                  jsample(np.random.default_rng(2), 260))
    d2 = make_crops_with_params(260, pack, seed=2, appearance="shaded",
                                device="cpu")
    for k in d:
        np.testing.assert_array_equal(d2[k], d[k], err_msg=k)
    lxy, base, noise = tshaded.shaded_draws(keyed.make_key(2),
                                            torch.tensor([259]))
    np.testing.assert_array_equal(
        d["images"][259], tshaded.render_from(
            torch.from_numpy(d["landmarks"][259:]), tshaded.light_from(lxy),
            base, noise)[0].numpy())


def test_make_shaded_crops_of_none_is_empty(pack):
    """Fault C4: the JAX function raises at n = 0; the port returns empty
    arrays of the contract's shapes."""
    d = tshaded.make_shaded_crops(0, pack, device="cpu")
    assert d["images"].shape == (0, 120, 120, 3)
    assert d["images"].dtype == np.uint8
    assert d["params"].shape == (0, 62) and d["params"].dtype == np.float32
    assert d["landmarks"].shape == (0, 3, 68)
    assert make_crops_with_params(0, pack, appearance="shaded", device="cpu")[
        "images"].shape == (0, 120, 120, 3)


def test_materialized_equals_streaming(pack):
    """Fault C5: the same (seed, index) gives the same pixels from
    ``make_shaded_crops`` and from the streaming dataset, whatever order
    and batch the stream fetches it in."""
    n, seed = 300, 6
    mat = tshaded.make_shaded_crops(n, pack, seed=seed, device="cpu")
    ds = GeneratedCropDataset(n, pack, seed=seed, appearance="shaded",
                              device="cpu")
    np.testing.assert_array_equal(ds.params, mat["params"])
    np.testing.assert_array_equal(ds.lmk, mat["landmarks"])
    order = np.random.default_rng(0).permutation(n)
    for part in np.array_split(order, 3):
        np.testing.assert_array_equal(ds.generate_images(part),
                                      mat["images"][part])
    img, p = ds[17]
    np.testing.assert_array_equal(img, mat["images"][17])
    np.testing.assert_array_equal(p, mat["params"][17])


def test_shaded_eval_pack_passes_its_self_check(pack):
    """The AFLW2000-protocol pack on shaded crops: the same ground truth as
    the dots pack, and scoring it gives ~0 NME."""
    from synergynet_tpu_torch.evals import benchmark_params
    ep = make_synthetic_aflw2000(32, pack, seed=11, appearance="shaded",
                                 device="cpu")
    dots = make_synthetic_aflw2000(32, pack, seed=11, device="cpu")
    for k in ("params", "roi_boxes", "pts68_gt", "yaws", "skip_indices"):
        np.testing.assert_array_equal(ep[k], dots[k], err_msg=k)
    assert ep["images"].shape == (32, 120, 120, 3)
    assert not np.array_equal(ep["images"], dots["images"])
    assert benchmark_params(ep["params"], ep)["nme_mean"] < 0.5
