"""The port's device augmentation against the JAX package's.

JAX's ``device_augment`` draws its factors, op order, occlusion coins and
kinds from a key; the test draws them from the same key exactly as the
function does and feeds them to the port's core (``augment_from``). Each
of the 6 op orders and each of the 7 occlusion kinds is reached.

The float outputs agree to atol 1e-3. The gray and the mean luma are
rounded to integers, so where one lands within a float32 ulp of a half
the reference itself is not fixed: XLA fuses the same ops differently
inside ``device_augment``'s switch than in a separate program, and the two
JAX compilations then differ by a whole gray level times (1 - f). The
port sums and rounds as the separate program does (the luma as a chain of
fused multiply-adds, the blends fused); where JAX's two compilations
differ by more than 1e-3 the port must equal one of them within 1e-3.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synergynet_tpu_torch.data import device_augment
from synergynet_tpu_torch.data.device_augment import (_PERMS, augment_from,
                                                      occlusion_masks)

jaug = importlib.import_module("synergynet_tpu.data.device_augment")

torch.set_num_threads(2)
ATOL = 1e-3


def _jax_draws(key, b, jitter=(0.4, 0.4, 0.4), prob=0.01):
    """``device_augment``'s draws, as it draws them."""
    k_f, k_perm, k_on, k_kind = jax.random.split(key, 4)
    lows = jnp.asarray([max(0.0, 1 - j) for j in jitter])
    highs = jnp.asarray([1 + j for j in jitter])
    f = jax.random.uniform(k_f, (b, 3)) * (highs - lows) + lows
    perm = int(jax.random.randint(k_perm, (), 0, len(_PERMS)))
    kind = jax.random.randint(k_kind, (b,), 0, 7)
    occ = jax.random.uniform(k_on, (b,)) < prob
    return np.array(f), perm, np.array(occ), np.array(kind)


def _key_with_perm(perm, start=0):
    for s in range(start, start + 1000):
        if _jax_draws(jax.random.PRNGKey(s), 1)[1] == perm:
            return jax.random.PRNGKey(s)
    raise AssertionError(f"no key draws perm {perm}")


def _jax_chain(images, f, perm, occ, kind, border):
    """The same ops as a program of its own (no switch), masked after."""
    def chain(x, f):
        img = x.astype(jnp.float32)
        ops = (jaug._brightness, jaug._contrast, jaug._saturation)
        for i in _PERMS[perm]:
            img = ops[i](img, f[:, i])
        return jnp.clip(img, 0.0, 255.0)
    out = np.asarray(jax.jit(chain)(jnp.asarray(images), jnp.asarray(f)))
    _, h, w, _ = images.shape
    interior, masks = occlusion_masks(h, w, border, "cpu")
    keep = np.where(occ[:, None, None], masks.numpy()[kind],
                    True) & interior.numpy()
    return out * keep[..., None]


def _check(images, key, prob, border=5):
    f, perm, occ, kind = _jax_draws(key, len(images), prob=prob)
    want = np.asarray(jaug.device_augment(jnp.asarray(images), key,
                                          occlusion_prob=prob,
                                          border=border))
    got = augment_from(torch.from_numpy(images), torch.from_numpy(f),
                       _PERMS[perm], torch.from_numpy(occ),
                       torch.from_numpy(kind).long(), border).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    off = np.abs(got - want) > ATOL
    if off.any():
        alt = _jax_chain(images, f, perm, occ, kind, border)
        ambiguous = np.abs(alt - want) > ATOL
        assert not (off & ~ambiguous).any(), np.abs(got - want)[
            ~ambiguous].max()
        np.testing.assert_allclose(got[off], alt[off], rtol=0, atol=ATOL)
    return perm, occ, kind


@pytest.mark.parametrize("perm", range(len(_PERMS)))
def test_each_op_order_matches_jax(perm):
    images = np.random.default_rng(perm).integers(0, 256, (12, 120, 120, 3),
                                                  np.uint8)
    got_perm, occ, _ = _check(images, _key_with_perm(perm), prob=0.3)
    assert got_perm == perm and occ.any() and not occ.all()


def test_every_occlusion_kind_matches_jax():
    images = np.random.default_rng(9).integers(0, 256, (40, 120, 120, 3),
                                               np.uint8)
    _, occ, kind = _check(images, jax.random.PRNGKey(4), prob=1.0)
    assert occ.all() and set(kind.tolist()) == set(range(7))


def test_kinds_and_border_are_the_reference_masks():
    """Kind 3 keeps the top-left quadrant as kind 0 (the reference's
    ``rdown``, quirk Q2); the border and each kind on a flat image."""
    imgs = torch.full((7, 40, 40, 3), 200, dtype=torch.uint8)
    out = augment_from(imgs, torch.ones((7, 3)), (0, 1, 2),
                       torch.ones(7, dtype=torch.bool), torch.arange(7),
                       border=0)
    kept = out[..., 0] > 0
    torch.testing.assert_close(kept[3], kept[0])
    assert kept[0, :20, :20].all() and not kept[0, 20:].any()
    assert kept[4, :, :20].all() and not kept[4, :, 20:].any()
    assert kept[6, 10:30, 10:30].all() and not kept[6, :10].any()
    out = augment_from(imgs, torch.ones((7, 3)), (0, 1, 2),
                       torch.zeros(7, dtype=torch.bool), torch.arange(7))
    assert (out[:, :5] == 0).all() and (out[:, :, -5:] == 0).all()
    assert (out[:, 5:-5, 5:-5] == 200).all()


def test_each_op_matches_the_host_transform_within_rounding():
    """As the JAX test: at a fixed factor each op is within float-vs-PIL
    rounding (1.5 LSB) of the host transform's."""
    from synergynet_tpu_torch.data.transforms import (adjust_brightness,
                                                      adjust_contrast,
                                                      adjust_saturation)
    img = np.random.default_rng(0).integers(0, 255, (1, 24, 24, 3), np.uint8)
    f = torch.full((1, 3), 1.3)
    for i, host in enumerate((adjust_brightness, adjust_contrast,
                              adjust_saturation)):
        got = augment_from(torch.from_numpy(img), f, (i,),
                           torch.zeros(1, dtype=torch.bool),
                           torch.zeros(1, dtype=torch.long), border=0)
        want = host(img[0], 1.3).astype(np.float32)
        assert np.abs(got[0].numpy() - want).max() <= 1.5, host.__name__


def test_device_augment_draws_from_its_seed():
    imgs = torch.from_numpy(np.random.default_rng(1).integers(
        1, 255, (6, 120, 120, 3), np.uint8))
    a = device_augment(imgs, 5)
    assert a.shape == (6, 120, 120, 3) and a.dtype == torch.float32
    assert float(a.min()) >= 0 and float(a.max()) <= 255
    assert (a[:, :5] == 0).all() and (a[:, :, -5:] == 0).all()
    torch.testing.assert_close(device_augment(imgs, 5), a, rtol=0, atol=0)
    assert not torch.equal(device_augment(imgs, 6), a)
    full = device_augment(torch.full((8, 40, 40, 3), 200, dtype=torch.uint8),
                          2, occlusion_prob=1.0, border=0)
    assert ((full == 0).all(-1).float().mean(dim=(1, 2)) > 0.2).all()
    plain = device_augment(imgs, 5, jitter=(0.0, 0.0, 0.0),
                           occlusion_prob=0.0, border=0)
    torch.testing.assert_close(plain, imgs.float(), rtol=0, atol=0)
