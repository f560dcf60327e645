"""Greedy NMS on the port: the plain twin (the bit-packed fixpoint) and a
plain transcription of kernel N1's algorithm (the transposed suppression
rows in N1's tiled layout, then the tiled in-order walk) against the JAX
package's ``greedy_nms_mask``, bit for bit; N1's IoU test (the fast path
for plain boxes, the general path for the rest) against ``pairwise_iou(...)
>= threshold``; ``pairwise_iou``'s bitwise symmetry, which N1's row layout
relies on; what N1's wrapper refuses before it asks for a card; and that
the serving engine's eager body reads nothing from the host once NMS runs
on the device (what lets a CUDA graph capture it).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _disable_current_modes)

from synergynet_tpu.detect.nms import greedy_nms_mask as jax_nms
from synergynet_tpu_torch.detect import detector as tdetector
from synergynet_tpu_torch.detect import nms as tnms
from synergynet_tpu_torch.detect.detector import (FaceBoxes, prepare_frame,
                                                  random_init_variables)
from synergynet_tpu_torch.detect.nms import (greedy_nms_mask,
                                             greedy_nms_mask_reference,
                                             greedy_nms_walk_reference,
                                             iou_at_least, n1_layout,
                                             n1_word_index, pairwise_iou,
                                             suppression_rows)
from synergynet_tpu_torch.pipeline import (FusedFrameEngine,
                                           FusedOverlayEngine, SynergyNet3DMM,
                                           overlay_engine)
from synergynet_tpu_torch.pipeline.program import CapturedProgram
from tests.nms_cases import (CASES, THRESHOLD, nms_case, random_boxes,
                             tie_pairs)

torch.set_num_threads(2)


def _jax_keep(boxes, valid):
    return np.stack([np.asarray(jax_nms(jnp.asarray(b), jnp.asarray(v),
                                        THRESHOLD))
                     for b, v in zip(boxes, valid)])


@pytest.mark.parametrize("case", CASES)
def test_twin_and_walk_equal_jax_bit_for_bit(case):
    boxes, valid = nms_case(case)
    want = _jax_keep(boxes, valid)
    tb, tv = torch.from_numpy(boxes), torch.from_numpy(valid)
    fixpoint = greedy_nms_mask_reference(tb, tv, THRESHOLD).numpy()
    walk = greedy_nms_walk_reference(tb, tv, THRESHOLD).numpy()
    np.testing.assert_array_equal(fixpoint, want)
    np.testing.assert_array_equal(walk, want)
    # The CPU route of the entry point is the twin.
    np.testing.assert_array_equal(greedy_nms_mask(tb, tv, THRESHOLD).numpy(),
                                  want)
    assert not np.any(want & ~valid)
    if case == "chain":
        assert np.array_equal(want[0], np.arange(boxes.shape[1]) % 3 == 0)
    if case == "ties":
        # Pairs in the order exact, below, above, 4 of each: the second box
        # of a pair at IoU >= 0.3 is suppressed, the one below is kept.
        second = want[0, 1:24:2]
        assert second.tolist() == [False] * 4 + [True] * 4 + [False] * 4
        assert want[0, 0:24:2].all()
    if case == "tile_edges":
        # Nothing is kept past the last valid box; the 10 px chain across
        # the tile edge keeps every third box, the 20 px chain filling tile
        # 1 every second one (both far from the random boxes).
        last = valid.shape[1] - 1 - np.argmax(valid[:, ::-1], 1)
        assert not want[np.arange(256)[None] > last[:, None]].any()
        assert np.array_equal(want[5, 40:101], np.arange(61) % 3 == 0)
        assert np.array_equal(want[6, 64:128], np.arange(64) % 2 == 0)


def test_tie_pairs_sit_on_the_threshold():
    t = np.float32(THRESHOLD)
    got = {name: np.float32(pairwise_iou(torch.from_numpy(np.stack(p)))[0, 1])
           for name, p in tie_pairs().items()}
    assert got["exact"] == t
    assert got["below"] == np.nextafter(t, np.float32(0))
    assert got["above"] == np.nextafter(t, np.float32(1))


@pytest.mark.parametrize("case", ["random", "crowd", "duplicates", "ties",
                                  "ragged"])
def test_pairwise_iou_is_symmetric_bit_for_bit(case):
    boxes, _ = nms_case(case, k=512)
    # Degenerate and inverted boxes too: negative extents, zero areas.
    rng = np.random.default_rng(1)
    odd = rng.uniform(-20, 20, (boxes.shape[0], 64, 4)).astype(np.float32)
    iou = pairwise_iou(torch.from_numpy(np.concatenate([boxes, odd], 1)))
    bits = iou.view(torch.int32)
    assert torch.equal(bits, bits.transpose(-1, -2))


@pytest.mark.parametrize("case", ["crowd", "ragged", "ties", "holes",
                                  "wide"])
def test_suppression_rows_are_the_fixpoint_matrix_transposed(case):
    """Row r of N1's bits is column r of the fixpoint's A (A[i, j] = IoU
    >= t, j < i, valid[j]), bit c % 64 of word c // 64, at the word's place
    in N1's layout, for the words that N1 writes: tiles t and words w with
    t <= w <= the tile of the frame's last valid box. Every place of the
    scratch belongs to one word at most, and what N1 does not write is
    zero here."""
    boxes, valid = nms_case(case, k=300)
    tb, tv = torch.from_numpy(boxes), torch.from_numpy(valid)
    words = suppression_rows(tb, tv, THRESHOLD)
    f, k = valid.shape
    nt, cap = n1_layout(k)
    assert words.shape == (f, cap)
    idx = n1_word_index(tv)                          # (F, T, 64, T)
    written = idx < cap
    for fr in range(f):
        at = idx[fr][written[fr]]
        assert len(torch.unique(at)) == len(at)
        unwritten = torch.ones(cap, dtype=torch.bool)
        unwritten[at] = False
        assert not words[fr, unwritten].any()
    rows = torch.gather(torch.nn.functional.pad(words, (0, 1)), 1,
                        idx.reshape(f, -1)).reshape(f, nt * 64, nt)
    bits = (rows[..., None] >> torch.arange(64)) & 1
    bits = bits.reshape(f, nt * 64, -1)[:, :k, :k].bool()
    lower = torch.tril(torch.ones((k, k), dtype=torch.bool), -1)
    a = (pairwise_iou(tb) >= THRESHOLD) & lower & tv[:, None, :]
    last = torch.tensor([int(np.flatnonzero(v).max()) if v.any() else -1
                         for v in valid])
    cols = torch.arange(k)[None, None, :] < 64 * (last // 64 + 1)[
        :, None, None]
    assert torch.equal(bits, a.transpose(-1, -2) & cols)


# -- N1's IoU test -----------------------------------------------------------

def _ulp_walk(x, n):
    """x and its n float32 neighbours on each side."""
    out = [np.float32(x)]
    for toward in (np.float32(np.inf), np.float32(-np.inf)):
        y = np.float32(x)
        for _ in range(n):
            y = np.nextafter(y, toward)
            out.append(y)
    return out


def _near_threshold_pairs(rng, thr, n=12, ulps=6):
    """Pairs of boxes whose IoU crosses ``thr`` as the second box slides
    along x (from IoU 1 to no overlap): the crossing offset found by
    bisection in float32, then the offsets ``ulps`` ulps either side of it,
    at scales from 1e-3 to 1e5. Where the IoU never crosses ``thr`` (thr 0
    or above 1) the walk is around half the box's width."""
    a_list, b_list = [], []
    t = np.float32(thr)
    for i in range(n):
        scale = np.float32(10.0 ** rng.uniform(-3, 5))
        a = (np.array([0, 0, rng.uniform(20, 60), rng.uniform(20, 60)])
             * scale).astype(np.float32)

        def iou_at(s):
            b = a + np.array([s, 0, s, 0], np.float32)
            return float(pairwise_iou(torch.from_numpy(np.stack([a, b]))
                                      )[0, 1])

        lo, hi = np.float32(0), np.float32(2 * a[2] + 2)
        if not iou_at(lo) >= t > iou_at(hi):
            lo = hi = np.float32(a[2] / 2)
        for _ in range(80):
            mid = np.float32((lo + hi) / 2)
            if mid in (lo, hi):
                break
            lo, hi = (mid, hi) if iou_at(mid) >= t else (lo, mid)
        for s in _ulp_walk(lo, ulps):
            a_list.append(a)
            b_list.append(a + np.array([s, 0, s, 0], np.float32))
    return np.stack(a_list), np.stack(b_list)


def _pair_set(name, thr):
    rng = np.random.default_rng(7)
    f = np.float32
    if name == "ties":
        a, b = (np.stack(x) for x in zip(*tie_pairs().values()))
    elif name == "near_threshold":
        a, b = _near_threshold_pairs(rng, thr)
    elif name == "rational_ties":
        # Same x, heights 3m and 10m (+-1): inter / union is 3 / 10 in the
        # reals, or just off it, at many magnitudes, so thr * union rounds
        # to either side of inter.
        w, m, d = (x.ravel() for x in np.meshgrid(
            np.arange(1, 41), np.arange(1, 41), [-1, 0, 1]))
        z = np.zeros_like(w)
        a = np.stack([z, z, w - 1, 3 * m - 1], 1)
        b = np.stack([z, z, w - 1, 10 * m + d - 1], 1)
    elif name == "nonfinite":
        special = [np.nan, np.inf, -np.inf]
        base = random_boxes(rng, 24, span=50.0)
        a = np.repeat(base, 3, 0)
        b = np.roll(a, 1, 0).copy()
        for i in range(len(a)):
            a[i, i % 4] = special[i % 3]
            if i % 2:
                b[i, (i // 2) % 4] = special[(i // 3) % 3]
        a = np.concatenate([a, base])
        b = np.concatenate([b, base[::-1]])
    elif name == "huge":
        m = f(2.0 ** 60)
        big = [m, np.nextafter(m, f(np.inf)), f(2.0 ** 61), f(1e30),
               f(3e38), -m, f(-3e38)]
        a = random_boxes(rng, 2 * len(big), span=50.0)
        b = random_boxes(rng, 2 * len(big), span=50.0)
        for i, v in enumerate(big):
            a[i, 2] = v                     # a huge right edge
            a[len(big) + i, [0, 2]] = [-v, v]
            b[len(big) + i, [1, 3]] = [-v, v]
        a = np.concatenate([a, np.full((2, 4), m), [[-m, -m, m, m]] * 2])
        b = np.concatenate([b, np.full((2, 4), m), [[0, 0, m, m],
                                                    [-m, -m, m, m]]])
    elif name == "degenerate":
        # Zero and negative extents, areas of zero or below, tiny and
        # subnormal coordinates, unions of zero or below.
        a = np.array([[0, 0, -1, 5], [0, 0, -1, -1], [3, 3, 1, 1],
                      [0, 0, 0, 0], [1e-30, 1e-30, 2e-30, 2e-30],
                      [0, 0, 1e-45, 1e-45], [5, 5, 2, 9], [0, 0, -2, 3],
                      [0, 0, 10, 10], [-1, -1, -1, -1]], f)
        b = np.array([[0, 0, -1, 5], [0, 0, 4, 4], [2, 2, 0, 0],
                      [0, 0, 0, 0], [1e-30, 1e-30, 3e-30, 3e-30],
                      [0, 0, 1e-45, 1e-45], [4, 5, 3, 9], [0, 0, -3, 3],
                      [10, 10, 10, 10], [-1, -1, -1, -1]], f)
    elif name == "random":
        sizes = 10.0 ** rng.uniform(-3, 6, (4000, 1))
        a = (rng.uniform(-1, 1, (4000, 4)) * sizes).astype(f)
        b = (a + rng.normal(0, 0.3, (4000, 4)) * sizes).astype(f)
        a[:, 2:] = np.maximum(a[:, 2:], a[:, :2])   # mostly proper boxes
        b[:2000, 2:] = np.maximum(b[:2000, 2:], b[:2000, :2])
    else:
        raise ValueError(name)
    return a.astype(f), b.astype(f)


@pytest.mark.parametrize("thr", [THRESHOLD, 0.7, 1.0, 2.0 ** -126, 0.0,
                                 1.5])
@pytest.mark.parametrize("pairs", ["ties", "near_threshold",
                                   "rational_ties", "nonfinite", "huge",
                                   "degenerate", "random"])
def test_n1_iou_test_equals_pairwise_iou(pairs, thr):
    """N1's IoU test in plain PyTorch, its fast path (NaN-dropping min and
    max, a multiply-and-compare far from the threshold) and its general
    path, decides every pair as ``pairwise_iou(...) >= threshold`` does, in
    both orders: on the f32 ties and one ulp either side, on pairs whose
    second box slides ulp by ulp across the threshold, on pairs whose IoU
    is 3 / 10 in the reals (or just off it), on NaN and inf coordinates,
    on coordinates at and past the plain bound 2^60, on degenerate boxes,
    and on random boxes at scales from 1e-3 to 1e6; at thresholds inside
    the fast path's range [2^-126, 1] and outside it."""
    a, b = _pair_set(pairs, thr)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    iou = pairwise_iou(torch.stack([ta, tb], 1))
    want = iou[:, 0, 1] >= thr
    assert torch.equal(iou[:, 0, 1].view(torch.int32),
                       iou[:, 1, 0].view(torch.int32))
    assert torch.equal(iou_at_least(ta, tb, thr), want)
    assert torch.equal(iou_at_least(tb, ta, thr), want)
    if pairs in ("ties", "near_threshold", "rational_ties") and \
            thr == THRESHOLD:
        # The sets reach the threshold from both sides.
        assert want.any() and not want.all()


def test_n1_iou_fast_path_decides_most_pairs_without_dividing():
    """On the serving path's kind of boxes the multiply-and-compare settles
    nearly every pair, and the pairs it leaves to the division are the ones
    within 2^-20 of the threshold."""
    rng = np.random.default_rng(3)
    boxes = torch.from_numpy(random_boxes(rng, 512, span=400.0))
    a, b = boxes[:, None], boxes[None]
    ax1, ay1, ax2, ay2 = a.unbind(-1)
    bx1, by1, bx2, by2 = b.unbind(-1)
    w = torch.fmax(torch.fmin(ax2, bx2) - torch.fmax(ax1, bx1) + 1.0,
                   torch.tensor(0.0))
    h = torch.fmax(torch.fmin(ay2, by2) - torch.fmax(ay1, by1) + 1.0,
                   torch.tensor(0.0))
    inter = w * h
    uni = ((ax2 - ax1 + 1.0) * (ay2 - ay1 + 1.0)
           + (bx2 - bx1 + 1.0) * (by2 - by1 + 1.0) - inter)
    p = torch.tensor(THRESHOLD, dtype=torch.float32) * uni
    hi = p * torch.tensor(1 + 2.0 ** -20, dtype=torch.float32)
    lo = p * torch.tensor(1 - 2.0 ** -20, dtype=torch.float32)
    divided = ~((inter >= hi) | (inter <= lo))
    assert float(divided.float().mean()) < 1e-3
    q = (inter.double() / uni.double())[divided]
    assert bool(((q - THRESHOLD).abs() <= 2.0 ** -19).all())
    assert torch.equal(iou_at_least(a, b, THRESHOLD),
                       pairwise_iou(boxes) >= THRESHOLD)


def test_n1_wrapper_refuses_before_asking_for_a_card():
    boxes, valid = (torch.from_numpy(a) for a in nms_case("ragged"))
    with pytest.raises(TypeError):
        tnms._launch(boxes.double(), valid, THRESHOLD)
    with pytest.raises(TypeError):
        tnms._launch(boxes, valid.to(torch.uint8), THRESHOLD)
    with pytest.raises(ValueError):
        tnms._launch(boxes[:, :50], valid, THRESHOLD)
    with pytest.raises(ValueError):
        tnms._launch(boxes.transpose(0, 1).contiguous().transpose(0, 1),
                     valid, THRESHOLD)
    big = tnms.N1_MAX_K + 1
    with pytest.raises(ValueError, match="at most"):
        tnms._launch(torch.zeros((1, big, 4)),
                     torch.ones((1, big), dtype=torch.bool), THRESHOLD)
    with pytest.raises(ValueError, match="no greedy NMS"):
        greedy_nms_mask(boxes.to("meta"), valid.to("meta"), THRESHOLD)


# -- the eager serving body reads nothing from the host -----------------------

class _NoHostRead(TorchDispatchMode):
    """Fails on every op that reads a tensor's value on the host or moves a
    tensor between devices, and on a host-made constant of more than one
    value (on a card, a blocking copy)."""

    READS = {"aten._local_scalar_dense", "aten.equal", "aten.is_nonzero",
             "aten.item"}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket._qualified_op_name.replace("::", ".")
        if name in self.READS:
            raise AssertionError(f"host read: {func}")
        if name == "aten.lift_fresh" and args[0].dim() > 0:
            raise AssertionError(
                f"a host-made constant {tuple(args[0].shape)}")
        out = func(*args, **kwargs)
        if name in ("aten._to_copy", "aten.copy_", "aten.to") and \
                torch.is_tensor(out) and torch.is_tensor(args[0]) and \
                out.device != (args[1].device if name == "aten.copy_"
                               else args[0].device):
            raise AssertionError(f"a copy between devices: {func}")
        return out


@pytest.fixture(scope="module")
def cpu_engine():
    api = SynergyNet3DMM(variables="trained", device="cpu")
    det = FaceBoxes(random_init_variables(0), device="cpu")
    return FusedFrameEngine(api, detector=det, max_faces=2)


def test_eager_body_makes_no_host_read_once_nms_is_on_the_device(
        cpu_engine, monkeypatch):
    """``process_batch_eager`` at the serving size (one 720x1088 frame),
    with greedy NMS patched to N1's walk (the fixpoint twin's convergence
    test is the host read that N1 removes), runs under a dispatch mode that
    fails on any host read, and gives the twin's outputs."""
    img = np.random.default_rng(5).integers(0, 256, (720, 1088, 3),
                                            np.uint8)
    canvas, packed, hw, _ = prepare_frame(img, 8, "cpu")
    args = (canvas[None], packed[None], hw[None])
    want = cpu_engine.process_batch(*args)
    with pytest.raises(AssertionError, match="host read"), _NoHostRead():
        cpu_engine.process_batch_eager(*args)
    monkeypatch.setattr(tdetector, "greedy_nms_mask",
                        greedy_nms_walk_reference)
    with _NoHostRead():
        got = cpu_engine.process_batch_eager(*args)
    assert int(got[1][0]) > 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_no_host_read_mode_sees_a_host_made_constant():
    """The mode catches what the two hoisted constants were: a vector made
    on the host per call (on a card, a blocking copy)."""
    x = torch.ones(4)
    with pytest.raises(AssertionError, match="host-made constant"), \
            _NoHostRead():
        x * torch.tensor([1.0, 2.0, 3.0, 4.0])
    with _NoHostRead():
        torch.minimum(x, torch.tensor(6.0))     # a 0-dim operand: a scalar


def test_cpu_process_batch_captures_nothing(cpu_engine):
    img = np.random.default_rng(6).integers(0, 256, (480, 640, 3), np.uint8)
    canvas, packed, hw, _ = prepare_frame(img, 8, "cpu")
    a = cpu_engine.process_batch(canvas[None], packed[None], hw[None])
    b = cpu_engine.process_batch_eager(canvas[None], packed[None], hw[None])
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    # the CPU's programs run the body eagerly: no graph is captured
    assert not any(isinstance(p, CapturedProgram)
                   for p in cpu_engine.programs.programs.values())


def test_overlay_render_body_makes_no_host_read(cpu_engine, monkeypatch):
    """The overlay's render program body (``render_bucket``: the face count
    a device tensor) equals the eager render bit for bit at one and two
    faces, and once its constants exist (the set-up's warm-up makes them)
    it reads nothing from the host. The raster runs outside the mode: on a
    card it is kernel B2, one launch; its CPU twin reads the host."""
    ov = FusedOverlayEngine(cpu_engine)
    u = cpu_engine.api.pack.u.reshape(-1, 3).T          # (3, N) mean face
    dense = torch.stack([u * 0.3 + 40.0,                 # 2 ~30 px faces
                         u * 0.3 + 100.0]).contiguous()
    canvas = torch.from_numpy(np.random.default_rng(3).integers(
        0, 256, (160, 200, 3)).astype(np.float32))
    frame_u8 = canvas.clamp(0, 255).to(torch.uint8)
    raster = overlay_engine.rasterize_buffers_tiled

    def raster_outside_the_mode(*args, **kwargs):
        with _disable_current_modes():
            return raster(*args, **kwargs)

    for n in (1, 2):
        want, _ = ov.render(frame_u8, dense, n)
        n_t = torch.tensor(n)
        assert torch.equal(ov.render_bucket(canvas, dense, n_t, n), want)
        with monkeypatch.context() as m, _NoHostRead():
            m.setattr(overlay_engine, "rasterize_buffers_tiled",
                      raster_outside_the_mode)
            got = ov.render_bucket(canvas, dense, n_t, n)
        assert torch.equal(got, want)
        assert not torch.equal(got, frame_u8)
