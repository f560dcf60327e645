"""Greedy NMS on the port: the plain twin (the bit-packed fixpoint) and a
plain transcription of kernel N1's algorithm (the transposed suppression
rows, then the in-order walk) against the JAX package's
``greedy_nms_mask``, bit for bit; ``pairwise_iou``'s bitwise symmetry,
which N1's row layout relies on; what N1's wrapper refuses before it asks
for a card; and that the serving engine's eager body reads nothing from
the host once NMS runs on the device (what lets a CUDA graph capture it).
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
                                             pairwise_iou, suppression_rows)
from synergynet_tpu_torch.pipeline import (FusedFrameEngine,
                                           FusedOverlayEngine, SynergyNet3DMM,
                                           overlay_engine)
from tests.nms_cases import CASES, THRESHOLD, nms_case, tie_pairs

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


@pytest.mark.parametrize("case", ["crowd", "ragged", "ties"])
def test_suppression_rows_are_the_fixpoint_matrix_transposed(case):
    """Row r of N1's bits is column r of the fixpoint's A (A[i, j] = IoU
    >= t, j < i, valid[j]), bit c % 64 of word c // 64."""
    boxes, valid = nms_case(case, k=300)
    tb, tv = torch.from_numpy(boxes), torch.from_numpy(valid)
    rows = suppression_rows(tb, tv, THRESHOLD)
    k = boxes.shape[1]
    assert rows.shape == (boxes.shape[0], k, -(-k // 64))
    bits = (rows[..., None] >> torch.arange(64)) & 1
    bits = bits.reshape(boxes.shape[0], k, -1)[..., :k].bool()
    lower = torch.tril(torch.ones((k, k), dtype=torch.bool), -1)
    a = (pairwise_iou(tb) >= THRESHOLD) & lower & tv[:, None, :]
    assert torch.equal(bits, a.transpose(-1, -2))


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
    assert cpu_engine.programs.programs == {}


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
