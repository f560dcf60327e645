"""The repairs of two port faults, on the CPU.

- C11: ``full_fp32`` flips the process-wide TF32 flags. It now counts its
  holders under a module lock: two threads that nest it in an interleaved
  order both see TF32 off inside, and the flags come back as they were
  before the first holder when the last one leaves; a stress run of more
  threads than cores never sees a flag on inside a holder. The f32
  ``FusedFrameEngine`` and ``make_param_extractor`` hold it; their bf16
  forms take no lock. (Flipping the flags is legal on the CPU build; the
  card test ``test_torch_gpu.py::test_f32_engine_card_matches_cpu`` holds
  the f32 engine's faces against the CPU.)
- C12: ``SynergyNet3DMM``'s positional parameters bind as the JAX class's,
  ``(arch, variables, pack, detector, dtype, seed)``, with ``device``
  after them; each positional call is run beside the JAX constructor on
  the same arguments.
"""

import inspect
import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from synergynet_tpu.core.checkpoint import \
    load_shipped_trained as jax_load_shipped_trained
from synergynet_tpu.pipeline import SynergyNet3DMM as JaxApi
from synergynet_tpu_torch.mm3d import codec, load_param_pack
from synergynet_tpu_torch.pipeline import SynergyNet3DMM

torch.set_num_threads(2)


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def _set_flags(matmul, cudnn):
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn


@pytest.fixture()
def flags_restored():
    before = _flags()
    yield
    _set_flags(*before)


# -- C11 ---------------------------------------------------------------------

@pytest.mark.parametrize("start", [(True, True), (False, True),
                                   (True, False), (False, False)])
def test_full_fp32_nests_across_threads(flags_restored, start):
    """A enters, B enters, A leaves (B still inside: TF32 stays off), B
    leaves: the flags are back at ``start``; each thread saw TF32 off at
    every step inside."""
    _set_flags(*start)
    a_in, b_in, a_out = threading.Event(), threading.Event(), \
        threading.Event()
    seen = {"a": [], "b": []}
    errors = []

    def a():
        try:
            with codec.full_fp32():
                seen["a"].append(_flags())
                a_in.set()
                assert b_in.wait(10)
                seen["a"].append(_flags())
            a_out.set()
        except BaseException as e:      # reported by the main thread
            errors.append(e)
            raise

    def b():
        try:
            assert a_in.wait(10)
            with codec.full_fp32():
                with codec.full_fp32():     # nested within the thread too
                    seen["b"].append(_flags())
                b_in.set()
                assert a_out.wait(10)
                seen["b"].append(_flags())  # A has left; B still holds
        except BaseException as e:
            errors.append(e)
            raise

    threads = [threading.Thread(target=f) for f in (a, b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20)
    assert not any(t.is_alive() for t in threads) and not errors
    assert seen["a"] == seen["b"] == [(False, False)] * 2
    assert _flags() == start
    assert codec._fp32_holders == 0


def test_full_fp32_restores_after_an_exception(flags_restored):
    _set_flags(True, True)
    with pytest.raises(RuntimeError):
        with codec.full_fp32():
            assert _flags() == (False, False)
            raise RuntimeError("inside")
    assert _flags() == (True, True) and codec._fp32_holders == 0


def test_full_fp32_stress(flags_restored):
    """More threads than cores entering and leaving in a tight loop under
    a short switch interval: no holder ever sees a flag on, and the flags
    end as they started."""
    _set_flags(True, True)
    n_threads, rounds = 16, 200
    bad = []
    start = threading.Barrier(n_threads)

    def work():
        start.wait(10)
        for _ in range(rounds):
            with codec.full_fp32():
                if _flags() != (False, False):
                    bad.append(_flags())

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not bad and _flags() == (True, True)
    assert codec._fp32_holders == 0


def test_full_fp32_if_guards_f32_only(flags_restored, monkeypatch):
    """The f32 guard is full_fp32; a bf16 net's takes no lock and leaves
    the flags alone."""
    _set_flags(True, True)
    with codec.full_fp32_if(torch.float32):
        assert _flags() == (False, False)
    assert _flags() == (True, True)
    monkeypatch.setattr(codec, "_FP32_LOCK", None)   # any use would raise
    with codec.full_fp32_if(torch.bfloat16):
        assert _flags() == (True, True)


def test_f32_engine_and_extractor_compute_with_tf32_off(flags_restored):
    """The f32 engine's detector and regressor, and the f32 extractor's
    model, run inside full_fp32; the bf16 engine's nets do not."""
    from synergynet_tpu_torch.detect.detector import (FaceBoxes,
                                                      prepare_frame,
                                                      random_init_variables)
    from synergynet_tpu_torch.evals import make_param_extractor
    from synergynet_tpu_torch.pipeline import FusedFrameEngine

    _set_flags(True, True)
    seen = []

    def spy(module):
        def hook(mod, args):
            seen.append((type(mod).__name__, _flags()))
        return module.register_forward_pre_hook(hook)

    det_variables = random_init_variables(0)
    img = np.random.default_rng(5).integers(0, 256, (120, 160, 3), np.uint8)
    for dtype, want in ((torch.float32, (False, False)),
                        (torch.bfloat16, (True, True))):
        api = SynergyNet3DMM(variables="trained", dtype=dtype, device="cpu")
        det = FaceBoxes(det_variables, dtype=dtype, device="cpu")
        eng = FusedFrameEngine(api, detector=det, max_faces=2)
        seen.clear()
        hooks = [spy(api.model), spy(det.net)]
        try:
            canvas, packed, hw, _ = prepare_frame(img, 8, "cpu")
            eng.process_batch(canvas[None], packed[None], hw[None])
        finally:
            for h in hooks:
                h.remove()
        assert sorted(n for n, _ in seen) == ["FaceBoxesNet", "SynergyNet"]
        assert all(f == want for _, f in seen), (dtype, seen)
        assert _flags() == (True, True)

    model = SynergyNet3DMM(variables="trained", device="cpu").model
    seen.clear()
    hook = spy(model)
    try:
        make_param_extractor(model, batch=2)(
            np.zeros((3, 120, 120, 3), np.uint8))
    finally:
        hook.remove()
    assert [f for _, f in seen] == [(False, False)] * 2
    assert _flags() == (True, True)


# -- C12 ---------------------------------------------------------------------

def test_positional_order_is_jax_with_device_after():
    jax_names = list(inspect.signature(JaxApi).parameters)
    names = list(inspect.signature(SynergyNet3DMM).parameters)
    assert jax_names == ["arch", "variables", "pack", "detector", "dtype",
                         "seed"]
    assert names == jax_names + ["device", "crop"]


def test_positional_arch_builds_that_family():
    """``SynergyNet3DMM("mobilenet_1")`` builds a MobileNetV1, as the JAX
    class does."""
    want = JaxApi("mobilenet_1")
    got = SynergyNet3DMM("mobilenet_1", device="cpu")
    assert want.model.arch == got.model.arch == "mobilenet_1"
    assert type(got.model.backbone).__name__ == "MobileNetV1"
    jax_leaves = {k for k in want.variables["params"]["backbone"]}
    port_leaves = {k for k in got.variables["params"]["backbone"]}
    assert port_leaves == jax_leaves


def test_positional_variables_pack_detector_dtype_seed():
    """``(arch, "trained", pack, detector, dtype, seed)`` bind as in JAX:
    the shipped weights, the given pack and detector, the dtype."""
    from synergynet_tpu_torch.detect import FaceBoxes
    pack = load_param_pack()
    det = FaceBoxes(device="cpu")
    want = JaxApi("mobilenet_v2", "trained", None, "jax-detector",
                  jnp.bfloat16, 3)
    got = SynergyNet3DMM("mobilenet_v2", "trained", pack, det,
                         torch.bfloat16, 3, "cpu")
    assert want._detector == "jax-detector" and got.detector is det
    assert want.model.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    assert got.pack is pack
    shipped = jax_load_shipped_trained("mobilenet_v2")
    for col in ("params", "batch_stats"):
        w_leaves = _leaves(shipped[col])
        g_leaves = _leaves(got.variables[col])
        j_leaves = _leaves(want.variables[col])
        assert w_leaves.keys() == g_leaves.keys() == j_leaves.keys()
        for k in w_leaves:
            np.testing.assert_array_equal(g_leaves[k], w_leaves[k])
            np.testing.assert_array_equal(np.asarray(j_leaves[k]),
                                          w_leaves[k])
    ref = SynergyNet3DMM(variables="trained", device="cpu")
    crops = np.random.default_rng(0).integers(0, 256, (2, 120, 120, 3),
                                              np.uint8)
    rois = np.asarray([[0, 0, 120, 120]] * 2, np.float32)
    f32 = SynergyNet3DMM("mobilenet_v2", "trained", device="cpu")
    assert np.array_equal(f32.process_crops(crops, rois)[0],
                          ref.process_crops(crops, rois)[0])


def _leaves(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = v
    return out


def test_positional_seed_draws_that_init():
    a = SynergyNet3DMM("mobilenet_v2", None, None, None, torch.float32, 7,
                       "cpu")
    b = SynergyNet3DMM(variables=None, seed=7, device="cpu")
    c = SynergyNet3DMM(variables=None, seed=8, device="cpu")
    la, lb, lc = (_leaves(x.variables["params"]) for x in (a, b, c))
    assert all(np.array_equal(la[k], lb[k]) for k in la)
    assert not all(np.array_equal(la[k], lc[k]) for k in la)
