"""The check, on the CPU at a size a test can hold: the program's run is
judged correct, and every fault the cells can have, and the fp8 control
in the program's place, are judged not correct by the cells' limits."""

import os

import pytest
import torch

from perfbench import harness
from perfbench.calibrate import control_numbers

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SMALL = {"mbv2.b128": {"frames_per_call": 2, "ring": 1, "check_calls": 1,
                       "check_rounds": 1},
         "mbv2.cam1": {"ring": 2, "check_calls": 2, "check_within": 3},
         "mbv2.overlay": {"ring": 2, "check_calls": 2, "check_within": 3}}


def _run(cell, seed, patch=None, monkeypatch=None):
    if patch:
        mod = harness.load_module(ROOT, "entries",
                                  harness.load_cell(ROOT, cell)[2]["entry"])
        start = mod.Entry.start

        def broken_start(self):
            start(self)
            patch(self)

        monkeypatch.setattr(mod.Entry, "start", broken_start)
        real = harness.load_module
        monkeypatch.setattr(harness, "load_module",
                            lambda root, kind, name: mod
                            if kind == "entries" else real(root, kind, name))
    return harness.run_cell(ROOT, cell, seed, 0.3, False, 0.0,
                            device="cpu", traffic_override=SMALL[cell])


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_sound_run_is_correct(cell):
    out = _run(cell, 21)
    assert out["result"]["correct"], out["check"]
    result = out["result"]
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "check"
    assert set(result["check"]) == set(
        harness.load_cell(ROOT, cell)[2]["limits"])


def _half_batch(entry):
    """Half of the batch left out: the second half's outputs copy the
    first half's."""
    engine = entry.engine
    body = engine.process_batch_eager

    def half(frames, s2d, hws):
        b = frames.shape[0]
        h = max(b // 2, 1)
        out = body(frames[:h], s2d[:h], hws[:h])
        if b == 1:                     # one frame: its faces dropped
            return (out[0], torch.zeros_like(out[1]), *out[2:])
        return tuple(torch.cat([x, x[:b - h]]) for x in out)

    engine.process_batch_eager = half


def _altered_answer(entry):
    """One face's parameters altered where the regressor produces them:
    one training deviation added to each of the first face's."""
    engine = entry.engine
    regress = engine.regress

    def altered(frames, rois):
        p = regress(frames, rois).clone()
        p[0, 0] += 1.0
        return p

    engine.regress = altered


def _altered_overlay(entry):
    """The overlay altered where the render produces it: every pixel that
    the faces cover three levels brighter."""
    render = entry.fn.render_bucket

    def altered(canvas, dense, n_faces, bucket):
        out = render(canvas, dense, n_faces, bucket)
        faces = (out != canvas.clamp(0, 255).to(torch.uint8)).any(-1)
        brighter = (out.int() + 3).clamp(max=255).to(torch.uint8)
        return torch.where(faces[..., None], brighter, out)

    entry.fn.render_bucket = altered


FAULTS = [(c, f) for c in sorted(SMALL) for f in (_half_batch,
                                                   _altered_answer)]
FAULTS.append(("mbv2.overlay", _altered_overlay))


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    out = _run(cell, 22, fault, monkeypatch)
    assert not out["result"]["correct"], out["check"]


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_control_fails_the_limits(cell):
    """The reference in fp8 in the program's place fails at least one of
    the cell's numbers."""
    limits = harness.load_cell(ROOT, cell)[2]["limits"]
    numbers = control_numbers(ROOT, cell, 23, "cpu", SMALL[cell])
    assert any(numbers[k] > v for k, v in limits.items()), numbers
