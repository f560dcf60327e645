"""Captured programs: one CUDA graph per input signature.

The JAX package runs its serving path as one compiled program per batch
size (``synergynet_tpu/pipeline/api.py``: ``FusedFrameEngine._build`` and
``_fused_batch_program``; ``overlay_engine.py``:
``FusedOverlayEngine._build``).
The port's counterpart is a CUDA graph of the eager body, captured once per
key (the inputs' shapes and dtypes, and any extra key the caller adds) and
replayed after:

- static inputs: device buffers that each call copies its inputs into;
- set-up, on the first call of a key: ``WARMUP`` eager calls on a side
  stream (cuDNN and cuBLAS pick their algorithms, the kernels' libraries
  load and set their shared-memory attributes, constants reach the
  device), then the capture of one call under ``torch.cuda.graph`` into a
  memory pool of the key's own;
- the replay: copy in, replay, and return clones of the outputs, so one
  call's outputs survive the next call, as JAX's fresh arrays do;
- one lock around set-up, copy-in, replay and clone-out, so concurrent
  callers serialize instead of racing on the static buffers;
- launch accounting: a kernel wrapper's ``launches`` counter runs in
  Python, which a replay skips. The capture records each counter's
  increase, and every replay credits it again; the set-up's own calls
  leave the counters as they were. So a counter reads one call's launches
  per call, replayed or eager.

A failed capture or replay raises; nothing falls back to the eager body on
a card. The CPU runs the eager body (the callers route by device).
"""

from __future__ import annotations

import threading
from typing import Callable, Sequence, Tuple

import torch

WARMUP = 2


def launch_counters() -> Tuple[Tuple[object, str], ...]:
    """Every kernel wrapper's launch counter, as (holder, attribute)."""
    from synergynet_tpu_torch.detect.nms import greedy_nms_mask
    from synergynet_tpu_torch.detect.stem_fused import fused_stem1_s2d8
    from synergynet_tpu_torch.ops.fused_decode import decode_dense_fused
    from synergynet_tpu_torch.render.raster_tiled import (rasterize_mesh,
                                                          rasterize_mesh_ids)
    return ((decode_dense_fused, "launches"),
            (fused_stem1_s2d8, "launches"),
            (fused_stem1_s2d8, "launches_f32"),
            (greedy_nms_mask, "launches"),
            (rasterize_mesh, "launches"),
            (rasterize_mesh_ids, "launches"))


def _read(counters) -> Tuple[int, ...]:
    return tuple(getattr(h, a) for h, a in counters)


def _credit(counters, amounts) -> None:
    for (h, a), n in zip(counters, amounts):
        if n:
            setattr(h, a, getattr(h, a) + n)


# The process captures one graph at a time (torch.cuda.graph's rule).
_CAPTURE_LOCK = threading.Lock()


class CapturedProgram:
    """One CUDA graph of ``fn(*inputs)`` (a tuple of tensors out) over
    static copies of ``inputs``, all on one card. Built by
    :class:`ProgramCache`, which holds its lock. ``pool_bytes``: the device
    memory the capture reserved (its pool: intermediates and outputs)."""

    def __init__(self, fn: Callable, inputs: Sequence[torch.Tensor]):
        dev = inputs[0].device
        counters = launch_counters()
        before = _read(counters)
        self.inputs = [x.clone() for x in inputs]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP):
                fn(*self.inputs)
        self.graph = torch.cuda.CUDAGraph()
        with _CAPTURE_LOCK:
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            reserved = _reserved(dev)
            start = _read(counters)
            # The warm-up's stream, whose cuBLAS workspace exists already;
            # thread_local: another thread's eager work (an allocation, a
            # sync) does not invalidate this capture.
            with torch.cuda.graph(self.graph, stream=side,
                                  capture_error_mode="thread_local"):
                outputs = fn(*self.inputs)
            end = _read(counters)
            self.pool_bytes = _reserved(dev) - reserved
        torch.cuda.current_stream(dev).wait_stream(side)
        self.outputs = tuple(outputs)
        # What one replay launches; the set-up itself is not counted.
        self.credits = tuple(e - s for e, s in zip(end, start))
        _credit(counters, [b - e for b, e in zip(before, end)])
        self.counters = counters
        self.stream = torch.cuda.current_stream(dev)

    def __call__(self, inputs: Sequence[torch.Tensor]
                 ) -> Tuple[torch.Tensor, ...]:
        stream = torch.cuda.current_stream(self.inputs[0].device)
        if stream != self.stream:       # the last call's work comes first
            stream.wait_stream(self.stream)
            self.stream = stream
        for s, x in zip(self.inputs, inputs):
            s.copy_(x)
        self.graph.replay()
        out = tuple(o.clone() for o in self.outputs)
        _credit(self.counters, self.credits)
        return out


class ProgramCache:
    """The captured programs of one engine on ``device``:
    ``cache.run(key, fn, *inputs)`` captures ``fn`` on the first call of
    (``key``, the inputs' shapes and dtypes) and replays that program
    after; ``key`` names ``fn`` (one ``fn`` per key). Inputs on another
    device raise."""

    def __init__(self, device: torch.device):
        self.device = device
        self.programs: dict = {}
        self.lock = threading.Lock()

    def run(self, key, fn: Callable, *inputs: torch.Tensor
            ) -> Tuple[torch.Tensor, ...]:
        for x in inputs:
            if x.device != self.device:
                raise ValueError(f"an input is on {x.device}; the program "
                                 f"runs on {self.device}")
        sig = (key, tuple((tuple(x.shape), x.dtype) for x in inputs))
        with self.lock:
            prog = self.programs.get(sig)
            if prog is None:
                prog = self.programs[sig] = CapturedProgram(fn, inputs)
            return prog(inputs)


def _reserved(device: torch.device) -> int:
    return torch.cuda.memory_stats(device).get("reserved_bytes.all.current",
                                               0)
