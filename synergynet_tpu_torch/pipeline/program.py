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
- launch accounting: the launch table ``launches`` of
  :mod:`synergynet_tpu_torch.ops.cuda_build` counts in Python, which a
  replay skips. The capture records each entry's increase, and every
  replay credits it again; the set-up's own calls leave the table as it
  was. So an entry reads one call's launches per call, replayed or eager.
- measurement (:mod:`synergynet_tpu_torch.core.profiling`): each program
  has its own record in the recorder, named by its key and its engine
  (:class:`ProgramCache`'s ``engine``): every call adds its bytes in and
  out (the static inputs' and outputs' sizes). The set-up is recorded as
  the spans ``synergy.warmup`` and ``synergy.capture``; the kernels'
  libraries are built and loaded before them, when the cache is made, so
  nvcc's seconds fall outside both. Under a profiler a call shows
  ``synergy.copy_in`` (the host enqueueing the copies into the static
  inputs), ``synergy.replay`` (the graph launch) and ``synergy.clone_out``
  (enqueueing the output clones): host times; the device's own are the
  stage stamps. A body run with ``stages`` stamps the boundaries between
  them; the program stamps the first point before its copy-in, the end of
  the copy-in as the graph's first node, and the last point after its
  clone-out, so a row spans the whole call on the device.

A failed capture or replay raises; nothing falls back to the eager body on
a card. On the CPU a cache runs the body eagerly (:class:`EagerProgram`)
with the same record: counters and a ring on the host clock.
"""

from __future__ import annotations

import itertools
import threading
from typing import Callable, Sequence, Tuple

import torch

from synergynet_tpu_torch.core.profiling import (ProgramStats, annotate,
                                                 recorder)
from synergynet_tpu_torch.ops.cuda_build import launches, load_kernel_library

WARMUP = 2


# The process captures one graph at a time (torch.cuda.graph's rule).
_CAPTURE_LOCK = threading.Lock()


def _nbytes(tensors: Sequence[torch.Tensor]) -> int:
    return sum(x.numel() * x.element_size() for x in tensors)


class CapturedProgram:
    """One CUDA graph of ``fn(*inputs)`` (a tuple of tensors out) over
    static copies of ``inputs``, all on one card, recorded in ``stats``.
    Built by :class:`ProgramCache`, which holds its lock. ``pool_bytes``:
    the device memory the capture reserved (its pool: intermediates and
    outputs)."""

    def __init__(self, fn: Callable, inputs: Sequence[torch.Tensor],
                 stats: ProgramStats):
        dev = inputs[0].device
        before = launches.copy()
        self.stats = stats
        seq = stats.sequence
        self.inputs = [x.clone() for x in inputs]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with recorder.setup_span("synergy.warmup"):
            with torch.cuda.stream(side):
                for _ in range(WARMUP):
                    fn(*self.inputs)
            side.synchronize()
        self.graph = torch.cuda.CUDAGraph()
        with _CAPTURE_LOCK, recorder.setup_span("synergy.capture"):
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            reserved = _reserved(dev)
            start = launches.copy()
            # The warm-up's stream, whose cuBLAS workspace exists already;
            # thread_local: another thread's eager work (an allocation, a
            # sync) does not invalidate this capture.
            with torch.cuda.graph(self.graph, stream=side,
                                  capture_error_mode="thread_local"), \
                    recorder.stamping(seq):
                if seq is not None:         # the copy-in ends here
                    seq.done(seq.stages[0])
                outputs = fn(*self.inputs)
            end = launches.copy()
            self.pool_bytes = _reserved(dev) - reserved
        torch.cuda.current_stream(dev).wait_stream(side)
        self.outputs = tuple(outputs)
        # What one replay launches; the set-up itself is not counted.
        self.credits = end - start
        launches.subtract(end - before)
        self.stream = torch.cuda.current_stream(dev)
        self.bytes_in, self.bytes_out = (_nbytes(self.inputs),
                                         _nbytes(self.outputs))
        stats.captures += 1
        stats.pool_bytes = self.pool_bytes

    def __call__(self, inputs: Sequence[torch.Tensor]
                 ) -> Tuple[torch.Tensor, ...]:
        st, seq = self.stats, self.stats.sequence
        stream = torch.cuda.current_stream(self.inputs[0].device)
        if stream != self.stream:       # the last call's work comes first
            stream.wait_stream(self.stream)
            self.stream = stream
        if seq is not None:
            seq.begin(recorder.current_call())
        with annotate("synergy.copy_in"):
            for s, x in zip(self.inputs, inputs):
                s.copy_(x)
        with annotate("synergy.replay"):
            self.graph.replay()
        with annotate("synergy.clone_out"):
            out = tuple(o.clone() for o in self.outputs)
        if seq is not None:
            seq.done(seq.stages[-1])
        launches.update(self.credits)
        st.calls += 1
        st.bytes_in += self.bytes_in
        st.bytes_out += self.bytes_out
        return out


class EagerProgram:
    """``fn`` run op by op (a CPU cache's program), recorded in ``stats``
    as a captured program is: a stamped body fills one ring row a call on
    the host clock (its ``copy_in`` interval is empty: nothing is
    copied)."""

    def __init__(self, fn: Callable, stats: ProgramStats):
        self.fn, self.stats = fn, stats

    def __call__(self, inputs: Sequence[torch.Tensor]
                 ) -> Tuple[torch.Tensor, ...]:
        st, seq = self.stats, self.stats.sequence
        if seq is not None:
            seq.begin(recorder.current_call())
            seq.done(seq.stages[0])
        with recorder.stamping(seq):
            out = tuple(self.fn(*inputs))
        if seq is not None:
            seq.done(seq.stages[-1])
        st.calls += 1
        st.bytes_in += _nbytes(inputs)
        st.bytes_out += _nbytes(out)
        return out


_ENGINES = itertools.count(1)


class ProgramCache:
    """The programs of one engine on ``device``: ``cache.run(key, fn,
    *inputs)`` captures ``fn`` on the first call of (``key``, the inputs'
    shapes and dtypes) and replays that program after (on the CPU: runs
    it eagerly); ``key`` (a string) names ``fn`` (one ``fn`` per key).
    With ``stages`` (the first the copy-in, the last the clone-out, the
    body marking those between with ``stage_done``) and ``tallies`` the
    program stamps; a stamped body takes its frames first, so a call's
    frames are its first input's leading size. Each program's record in
    the recorder is named by ``key`` and ``self.engine`` (``engine``
    numbered in the process: ``frame#1``). ``kernels``: the ``csrc``
    libraries the engine's bodies launch, built and loaded now on a card.
    Inputs on another device raise."""

    def __init__(self, device: torch.device, engine: str,
                 kernels: Sequence[str] = ()):
        self.device = torch.device(device)
        self.engine = f"{engine}#{next(_ENGINES)}"
        self.programs: dict = {}
        self.lock = threading.Lock()
        if self.device.type == "cuda":
            for name in (*kernels, "stage_stamp"):
                load_kernel_library(name)

    def run(self, key: str, fn: Callable, *inputs: torch.Tensor,
            stages: Sequence[str] = (), tallies: Sequence[str] = ()
            ) -> Tuple[torch.Tensor, ...]:
        for x in inputs:
            if x.device != self.device:
                raise ValueError(f"an input is on {x.device}; the program "
                                 f"runs on {self.device}")
        sig = (key, tuple((tuple(x.shape), x.dtype) for x in inputs))
        with self.lock:
            prog = self.programs.get(sig)
            if prog is None:
                stats = recorder.program(
                    key, self.engine, self.device, stages, tallies,
                    inputs[0].shape[0] if stages else 0)
                prog = self.programs[sig] = (
                    CapturedProgram(fn, inputs, stats)
                    if self.device.type == "cuda" else
                    EagerProgram(fn, stats))
            return prog(inputs)


def _reserved(device: torch.device) -> int:
    return torch.cuda.memory_stats(device).get("reserved_bytes.all.current",
                                               0)
