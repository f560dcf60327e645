"""Profiling: device traces, the serving path's spans, stage stamps and
counters, stage timers.

Counterpart, for the card, of ``synergynet_tpu/core/profiling.py``
(``:27-107``):

- :func:`trace` records the enclosed region under ``torch.profiler`` (CPU
  and, where there is a card, CUDA activity) and writes a Chrome trace
  into a directory;
- :class:`StageTimer` times named stages: CUDA events on the card, the
  host clock on the CPU; :func:`device_memory_stats` reads the card's
  allocator.

The serving path measures itself through one process-wide
:class:`Recorder`, :data:`recorder`:

- spans (:func:`annotate`, named ``synergy.<layer>``): while no
  ``torch.profiler`` runs, a span costs one check and records nothing;
  while one runs, it is a ``record_function`` range in the profiler's trace
  (on the same timeline as the device ops it launches) and a
  :class:`Span` in the recorder, numbered by the call it belongs to. The
  set-up spans of a captured program (``synergy.warmup``,
  ``synergy.capture``) are recorded always;
- per program (:class:`ProgramStats`, one for each captured program of
  each engine, kept by the recorder): host counters (calls, bytes in and
  out, captures, pool bytes) and, for a body that names its stages, a
  :class:`StageSequence`: the body marks its stage boundaries with
  :func:`stage_done`; on a card each mark is a one-thread kernel
  (``csrc/stage_stamp.cu``, ``stage_stamp`` in a trace) that writes the
  device's global timer into the program's ring of 64 rows on the device,
  a row per call; on the CPU the host clock goes into a CPU ring the same
  way. The body's :func:`tally` adds what it served into the same device
  tensor, all of the program's tallies at once or some of them by name.
  Only the body that its program captures (or runs, on the CPU) stamps: a
  stage called on its own, or a warm-up call, stamps nothing.

Nothing reads the device inside a call: :meth:`Recorder.stage_ms`,
:meth:`Recorder.counters` and :meth:`Recorder.spans` read on request.

The JAX package's ``enable_compile_cache`` has no counterpart: nothing of
the port is compiled by XLA.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import itertools
import os
import statistics
import threading
import time
from typing import (Any, Callable, Dict, Iterable, List, NamedTuple,
                    Optional, Sequence, Tuple)

import torch
from torch.autograd import profiler as _autograd_profiler

from synergynet_tpu_torch.core.device import resolve_device


def _activities():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str):
    """Record the enclosed region under ``torch.profiler`` and write its
    Chrome trace to ``log_dir/trace_<pid>_<ns>.json`` (open it in Perfetto
    or ``chrome://tracing``); the path is the profiler's ``trace_path``."""
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=_activities()) as prof:
        yield prof
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.trace_path = os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(prof.trace_path)


class StageTimer:
    """Accumulating per-stage timer on ``device`` (the card unless the
    caller asks for the CPU): CUDA events around each stage on the card,
    read when the totals are asked for (one synchronize then); the host
    clock on the CPU.

    >>> t = StageTimer()
    >>> with t.stage("decode"):
    ...     out = decode(...)          # device work
    >>> t.report()
    """

    def __init__(self, sync: bool = True, device="cuda"):
        self.device = resolve_device(device)
        self.sync = sync
        self._totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._pending = []

    @contextlib.contextmanager
    def stage(self, name: str):
        cuda = self.device.type == "cuda"
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(self.device))
        else:
            t0 = time.perf_counter()
        try:
            yield self
        finally:
            if cuda:
                end.record(torch.cuda.current_stream(self.device))
                self._pending.append((name, start, end))
                if self.sync:
                    self._resolve()
            else:
                self._add(name, time.perf_counter() - t0)

    def _add(self, name: str, seconds: float) -> None:
        self._totals[name] = self._totals.get(name, 0.0) + seconds
        self.counts[name] = self.counts.get(name, 0) + 1

    def _resolve(self) -> None:
        for name, start, end in self._pending:
            end.synchronize()
            self._add(name, start.elapsed_time(end) / 1e3)
        self._pending.clear()

    @property
    def totals(self) -> Dict[str, float]:
        """Seconds per stage, summed over its calls."""
        self._resolve()
        return self._totals

    def averages(self) -> Dict[str, float]:
        totals = self.totals
        return {k: totals[k] / max(self.counts[k], 1) for k in totals}

    def report(self) -> str:
        return "\n".join(
            f"{k}: total {self._totals[k] * 1e3:.3f} ms over "
            f"{self.counts[k]} call(s), avg {v * 1e3:.3f} ms"
            for k, v in self.averages().items())


def device_memory_stats(device: Optional[Any] = None) -> Dict[str, int]:
    """The card's allocator counters (``torch.cuda.memory_stats``: live and
    peak bytes, ``allocated_bytes.all.peak`` ...) for a CUDA ``device``
    (the current card when None and there is one); empty for the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.cuda.current_device()
    dev = torch.device(device) if not isinstance(device, int) else \
        torch.device("cuda", device)
    if dev.type != "cuda":
        return {}
    return dict(torch.cuda.memory_stats(dev))


# -- the serving path's spans, stage stamps and counters ----------------------

RING_ROWS = 64          # rows of a stage ring: a program's last 64 calls

_NULL = contextlib.nullcontext()


def _device(device) -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Span(NamedTuple):
    """One closed span: its name, host-clock bounds (``time.perf_counter_ns``),
    the enclosing span's name (None at the outermost) and the number of the
    call it belongs to (None for a set-up span outside any call)."""
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[str]
    call: Optional[int]


class _OpenSpan:
    """A span while it is open. ``always``: a set-up span, recorded with
    or without a profiler."""

    __slots__ = ("rec", "name", "always", "rf", "parent", "call", "start_ns")

    def __init__(self, rec: "Recorder", name: str, always: bool):
        self.rec, self.name, self.always = rec, name, always

    def __enter__(self):
        rec = self.rec
        self.rf = None
        if _autograd_profiler._is_profiler_enabled:
            self.rf = _autograd_profiler.record_function(self.name)
            self.rf.__enter__()
        stack = rec._stack()
        if stack:
            self.parent, self.call = stack[-1].name, stack[-1].call
        else:
            self.parent = None
            self.call = None if self.always else next(rec._calls)
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        self.rec._stack().pop()
        self.rec._spans.append(Span(self.name, self.start_ns, end,
                                    self.parent, self.call))
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


_STAMP_ARGS = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
               + [ctypes.c_void_p])


class StageSequence:
    """One program's stage stamps: ``stages`` names the intervals, so a row
    holds ``len(stages) + 1`` stamps (slot 0 before the first stage, slot
    i + 1 after stage i), and the last stamp of a row advances it.

    One int64 tensor on ``device`` holds the ring (``RING_ROWS`` rows), the
    count of completed rows and the ``tallies``; the program's graph keeps
    pointers into it. On a card a stamp is kernel ``stage_stamp`` on the
    current stream (the device's global timer, ns); on the CPU its twin
    writes ``time.perf_counter_ns``. The program's calls are serialized
    (:class:`~synergynet_tpu_torch.pipeline.program.ProgramCache` holds its
    lock), so a call's stamps fill one row."""

    def __init__(self, stages: Sequence[str], device,
                 tallies: Sequence[str] = ()):
        self.stages, self.tally_names = tuple(stages), tuple(tallies)
        self.device = _device(device)
        self.slots, self.rows = len(self.stages) + 1, RING_ROWS
        self.slot_of = {s: i + 1 for i, s in enumerate(self.stages)}
        n = self.rows * self.slots
        with torch.inference_mode(False):
            self.buf = torch.zeros(n + 1 + len(self.tally_names),
                                   dtype=torch.int64, device=self.device)
        self.ring = self.buf[:n].view(self.rows, self.slots)
        self.row = self.buf[n:n + 1]
        self.tallies = self.buf[n + 1:]
        self.done_rows = 0              # host mirror of ``row``
        self.row_calls: List[Optional[int]] = [None] * self.rows
        self._launch = None
        if self.device.type == "cuda":
            from synergynet_tpu_torch.ops.cuda_build import (kernel_entry,
                                                             require_sm90)
            require_sm90(self.device, "stage-stamp")
            self._launch = kernel_entry("stage_stamp", "synergy_stage_stamp",
                                        _STAMP_ARGS)
            self._ptrs = (self.ring.data_ptr(), self.row.data_ptr())
            # Load the kernel before any capture; the first row overwrites
            # this stamp.
            self.stamp(0, False)

    def stamp(self, slot: int, advance: bool) -> None:
        if self._launch is not None:
            # The raw handle and no guard on the ring's own device: an
            # eager stamp costs a launch (~6 us on the host), not the ~15
            # us of a Stream object and a device switch.
            idx = self.device.index
            with (_NULL if torch.cuda.current_device() == idx else
                  torch.cuda.device(idx)):
                rc = self._launch(
                    *self._ptrs, slot, self.slots, self.rows, int(advance),
                    torch._C._cuda_getCurrentRawStream(idx))
            if rc != 0:
                raise RuntimeError(f"stage-stamp kernel launch failed: CUDA "
                                   f"error {rc}")
        else:
            self.ring[self.done_rows % self.rows, slot] = \
                time.perf_counter_ns()
            if advance:
                self.row += 1
        if advance:
            self.done_rows += 1

    def begin(self, call: Optional[int]) -> None:
        """Slot 0 of the next row, tagged with ``call``."""
        self.row_calls[self.done_rows % self.rows] = call
        self.stamp(0, False)

    def done(self, stage: str) -> None:
        """The stamp after ``stage``; after the last stage the row is
        complete."""
        slot = self.slot_of[stage]
        self.stamp(slot, slot == self.slots - 1)

    def read(self) -> Tuple[List[Tuple[Optional[int], List[int]]],
                            List[int]]:
        """(complete rows oldest first as (call, stamps), tallies): one
        copy to the host, after the device's work is done."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        host = self.buf.cpu().tolist()
        n = self.rows * self.slots
        done = host[n]
        rows = [(self.row_calls[r % self.rows],
                 host[(r % self.rows) * self.slots:
                      (r % self.rows + 1) * self.slots])
                for r in range(max(0, done - self.rows), done)]
        return rows, host[n + 1:]

    def clear(self) -> None:
        self.buf.zero_()
        self.done_rows = 0
        self.row_calls = [None] * self.rows


@dataclasses.dataclass(eq=False)
class ProgramStats:
    """One program's record: ``key`` (``process_batch.b128``: the body and
    the batch size it serves), the ``engine`` that owns it, its ``device``;
    the host counters (calls; bytes a call takes in and gives out, on a
    card copied into the static inputs and cloned out of the outputs;
    captures and the capture's pool bytes); a stamped program's frames a
    call and its ``sequence`` (None for a program without stages)."""
    key: str
    engine: str
    device: str
    frames_per_call: int = 0
    sequence: Optional[StageSequence] = None
    calls: int = 0
    bytes_in: int = 0
    bytes_out: int = 0
    captures: int = 0
    pool_bytes: int = 0

    COUNTERS = ("calls", "bytes_in", "bytes_out", "captures", "pool_bytes")

    def values(self) -> Dict[str, int]:
        """The counters, ``frames`` (calls x frames a call) for a stamped
        program and the sequence's tallies (one copy from the device)."""
        out = {c: getattr(self, c) for c in self.COUNTERS}
        if self.sequence is not None:
            out["frames"] = self.calls * self.frames_per_call
            out.update(zip(self.sequence.tally_names,
                           self.sequence.read()[1]))
        return out

    def zero(self) -> None:
        for c in self.COUNTERS:
            setattr(self, c, 0)
        if self.sequence is not None:
            self.sequence.clear()


class Recorder:
    """The process's spans and the records of its programs (each program
    owns its counters and stage ring; the recorder keeps them, a few KiB
    each, for reading after the engine is gone). The read methods take a
    key and, to narrow it to one engine's program, the engine: counters are
    summed over the programs they match, rows gathered."""

    def __init__(self):
        self._local = threading.local()
        self._spans: List[Span] = []
        self._calls = itertools.count(1)
        self._programs: List[ProgramStats] = []

    # -- spans ---------------------------------------------------------------

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def span(self, name: str):
        """A span around a layer of the serving path (see the module
        docstring); the outermost span of a call starts a new call
        number."""
        if not _autograd_profiler._is_profiler_enabled:
            return _NULL
        return _OpenSpan(self, name, False)

    def setup_span(self, name: str) -> _OpenSpan:
        """A span recorded with or without a profiler."""
        return _OpenSpan(self, name, True)

    def current_call(self) -> Optional[int]:
        stack = getattr(self._local, "stack", None)
        return stack[-1].call if stack else None

    def spans(self) -> List[Span]:
        """Every span recorded since the last :meth:`reset`, in the order
        they closed."""
        return list(self._spans)

    # -- programs ------------------------------------------------------------

    def program(self, key: str, engine: str, device,
                stages: Sequence[str] = (), tallies: Sequence[str] = (),
                frames_per_call: int = 0) -> ProgramStats:
        """A new program's record, kept for reading; with ``stages`` its
        stage ring (made at set-up: not while a capture runs, whose memory
        would belong to the graph)."""
        seq = StageSequence(stages, device, tallies) if stages else None
        st = ProgramStats(key, engine, str(_device(device)), frames_per_call,
                          seq)
        self._programs.append(st)
        return st

    def programs(self, key: str, engine: Optional[str] = None
                 ) -> List[ProgramStats]:
        return [p for p in self._programs
                if p.key == key and engine in (None, p.engine)]

    def counters(self, key: str, engine: Optional[str] = None
                 ) -> Optional[Dict[str, int]]:
        """The counters of ``key``'s programs, summed, or None for a key
        never seen."""
        out: Dict[str, int] = collections.Counter()
        found = False
        for p in self.programs(key, engine):
            out.update(p.values())
            found = True
        return dict(out) if found else None

    # -- stage stamps --------------------------------------------------------

    @contextlib.contextmanager
    def stamping(self, seq: Optional[StageSequence]):
        """While a program captures or runs its body: the body's
        :func:`stage_done` and :func:`tally` go to ``seq``. Anywhere else
        (a warm-up call, a stage called on its own) they do nothing."""
        prev = getattr(self._local, "seq", None)
        self._local.seq = seq
        try:
            yield
        finally:
            self._local.seq = prev

    def stage_done(self, stage: str) -> None:
        seq = getattr(self._local, "seq", None)
        if seq is not None:
            seq.done(stage)

    def tally(self, values: Callable[[], Sequence[torch.Tensor]],
              names: Optional[Sequence[str]] = None) -> None:
        """Add ``values()`` (0-dim integer tensors on the body's device, or
        one 1-D integer tensor) to the stamped body's tallies: to all of
        them in their order, or to ``names``, a run of them in their order
        (a body whose program tallies none of ``names`` adds nothing).
        ``values`` is called only where it is added, so elsewhere it costs
        nothing."""
        seq = getattr(self._local, "seq", None)
        if seq is None:
            return
        names = seq.tally_names if names is None else tuple(names)
        if names[0] not in seq.tally_names:
            return
        first = seq.tally_names.index(names[0])
        if seq.tally_names[first:first + len(names)] != names:
            raise ValueError(f"the body tallies {seq.tally_names}; {names} "
                             f"is not a run of them")
        vals = values()
        vals = (vals if isinstance(vals, torch.Tensor) else
                torch.stack(list(vals)))
        if len(vals) != len(names):
            raise ValueError(f"the body tallies {names}, given {len(vals)} "
                             f"values")
        seq.tallies[first:first + len(names)].add_(vals.to(torch.int64))

    def stage_rows(self, key: str, engine: Optional[str] = None
                   ) -> List[Tuple[Optional[int], Dict[str, float]]]:
        """``key``'s complete rows in its programs' rings, each program's
        oldest first, as (call, {stage: ms}); the call is None for a row
        stamped with no profiler running."""
        return [(call, {s: (t[i + 1] - t[i]) / 1e6
                        for i, s in enumerate(p.sequence.stages)})
                for p in self.programs(key, engine)
                if p.sequence is not None
                for call, t in p.sequence.read()[0]]

    def stage_ms(self, key: str, last: Optional[int] = None,
                 calls: Optional[Iterable[int]] = None,
                 engine: Optional[str] = None
                 ) -> Optional[Dict[str, float]]:
        """Median ms of each stage of ``key`` over its complete rows: those
        of ``calls`` when given, of them the ``last`` when given; None when
        no row is left."""
        rows = self.stage_rows(key, engine)
        if calls is not None:
            keep = set(calls)
            rows = [r for r in rows if r[0] in keep]
        if last is not None:
            rows = rows[len(rows) - last:] if last > 0 else []
        if not rows:
            return None
        return {s: statistics.median(r[1][s] for r in rows)
                for s in rows[0][1]}

    def reset(self) -> None:
        """Forget every span and zero every program's counters and ring
        (the records stay: their programs write into them)."""
        self._spans.clear()
        self._calls = itertools.count(1)
        for p in self._programs:
            p.zero()


recorder = Recorder()
annotate = recorder.span
stage_done = recorder.stage_done
tally = recorder.tally
