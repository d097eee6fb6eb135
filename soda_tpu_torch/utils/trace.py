"""Timing spans and per-card device intervals of the program, recorded
while a profiler records.

These are spans of time, not the stencil spans of `plan/spans.py` (how far
a stage reaches over the grid).

`span(name, args)` marks a step of the host: `with trace.span("soda.fn"):
...`; `args`, a dict made once by the caller, goes with the range as its
arguments (the profiler keeps them where it records shapes).
`device_interval(kind, *devices)` marks what each card's current stream
runs between its entry and its exit, by a pair of CUDA events a card.
Both are on exactly while `torch.autograd.profiler` records (a
`torch.profiler.profile` session is open, as in the benchmark's traced
slice and `sodac --profile`), and cost one flag read otherwise: they then
return one shared no-op context, read no clock and record nothing.

While on, a span records a named range with the profiler, so it sits in
the profiler's trace on the profiler's clock, beside the device's kernels
and copies, and it adds its count, its total host seconds and its self
seconds (the total less its child spans) to `totals()`, by the host's
`time.perf_counter`.  The range is a `cpu_op` event of
`_RecordFunctionFast`, not `record_function`'s `user_annotation`, which
costs the host about four times as much (13 against 3 us a span on the
H100's host with a profiler recording the card), time the card waits for
after each synchronise.  An interval keeps
its events unresolved until `device_ms()` reads them (more than
PENDING_MAX pending pairs fold those already completed into the totals
first).  CPU devices record no interval.

`reset()` clears the spans' table and the intervals, pending or folded;
`backend/cuda.py::reset_launches` calls it, so one reset clears the launch
counts and these together.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch
import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast as _record

PENDING_MAX = 1024

_clock = time.perf_counter


class Total(NamedTuple):
    """One span's count and host seconds since the last `reset()`."""
    count: int
    total_s: float
    self_s: float


class _Off:
    """The context every span and interval is while no profiler records."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()
_totals: dict[str, list] = {}       # name -> [count, total s, self s]
_open: list["_Span"] = []           # the spans entered and not yet left
_pending: list[tuple] = []          # (kind, card, start event, end event)
_device: dict[tuple[str, str], list] = {}   # (kind, card) -> [intervals, ms]


def span(name: str, args: dict | None = None):
    """A context timing one step of the host while a profiler records,
    `args` the range's arguments."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, args)


class _Span:
    __slots__ = ("name", "args", "rf", "t0", "child")

    def __init__(self, name: str, args: dict | None):
        self.name, self.args = name, args

    def __enter__(self):
        self.rf = _record(self.name, (), self.args) if self.args else _record(self.name)
        self.rf.__enter__()
        self.child = 0.0
        _open.append(self)
        self.t0 = _clock()

    def __exit__(self, *exc) -> bool:
        dt = _clock() - self.t0
        _open.pop()
        if _open:
            _open[-1].child += dt
        row = _totals.get(self.name)
        if row is None:
            row = _totals[self.name] = [0, 0.0, 0.0]
        row[0] += 1
        row[1] += dt
        row[2] += dt - self.child
        self.rf.__exit__(*exc)
        return False


def device_interval(kind: str, *devices):
    """A context timing, on each CUDA device of `devices`, its current
    stream from the entry to the exit, under `kind`, while a profiler
    records."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    cards = [d for d in devices if d.type == "cuda"]
    return _Interval(kind, cards) if cards else _OFF


def _event(stream) -> torch.cuda.Event:
    e = torch.cuda.Event(enable_timing=True)
    e.record(stream)
    return e


class _Interval:
    __slots__ = ("kind", "cards", "starts")

    def __init__(self, kind: str, cards: list):
        self.kind, self.cards = kind, cards

    def __enter__(self):
        self.starts = []
        for d in self.cards:
            s = torch.cuda.current_stream(d)
            self.starts.append((s, _event(s)))

    def __exit__(self, *exc) -> bool:
        for d, (s, e0) in zip(self.cards, self.starts):
            _pending.append((self.kind, str(d), e0, _event(s)))
        if len(_pending) > PENDING_MAX:
            _fold(wait=False)
        return False


def _fold(wait: bool) -> None:
    """Add the pending pairs to the intervals' totals: every pair, each
    waited for (`wait`), or those already completed."""
    keep = []
    for kind, card, e0, e1 in _pending:
        if wait:
            e1.synchronize()
        elif not e1.query():
            keep.append((kind, card, e0, e1))
            continue
        row = _device.setdefault((kind, card), [0, 0.0])
        row[0] += 1
        row[1] += e0.elapsed_time(e1)
    _pending[:] = keep


def totals() -> dict[str, Total]:
    """Each span's count, total and self host seconds, by name."""
    return {name: Total(*row) for name, row in _totals.items()}


def device_ms() -> dict[str, dict[str, tuple[int, float]]]:
    """Each interval kind's count and total ms by card ("cuda:0"), every
    pending pair waited for and resolved."""
    _fold(wait=True)
    out: dict[str, dict[str, tuple[int, float]]] = {}
    for (kind, card), (n, ms) in sorted(_device.items()):
        out.setdefault(kind, {})[card] = (n, ms)
    return out


def reset() -> None:
    """Clear the spans' table and every interval, pending or resolved."""
    _totals.clear()
    _pending.clear()
    _device.clear()
