"""The port's counters and spans, kept in memory in this process.

- ``counters``, a ``collections.Counter``, always on: ``launch.<kernel>``
  for each launch of a hand-written kernel (``ops/cuda_*.py``),
  ``transport.<collective>.<backend>.<device>`` for each collective of
  ``parallel/mesh.py``, ``sync.<site>`` for each host sync of the render
  path (``sync_any``, ``sync_nonzero``).
- ``span(name, device, attrs)`` records a span: its name, the enclosing
  span (a per-thread stack), host start and end from ``time.time_ns()``
  (the clock of ``torch.profiler``'s events), its attributes and, on a
  CUDA device, a pair of timing events for its device milliseconds. While
  it is open it is also a FUNCTION-scope profiler range ``ptt.<name>``
  (``_RecordFunctionFast``), never a user annotation, so the profiler
  mirrors nothing of it onto the device timeline. The scene build's and
  the kernel library's spans are always recorded: a few per process.
- ``traced(name, device, attrs)`` records the same span only while a
  ``torch.profiler`` records; otherwise it returns ``NOOP``, a shared
  context that allocates nothing, reads no clock and records no event.
  The render path's spans (one per bounce phase) are of this kind, so an
  operator turns them on by wrapping a render in
  ``torch.profiler.profile``.
- ``records()`` waits for every pending event, resolves it and every
  attribute held as a device tensor, and returns the records; ``clear()``
  empties them.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast

counters: collections.Counter = collections.Counter()

_records: list = []
# (record, start event, end event) whose device ms are not read yet.
_pending: list = []
_lock = threading.Lock()
_local = threading.local()


@dataclasses.dataclass
class Record:
    """One span. ``parent`` is the enclosing span's record (None at the
    top); ``device_ms`` the span's device time (None off a CUDA device,
    and until ``records()`` resolves it); ``attrs`` values held as device
    tensors become ints or lists at ``records()``."""

    name: str
    parent: Optional["Record"] = dataclasses.field(repr=False)
    start_ns: int = 0
    end_ns: int = 0
    attrs: dict = dataclasses.field(default_factory=dict)
    device_ms: Optional[float] = None

    @property
    def seconds(self) -> float:
        """Host seconds from start to end."""
        return (self.end_ns - self.start_ns) * 1e-9


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    """The context of one recorded span (``span``)."""

    __slots__ = ("rec", "device", "range", "events")

    def __init__(self, name: str, device, attrs):
        self.rec = Record(name, None, attrs=dict(attrs) if attrs else {})
        self.device = (device if device is not None
                       and torch.device(device).type == "cuda" else None)
        self.range = _RecordFunctionFast("ptt." + name)
        self.events = None

    def __enter__(self):
        stack = _stack()
        self.rec.parent = stack[-1] if stack else None
        self.range.__enter__()
        if self.device is not None:
            stream = torch.cuda.current_stream(self.device)
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(stream)
        stack.append(self.rec)
        with _lock:
            _records.append(self.rec)
        self.rec.start_ns = time.time_ns()
        return self.rec

    def __exit__(self, *exc):
        self.rec.end_ns = time.time_ns()
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
            with _lock:
                _pending.append((self.rec, *self.events))
        _stack().pop()
        self.range.__exit__(*exc)
        return False


class _Noop:
    """The shared context of a span site while spans are off."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


def span(name: str, device=None, attrs: Optional[dict] = None) -> _Span:
    """A span that is always recorded (set-up). ``device``: the device
    whose stream the span's device time is taken on (None, or a device
    that is not CUDA: no device time)."""
    return _Span(name, device, attrs)


def traced(name: str, device=None, attrs: Optional[dict] = None):
    """``span`` while a profiler records, else ``NOOP``."""
    if not _autograd_profiler._is_profiler_enabled:
        return NOOP
    return _Span(name, device, attrs)


def sync_any(x: torch.Tensor, site: str) -> bool:
    """``bool(x.any())``, a host sync: counted as ``sync.<site>``, and
    recorded as a span of that name while a profiler records."""
    key = "sync." + site
    counters[key] += 1
    if not _autograd_profiler._is_profiler_enabled:
        return bool(x.any())
    with _Span(key, x.device, None):
        return bool(x.any())


def sync_nonzero(x: torch.Tensor, site: str) -> list:
    """The indices of the true entries of the 1-D ``x`` as a list, a host
    sync counted and recorded as ``sync_any`` does."""
    key = "sync." + site
    counters[key] += 1
    if not _autograd_profiler._is_profiler_enabled:
        return torch.nonzero(x)[:, 0].tolist()
    with _Span(key, x.device, None):
        return torch.nonzero(x)[:, 0].tolist()


def _resolve(value):
    if isinstance(value, torch.Tensor):
        return value.item() if value.numel() == 1 else value.tolist()
    return value


def records() -> list:
    """Every record so far, in the order the spans opened, with device ms
    and device-tensor attributes resolved (each waits for its device)."""
    with _lock:
        pending, _pending[:] = list(_pending), []
        out = list(_records)
    for rec, ev0, ev1 in pending:
        ev1.synchronize()
        rec.device_ms = ev0.elapsed_time(ev1)
    for rec in out:
        for k, v in rec.attrs.items():
            if isinstance(v, torch.Tensor):
                rec.attrs[k] = _resolve(v)
    return out


def clear() -> None:
    """Drop every record (spans still open are recorded no more)."""
    with _lock:
        _records.clear()
        _pending.clear()
