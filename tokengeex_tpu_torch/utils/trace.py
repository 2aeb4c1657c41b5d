"""The port's tracer: named spans and counters over its passes.

Two ways to time a pass's phases share one call, `phase(timer, name)`:

  - with a `PhaseTimer`, the phase adds its host seconds to the timer's
    flat `seconds[name]`, synchronising the device at both ends so that
    device work is charged to the phase that queued it;
  - with `timer=None`, the phase is an ambient span. It is off unless a
    `torch.profiler` session is recording or a caller opened
    `recording()`; off, it costs one check of those two flags. On, it
    pushes its name on a thread-local stack, so that its path names its
    parents (`prune.session.tables`), marks the profiler's timeline as
    `tgx.<path>` (where a profiler runs), and adds its calls, seconds and
    child seconds to the process's `Record`. It never synchronises the
    device, so it may run inside a traced window that measures the
    device's idle time; a caller that wants synchronised seconds per phase
    passes a `PhaseTimer`.

`count(name, n)` adds n to the record under the innermost open span's
path, gated as a span is. Callers count once a group or a pass, from
numbers at hand, never inside a per-token, per-span or per-row loop.

The record holds everything recorded in the process since the last
`reset()` (or `recording()`): in a benchmark process that records only
under its profiler, the profiled window's spans and counters.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.autograd.profiler as _profiler

# The profiler's cheap event. Unlike torch.profiler.record_function (a
# user-scope annotation) it puts no copy of the span on the device's
# timeline, which a trace would count as device work. A torch without it
# still records spans and counters, with no mark on the profiler's clock.
_mark = getattr(torch._C._profiler, "_RecordFunctionFast", None)


class PhaseTimer:
    """Host seconds per phase of a pass. Synchronises the device at each
    phase boundary so device work is charged to the phase that queued
    it; pass one only when the split is wanted."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.seconds: Dict[str, float] = defaultdict(float)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self, name: str):
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.seconds[name] += time.perf_counter() - t0


class Record:
    """Spans by path: calls, seconds and the seconds of their direct
    children (a span's self time is its seconds less those); counters by
    (path, name)."""

    def __init__(self):
        self.spans: Dict[str, List[float]] = {}
        self.counters: Dict[Tuple[str, str], float] = defaultdict(float)
        self._lock = threading.Lock()

    def _add_span(self, path: str, seconds: float, child: float) -> None:
        with self._lock:
            s = self.spans.setdefault(path, [0, 0.0, 0.0])
            s[0] += 1
            s[1] += seconds
            s[2] += child

    def _add_count(self, path: str, name: str, n) -> None:
        with self._lock:
            self.counters[(path, name)] += n

    def calls(self, path: str) -> int:
        return int(self.spans[path][0]) if path in self.spans else 0

    def seconds(self, path: str) -> Optional[float]:
        """The span's seconds over all its calls; None if never opened."""
        return self.spans[path][1] if path in self.spans else None

    def child_seconds(self, path: str) -> Optional[float]:
        """The seconds of the span's direct children within it."""
        return self.spans[path][2] if path in self.spans else None

    def self_seconds(self, path: str) -> Optional[float]:
        if path not in self.spans:
            return None
        _, total, child = self.spans[path]
        return total - child

    def counter(self, name: str, under: str = "") -> Optional[float]:
        """The counter's sum over the span `under` and its descendants
        (every path when empty); None if nothing was counted there."""
        out = None
        for (path, k), v in self.counters.items():
            if k == name and (not under or path == under
                              or path.startswith(under + ".")):
                out = (out or 0) + v
        return out


_RECORD = Record()
_RECORDING = False
_local = threading.local()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def on() -> bool:
    """Whether spans and counters record now."""
    return _profiler._is_profiler_enabled or _RECORDING


def record() -> Record:
    """The process's record."""
    return _RECORD


def reset() -> Record:
    """Start a new, empty record and return it."""
    global _RECORD
    _RECORD = Record()
    return _RECORD


@contextlib.contextmanager
def recording() -> Iterator[Record]:
    """Record spans and counters without a profiler, into a new record
    (yielded). For tests and measurement scripts."""
    global _RECORDING
    prev = _RECORDING
    _RECORDING = True
    try:
        yield reset()
    finally:
        _RECORDING = prev


class _Span:
    __slots__ = ("name", "path", "t0", "child", "mark", "rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.path = (stack[-1].path + "." + self.name) if stack else self.name
        self.rec = _RECORD
        self.child = 0.0
        self.mark = None
        if _mark is not None and _profiler._is_profiler_enabled:
            self.mark = _mark("tgx." + self.path)
            self.mark.__enter__()
        stack.append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self.t0
        stack = _stack()
        stack.pop()
        if self.mark is not None:
            self.mark.__exit__(None, None, None)
        self.rec._add_span(self.path, seconds, self.child)
        if stack:
            stack[-1].child += seconds
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """An ambient span (see the module docstring)."""
    if _profiler._is_profiler_enabled or _RECORDING:
        return _Span(name)
    return _OFF


def phase(timer: Optional[PhaseTimer], name: str):
    """The phase `name` on `timer` (flat seconds, synchronised), or without
    one an ambient span."""
    return timer(name) if timer is not None else span(name)


def traced(name: str):
    """Decorate a function so that each call runs in the span `name`."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            if _profiler._is_profiler_enabled or _RECORDING:
                with _Span(name):
                    return fn(*args, **kwargs)
            return fn(*args, **kwargs)

        return inner

    return wrap


def count(name: str, n) -> None:
    """Add n to the counter `name` under the innermost open span."""
    if _profiler._is_profiler_enabled or _RECORDING:
        stack = _stack()
        _RECORD._add_count(stack[-1].path if stack else "", name, n)
