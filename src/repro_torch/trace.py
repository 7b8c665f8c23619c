"""The port's tracer: spans at the boundaries of the round's and the serving
engine's layers, on the clock of ``torch.profiler``'s events.

    with trace.span("fed.aggregate"):
        ...
    with trace.wait("decode.next_tokens"):   # the host blocked on the card
        tokens = logits.argmax(-1).cpu()

A span records only while a ``torch.profiler`` session is active. At any
other time ``span`` and ``wait`` check one flag and return the shared
object ``OFF``, which does nothing, so the records of a run cover exactly
the stretch that a device trace covers. An attribute that costs something
to compute is set only on a recording span:

    with trace.span("engine.decode") as sp:
        if sp is not trace.OFF:
            sp.attrs["rows"] = int(active.sum())

A record's times are the epoch nanoseconds of ``time.time_ns``, the clock
whose readings the profiler's events carry (``kineto_results.events()[i]
.start_ns()``), host and device events alike: an idle gap on the card can
be put down to the span open on the host at its start (``open_at``).

``wait`` marks the host blocked on the card: a ``.cpu()``, a ``float()``
or ``int()`` of a device tensor, a synchronise. ``span`` marks the rest.
Records are kept in memory, at most ``MAX_RECORDS``; the tracer's
``dropped`` counts those past it.
"""
from __future__ import annotations

import threading
import time

import torch
from torch.autograd import profiler as _autograd_profiler

MAX_RECORDS = 10**6

if hasattr(_autograd_profiler, "_is_profiler_enabled"):
    def _profiling() -> bool:
        return _autograd_profiler._is_profiler_enabled
else:  # a torch that keeps the flag in C only
    _profiling = torch._C._autograd._profiler_enabled


class Record:
    """One span: ``name``, ``kind`` ("span" or "wait"), ``start`` and
    ``end`` (epoch ns), the enclosing record ``parent`` (None at the top)
    and ``attrs``. It is its own context manager."""

    __slots__ = ("name", "kind", "start", "end", "parent", "attrs", "_tracer")

    def __init__(self, tracer: Tracer, name: str, kind: str, attrs: dict):
        self._tracer = tracer
        self.name, self.kind, self.attrs = name, kind, attrs
        self.start = self.end = 0
        self.parent = None

    def __enter__(self) -> Record:
        stack = self._tracer._stack()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.end = time.time_ns()
        t = self._tracer
        t._stack().pop()
        if len(t._records) < MAX_RECORDS:
            t._records.append(self)
        else:
            t.dropped += 1
        return False

    @property
    def seconds(self) -> float:
        return (self.end - self.start) * 1e-9

    def path(self) -> str:
        """The names from the outermost enclosing record down to this one."""
        names, r = [], self
        while r is not None:
            names.append(r.name)
            r = r.parent
        return " > ".join(reversed(names))

    def __repr__(self) -> str:
        return (f"Record({self.name!r}, {self.kind!r}, {self.start}, "
                f"{self.end}, attrs={self.attrs!r})")


class _Off:
    """What ``span`` returns when nothing records: one shared object."""

    __slots__ = ()

    def __enter__(self) -> _Off:
        return self

    def __exit__(self, *exc) -> bool:
        return False


OFF = _Off()


class Tracer:
    """Records, the stack of open spans (one per thread) and the count of
    records dropped past ``MAX_RECORDS``."""

    def __init__(self):
        self.dropped = 0
        self._records: list[Record] = []
        self._local = threading.local()

    def _stack(self) -> list[Record]:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def span(self, name: str, **attrs):
        """A context manager that records ``name`` while a profiler session
        is active."""
        if _profiling():
            return Record(self, name, "span", attrs)
        return OFF

    def wait(self, name: str, **attrs):
        """``span`` for a stretch in which the host waits for the card."""
        if _profiling():
            return Record(self, name, "wait", attrs)
        return OFF

    def records(self) -> list[Record]:
        """The closed records, by start."""
        return sorted(self._records, key=lambda r: r.start)

    def clear(self) -> None:
        self._records.clear()

    def open_at(self, t_ns: int) -> Record | None:
        """The innermost record open at ``t_ns`` (start <= t < end)."""
        best = None
        for r in self._records:
            if r.start <= t_ns < r.end and (
                    best is None or (r.start, -r.end) > (best.start, -best.end)):
                best = r
        return best


TRACER = Tracer()  # the process's one tracer, which the functions below use
span, wait = TRACER.span, TRACER.wait
records, clear, open_at = TRACER.records, TRACER.clear, TRACER.open_at
