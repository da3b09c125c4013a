"""In-memory spans of the program's own phases, recorded only while
``torch.profiler`` runs.

A span is ``(name, start_ns, end_ns, id, parent, rid, thread)``, stamped with
``time.time_ns()``: the wall clock on which the profiler stamps its host and
device events, so a span can be laid over the device's timeline. ``parent``
is the innermost span the recording thread had open (0 for none); ``rid``
is the id of the request a span belongs to (None for a batch's spans, which
their children name as ``parent``).

Recording is on exactly while a profiler runs. The flag read is the
process-wide ``torch.autograd.profiler._is_profiler_enabled``, which every
thread sees; the C++ check is thread-local and reads ``False`` on threads
the profiler did not start, such as a server's handlers. With it off,
``span`` returns one shared no-op context and nothing is recorded.

Records go into a ring of fixed size: when it is full the oldest record is
dropped and counted. ``take`` hands out and clears what was recorded, and
the ring is cleared (its count too) when recording turns on again, so a
process keeps at most one profiled run's spans.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from typing import List, NamedTuple, Optional

import torch.autograd.profiler as _profiler

__all__ = ["Span", "Recorder", "RECORDER", "span", "add", "current_rid", "stamp", "take",
           "enabled"]


class Span(NamedTuple):
    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int
    rid: Optional[int]
    thread: int


def enabled() -> bool:
    return getattr(_profiler, "_is_profiler_enabled", False)


_OFF = contextlib.nullcontext(0)  # stateless: shared by every thread
_local = threading.local()


def _open() -> list:
    """The calling thread's stack of open spans."""
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Recorder:
    """A ring of at most ``capacity`` spans, shared by all threads;
    ``dropped`` counts the records it let go when full."""

    def __init__(self, capacity: int):
        self._ring: deque = deque(maxlen=int(capacity))
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self.dropped = 0
        self.on = False  # recording, as last seen

    def follow(self, on: bool) -> bool:
        """Take the profiler's flag as read; the ring is cleared where it
        turned on."""
        with self._lock:
            if on and not self.on:
                self._ring.clear()
                self.dropped = 0
            self.on = on
        return on

    def new_id(self) -> int:
        return next(self._ids)

    def push(self, record: Span) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append(record)

    def take(self, lo_ns: int, hi_ns: int) -> List[Span]:
        """The spans that overlap ``[lo_ns, hi_ns]``; the ring is emptied."""
        with self._lock:
            out = [s for s in self._ring if s.end_ns >= lo_ns and s.start_ns <= hi_ns]
            self._ring.clear()
        return out


class _Live:
    __slots__ = ("rec", "name", "rid", "id", "parent", "start")

    def __init__(self, rec: Recorder, name: str, rid: Optional[int]):
        self.rec, self.name, self.rid = rec, name, rid

    def __enter__(self) -> int:
        stack = _open()
        self.parent = stack[-1].id if stack else 0
        self.id = self.rec.new_id()
        stack.append(self)
        self.start = time.time_ns()
        return self.id

    def __exit__(self, *exc) -> None:
        end = time.time_ns()
        _open().pop()
        self.rec.push(Span(self.name, self.start, end, self.id, self.parent, self.rid,
                           threading.get_ident()))


RECORDER = Recorder(1 << 20)


def _recording() -> bool:
    on = enabled()
    return on if on is RECORDER.on else RECORDER.follow(on)


def span(name: str, rid: Optional[int] = None):
    """``with span(name, rid) as span_id:`` records the block (``span_id`` 0
    when off)."""
    if not _recording():
        return _OFF
    return _Live(RECORDER, name, rid)


def add(name: str, start_ns: int, end_ns: int, rid: Optional[int] = None,
        parent: Optional[int] = None) -> None:
    """Record a span that began elsewhere (on another thread, say) and ends
    here; ``parent`` defaults to the calling thread's innermost open span."""
    if not _recording():
        return
    if parent is None:
        stack = _open()
        parent = stack[-1].id if stack else 0
    RECORDER.push(Span(name, int(start_ns), int(end_ns), RECORDER.new_id(), int(parent), rid,
                       threading.get_ident()))


def current_rid() -> Optional[int]:
    """The ``rid`` of the calling thread's innermost open span (None for
    none): a request's id, for work it queues for another thread."""
    stack = getattr(_local, "stack", None)
    return stack[-1].rid if stack else None


def stamp() -> int:
    """``time.time_ns()`` while recording, else 0 (a start no span uses)."""
    return time.time_ns() if _recording() else 0


def take(lo_ns: int, hi_ns: int) -> List[Span]:
    """The recorded spans that overlap the window; the recorder is emptied."""
    return RECORDER.take(lo_ns, hi_ns)
