"""Spans of the program's stages, on the clock of the profiler's trace.

``with span(name, **attrs) as s:`` marks one stage, and ``s.note(**attrs)``
adds what the stage found to its attributes. While a torch profiler
records (any ``torch.profiler.profile``, on the CPU or the card: there
is no other switch), each span is kept in memory as a ``Span``: its
name, its start and end in Unix ns, its id, its parent's id and the id of
its root, the public call it runs under, which every span of that call
shares. It also opens ``record_function("torchdraco.<name>")``, so that the
profiler's Chrome trace shows the program's stages beside the kernels. A
Chrome event's ``ts`` is its Unix time in us less the trace file's
``baseTimeNanoseconds / 1e3``, so one constant puts the kept spans on the
device's timeline. Without a profiler a span costs one flag check and
keeps nothing.

``root(name, **attrs)`` opens a public call. Profiler or not, it keeps the
call's nanoseconds by the name of each ``timed`` span opened under it
(``totals``), which the encoders make their ``timings`` from; a ``timed``
span reads the clock twice with or without a profiler. A root opened
under another (the router's device-plane calls) adds its totals to the
enclosing root's when it closes, counts that its call put there beside
the nanoseconds included (the group path's upload bytes, ``h2d_bytes``).

``spans()`` returns the kept spans and ``clear()`` drops them. Past ``CAP``
spans nothing more is kept, and ``dropped()`` counts what was not. Each
thread has a stack of its own: a span opened on a worker thread has no
parent and is its own root.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd.profiler import record_function

CAP = 1 << 18  # spans kept at most: about 90 MB of host memory
PREFIX = "torchdraco."


class Span(NamedTuple):
    name: str
    start_ns: int  # Unix time
    end_ns: int
    id: int
    parent: int | None
    root: int
    attrs: dict


_kept: list[Span] = []
_dropped = 0
_ids = itertools.count(1)
_lock = threading.Lock()
_local = threading.local()


class _Off:
    """A span while no profiler records: keeps nothing."""

    __slots__ = ()

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def note(self, **attrs) -> None:
        pass


_OFF = _Off()


def recording() -> bool:
    """Whether a torch profiler is recording in this process."""
    return torch._C._autograd._profiler_enabled()


def spans() -> list[Span]:
    """The spans kept so far, in the order they closed."""
    with _lock:
        return list(_kept)


def dropped() -> int:
    """The spans not kept since the last ``clear()``, the record being
    full."""
    return _dropped


def clear() -> None:
    global _dropped
    with _lock:
        _kept.clear()
        _dropped = 0


def _stacks() -> tuple[list, list]:
    """This thread's open recorded spans and its open roots."""
    try:
        return _local.stack, _local.roots
    except AttributeError:
        _local.stack, _local.roots = [], []
        return _local.stack, _local.roots


def _keep(s: Span) -> None:
    global _dropped
    with _lock:
        if len(_kept) < CAP:
            _kept.append(s)
        else:
            _dropped += 1


class _Open:
    """An open span; ``totals`` on a root, ``timed`` where its
    nanoseconds count in the enclosing root's."""

    __slots__ = ("name", "attrs", "timed", "totals", "rec", "id", "parent",
                 "root", "_fn", "_t0", "_u0")

    def __init__(self, name: str, attrs: dict, timed: bool = False,
                 is_root: bool = False) -> None:
        self.name, self.attrs, self.timed = name, attrs, timed
        self.totals: dict | None = {} if is_root else None
        self.rec = recording()

    def __enter__(self) -> "_Open":
        stack, roots = _stacks()
        if self.totals is not None:
            roots.append(self)
        if self.rec:
            top = stack[-1] if stack else None
            self.id = next(_ids)
            self.parent = top.id if top is not None else None
            self.root = top.root if top is not None else self.id
            stack.append(self)
            self._u0 = time.time_ns()
        if self.rec or self.timed:
            self._t0 = time.perf_counter_ns()
        if self.rec:
            self._fn = record_function(PREFIX + self.name)
            self._fn.__enter__()
        return self

    def note(self, **attrs) -> None:
        """Adds ``attrs`` to the span's attributes (what it found)."""
        self.attrs.update(attrs)

    def __exit__(self, *exc) -> bool:
        stack, roots = _stacks()
        if self.rec or self.timed:
            dt = time.perf_counter_ns() - self._t0
        if self.totals is not None:
            roots.pop()
            if roots:  # a nested call's totals count in its caller's too
                t = roots[-1].totals
                for k, v in self.totals.items():
                    t[k] = t.get(k, 0) + v
        if self.timed and roots:
            t = roots[-1].totals
            t[self.name] = t.get(self.name, 0) + dt
        if self.rec:
            self._fn.__exit__(None, None, None)
            stack.pop()
            _keep(Span(self.name, self._u0, self._u0 + dt, self.id,
                       self.parent, self.root, self.attrs))
        return False


def span(name: str, **attrs):
    """A stage, kept while a profiler records; otherwise nothing."""
    return _Open(name, attrs) if recording() else _OFF


def timed(name: str, **attrs) -> _Open:
    """A stage whose nanoseconds count in the enclosing root's ``totals``
    whether a profiler records or not."""
    return _Open(name, attrs, timed=True)


def root(name: str, **attrs) -> _Open:
    """A public call: the root of the spans under it, with the totals of
    its ``timed`` spans by name (``totals``, ns), those of the roots
    nested in it included."""
    return _Open(name, attrs, is_root=True)
