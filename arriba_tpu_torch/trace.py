"""Spans and counters of one call of the CLI, kept in memory.

A span is a named interval on ``time.perf_counter()``, the clock a caller
that times the whole call reads too, so the program's spans and the
caller's own stamps lie on one timeline. ``cli.main`` opens the root span,
``sample``, once a call (``sample(on)``); every span of that call carries
the root's id as its ``sample`` and the id of the span that was open when
it began as its ``parent`` (the innermost open span, else the current
stage, else the root). Counters are integers on the root
(``root.counters``). The finished roots of the last ``KEEP`` calls stay in
a bounded buffer (``finished()``); nothing is written to a file.

The switch is the stage log's, ``ARRIBA_TPU_TORCH_STAGE_TIMES=1``, which
``pipeline._STAGE_TIMES`` holds and ``cli.main`` hands to ``sample``.
Off, no root is open: ``span`` returns one shared no-op context and
``count`` and ``upload``'s counting are one check. A span never waits on the device and changes
nothing that is computed: a wait on the card shows in the span of the
call that already waits for its results.

Spans open and close on the thread that runs the pipeline.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import time
from typing import Optional

KEEP = 64

_ids = itertools.count(1)
_finished: collections.deque = collections.deque(maxlen=KEEP)
_root: Optional["Root"] = None   # the root of the call in flight
_open: list = []                 # its open spans, innermost last
_stage: Optional["Span"] = None  # its current stage span
_last_stage: Optional["Span"] = None   # the latest stage span of any call


class Span:
    __slots__ = ("name", "id", "parent", "sample", "start", "end", "label")

    def __init__(self, name: str, parent: Optional[int],
                 sample: Optional[int], start: float, label: str = None):
        self.name = name
        self.id = next(_ids)
        self.parent = parent
        self.sample = sample
        self.start = start
        self.end: Optional[float] = None
        self.label = label   # a stage span's log message


class Root(Span):
    """The span of one call, with every span of the call in the order
    they began and the call's counters."""

    __slots__ = ("spans", "counters")

    def __init__(self):
        super().__init__("sample", None, None, time.perf_counter())
        self.sample = self.id
        self.spans: list = []
        self.counters: dict = {}


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc) -> bool:
        return False


_NO_SPAN = _NoSpan()


class _Opened:
    __slots__ = ("name", "span")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> Optional[Span]:
        root = _root
        if root is None:
            self.span = None
            return None
        parent = _open[-1] if _open else (_stage or root)
        self.span = Span(self.name, parent.id, root.id, time.perf_counter())
        root.spans.append(self.span)
        _open.append(self.span)
        return self.span

    def __exit__(self, *exc) -> bool:
        if self.span is not None:
            self.span.end = time.perf_counter()
            _open.pop()
        return False


def span(name: str):
    """A context that records a span named name inside the call in
    flight; the shared no-op context when none is traced."""
    if _root is None:
        return _NO_SPAN
    return _Opened(name)


def spanned(name: str):
    """Decorate a function so that each call of it is a span named
    name."""
    def decorate(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            if _root is None:
                return fn(*args, **kwargs)
            with _Opened(name):
                return fn(*args, **kwargs)
        return wrapped
    return decorate


def active() -> bool:
    """Whether a call is traced: guards a counter whose value costs work
    to compute."""
    return _root is not None


def count(name: str, n: int = 1) -> None:
    """Add n to the counter name of the call in flight, if traced."""
    if _root is not None:
        _root.counters[name] = _root.counters.get(name, 0) + int(n)


def upload(array, device, out=None):
    """array (numpy) as a tensor on device, its bytes added to the
    counter h2d_bytes: every copy of a host array to the device goes
    through here. With out (a device tensor of its size), array is a
    pinned CPU tensor copied into out without waiting."""
    import torch

    if _root is not None:
        _root.counters["h2d_bytes"] = (_root.counters.get("h2d_bytes", 0)
                                       + array.nbytes)
    if out is not None:
        return out.copy_(array, non_blocking=True)
    return torch.from_numpy(array).to(device)


def stage(label: str) -> Optional[float]:
    """Close the current stage span and open the next, labelled with its
    log message; return the seconds since the previous stage span began
    (None before the first). Outside a traced call the span is kept
    nowhere but still times the next line."""
    global _stage, _last_stage
    now = time.perf_counter()
    since = None if _last_stage is None else now - _last_stage.start
    if _stage is not None:
        _stage.end = now
    root = _root
    _stage = _last_stage = Span("stage", root and root.id,
                                root and root.id, now, label)
    if root is not None:
        root.spans.append(_stage)
    return since


@contextlib.contextmanager
def sample(on: bool):
    """The root span of one call when on; its spans close with it and it
    joins the buffer of finished roots."""
    global _root, _stage
    if not on:
        yield None
        return
    root = _root = Root()
    _open.clear()
    _stage = None
    try:
        yield root
    finally:
        now = time.perf_counter()
        for s in _open + [_stage]:
            if s is not None and s.end is None:
                s.end = now
        root.end = now
        _finished.append(root)
        _root = _stage = None
        _open.clear()


def finished() -> list:
    """The finished roots of the last KEEP traced calls, oldest first."""
    return list(_finished)
