"""Host-side span tracer: low-overhead wall-time spans with Chrome-trace
JSON export.

Disabled by default — ``span()`` is then a no-op context manager costing one
attribute read, so instrumented code paths (train step, replan/migrate,
checkpoint, serve decode) can leave their spans in unconditionally.  Enable
with :func:`configure`; export with :func:`export` (view in
``chrome://tracing`` / https://ui.perfetto.dev).

Events are complete-span ("ph": "X") Chrome trace events in microseconds
relative to tracer start, ring-buffered so long runs can't leak host memory.
Spans read the host clock (``time.perf_counter_ns``) and add no CUDA
synchronize of their own: a span around queued device work measures its
dispatch unless the caller synchronizes (the CLIs do when telemetry is on).
Nesting is implicit (Chrome derives it from ts/dur on one tid), but the
tracer also records the span ``depth`` for programmatic consumers.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from contextlib import contextmanager


class Tracer:
    def __init__(self, *, enabled: bool = True, max_events: int = 100_000,
                 clock=time.perf_counter_ns):
        self.enabled = enabled
        self.max_events = max_events
        self._clock = clock
        self._t0 = clock()
        self._events: deque = deque(maxlen=max_events)
        self._local = threading.local()

    @contextmanager
    def span(self, name: str, **args):
        """Time a region.  Yields the (mutable) args dict when enabled so the
        body can attach results (``s["tokens"] = n``), or None when disabled.
        """
        if not self.enabled:
            yield None
            return
        depth = getattr(self._local, "depth", 0)
        self._local.depth = depth + 1
        t0 = self._clock()
        try:
            yield args
        finally:
            t1 = self._clock()
            self._local.depth = depth
            ev = {"name": name, "ph": "X",
                  "ts": (t0 - self._t0) / 1e3,
                  "dur": (t1 - t0) / 1e3,
                  "pid": 0, "tid": threading.get_ident(),
                  "args": {"depth": depth, **args}}
            self._events.append(ev)

    @property
    def events(self) -> list:
        return list(self._events)

    def chrome_trace(self) -> dict:
        return {"traceEvents": list(self._events), "displayTimeUnit": "ms"}

    def export(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f)
        return path

    def reset(self) -> None:
        self._events.clear()
        self._t0 = self._clock()


# Module-level singleton: the instrumented code paths (train/serve/ckpt)
# all talk to this, so one --trace flag lights them all up.
_TRACER = Tracer(enabled=False)


def configure(*, enabled: bool = True,
              max_events: int = 100_000) -> Tracer:
    """(Re)configure the global tracer; returns it."""
    global _TRACER
    _TRACER = Tracer(enabled=enabled, max_events=max_events)
    return _TRACER


def get() -> Tracer:
    return _TRACER


def enabled() -> bool:
    return _TRACER.enabled


def span(name: str, **args):
    return _TRACER.span(name, **args)


def export(path: str) -> str:
    return _TRACER.export(path)


def reset() -> None:
    _TRACER.reset()


def load_trace(path: str) -> dict:
    """Read back an exported Chrome trace (tests / tooling)."""
    with open(path) as f:
        return json.load(f)
