"""Pluggable metrics sinks: one ``emit(record)`` interface shared by the
train and serve loops (--metrics_out), the load monitor, the replan hooks
and the resilience layer's events.

Records are flat dicts; tensor, array and numpy values are coerced to plain
Python scalars/lists at the sink boundary (the caller decides *when* to
force the device->host transfer).  Standard library and numpy only: a
tensor is recognised by its ``detach`` method, never by importing torch.
"""
from __future__ import annotations

import csv
import json
import os
from collections import deque
from typing import Optional

import numpy as np


def _coerce(v):
    """Tensors / arrays / numpy scalars -> JSON-serializable Python values
    (a card's tensor is copied to the host here)."""
    if hasattr(v, "detach"):  # a torch tensor, on any device
        v = v.detach().cpu()
        if str(v.dtype) == "torch.bfloat16":  # numpy has no bf16
            v = v.float()
        v = v.numpy()
    if hasattr(v, "__array__") or isinstance(v, np.generic):
        a = np.asarray(v)
        if a.dtype.kind not in "ifub":  # bf16 etc: go through float32
            a = a.astype(np.float32)
        return a.item() if a.ndim == 0 else a.tolist()
    return v


class MetricsSink:
    """Base interface.  ``emit`` one flat dict per record."""

    def emit(self, record: dict) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class JsonlSink(MetricsSink):
    """One JSON object per line, flushed per record (crash-safe tails)."""

    def __init__(self, path: str, *, append: bool = False):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "a" if append else "w")

    def emit(self, record: dict) -> None:
        json.dump({k: _coerce(v) for k, v in record.items()}, self._f)
        self._f.write("\n")
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


class CsvSink(MetricsSink):
    """CSV writer; column set locks at the first record (later extra keys
    are dropped, missing ones left empty — CSV has one header)."""

    def __init__(self, path: str, *, fieldnames: Optional[list] = None):
        self.path = path
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(path, "w", newline="")
        self._fieldnames = list(fieldnames) if fieldnames else None
        self._writer = None

    def emit(self, record: dict) -> None:
        rec = {k: _coerce(v) for k, v in record.items()}
        if self._writer is None:
            if self._fieldnames is None:
                self._fieldnames = list(rec)
            self._writer = csv.DictWriter(self._f, self._fieldnames,
                                          extrasaction="ignore")
            self._writer.writeheader()
        self._writer.writerow(rec)
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()


class MemorySink(MetricsSink):
    """In-memory ring for tests and the LoadMonitor's bounded history."""

    def __init__(self, capacity: Optional[int] = None):
        self._records: deque = deque(maxlen=capacity)

    def emit(self, record: dict) -> None:
        self._records.append({k: _coerce(v) for k, v in record.items()})

    @property
    def records(self) -> list:
        return list(self._records)


class MultiSink(MetricsSink):
    def __init__(self, *sinks: MetricsSink):
        self.sinks = [s for s in sinks if s is not None]

    def emit(self, record: dict) -> None:
        for s in self.sinks:
            s.emit(record)

    def close(self) -> None:
        for s in self.sinks:
            s.close()


def jsonl_records(path: str) -> list:
    """Read back a JsonlSink file (tests / tooling)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out
