"""Deterministic fault-injection registry for resilience drills.

A *fault spec* is a flat dict armed into a process-global registry; code
paths that can fail in production declare named *points* and call
:func:`fire` when they pass them.  Matching specs trigger deterministically
(by hit count or step number), so the same drill replays bit-identically —
the property that lets ``tests/test_torch_resilience.py`` assert exact
recovery behavior instead of "it probably survived".  The JAX package's
registry (``repro/resilience/faults.py``), with the same specs, points,
events and exit code.

Spec fields:

``kind``
    ``crash``          — ``os._exit(137)`` at the point (simulates SIGKILL:
                         no atexit, no finally blocks, no flushes).
    ``corrupt_array``  — overwrite bytes of the file named in the point's
                         ``file=`` payload (post-checksum bit-rot; restore
                         must catch it).  Optional ``match`` substring
                         filters on the flat param ``key``.
    ``nonfinite``      — poison a train step: loss/grad_norm -> NaN and
                         every float param leaf NaN-poisoned in place (what
                         a real overflowed step leaves behind: the port's
                         AdamW updates the params in place).
    ``drop_spike``     — force ``drop_frac`` in the step metrics to
                         ``value`` (default 1.0) for a step range.
``point``
    The injection site name, e.g. ``ckpt_save_arrays``, ``ckpt_save_file``,
    ``ckpt_save_pre_commit``, ``train_step``.
``at``
    1-based *hit count* trigger: fire on the Nth time this process passes
    the point (one-shot).
``step`` / ``until``
    *Step-number* trigger: fire while ``step`` <= current step < ``until``
    (``until`` defaults to ``step + 1``).  ``nonfinite`` disarms after its
    first firing even with a range, so a guarded retry of the same step
    succeeds — the transient-fault model.

Arming: :func:`arm` programmatically, or the ``REPRO_FAULTS`` env var as a
JSON list so subprocess CLI runs (``repro_torch.launch.train``) can be injected
from tests without code hooks.  Every firing emits a ``{"kind": "fault"}``
obs event through :func:`set_sink` and is appended to :data:`fired`.

Import discipline: the standard library (torch and the optimizer's tree
walk only inside :func:`apply_step`) — :mod:`repro_torch.checkpoint`
imports this lazily, so no package cycles.
"""
from __future__ import annotations

import json
import os
from typing import Optional

from repro_torch.obs import events as obs_events

ENV_VAR = "REPRO_FAULTS"
CRASH_EXIT_CODE = 137  # what a SIGKILLed process reports (128 + 9)

_ARMED: list = []
_SINK = None
fired: list = []  # record of every firing (tests introspect this)


class _Fault:
    def __init__(self, spec: dict):
        self.spec = dict(spec)
        self.kind = self.spec["kind"]
        self.point = self.spec["point"]
        self.hits = 0
        self.done = False

    def matches(self, step: Optional[int]) -> bool:
        if self.done:
            return False
        if "at" in self.spec:
            return self.hits == int(self.spec["at"])
        if "step" in self.spec:
            if step is None:
                return False
            lo = int(self.spec["step"])
            hi = int(self.spec.get("until", lo + 1))
            return lo <= int(step) < hi
        return True  # unconditional: fires on every pass

    def one_shot(self) -> bool:
        # hit-count triggers always retire; nonfinite retires even on a
        # step range (transient-fault model: the retry must succeed)
        return "at" in self.spec or self.kind in ("crash", "nonfinite")


def arm(spec: dict) -> None:
    """Arm one fault spec (validated minimally: kind + point required)."""
    if "kind" not in spec or "point" not in spec:
        raise ValueError(f"fault spec needs 'kind' and 'point': {spec}")
    _ARMED.append(_Fault(spec))


def arm_specs(specs) -> None:
    for s in specs:
        arm(s)


def arm_from_env(var: str = ENV_VAR) -> int:
    """Arm specs from a JSON list in ``var``; returns how many were armed."""
    raw = os.environ.get(var, "")
    if not raw:
        return 0
    specs = json.loads(raw)
    if isinstance(specs, dict):
        specs = [specs]
    arm_specs(specs)
    return len(specs)


def clear() -> None:
    _ARMED.clear()
    fired.clear()


def set_sink(sink) -> None:
    """Route fault-firing obs events into ``sink`` (None = record only)."""
    global _SINK
    _SINK = sink


def armed() -> list:
    return [f.spec for f in _ARMED if not f.done]


def _record(fault: _Fault, step: Optional[int], info: dict) -> dict:
    rec = {"fault_kind": fault.kind, "point": fault.point,
           "hits": fault.hits, **({"step": step} if step is not None else {}),
           **{k: v for k, v in info.items() if isinstance(v, (str, int, float))}}
    fired.append(rec)
    obs_events.emit(_SINK, obs_events.FAULT, **rec)
    return rec


def fire(point: str, *, step: Optional[int] = None, **info) -> list:
    """Pass an injection point: trigger matching armed faults.

    ``crash`` and ``corrupt_array`` are handled here (the point payload in
    ``info`` carries what they need, e.g. ``file=``); other kinds are
    returned for the caller to apply (see :func:`apply_step`).
    """
    out = []
    for f in _ARMED:
        if f.point != point:
            continue
        if f.kind == "corrupt_array":
            # the match filter gates what counts as a pass of this point,
            # so "at" means "the Nth matching file", not "the Nth file"
            match = f.spec.get("match")
            if match is not None and match not in str(info.get("key", "")):
                continue
        f.hits += 1  # hits counts passes of this point; "at" is 1-based
        if not f.matches(step):
            continue
        if f.one_shot():
            f.done = True
        _record(f, step, info)
        if f.kind == "crash":
            if _SINK is not None:
                try:  # the event above must survive the kill
                    _SINK.close()
                except Exception:
                    pass
            os._exit(CRASH_EXIT_CODE)
        if f.kind == "corrupt_array":
            f.done = True
            corrupt_file(str(info["file"]))
            continue
        out.append(f.spec)
    return out


def corrupt_file(path: str, *, offset: int = -64, nbytes: int = 16) -> None:
    """Flip bytes in ``path`` (payload region by default: ``offset`` < 0 is
    relative to EOF, clamped past the npy header) — deterministic bit-rot.

    Clamping matters: flipping header bytes makes ``np.load`` *error*, a
    different (easier) failure than the silent bad data that checksums
    exist to catch.
    """
    size = os.path.getsize(path)
    pos = max(0, size + offset if offset < 0 else offset)
    with open(path, "r+b") as f:
        if f.read(6) == b"\x93NUMPY":  # keep the corruption in the payload
            major = f.read(2)[0]
            hlen = int.from_bytes(f.read(2 if major == 1 else 4), "little")
            pos = max(pos, f.tell() + hlen)
        pos = min(pos, max(0, size - 1))
        f.seek(pos)
        chunk = f.read(nbytes)
        f.seek(pos)
        f.write(bytes(b ^ 0xFF for b in chunk))


# ---------------------------------------------------------------------------
# Train-step application (host side, after the step returns)
# ---------------------------------------------------------------------------


def apply_step(params, opt_state, metrics, *, step: int):
    """Apply train-step faults at the ``train_step`` point.

    ``nonfinite`` poisons the step the way a real overflow does: the
    reported loss/grad_norm go NaN *and* every float param leaf is
    multiplied by NaN in place, so a guard that only patched the metrics
    (without restoring state) would be caught by the next step's loss.
    ``drop_spike`` overrides ``drop_frac`` (and ``dropped``) in the
    metrics, driving the guard's sustained-spike fallback.
    """
    specs = fire("train_step", step=step)
    if not specs:
        return params, opt_state, metrics
    import torch

    from repro_torch.optim.adamw import tree_leaves
    for spec in specs:
        if spec["kind"] == "nonfinite":
            with torch.no_grad():
                for p in tree_leaves(params):
                    if isinstance(p, torch.Tensor) and p.is_floating_point():
                        p.mul_(float("nan"))
            metrics = dict(metrics)
            metrics["loss"] = metrics["loss"] * float("nan")
            if "grad_norm" in metrics:
                metrics["grad_norm"] = metrics["grad_norm"] * float("nan")
        elif spec["kind"] == "drop_spike":
            v = float(spec.get("value", 1.0))
            metrics = dict(metrics)
            dev = getattr(metrics.get("loss"), "device", "cpu")
            metrics["drop_frac"] = torch.full((), v, device=dev)
            if "dropped" in metrics:
                metrics["dropped"] = torch.full((), v * 1e4, device=dev)
    return params, opt_state, metrics
