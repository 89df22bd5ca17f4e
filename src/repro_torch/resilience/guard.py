"""Step guard: non-finite detection, last-good snapshots and the drop-spike
fallback (the JAX package's ``repro/resilience/guard.py``).

A single NaN step corrupts the weights for good: the loss keeps "training"
on poisoned params long after the incident.  The guard breaks that at the
train loop:

* :meth:`StepGuard.commit` copies (params, opt_state) to host memory after
  each verified-finite step (every ``snapshot_every``-th, to amortize the
  copy).  The port's AdamW updates the live tensors in place, so a bare
  reference would be poisoned with them.  The copies go to one host
  buffer, allocated once and reused (a full-width training state is tens
  of GB beside the live one on the card), page-locked with
  ``cudaHostRegister`` when the state is on the card (PyTorch's pinned
  allocator would round each leaf up to a power of two and keep the
  blocks after they are freed); each copy is queued on the current stream
  without a synchronize, so it is ordered before the next step's update
  of the same tensors.
* :meth:`StepGuard.check` inspects the step's host-side loss/grad_norm:
  non-finite means the just-written state is discarded and
  :meth:`StepGuard.restore` copies the last good snapshot back into the
  live tensors for a bounded retry (``max_bad_steps`` consecutive
  failures raise :class:`TrainingAborted`).
* A ``drop_frac`` above ``drop_threshold`` for ``drop_patience``
  consecutive steps signals the dropless-bound fallback once
  (``GuardVerdict.fallback_dropless``); the train loop rebuilds its step
  with ``ragged_bound=0``.

The replan probation is ``repro_torch.placement.ReplanProbation``,
re-exported by this package.  Every skip/restore/abort/spike emits a
:mod:`repro_torch.obs.events` record.
"""
from __future__ import annotations

import math
import weakref
from typing import NamedTuple, Optional

import torch

from repro_torch.obs import events as obs_events
from repro_torch.optim.adamw import tree_leaves


class TrainingAborted(RuntimeError):
    """Raised when more than ``max_bad_steps`` consecutive steps go bad."""


class GuardVerdict(NamedTuple):
    ok: bool
    reason: str = ""
    fallback_dropless: bool = False  # only ever True on an ok verdict


def _rebuild(tree, it):
    """``tree`` with its leaves taken in order from ``it`` (NamedTuples
    such as ``AdamWState`` keep their type)."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, it) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(v, it) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)


_ALIGN = 64  # bytes: each leaf's view starts on a 64-byte boundary


def _unpin(flat: torch.Tensor) -> None:
    torch.cuda.check_error(torch.cuda.cudart().cudaHostUnregister(
        flat.data_ptr()))


def _host_buffers(leaves: list) -> tuple:
    """(one flat host buffer, a view of it shaped like each tensor leaf or
    None), the buffer page-locked where a leaf is on the card (the copies
    from it are then asynchronous)."""
    offsets, total = [], 0
    for x in leaves:
        offsets.append(total)
        if isinstance(x, torch.Tensor):
            total += -(-x.numel() * x.element_size() // _ALIGN) * _ALIGN
    flat = torch.empty(total, dtype=torch.uint8)
    pinned = total > 0 and any(isinstance(x, torch.Tensor) and x.is_cuda
                               for x in leaves)
    if pinned:
        torch.cuda.check_error(torch.cuda.cudart().cudaHostRegister(
            flat.data_ptr(), total, 0))
    views = [flat[o:o + x.numel() * x.element_size()].view(x.dtype)
             .view(x.shape) if isinstance(x, torch.Tensor) else None
             for o, x in zip(offsets, leaves)]
    return flat, views, pinned


class StepGuard:
    def __init__(self, *, max_bad_steps: int = 3, drop_threshold: float = 0.25,
                 drop_patience: int = 4, snapshot_every: int = 1, sink=None):
        self.max_bad_steps = int(max_bad_steps)
        self.drop_threshold = float(drop_threshold)
        self.drop_patience = int(drop_patience)
        self.snapshot_every = max(1, int(snapshot_every))
        self.sink = sink
        self._live = None  # the (params, opt_state) trees of the snapshot
        self._bufs: list = []  # host copies, leaf for leaf (non-tensors as is)
        self._release = None  # unpins and frees the host buffer
        self._snap_step = None
        self.bad_streak = 0
        self.bad_total = 0
        self._drop_streak = 0
        self._fallback_signalled = False

    # -- snapshots ----------------------------------------------------------

    def commit(self, step: int, params, opt_state, *,
               force: bool = False) -> None:
        """Record a verified-good state (copied to host memory).

        Resets the consecutive-bad counter; snapshots every
        ``snapshot_every``-th committed step (the first always).  ``force``
        snapshots regardless of cadence: the train loop forces one after
        every placement migration, so a restore never reinstates params in
        a stale physical layout under a rebuilt step.
        """
        self.bad_streak = 0
        due = (force or self._live is None or self.snapshot_every == 1
               or step - self._snap_step >= self.snapshot_every)
        if due:
            self._take((params, opt_state))
            self._snap_step = step

    def _take(self, trees) -> None:
        leaves = tree_leaves(trees)
        fits = len(leaves) == len(self._bufs) and all(
            isinstance(b, torch.Tensor) == isinstance(x, torch.Tensor)
            and (not isinstance(x, torch.Tensor)
                 or (b.shape == x.shape and b.dtype == x.dtype))
            for b, x in zip(self._bufs, leaves))
        if not fits:  # first snapshot, or a migration changed a leaf
            if self._release is not None:
                self._release()
            self._bufs = []
            flat, self._bufs, pinned = _host_buffers(leaves)
            # unpinned when the guard goes (or the next buffer comes)
            self._release = (weakref.finalize(self, _unpin, flat) if pinned
                             else None)
        with torch.no_grad():
            for i, x in enumerate(leaves):
                if isinstance(x, torch.Tensor):
                    self._bufs[i].copy_(x, non_blocking=True)
                else:
                    self._bufs[i] = x
        self._live = trees

    def load_snapshot(self):
        """Copy the last good snapshot back into the live tensors it was
        taken from; returns them as (params, opt_state) (no event)."""
        if self._live is None:
            raise TrainingAborted("no good state to restore from")
        leaves = tree_leaves(self._live)
        with torch.no_grad():
            for b, x in zip(self._bufs, leaves):
                if isinstance(x, torch.Tensor):
                    x.copy_(b, non_blocking=True)
        return _rebuild(self._live, iter(
            x if isinstance(x, torch.Tensor) else b
            for b, x in zip(self._bufs, leaves)))

    def restore(self):
        """The last good (params, opt_state), copied back into the live
        tensors (the retried step then runs on the same tensors)."""
        trees = self.load_snapshot()
        obs_events.emit(self.sink, obs_events.GUARD_RESTORE,
                        step=self._snap_step)
        return trees

    @property
    def snapshot_step(self) -> Optional[int]:
        return self._snap_step

    @property
    def snapshot(self):
        """The raw last-good (params, opt_state) as host tensors — no copy,
        no event; None before the first commit."""
        if self._live is None:
            return None
        return _rebuild(self._live, iter(self._bufs))

    # -- per-step verdict ---------------------------------------------------

    def check(self, step: int, *, loss: float, grad_norm: Optional[float] = None,
              drop: float = 0.0) -> GuardVerdict:
        bad = not math.isfinite(loss)
        if grad_norm is not None and not math.isfinite(grad_norm):
            bad = True
        if bad:
            self.bad_streak += 1
            self.bad_total += 1
            obs_events.emit(self.sink, obs_events.GUARD_SKIP, step=step,
                            loss=float(loss),
                            grad_norm=(None if grad_norm is None
                                       else float(grad_norm)),
                            bad_streak=self.bad_streak)
            if self.bad_streak > self.max_bad_steps:
                obs_events.emit(self.sink, obs_events.GUARD_ABORT, step=step,
                                bad_streak=self.bad_streak)
                raise TrainingAborted(
                    f"step {step}: {self.bad_streak} consecutive non-finite "
                    f"steps (> max_bad_steps={self.max_bad_steps})")
            return GuardVerdict(False, "nonfinite")
        # drop spikes only tick on finite steps (a NaN step's drop counter
        # is as poisoned as its loss)
        if drop > self.drop_threshold:
            self._drop_streak += 1
        else:
            self._drop_streak = 0
        fb = False
        if (self._drop_streak >= self.drop_patience
                and not self._fallback_signalled):
            fb = True
            self._fallback_signalled = True  # one fallback per run
            self._drop_streak = 0
            obs_events.emit(self.sink, obs_events.DROP_SPIKE, step=step,
                            drop_frac=float(drop),
                            patience=self.drop_patience,
                            threshold=self.drop_threshold)
        return GuardVerdict(True, fallback_dropless=fb)
