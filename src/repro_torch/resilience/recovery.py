"""Auto-resume: periodic atomic saves, retention GC and newest-complete-wins
restore (the JAX package's ``repro/resilience/recovery.py``).

:class:`CheckpointManager` owns one checkpoint root for a training run:

* :meth:`maybe_save` commits ``step_<N>`` atomically every ``save_every``
  steps (a checkpoint holds the state *after* step N, always in logical
  expert order through the ``placement`` kwarg) and GCs down to the
  ``keep`` newest.
* :meth:`restore_latest` walks the complete checkpoints newest-first and
  returns the first that passes full verification: a corrupt newest
  checkpoint is *skipped with an obs event*, not fatal.

On a mesh (``mesh=``) every rank calls the manager alike; rank 0 writes
and collects (``checkpoint.ckpt``).  Events: ``ckpt_save``, ``ckpt_gc``,
``ckpt_corrupt``, ``resume``.
"""
from __future__ import annotations

import os
from typing import Any, Optional

from repro_torch.checkpoint import ckpt
from repro_torch.obs import events as obs_events


class CheckpointManager:
    def __init__(self, root: str, *, save_every: int = 0, keep: int = 3,
                 sink=None, mesh=None, expert_tp: bool = False):
        self.root = root
        self.save_every = int(save_every)
        self.keep = max(1, int(keep))
        self.sink = sink
        self.mesh, self.expert_tp = mesh, expert_tp
        self.lead = mesh is None or mesh.rank == 0
        self._last_saved: Optional[int] = None
        if self.lead:
            os.makedirs(root, exist_ok=True)

    def step_dir(self, step: int) -> str:
        return ckpt.step_path(self.root, step)

    def maybe_save(self, step: int, tree: Any, *, placement=None,
                   force: bool = False) -> Optional[str]:
        """Save iff step N completes a ``save_every`` interval (or
        ``force``): with ``save_every=2`` the saves land after steps 1, 3,
        5, ...  Never saves one step twice."""
        if self._last_saved == step:
            return None
        due = self.save_every > 0 and (step + 1) % self.save_every == 0
        if not (due or force):
            return None
        return self.save(step, tree, placement=placement)

    def save(self, step: int, tree: Any, *, placement=None) -> str:
        path = self.step_dir(step)
        ckpt.save(path, tree, step=step, placement=placement, mesh=self.mesh,
                  expert_tp=self.expert_tp)
        self._last_saved = step
        obs_events.emit(self.sink, obs_events.CKPT_SAVE, step=step, path=path)
        removed = (ckpt.gc_checkpoints(self.root, keep=self.keep)
                   if self.lead else [])
        if removed:
            obs_events.emit(self.sink, obs_events.CKPT_GC, step=step,
                            removed=len(removed))
        return path

    def restore_latest(self, like: Any, *, placement=None,
                       inplace: bool = False):
        """``(tree, step)`` from the newest checkpoint that verifies, or None
        when the root holds none.  A verification failure falls back to
        the next-older complete checkpoint."""
        for step, path in reversed(ckpt.complete_steps(self.root)):
            try:
                tree = ckpt.restore(path, like, placement=placement,
                                    mesh=self.mesh, expert_tp=self.expert_tp,
                                    inplace=inplace)
            except (ckpt.CheckpointError, OSError) as e:
                obs_events.emit(self.sink, obs_events.CKPT_CORRUPT, step=step,
                                path=path, error=str(e))
                continue
            obs_events.emit(self.sink, obs_events.RESUME, step=step,
                            path=path)
            return tree, step
        return None
