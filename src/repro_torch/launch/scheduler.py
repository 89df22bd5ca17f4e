"""Continuous batching: the serving loop behind ``serve --continuous``.

A fixed-width decode batch whose slots requests occupy independently: a
new prompt prefills (batch 1) into a free slot every tick, each decode
tick advances every slot at its own position, and a finished sequence
frees its slot at once for the next queued request, so no request waits
on the longest one in its batch.  Host-side orchestration around one
batched decode step a tick, whatever the occupancy; idle slots decode a
dummy token that still routes through the MoE layers.

* **Paged KV cache.**  Slots read and write one block pool per layer
  (``lm.init_paged_cache``) through per-slot block tables instead of a
  (slots, max_len) ring.  A BlockAllocator free-lists the physical blocks;
  admission reserves a request's whole ceil((S + max_new) / block_size)
  blocks up front, so a decode tick never runs out of cache.  Decode
  through the table view equals the ring bit for bit when the view is as
  long as the ring (``blocks_per_slot * block_size == max_len``).
* **Admission policy.**  "continuous" admits into any free slot each tick;
  "static" only when every slot is free, which reproduces the static
  batch's head-of-line blocking on the same decode path.
* **Mesh.**  On a 1xM mesh every rank runs this loop on the same request
  stream with the tokens replicated, and the MoE layers run the psum mode
  over the model axis (``serve.decode_dist``).

A tick costs one host-to-device copy (tokens, positions and block tables
packed in one tensor) and one device-to-host copy (the next tokens).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.serve_api import Completion, Request, ServeConfig
from repro_torch.models import attention as A
from repro_torch.models import lm


class BlockAllocator:
    """Free list over the pool's non-reserved physical blocks.

    Rows 0 (null) and 1 (scratch) are reserved (``models/attention``);
    everything above is handed out in whole-request batches and returned
    on retire.  Host state only: the device sees the block tables."""

    def __init__(self, num_blocks: int):
        if num_blocks <= A.RESERVED_BLOCKS:
            raise ValueError(
                f"pool needs more than the {A.RESERVED_BLOCKS} reserved "
                f"blocks, got {num_blocks}")
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(A.RESERVED_BLOCKS, num_blocks))

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def alloc(self, n: int) -> Optional[List[int]]:
        """n physical block ids, or None when the pool cannot cover them
        (admission then waits, FIFO: no skip-ahead, no partial grants)."""
        if n > len(self._free):
            return None
        out = self._free[:n]
        del self._free[:n]
        return out

    def free(self, blocks: List[int]) -> None:
        self._free.extend(blocks)


def _insert_blocks(pool: list, ring: list, blocks: torch.Tensor) -> None:
    """Copy a single-sequence prefill ring (per layer, (1, nb*bs, ...)
    leaves) into pool rows ``blocks``, in place.  Ring entries past the
    prompt hold the fresh state (zeros, positions -1), as a clean pool
    block does, so a partial tail block goes in whole."""
    nb = blocks.shape[0]
    for pool_l, ring_l in zip(pool, ring):
        for dst, src in zip(pool_l, ring_l):
            dst[blocks] = src[0].reshape(nb, *dst.shape[1:]).to(dst.dtype)


def _release_blocks(pool: list, blocks: torch.Tensor) -> None:
    """Reset freed blocks' positions to -1 so later reads mask them.  The
    stale payload may stay: a masked entry's softmax weight is exactly 0,
    so it adds nothing."""
    for pool_l in pool:
        pool_l.positions[blocks] = -1


@dataclass
class _Slot:
    """Host-side state of one occupied decode slot."""

    req: Request
    blocks: Optional[List[int]]  # physical block ids (paged mode only)
    out: List[int] = field(default_factory=list)
    times: List[float] = field(default_factory=list)


class ContinuousBatcher:
    """The continuous-batching serve loop.

    ``params`` live on ``device``; with a ``mesh`` (``launch.mesh.Mesh``,
    1xM) they are this rank's shard (``interop.shard_params``), and a
    ``ServeConfig.mesh`` without one builds it from the joined process
    group.  ``impl`` picks the expert kernels.  Public surface:
    ``submit(Request)``, ``step()``, ``run()``, and ``completions`` /
    ``ticks`` for the caller."""

    def __init__(self, params, cfg: ModelConfig,
                 serve_cfg: Optional[ServeConfig] = None, *, mesh=None,
                 impl: str = "fused", device="cuda"):
        scfg = serve_cfg if serve_cfg is not None else ServeConfig()
        if mesh is None and scfg.mesh:
            data, model = scfg.mesh_shape()
            serve.check_serving_mesh(data)
            mesh = make_local_mesh(data, model)
        if mesh is not None:
            serve.check_serving_mesh(mesh.shape["data"],
                                     mesh.shape.get("node", 1))
        self.params = params
        self.cfg = cfg
        self.scfg = scfg
        self.B = scfg.slots
        self.eos_id = scfg.eos_id
        self.paged = scfg.paged and lm.supports_paged(cfg)
        self.mesh = mesh
        self.dev = resolve(device)

        ddist = pdist = None
        if mesh is not None:
            # prefill is one sequence: psum-pinned like decode
            ddist = serve.decode_dist(cfg, mesh, self.B)
            pdist = serve.decode_dist(cfg, mesh, 1)
            if cfg.moe is not None and ddist is None:
                raise ValueError(f"{cfg.moe.num_experts} experts do not split "
                                 f"over the model axis of {mesh}")
        self._pdist, self._ddist = pdist, ddist
        self._impl = impl

        self.pos = np.zeros(self.B, np.int64)  # next write position a slot
        self.next_tok = np.zeros(self.B, np.int64)
        self.slots: List[Optional[_Slot]] = [None] * self.B
        self.queue: List[Request] = []
        self.completions: List[Completion] = []
        self.ticks = 0
        if self.paged:
            self.bs = scfg.block_size
            self.nb = scfg.blocks_per_slot
            self.pool = lm.init_paged_cache(cfg, scfg.pool_blocks, self.bs,
                                            device=self.dev)
            self.tables = np.full((self.B, self.nb), A.NULL_BLOCK, np.int64)
            self.allocator = BlockAllocator(scfg.pool_blocks)
        else:
            self.cache = lm.init_cache(cfg, self.B, scfg.max_len,
                                       device=self.dev)

    # -- request lifecycle ---------------------------------------------------

    def submit(self, req: Request) -> None:
        total = int(req.prompt.shape[0]) + req.max_new_tokens
        if total > self.scfg.max_len:
            raise ValueError(
                f"request {req.id}: prompt+max_new_tokens = {total} exceeds "
                f"max_len = {self.scfg.max_len}")
        if req.arrival is None:
            req.arrival = time.time()
        self.queue.append(req)

    def _prefill(self, req: Request, cache_len: int):
        """(first token, the filled single-sequence ring)."""
        prompt = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                 device=self.dev)[None]
        ring = lm.init_cache(self.cfg, 1, cache_len, device=self.dev)
        with torch.no_grad():
            logits, ring, _ = lm.prefill(self.params, self.cfg, prompt, ring,
                                         impl=self._impl, device=self.dev,
                                         dist=self._pdist)
        return int(torch.argmax(logits[0, -1])), ring

    def _admit(self) -> None:
        free = [i for i, s in enumerate(self.slots) if s is None]
        if self.scfg.policy == "static" and len(free) < self.B:
            return  # the static baseline admits at whole-batch boundaries
        for slot in free:
            if not self.queue:
                break
            req = self.queue[0]
            S = int(req.prompt.shape[0])
            blocks = None
            if self.paged:
                blocks = self.allocator.alloc(
                    -(-(S + req.max_new_tokens) // self.bs))
                if blocks is None:
                    break  # FIFO under pool pressure: no skip-ahead
            self.queue.pop(0)
            if self.paged:
                # prefill a ring of whole blocks, then copy it into the
                # request's pool rows
                nb_p = -(-S // self.bs)
                tok, ring = self._prefill(req, nb_p * self.bs)
                _insert_blocks(self.pool, ring, torch.as_tensor(
                    blocks[:nb_p], device=self.dev))
                self.tables[slot, :len(blocks)] = blocks
                self.tables[slot, len(blocks):] = A.NULL_BLOCK
            else:
                tok, ring = self._prefill(req, self.scfg.max_len)
                for big, one in zip(self.cache, ring):
                    for dst, src in zip(big, one):
                        dst[slot] = src[0]
            self.slots[slot] = _Slot(req=req, blocks=blocks, out=[tok],
                                     times=[time.time()])
            self.pos[slot] = S
            self.next_tok[slot] = tok

    def _retire(self, slot: int, now: float) -> None:
        st = self.slots[slot]
        self.completions.append(Completion(
            request_id=st.req.id, tokens=st.out,
            prompt_len=int(st.req.prompt.shape[0]), queued=st.req.arrival,
            first_token=st.times[0], done=now, token_times=st.times))
        if self.paged:
            _release_blocks(self.pool, torch.as_tensor(st.blocks,
                                                       device=self.dev))
            self.allocator.free(st.blocks)
            self.tables[slot, :] = A.NULL_BLOCK
        else:  # reset the slot's ring so no stale entry leaks forward
            for c in self.cache:
                for buf in c[:-1]:
                    buf[slot].zero_()
                c.positions[slot].fill_(-1)
        self.slots[slot] = None
        self.pos[slot] = 0
        self.next_tok[slot] = 0

    # -- one decode tick -----------------------------------------------------

    def step(self) -> int:
        """Admit queued requests, then decode one token for every slot.
        Returns the number of active slots this tick."""
        self._admit()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return 0
        B = self.B
        host = [self.next_tok, self.pos]
        if self.paged:
            host.append(self.tables.reshape(-1))
        packed = torch.from_numpy(np.concatenate(host)).to(self.dev)
        toks, pos = packed[:B, None], packed[B:2 * B]
        kw = dict(impl=self._impl, device=self.dev, dist=self._ddist)
        with torch.no_grad():
            if self.paged:
                logits, self.pool, _ = lm.decode_step(
                    self.params, self.cfg, toks, pos, self.pool,
                    block_tables=packed[2 * B:].view(B, self.nb), **kw)
            else:
                logits, self.cache, _ = lm.decode_step(
                    self.params, self.cfg, toks, pos, self.cache, **kw)
        nxt = torch.argmax(logits[:, 0], dim=-1).cpu().numpy()
        now = time.time()
        for slot in active:
            st = self.slots[slot]
            self.pos[slot] += 1
            tok = int(nxt[slot])
            st.out.append(tok)
            st.times.append(now)
            self.next_tok[slot] = tok
            if (len(st.out) >= st.req.max_new_tokens
                    or (self.eos_id is not None and tok == self.eos_id)):
                self._retire(slot, now)
        self.ticks += 1
        return len(active)

    def run(self, max_ticks: int = 100000) -> None:
        """Tick until every submitted request has completed."""
        for _ in range(max_ticks):
            if not self.queue and all(s is None for s in self.slots):
                return
            if self.step() == 0 and self.queue:
                raise RuntimeError(
                    "admission stalled: the shared pool cannot cover the "
                    "next queued request (raise ServeConfig.num_blocks or "
                    "the max_len / block_size geometry)")
        raise RuntimeError("scheduler did not drain")
