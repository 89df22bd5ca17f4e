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
* **Mesh.**  On a DxM mesh every rank runs this loop on the same request
  stream: the same admission, slot table and ticks.  The MoE layers run
  the psum mode over the model axis (``serve.decode_dist``).  A batcher
  per data group: where the slots split over the data axis, data group g
  holds and decodes only its B/D slots (the g-th block), prefills the
  requests admitted into them, and after each tick (and each admission)
  the groups exchange their tokens over the data axis, so every rank's
  host state stays the same.  Every group runs every tick's decode, with
  or without an active slot of its own: the MoE layers' metrics
  all-reduce over the data axis.  Where the slots do not split, every
  group decodes all of them.
* **Online replan.**  ``ServeReplanHook`` is ``launch.train.ReplanHook``
  on the serving side: the decode step's (L, E) expert loads
  (``lm.decode_step(layer_loads=True)``) feed a LoadMonitor EMA, a
  PlacementController polls it every ``replan_every`` ticks, and a plan it
  accepts is applied between ticks (``apply_placement``: the params
  migrated in place, the steps rebuilt), on probation against the drop
  fraction (serving has no loss).  Safe mid-traffic because decode runs
  the psum mode, whose placed reduction is slot-wise: the same stream
  gives the same tokens under any plan, bit for bit.

A tick costs one host-to-device copy (tokens, positions and block tables
packed in one tensor) and one device-to-host copy (the next tokens, with
the tick's drop fraction when a replan hook reads it); the hook fetches
the loads only every ``sync_every`` ticks.
"""
from __future__ import annotations

import time
import weakref
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import comm
from repro_torch.core.balance import MoEMetrics
from repro_torch.core.dispatch import expert_capacity
from repro_torch.core.fmoe import DistConfig
from repro_torch.core.monitor import LoadMonitor
from repro_torch.device import resolve
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.serve_api import Completion, Request, ServeConfig
from repro_torch.launch.train import _host
from repro_torch.models import attention as A
from repro_torch.models import lm
from repro_torch.obs import trace as obs_trace
from repro_torch.placement import (PlacementController, ReplanProbation,
                                   from_logical, load_calibration, migrate)


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


class ServeReplanHook:
    """``launch.train.ReplanHook`` on the serving side: the decode loads'
    EMA -> PlacementController -> ``batcher.apply_placement`` between
    ticks, on probation against the drop fraction (serving has no loss).
    Owned by the ContinuousBatcher; one :meth:`observe` a decode tick.

    The controller plans for inference (``train=False``: no gradient sync
    to charge) at the capacity of the whole slot count, as the
    reference's; the monitor takes the loads every ``sync_every`` ticks
    (one host transfer then).  On a mesh the loads and the drop fraction
    are the means over the data axis, the same on every rank, so every
    rank takes the same decision on the same tick (``apply_placement``
    migrates collectively).  ``sink``: the telemetry sink; the probation's
    verdicts and each replan land in it."""

    def __init__(self, batcher: "ContinuousBatcher", num_ranks: int, *,
                 every: int, per_layer: bool = True, sink=None):
        cfg = batcher.cfg
        moe = cfg.moe
        L = cfg.num_layers if per_layer else 0
        # a weak reference: the batcher owns the hook, and a cycle would
        # keep the batcher's params alive until the cycle collector runs
        self.batcher = weakref.proxy(batcher)
        self.per_layer = per_layer
        self.sink = sink
        self.monitor = LoadMonitor(moe.num_experts, ema=0.9, num_layers=L)
        self.controller = PlacementController(
            self.monitor, num_ranks, d_model=cfg.d_model,
            d_hidden=moe.d_expert_hidden,
            capacity=expert_capacity(batcher.B, moe.num_experts, moe.top_k,
                                     moe.capacity_factor),
            capacity_factor=moe.capacity_factor, every=every, train=False,
            num_layers=L, constants=load_calibration())
        self.probation = ReplanProbation(window=max(4, min(64, every // 4)),
                                         sink=sink)
        # decode ticks are cheap: sample the loads sparsely, as the train
        # hook does, so the host never waits on a fetch every tick
        self.sync_every = max(1, every // 16)
        self._drop_ema: Optional[float] = None

    def observe(self, tick: int, md: dict) -> None:
        """``md``: the tick's ``drop_frac`` (a host float) and its
        ``load_layers`` (L, E) or ``load`` (E,) (device tensors, fetched
        only on a sampled tick)."""
        drop = md.get("drop_frac")
        if drop is not None:
            drop = float(drop)
            self._drop_ema = (drop if self._drop_ema is None
                              else 0.9 * self._drop_ema + 0.1 * drop)
        load_key = "load_layers" if self.per_layer else "load"
        if load_key in md and tick % self.sync_every == 0:
            self.monitor.update(MoEMetrics(
                0.0, 0.0, _host(md[load_key]),
                drop if drop is not None else 0.0))
        if self.probation.active:
            decision = self.probation.observe(tick, drop=drop)
            if decision.rollback:
                self.batcher.apply_placement(decision.old_plan)
                self.controller.rollback(decision.old_plan,
                                         decision.new_plan)
                return
            if self.probation.active:  # still judging: no new replan
                return
        old = self.controller.current
        new = self.controller.maybe_replan(tick)
        if new is None:
            return
        self.batcher.apply_placement(new)
        # a serve-time replan must not bring drops in, even where none
        # were measured before it
        self.probation.start(tick, old, new, baseline_drop=(
            self._drop_ema if self._drop_ema is not None else 0.0))
        if self.sink is not None:
            self.sink.emit({"kind": "replan", "step": tick,
                            "imbalance": self.monitor.imbalance})


class ContinuousBatcher:
    """The continuous-batching serve loop.

    ``params`` live on ``device``; with a ``mesh`` (``launch.mesh.Mesh``,
    DxM) they are this rank's shard (``interop.shard_params``), and a
    ``ServeConfig.mesh`` without one builds it from the joined process
    group.  ``impl`` picks the expert kernels.  ``placement``: an
    ``ExpertPlacement`` or ``PerLayerPlacement`` whose physical order
    ``params`` are already in (``placement.from_logical``), as the
    reference's.  With ``ServeConfig.replan_every`` > 0 a
    :class:`ServeReplanHook` replans between ticks, and the identity plan
    is engaged from tick 0 where no plan is given, so every later switch
    stays on the slot-wise placed decode.  ``sink``: the telemetry sink
    (``repro_torch.obs.sink``), which takes a ``serve_admit`` and a
    ``serve_retire`` record per request and the replan hook's.  Public
    surface:
    ``submit(Request)``, ``step()``, ``run()``, ``apply_placement(plan)``,
    and ``completions`` / ``ticks`` / ``replans`` for the caller."""

    def __init__(self, params, cfg: ModelConfig,
                 serve_cfg: Optional[ServeConfig] = None, *, mesh=None,
                 impl: str = "fused", device="cuda", placement=None,
                 sink=None):
        scfg = serve_cfg if serve_cfg is not None else ServeConfig()
        if mesh is None and scfg.mesh:
            data, model = scfg.mesh_shape()
            mesh = make_local_mesh(data, model)
        if mesh is not None:
            serve.check_serving_mesh(mesh.shape.get("node", 1))
        self.params = params
        self.cfg = cfg
        self.scfg = scfg
        self.B = scfg.slots
        self.eos_id = scfg.eos_id
        self.paged = scfg.paged and lm.supports_paged(cfg)
        self.mesh = mesh
        self.dev = resolve(device)
        self.sink = sink
        self.plan = placement
        self._impl = impl
        if (mesh is not None and cfg.moe is not None
                and serve.decode_dist(cfg, mesh, self.B) is None):
            raise ValueError(f"{cfg.moe.num_experts} experts do not split "
                             f"over the model axis of {mesh}")
        # the data group's slots: a block of B/D where the slots split
        D = mesh.shape["data"] if mesh is not None else 1
        self._split = D > 1 and self.B % D == 0
        g = mesh.axis_index("data") if self._split else 0
        n = self.B // D if self._split else self.B
        self.mine = range(g * n, (g + 1) * n)

        self.pos = np.zeros(self.B, np.int64)  # next write position a slot
        self.next_tok = np.zeros(self.B, np.int64)
        self.slots: List[Optional[_Slot]] = [None] * self.B
        self.queue: List[Request] = []
        self.completions: List[Completion] = []
        self.ticks = 0
        self.replans = 0
        if self.paged:
            # the pool's block ids are the shared allocator's; a data group
            # writes only its slots' blocks
            self.bs = scfg.block_size
            self.nb = scfg.blocks_per_slot
            self.pool = lm.init_paged_cache(cfg, scfg.pool_blocks, self.bs,
                                            device=self.dev)
            self.tables = np.full((self.B, self.nb), A.NULL_BLOCK, np.int64)
            self.allocator = BlockAllocator(scfg.pool_blocks)
        else:
            self.cache = lm.init_cache(cfg, len(self.mine), scfg.max_len,
                                       device=self.dev)

        self._replan: Optional[ServeReplanHook] = None
        if scfg.replan_every > 0 and cfg.moe is not None:
            self._replan = ServeReplanHook(
                self, self._expert_ranks(), every=scfg.replan_every,
                per_layer=scfg.per_layer_plans, sink=sink)
            if self.plan is None:
                # the identity plan (logical order) from tick 0: every
                # later switch stays on the slot-wise placed decode
                self.plan = self._replan.controller.current
        self._build_dists()

    def _expert_ranks(self) -> int:
        if self.mesh is None:
            return 1
        d = serve.decode_dist(self.cfg, self.mesh, self.B)
        return d.expert_parallelism if d is not None else 1

    def _build_dists(self) -> None:
        """The decode and prefill ``DistConfig``s under the current plan.
        Prefill is one sequence, psum-pinned over its model group like
        decode (``decode_dist(..., 1)``: no data axis among its token
        axes), so one plan applies to both phases of a request."""
        if self.mesh is None:
            local = (DistConfig.local(placement=self.plan)
                     if self.plan is not None else None)
            self._ddist = self._pdist = local
            return
        ddist = serve.decode_dist(self.cfg, self.mesh, self.B)
        pdist = serve.decode_dist(self.cfg, self.mesh, 1)
        if self.plan is not None and ddist is not None:
            ddist = ddist._replace(placement=self.plan)
            pdist = pdist._replace(placement=self.plan)
        self._ddist, self._pdist = ddist, pdist

    def apply_placement(self, plan) -> None:
        """Switch the live expert layout between ticks: the params permuted
        in place from the current plan's physical order into ``plan``'s
        (from logical order where none is engaged; across the ranks of the
        expert axes on a mesh, so every rank calls it on the same tick),
        and the decode and prefill dists rebuilt.  Decode runs the psum
        mode, whose placed reduction is slot-wise, so the tokens after the
        switch are those of never switching, bit for bit."""
        if self.plan is not None:
            migrate(self.params, self.plan, plan, mesh=self.mesh)
        else:
            from_logical(self.params, plan, mesh=self.mesh)
        self.plan = plan
        self._build_dists()
        self.replans += 1

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
        """(first token as a device scalar, the filled single-sequence
        ring)."""
        prompt = torch.as_tensor(np.asarray(req.prompt, np.int64),
                                 device=self.dev)[None]
        ring = lm.init_cache(self.cfg, 1, cache_len, device=self.dev)
        with torch.no_grad():
            logits, ring, _ = lm.prefill(self.params, self.cfg, prompt, ring,
                                         impl=self._impl, device=self.dev,
                                         dist=self._pdist)
        return torch.argmax(logits[0, -1]), ring

    def _gather_slots(self, mine: torch.Tensor) -> torch.Tensor:
        """This group's (len(mine),) per-slot values -> every slot's (B,),
        exchanged over the data axis where the slots split."""
        if not self._split:
            return mine
        return comm.all_gather_rows(mine, self.mesh.group("data"))

    def _admit(self) -> None:
        free = [i for i, s in enumerate(self.slots) if s is None]
        if self.scfg.policy == "static" and len(free) < self.B:
            return  # the static baseline admits at whole-batch boundaries
        first = torch.zeros(len(self.mine), dtype=torch.int64,
                            device=self.dev)
        admitted = []
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
            admitted.append((slot, req, blocks))
            if self.paged:
                self.tables[slot, :len(blocks)] = blocks
                self.tables[slot, len(blocks):] = A.NULL_BLOCK
            if slot not in self.mine:
                continue  # another data group prefills it
            if self.paged:
                # prefill a ring of whole blocks, then copy it into the
                # request's pool rows
                nb_p = -(-S // self.bs)
                tok, ring = self._prefill(req, nb_p * self.bs)
                _insert_blocks(self.pool, ring, torch.as_tensor(
                    blocks[:nb_p], device=self.dev))
            else:
                tok, ring = self._prefill(req, self.scfg.max_len)
                for big, one in zip(self.cache, ring):
                    for dst, src in zip(big, one):
                        dst[slot - self.mine.start] = src[0]
            first[slot - self.mine.start] = tok
        if not admitted:
            return
        first = self._gather_slots(first).cpu().numpy()
        now = time.time()
        for slot, req, blocks in admitted:
            tok = int(first[slot])
            self.slots[slot] = _Slot(req=req, blocks=blocks, out=[tok],
                                     times=[now])
            self.pos[slot] = int(req.prompt.shape[0])
            self.next_tok[slot] = tok
            if self.sink is not None:
                self.sink.emit({"kind": "serve_admit", "tick": self.ticks,
                                "id": req.id, "slot": slot,
                                "queue_wait": now - req.arrival})

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
        elif slot in self.mine:  # reset the ring: no stale entry leaks on
            for c in self.cache:
                for buf in c[:-1]:
                    buf[slot - self.mine.start].zero_()
                c.positions[slot - self.mine.start].fill_(-1)
        self.slots[slot] = None
        self.pos[slot] = 0
        self.next_tok[slot] = 0
        if self.sink is not None:
            self.sink.emit({"kind": "serve_retire", "tick": self.ticks,
                            "id": st.req.id, "slot": slot,
                            "tokens": len(st.out)})

    # -- one decode tick -----------------------------------------------------

    def step(self) -> int:
        """Admit queued requests, then decode one token for every slot.
        Returns the number of active slots this tick."""
        self._admit()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return 0
        mine = slice(self.mine.start, self.mine.stop)
        n = len(self.mine)
        host = [self.next_tok[mine], self.pos[mine]]
        if self.paged:
            host.append(self.tables[mine].reshape(-1))
        packed = torch.from_numpy(np.concatenate(host)).to(self.dev)
        toks, pos = packed[:n, None], packed[n:2 * n]
        kw = dict(impl=self._impl, device=self.dev, dist=self._ddist,
                  layer_loads=self._replan is not None)
        with torch.no_grad(), obs_trace.span("decode_step", tick=self.ticks):
            if self.paged:
                res = lm.decode_step(
                    self.params, self.cfg, toks, pos, self.pool,
                    block_tables=packed[2 * n:].view(n, self.nb), **kw)
                self.pool = res[1]
            else:
                res = lm.decode_step(self.params, self.cfg, toks, pos,
                                     self.cache, **kw)
                self.cache = res[1]
        nxt = self._gather_slots(torch.argmax(res[0][:, 0], dim=-1))
        md = {}
        if self._replan is not None:
            # the drop fraction rides the tokens' one device-to-host copy
            L = max(self.cfg.num_layers, 1)
            both = torch.cat([nxt.double(), (res[2].drop_frac / L).double()
                              .reshape(1)]).cpu().numpy()
            nxt, md["drop_frac"] = both[:-1].astype(np.int64), float(both[-1])
            md["load_layers"], md["load"] = res[3], res[2].load / L
        else:
            nxt = nxt.cpu().numpy()
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
        if self._replan is not None:
            self._replan.observe(self.ticks, md)
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
