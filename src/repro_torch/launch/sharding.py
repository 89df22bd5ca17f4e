"""Logical-axis sharding rules: the reference's parameter layout as data.

The reference (``repro/launch/sharding.py``) maps every parameter path to
logical axes by the first matching rule, and a logical -> mesh table turns
those into PartitionSpecs, with a divisibility guard that replicates a dim
that does not split evenly.  The port keeps the same rules and tables.  A
spec here is a tuple with one entry per dim, as a ``PartitionSpec`` holds
them: None (replicated), an axis name, or a tuple of axis names (the dim
split over their product, the first one major).

The functions take any mesh with ``axis_names`` and a ``shape`` dict: the
port's ``launch.mesh.Mesh``, or :class:`ShapeMesh`, shape only, over any
axis names (the reference's ``("pod", "data", "model")`` meshes among
them).  The port's tree keeps ``layers`` and ``enc_layers`` as lists of
per-layer dicts, so a port path ``layers/3/attn/wq/w`` takes the reference
spec of ``layers/attn/wq/w`` without its leading None (the stacked L dim).

The train layout (``mode="train"``, the reference's ``jit_train_step``):
every leaf FSDP-sharded over ``data`` on its ``embed`` dim and sharded over
``model`` on heads, ffn, vocab and experts; the routed expert stacks
shard their expert dim over the expert axes and their hidden dim over
``data``.  The serve layout (``mode="serve"``, the reference's
``jit_serve_step`` under ``opts["serve_tp"]``): the same without the
FSDP split.  :class:`Layout` carries a rank's specs into the model
(``models.lm`` gathers a layer's leaves at its entry through
``core.comm.gather_shard``), the gradient sync and the clipping norm
(``core.sync``), the checkpoints and the dry run.  Serving on a mesh
always holds its params in one of the two (:func:`serve_layout`, with
the reference's tiny-batch policy).

Which split a leaf's use gathers is one rule, :meth:`Layout.gather_dims`:
a split over ``data`` (FSDP) is gathered; a split over ``model`` is kept
where serving computes the leaf's block tensor-parallel (``serve=True``
and the block in :attr:`Layout.tp`), and gathered otherwise.  Training
gathers every split.  The tensor-parallel blocks (:func:`tp_blocks`):
GQA attention (self, cross and encoder) whose head and kv-head counts
both split over ``model`` and whose four projections the specs split on
heads; the dense FFN and the shared-expert and dense-residual FFNs
(columns of ``wi*``, rows of ``wo``); the embedding and the head (vocab
rows).  MLA, RWKV6 and Mamba leaves, and a flat projection whose split
does not fall on a head boundary, are gathered at use.  The routed
expert stacks keep their expert dim (expert parallelism); their hidden
dim over ``data`` is gathered by the MoE layer (``fsdp_axis``).

Gradient-sync tags (the paper's §3.2) follow from the specs:
``core.sync.fastmoe_tag`` and ``sync_report``.  This module is plain
Python over shapes: it issues no collective.
"""
from __future__ import annotations

import contextlib
import math
import re
from typing import Any, NamedTuple

import torch

from repro_torch.core.sync import is_expert_path

# (path regex, logical axes per dim): the first match wins.  Paths are
# '/'-joined; the reference prepends None for its stacked L dim.
RULES: list[tuple[str, tuple]] = [
    (r"embed/table$", ("vocab", "embed")),
    (r"lm_head/w$", ("embed", "vocab")),
    # router ("world" tag): replicated everywhere
    (r"router/w$", (None, None)),
    # experts ("none" tag): expert dim over the expert axis, hidden dim over
    # the data axis (the layout coincides with expert-internal TP)
    (r"experts/wi(_gate|_up)?$", ("expert", None, "embed")),
    (r"experts/wo$", ("expert", "embed", None)),
    # attention (tag "dp"): heads over model
    (r"attn/w[qkv]/w$", ("embed", "heads")),
    (r"attn/w[qkv]/b$", ("heads",)),
    (r"attn/wo/w$", ("heads", "embed")),
    # MLA
    (r"attn/w_dq/w$", ("embed", None)),
    (r"attn/w_uq/w$", (None, "heads")),
    (r"attn/w_dkv/w$", ("embed", None)),
    (r"attn/w_kr/w$", ("embed", None)),
    (r"attn/w_u[kv]$", ("heads", None, None)),
    # cross attention (whisper decoder)
    (r"cross_attn/w[qkv]/w$", ("embed", "heads")),
    (r"cross_attn/wo/w$", ("heads", "embed")),
    # dense FFN / shared experts / dense residual
    (r"(ffn|shared|dense)/wi(_gate|_up)?/?w?$", ("embed", "ffn")),
    (r"(ffn|shared|dense)/wo/?w?$", ("ffn", "embed")),
    # rwkv6 time-mix
    (r"rwkv/w[rkvg]/w$", ("embed", "heads")),
    (r"rwkv/wo/w$", ("heads", "embed")),
    (r"rwkv/ts_w1$", ("embed", None)),
    (r"rwkv/ts_w2$", (None, None, "embed")),
    (r"rwkv/decay_w1$", ("embed", None)),
    (r"rwkv/decay_w2$", (None, "embed")),
    (r"rwkv/cm_k/w$", ("embed", "ffn")),
    (r"rwkv/cm_v/w$", ("ffn", "embed")),
    (r"rwkv/cm_r/w$", ("embed", "heads")),
    # mamba (hymba)
    (r"mamba/in_proj/w$", ("embed", "ffn")),
    (r"mamba/out_proj/w$", ("ffn", "embed")),
    (r"mamba/conv_w$", (None, "ffn")),
    (r"mamba/conv_b$", ("ffn",)),
    (r"mamba/x_proj/w$", ("ffn", None)),
    (r"mamba/dt_proj/w$", (None, "ffn")),
    (r"mamba/dt_proj/b$", ("ffn",)),
    (r"mamba/A_log$", ("ffn", None)),
    (r"mamba/D$", ("ffn",)),
]

LOGICAL_TO_MESH = {
    "batch": ("pod", "data"),
    "embed": ("data",),  # FSDP
    "heads": ("model",),
    "ffn": ("model",),
    "expert": ("model",),  # the paper's expert parallelism
    "vocab": ("model",),
}

# Serving keeps weights tensor-parallel and resident: no FSDP over data.
LOGICAL_TO_MESH_SERVE = dict(LOGICAL_TO_MESH, embed=())

# The axes the expert dim shards over: ("model",), or ("node", "model") on
# a node mesh (node-major, the rank order of the two-level exchange), or
# ("pod", "model") under the reference's expert_pod option.
EXPERT_AXES: list = [("model",)]

# The reference's mla_replicate option: replicate MLA's up-projections
# over the model axis.
MLA_REPLICATE: list = [False]


def _cell_override(cell: list, value):
    @contextlib.contextmanager
    def _cm():
        old = cell[0]
        cell[0] = value
        try:
            yield
        finally:
            cell[0] = old
    return _cm()


def expert_axes_override(axes: tuple):
    return _cell_override(EXPERT_AXES, axes)


def option_overrides(opts: dict, mesh):
    """An ExitStack applying the reference's layout options in ``opts``
    (``expert_pod``, ``mla_replicate``) and the node mesh's expert axes."""
    stack = contextlib.ExitStack()
    opts = opts or {}
    names = getattr(mesh, "axis_names", ())
    if opts.get("expert_pod") and "pod" in names:
        stack.enter_context(expert_axes_override(("pod", "model")))
    if "node" in names:
        stack.enter_context(expert_axes_override(("node", "model")))
    if opts.get("mla_replicate"):
        stack.enter_context(_cell_override(MLA_REPLICATE, True))
    return stack


class ShapeMesh(NamedTuple):
    """A mesh of shape only: ``axis_names`` and ``shape`` {axis: size}."""
    axis_names: tuple
    shape: dict

    @classmethod
    def of(cls, **sizes) -> "ShapeMesh":
        return cls(tuple(sizes), dict(sizes))


def _mesh_axes_for(logical, mesh, table=None) -> Any:
    if logical is None:
        return None
    table = table or LOGICAL_TO_MESH
    src = EXPERT_AXES[0] if logical == "expert" else table[logical]
    axes = tuple(a for a in src if a in mesh.axis_names)
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def entry_axes(entry) -> tuple:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def _axis_size(entry, mesh) -> int:
    return math.prod(mesh.shape[a] for a in entry_axes(entry))


def rules_for(cfg, mesh) -> list:
    """RULES, prefixed with the reference's head-aware attention overrides:
    a projection whose heads (or kv heads) do not divide the model axis is
    replicated over it instead."""
    if cfg is None or getattr(cfg, "attention", None) is None:
        return RULES
    mp = mesh.shape.get("model", 1)
    a = cfg.attention
    extra = []
    if a.kind == "gqa" and a.num_kv_heads % mp:
        extra += [(r"(cross_)?attn/w[kv]/w$", ("embed", None)),
                  (r"(cross_)?attn/w[kv]/b$", (None,))]
    if a.kind == "gqa" and a.num_heads % mp:
        extra += [(r"(cross_)?attn/wq/w$", ("embed", None)),
                  (r"(cross_)?attn/wq/b$", (None,)),
                  (r"(cross_)?attn/wo/w$", (None, "embed"))]
    if a.kind == "mla" and (a.num_heads % mp or MLA_REPLICATE[0]):
        extra += [(r"attn/w_u[kq]", ("embed", None)),
                  (r"attn/w_uv$", (None, None, None)),
                  (r"attn/wo/w$", (None, "embed"))]
    return extra + RULES


def spec_for(path: str, shape: tuple, mesh, *, stacked: bool = False,
             mode: str = "train", rules: list | None = None) -> tuple:
    """The spec of the leaf at ``path`` of shape ``shape``: its rule's
    logical axes through the mode's table, replicated where a dim does not
    split evenly.  ``stacked``: the leaf has the reference's leading L dim
    (never sharded)."""
    table = LOGICAL_TO_MESH_SERVE if mode == "serve" else LOGICAL_TO_MESH
    for pattern, logical in (rules or RULES):
        if re.search(pattern, path):
            dims = [_mesh_axes_for(lg, mesh, table) for lg in logical]
            break
    else:
        dims = [None] * (len(shape) - (1 if stacked else 0))
    if stacked:
        dims = [None] + dims
    dims = dims[:len(shape)]
    dims += [None] * (len(shape) - len(dims))
    return tuple(d if shape[i] % _axis_size(d, mesh) == 0 else None
                 for i, d in enumerate(dims))


def flat_paths(tree, prefix: str = ""):
    """(path, leaf) over dicts, NamedTuples, lists and tuples; a tensor, a
    shape-carrying object or a spec tuple (a tuple of axis names and None)
    is a leaf."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from flat_paths(v, f"{prefix}{k}/")
    elif hasattr(tree, "_fields") and not hasattr(tree, "shape"):
        for k in tree._fields:
            yield from flat_paths(getattr(tree, k), f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)) and not _is_spec(tree):
        for i, v in enumerate(tree):
            yield from flat_paths(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _is_spec(t) -> bool:
    return isinstance(t, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in t) and not hasattr(t, "_fields")


def rebuild(like, specs: dict, prefix: str = ""):
    """A tree shaped like ``like`` with ``specs[path]`` at each leaf."""
    if isinstance(like, dict):
        return {k: rebuild(v, specs, f"{prefix}{k}/") for k, v in like.items()}
    if hasattr(like, "_fields") and not hasattr(like, "shape"):
        return type(like)(*(rebuild(getattr(like, k), specs, f"{prefix}{k}/")
                            for k in like._fields))
    if isinstance(like, (list, tuple)) and not _is_spec(like):
        return type(like)(rebuild(v, specs, f"{prefix}{i}/")
                          for i, v in enumerate(like))
    return specs[prefix[:-1]]


def _stacked(path: str, stacked) -> bool:
    if stacked is None:  # the reference's tree: layers stacked on L
        return path.startswith(("layers/", "enc_layers/"))
    return bool(stacked)


def tree_specs(tree, mesh, mode: str = "train", cfg=None, *,
               stacked=False) -> Any:
    """A spec tree mirroring ``tree`` (tensors, meta tensors or anything
    with a ``shape``).  ``stacked=None`` reads a tree in the reference's
    layout (layers stacked on a leading L dim); the port's own trees are
    unstacked (the default).  ``cfg`` applies the head-aware rules."""
    rules = rules_for(cfg, mesh) if cfg is not None else None
    with option_overrides({}, mesh):
        specs = {p: spec_for(p, tuple(v.shape), mesh, mode=mode, rules=rules,
                             stacked=_stacked(p, stacked))
                 for p, v in flat_paths(tree)}
    return rebuild(tree, specs)


# ---------------------------------------------------------------------------
# Activation / input specs
# ---------------------------------------------------------------------------


def data_axes(mesh) -> tuple:
    """Mesh axes that carry the batch dimension (pod folds into data)."""
    return tuple(a for a in mesh.axis_names if a in ("pod", "data"))


def batch_spec(batch_size: int, mesh, extra_dims: int = 1) -> tuple:
    """Shard the batch dim over (pod, data) where divisible."""
    axes = data_axes(mesh)
    entry = axes if len(axes) > 1 else (axes[0] if axes else None)
    if entry is None or batch_size % _axis_size(entry, mesh):
        entry = None
    return (entry, *([None] * extra_dims))


def cache_specs(cache_tree, mesh, batch_size: int, seq_shard: bool = False,
                paged: bool = False, *, stacked: bool = False) -> Any:
    """Decode-cache specs, as the reference's: batch over the data axes,
    the trailing feature dim (head_dim / latent) over model; ``seq_shard``
    puts the ring dim over model instead where each shard keeps >= 2048
    entries; ``paged`` block pools (no batch dim) replicate over data and
    shard only the feature dim.  The port's caches are lists of per-layer
    caches (``stacked=False``); ``stacked=True`` reads the reference's
    (L, B, ...) leaves."""
    bs = batch_spec(batch_size, mesh, 0)[0]
    mp = mesh.shape["model"] if "model" in mesh.axis_names else 1
    lead = 1 if stacked else 0

    def pool_spec(path, leaf):
        ndim = len(leaf.shape)
        dims = [None] * ndim
        final = path.split("/")[-1]
        if (final in ("k", "v", "ckv", "kr") and ndim + 1 - lead >= 4
                and mp > 1 and leaf.shape[-1] % mp == 0):
            dims[-1] = "model"
        return tuple(dims)

    def leaf_spec(path, leaf):
        if paged:
            return pool_spec(path, leaf)
        ndim = len(leaf.shape)
        dims = [None] * ndim
        # batch dim: after the stacked L dim where there is one
        if stacked and ndim >= 2 and leaf.shape[1] == batch_size:
            b_idx = 1
        elif leaf.shape and leaf.shape[0] == batch_size:
            b_idx = 0
        else:
            b_idx = None
        if b_idx is not None:
            dims[b_idx] = bs
        final = path.split("/")[-1]
        ring = final in ("k", "v", "ckv", "kr", "positions")
        w_idx = (b_idx + 1) if (ring and b_idx is not None
                                and ndim > b_idx + 1) else None
        if (seq_shard and mp > 1 and w_idx is not None
                and leaf.shape[w_idx] % mp == 0
                and leaf.shape[w_idx] >= mp * 2048):
            dims[w_idx] = "model"
            return tuple(dims)
        if (ring and final != "positions" and w_idx is not None
                and ndim >= w_idx + 2 and mp > 1
                and leaf.shape[-1] % mp == 0):
            dims[-1] = "model"
        return tuple(dims)

    specs = {p: leaf_spec(p, v) for p, v in flat_paths(cache_tree)}
    return rebuild(cache_tree, specs)


# ---------------------------------------------------------------------------
# A rank's shard of a leaf
# ---------------------------------------------------------------------------


def coords(mesh, rank: int) -> dict:
    """{axis: coordinate} of ``rank``, row-major over ``axis_names``."""
    out = {}
    for a in reversed(mesh.axis_names):
        rank, out[a] = divmod(rank, mesh.shape[a])
    return out


def entry_index(entry, mesh, rank: int) -> int:
    """``rank``'s block index over a spec entry's axes, the first major."""
    c = coords(mesh, rank)
    i = 0
    for a in entry_axes(entry):
        i = i * mesh.shape[a] + c[a]
    return i


def sharded_dims(spec) -> list:
    """(dim, entry) of every sharded dim of ``spec``."""
    return [(d, e) for d, e in enumerate(spec or ()) if e is not None]


def shard_shape(shape, spec, mesh) -> tuple:
    out = list(shape)
    for d, e in sharded_dims(spec):
        out[d] //= _axis_size(e, mesh)
    return tuple(out)


def shard_leaf(full: torch.Tensor, spec, mesh, rank: int) -> torch.Tensor:
    """``rank``'s block of ``full`` under ``spec``: over each sharded dim
    (one or more), its block index over that entry's axes.  A copy where
    anything is cut, so the whole can be freed; ``full`` itself where
    nothing is."""
    out = full
    for d, e in sharded_dims(spec):
        n = _axis_size(e, mesh)
        if full.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(full.shape)} does not split "
                             f"over {e!r} ({n})")
        b = full.shape[d] // n
        out = out.narrow(d, entry_index(e, mesh, rank) * b, b)
    return out if out is full else out.clone()


def unshard_leaf(shards: list, spec, mesh) -> torch.Tensor:
    """The inverse of :func:`shard_leaf`: ``shards[r]`` is rank ``r``'s
    block; returns the whole leaf."""
    dims = sharded_dims(spec)
    if not dims:
        return shards[0]
    # one representative rank per block (the first rank holding it)
    blocks: dict = {}
    for r, t in enumerate(shards):
        blocks.setdefault(tuple(entry_index(e, mesh, r) for _, e in dims), t)

    def build(level: int, prefix: tuple):
        d, e = dims[level]
        n = _axis_size(e, mesh)
        parts = [blocks[prefix + (i,)] if level == len(dims) - 1
                 else build(level + 1, prefix + (i,)) for i in range(n)]
        return torch.cat(parts, dim=d)
    return build(0, ())


# ---------------------------------------------------------------------------
# The port's layouts
# ---------------------------------------------------------------------------


# A leaf of a block that serving may compute tensor-parallel: the block's
# path, and the leaf's name in it.  The block kinds: GQA attention (self,
# cross, encoder), the dense / shared-expert / dense-residual FFN, the
# embedding and the head.
_TP_LEAF = re.compile(
    r"^(?P<block>(?:.*/)?(?:attn|cross_attn|ffn|shared|dense|embed|lm_head))"
    r"/(?P<leaf>w[qkv]/[wb]|wo/w|wi|wi_gate|wi_up|wo|table|w)$")
# the dim of each such leaf that the block splits over model: heads or ffn
# columns (dim 1 of the column-parallel and head projections), rows of the
# row-parallel ones, vocab rows of the table, vocab columns of the head
_TP_DIM = {"wq/w": 1, "wk/w": 1, "wv/w": 1, "wq/b": 0, "wk/b": 0, "wv/b": 0,
           "wo/w": 0, "wi": 1, "wi_gate": 1, "wi_up": 1, "wo": 0,
           "table": 0, "w": 1}
_GQA = ("wq/w", "wk/w", "wv/w", "wo/w")


def tp_blocks(whole, specs: dict, mesh, head_dim: int | None) -> frozenset:
    """The paths of the blocks (``layers/3/attn``, ``layers/3/ffn/shared``,
    ``embed``) that serving computes tensor-parallel over ``model`` under
    ``specs``: every leaf of the block split over exactly ``model`` on its
    head, column or vocab dim, and for attention the four GQA projections
    present (MLA's block has none of ``wk``) with both head counts (from
    ``head_dim``) a multiple of the model axis, so the split falls on a
    head boundary.  Empty on a model axis of 1."""
    mp = mesh.shape.get("model", 1)
    if mp == 1:
        return frozenset()
    blocks: dict = {}
    for path, t in flat_paths(whole):
        m = _TP_LEAF.match(path)
        if m:
            blocks.setdefault(m["block"], {})[m["leaf"]] = (tuple(t.shape),
                                                            specs[path])
    out = set()
    for block, leaves in blocks.items():
        if not all(entry_axes(spec[_TP_DIM[leaf]]) == ("model",)
                   for leaf, (_, spec) in leaves.items()):
            continue
        if block.endswith("attn"):
            if head_dim is None or not set(_GQA) <= set(leaves):
                continue
            if any(leaves[n][0][1] // head_dim % mp for n in _GQA[:3]):
                continue
        out.add(block)
    return frozenset(out)


class Layout(NamedTuple):
    """A rank's param layout: the mesh, {param path: spec} of the whole
    params (the port's paths: ``layers/3/attn/wq/w``), and the blocks that
    serving computes tensor-parallel (:func:`tp_blocks`).  :meth:`spec`
    finds a leaf's spec from any path that ends in a param path, so the
    AdamW moments (``1/layers/...``) and checkpoint trees read it too."""
    mesh: Any
    specs: dict
    tp: frozenset = frozenset()

    def spec(self, path: str):
        parts = path.split("/")
        for i in range(len(parts)):
            got = self.specs.get("/".join(parts[i:]))
            if got is not None:
                return got
        return None

    def gather_dims(self, path: str, serve: bool = False) -> list:
        """(dim, mesh axes) that a leaf's use gathers: every sharded dim of
        a non-expert leaf; an expert leaf gathers only its hidden dim (the
        expert dim stays sharded: expert parallelism).  ``serve``: a split
        over ``model`` stays local where the leaf's block is computed
        tensor-parallel (:attr:`tp`); a split over ``data`` is gathered
        all the same.  Training passes ``serve=False``: every split."""
        spec = self.spec(path) or ()
        local = serve and self.tp_block(path) is not None
        return [(d, entry_axes(e)) for d, e in sharded_dims(spec)
                if not (is_expert_path(path) and d == 0)
                and not (local and entry_axes(e) == ("model",))]

    def tp_block(self, path: str):
        """The tensor-parallel block a param path belongs to, or None."""
        m = _TP_LEAF.match(path)
        return m["block"] if m and m["block"] in self.tp else None

    def blocks_under(self, prefix: str) -> frozenset:
        """The tensor-parallel blocks under ``prefix`` (``layers/3``), by
        their paths relative to it (``attn``, ``ffn/shared``); ``""``: the
        embedding and the head."""
        if not prefix:
            return frozenset(b for b in self.tp if "/" not in b)
        n = len(prefix) + 1
        return frozenset(b[n:] for b in self.tp if b.startswith(prefix + "/"))

    def splits_over(self, axis: str) -> bool:
        """Whether any leaf is split over mesh ``axis`` (its use then runs
        a collective over it)."""
        return any(axis in entry_axes(e) for spec in self.specs.values()
                   for e in spec)

    def expert_hidden_axes(self) -> tuple:
        """The axes the expert stacks' hidden dim shards over, or ()."""
        for p, spec in self.specs.items():
            if is_expert_path(p):
                d = 1 if p.endswith("/wo") else 2
                return entry_axes(spec[d])
        return ()


def param_specs(params, mesh, mode: str = "train", cfg=None) -> dict:
    """{port path: spec} of a whole param tree (tensors or meta tensors)
    under ``mode``: "train" (the reference's train layout) or "serve" (its
    serve layout)."""
    return dict(flat_paths(tree_specs(params, mesh, mode, cfg)))


def make_layout(cfg, mesh, mode: str = "train", *, head_aware: bool = False
                ) -> Layout:
    """The :class:`Layout` of ``cfg``'s params on ``mesh``, from their
    whole shapes (drawn on the meta device: nothing is allocated), with
    its tensor-parallel blocks."""
    from repro_torch.models import lm
    whole = lm.init_params(cfg, device="meta", param_dtype=cfg.param_dtype)
    specs = param_specs(whole, mesh, mode, cfg if head_aware else None)
    a = cfg.attention
    hd = a.head_dim if a is not None and a.kind == "gqa" else None
    return Layout(mesh, specs, tp_blocks(whole, specs, mesh, hd))


def serve_layout(cfg, mesh, batch: int, opts: dict | None = None) -> Layout:
    """The layout serving ``batch`` rows holds ``cfg``'s params in on
    ``mesh``, as the reference's ``jit_serve_step``: the train-mode specs
    by default, the serve-mode specs under ``opts["serve_tp"]`` (weights
    resident over ``model``, no FSDP), the head-aware rules under
    ``opts["head_aware"]``; a dense config's tiny batch (``batch`` below
    the model axis) drops both, as weight reads then dominate."""
    opts = dict(opts or {})
    if batch < mesh.shape.get("model", 1) and cfg.moe is None:
        opts.pop("serve_tp", None)
        opts.pop("head_aware", None)
    with option_overrides(opts, mesh):
        return make_layout(cfg, mesh,
                           "serve" if opts.get("serve_tp") else "train",
                           head_aware=bool(opts.get("head_aware")))


def shard_tree(params, layout: Layout, rank: int | None = None):
    """Every leaf of whole ``params`` cut to ``rank``'s block (default: the
    layout's mesh's own rank) by its spec."""
    from repro_torch.optim.adamw import tree_map
    mesh = layout.mesh
    rank = mesh.rank if rank is None else rank
    flat = iter([shard_leaf(t, layout.spec(p), mesh, rank)
                 for p, t in flat_paths(params)])
    return tree_map(lambda _: next(flat), params)


def spec_bytes(params_like, layout: Layout, bytes_per: int | None = None,
               rank: int = 0) -> int:
    """The bytes of ``rank``'s shards of a whole tree (tensors or meta)
    under ``layout``: each leaf's shard shape times its element size (or
    ``bytes_per``)."""
    total = 0
    for p, t in flat_paths(params_like):
        n = math.prod(shard_shape(t.shape, layout.spec(p), layout.mesh))
        total += n * (bytes_per or t.element_size())
    return total
