"""Checkpoints on the JAX package's on-disk format, so a checkpoint written
by either package loads in the other.

Layout: one directory per step with a JSON manifest mapping the flat keys
of the reference's tree to file names, dtypes, shapes and sha256 checksums,
each array a ``.npy`` file as ``np.save`` writes it (bf16 stored as f32,
declared bf16).  The tree on disk is the reference's: the params' layers
stacked on a leading L dim (``interop.to_jax`` stacks them alike), the
AdamW state ``AdamWState(step, mu, nu)`` with ``step`` a 0-d int32, the
flat keys the reference's ``_flatten`` keys, the dtypes under numpy's
names.  :func:`restore` takes the port's own tree as ``like`` (layers a
list of per-layer dicts) and gives it back in that layout, on the ``like``
tree's device.

The expert stacks are written whole and in logical expert order: on a mesh
(``mesh=``) every rank gathers its shards over the expert axes (and the
hidden dim over ``data`` under ``expert_tp``) and rank 0 writes while the
others wait at a barrier; under a placement (``placement=``) the physical
order is undone through ``placement.migrate.to_logical``.  :func:`restore`
applies ``from_logical`` and each rank keeps its shard, so a checkpoint
from any mesh and layout restores on any other.

Durability, as the reference's:

* atomic commit: the arrays and the manifest go to a hidden temp directory
  (``.tmp-<name>.<pid>``), fsynced, published by one ``os.replace``; a
  crash (even SIGKILL) mid-save leaves only the temp dir, which
  :func:`latest_step` and :func:`complete_steps` never consider;
* verified restore: the manifest's ``"complete": true`` marker (written
  last, inside the atomic unit) and a sha256 per array; :func:`restore`
  refuses an incomplete manifest and a checksum mismatch with
  :class:`CheckpointError`; a structure, shape or dtype that does not
  match ``like`` is a ``ValueError``;
* retention: :func:`gc_checkpoints` keeps the newest N complete
  checkpoints and sweeps stale temp dirs.

The fault points ``ckpt_save_file``, ``ckpt_save_arrays`` and
``ckpt_save_pre_commit`` (``repro_torch.resilience.faults``) fire where
the reference fires them.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
from typing import Any

import numpy as np
import torch

from repro_torch.obs import trace as obs_trace

MANIFEST = "manifest.json"
_STEP_RE = re.compile(r"^step_(\d+)$")


class CheckpointError(RuntimeError):
    """A checkpoint on disk is missing, incomplete, or fails verification."""


def _flatten(tree: Any, prefix: str = "") -> dict:
    """The reference's flat keys: dict keys sorted, list indices, NamedTuple
    fields in order, joined by "/"."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif hasattr(tree, "_fields"):  # NamedTuple
        for k in tree._fields:
            out.update(_flatten(getattr(tree, k), f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


class _Leaf:
    """One array of the reference's tree: the port leaves it is made of, as
    (port path, value), several when the layers are stacked on L."""

    def __init__(self, parts: list, stacked: bool = False):
        self.parts, self.stacked = parts, stacked


def _view(tree: Any, path: str = "") -> Any:
    """The port tree in the reference's structure, its leaves :class:`_Leaf`:
    a ``layers`` list of per-layer dicts becomes one dict whose leaves stack
    the layers'."""
    join = (lambda k: f"{path}/{k}") if path else str
    if isinstance(tree, dict):
        return {k: (_stack([_view(l, f"{join(k)}/{i}") for i, l in enumerate(v)])
                    if k == "layers" and isinstance(v, list) else _view(v, join(k)))
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_view(getattr(tree, f), join(f))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return [_view(v, join(i)) for i, v in enumerate(tree)]
    return _Leaf([(path, tree)])


def _stack(views: list) -> Any:
    if isinstance(views[0], dict):
        return {k: _stack([v[k] for v in views]) for k in views[0]}
    return _Leaf([p for v in views for p in v.parts], stacked=True)


def _dtype_name(v) -> str:
    """numpy's name for a leaf's dtype ("float32", "bfloat16", "int32")."""
    if isinstance(v, torch.Tensor):
        return str(v.dtype).replace("torch.", "")
    if isinstance(v, (bool, int, np.integer)):
        return "int32"  # a step counter: the reference's 0-d int32
    return str(np.asarray(v).dtype)


def _is_expert(path: str) -> bool:
    return "experts" in path.split("/")


def _hidden_dim(path: str) -> int:
    return 1 if path.split("/")[-1] == "wo" else 2


def _one_leaf(path: str, leaf) -> dict:
    """A tree holding only ``leaf`` at ``path``, so that ``placement.
    migrate``'s walk finds its expert key and its layer."""
    tree = leaf
    for k in reversed(path.split("/")):
        tree = {k: tree}
    return tree


def _get(tree: dict, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


def _num_shadow(placement) -> int:
    if placement is None:
        return 0
    g = getattr(placement, "geometry", placement)
    return int(g.num_shadow)


def _whole(path: str, t: torch.Tensor, *, placement, mesh,
           expert_tp: bool) -> torch.Tensor:
    """A rank's leaf -> the whole leaf, in its physical order (collective
    on a mesh: every rank calls this for every leaf in the same order)."""
    t = t.detach()
    if _is_expert(path) and mesh is not None:
        from repro_torch.core import comm
        if expert_tp and mesh.shape["data"] > 1:
            t = comm.all_gather_rows(t, mesh.group("data"), _hidden_dim(path))
        if mesh.axes_size(mesh.expert_axes) > 1:
            own = t.shape[0] - _num_shadow(placement)
            t = torch.cat([comm.all_gather_rows(
                t[:own], mesh.group(mesh.expert_axes)), t[own:]])
    return t


def _to_host(path: str, t: torch.Tensor, out: np.ndarray, placement) -> None:
    """Copy the whole leaf ``t`` into the host array ``out`` (f32 for bf16:
    np.save can't hold bf16, which is stored as f32 and declared bf16), in
    logical expert order."""
    dst = torch.from_numpy(out)
    dst.copy_(t)
    if _is_expert(path) and placement is not None:
        from repro_torch.placement.migrate import to_logical
        to_logical(_one_leaf(path, dst), placement)  # in place, on the host


def _np_dtype(t: torch.Tensor):
    return np.float32 if t.dtype == torch.bfloat16 else \
        torch.empty((), dtype=t.dtype).numpy().dtype


def _host(v) -> np.ndarray:
    """A non-tensor leaf as the reference stores it (a step: 0-d int32)."""
    if isinstance(v, (bool, int, np.integer)):
        return np.asarray(v, np.int32)
    return np.asarray(v)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


class _Hashing:
    """A write-only file that hashes what it is given (and passes it on to
    ``f`` where set): the digest of an ``.npy`` file as ``np.save`` writes
    it, taken on the way out, with no second read."""

    def __init__(self, f=None):
        self.f, self.h = f, hashlib.sha256()

    def write(self, b) -> int:
        self.h.update(b)
        return self.f.write(b) if self.f is not None else len(b)


def _write(fpath, arr: np.ndarray) -> str:
    """np.save ``arr`` to ``fpath`` (fsynced, or nowhere for None); its
    sha256."""
    if fpath is None:
        out = _Hashing()
        np.save(out, arr)
        return out.h.hexdigest()
    with open(fpath, "wb") as f:
        out = _Hashing(f)
        np.save(out, arr)
        f.flush()
        os.fsync(f.fileno())
    return out.h.hexdigest()


def _fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _barrier(mesh) -> None:
    if mesh is not None and mesh.size > 1:
        torch.distributed.barrier(group=mesh.group(mesh.axis_names))


_WRITERS = min(8, os.cpu_count() or 1)  # files written and hashed at once
# host bytes of arrays handed to the writers and not yet written, at most:
# sha256 runs at well under 1 GB/s a thread, so the large expert stacks are
# hashed side by side
_IN_FLIGHT_BYTES = 8 * 2 ** 30


def _arrays(tree, *, placement, mesh, expert_tp, lead):
    """(key, dtype name, whole logical-order host array or None off the
    lead rank) of every array of the reference's tree, in its key order:
    the gathers of a mesh run in that order on every rank.  A stacked
    array is allocated once and each layer copied into its slot."""
    for key, leaf in _flatten(_view(tree)).items():
        arr = None
        for i, (p, v) in enumerate(leaf.parts):
            if not isinstance(v, torch.Tensor):
                arr = _host(v)
                continue
            t = _whole(p, v, placement=placement, mesh=mesh,
                       expert_tp=expert_tp)
            if not lead:
                continue
            if arr is None:
                arr = np.empty(((len(leaf.parts),) if leaf.stacked else ())
                               + tuple(t.shape), _np_dtype(t))
            _to_host(p, t, arr[i] if leaf.stacked else arr, placement)
            del t
        yield key, _dtype_name(leaf.parts[0][1]), arr if lead else None


def _write_all(tree, folder, *, placement, mesh, expert_tp, lead) -> dict:
    """Write every array to ``folder`` (None: hash only), several files at
    once while the next arrays come off the card; {key: (file, dtype,
    shape, sha256)} in key order (empty off the lead rank)."""
    from concurrent.futures import ThreadPoolExecutor
    out, pending = {}, []
    with ThreadPoolExecutor(_WRITERS) as pool:
        for i, (key, dtype, arr) in enumerate(_arrays(
                tree, placement=placement, mesh=mesh, expert_tp=expert_tp,
                lead=lead)):
            if arr is None:
                continue
            fname = f"arr_{i:05d}.npy"
            fpath = None if folder is None else os.path.join(folder, fname)
            out[key] = (fname, dtype, list(arr.shape))
            pending.append((key, arr.nbytes, pool.submit(_write, fpath, arr)))
            del arr
            while (len([1 for _, _, f in pending if not f.done()]) > 1
                   and sum(n for _, n, f in pending if not f.done())
                   > _IN_FLIGHT_BYTES):
                next(f for _, _, f in pending if not f.done()).result()
        return {k: (*out[k], f.result()) for k, _, f in pending}


def digests(tree: Any, *, placement=None, mesh=None,
            expert_tp: bool = False) -> dict:
    """{flat key: sha256} of the arrays :func:`save` would write for
    ``tree`` (the same ``.npy`` bytes), written nowhere: a digest of a
    training state to hold against a checkpoint's manifest.  Collective on
    a mesh, as :func:`save`; rank 0's result, {} on the others."""
    lead = mesh is None or mesh.rank == 0
    got = _write_all(tree, None, placement=placement, mesh=mesh,
                     expert_tp=expert_tp, lead=lead)
    return {k: v[3] for k, v in got.items()}


def save(path: str, tree: Any, *, step: int | None = None, placement=None,
         mesh=None, expert_tp: bool = False) -> None:
    """Write ``tree`` (the port's: params, or ``{"params": ..., "opt":
    AdamWState}``) to ``path`` atomically, in the reference's format.

    ``placement`` (ExpertPlacement or PerLayerPlacement): the tree's
    physical expert layout, undone before writing (checkpoints are in
    logical expert order).  ``mesh``: the tree is this rank's shard; every
    rank must call this, rank 0 writes the whole tree and the others wait
    at a barrier (``expert_tp``: the expert stacks are also hidden-sharded
    over ``data``).  The live tree is not changed.  The files are written
    and hashed by a few threads while the next arrays are copied off the
    card; the ``ckpt_save_file`` point then fires for each, in key order.
    """
    from repro_torch.resilience import faults  # resilience imports this
    lead = mesh is None or mesh.rank == 0
    with obs_trace.span("ckpt_save", path=path, step=step):
        tmp = None
        if lead:
            path = os.path.abspath(path)
            parent, base = os.path.split(path)
            os.makedirs(parent, exist_ok=True)
            tmp = os.path.join(parent, f".tmp-{base}.{os.getpid()}")
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
        written = _write_all(tree, tmp, placement=placement, mesh=mesh,
                             expert_tp=expert_tp, lead=lead)
        if lead:
            manifest = {"format": 2, "step": step, "complete": True,
                        "params": {}}
            for key, (fname, dtype, shape, digest) in written.items():
                # post-checksum injection point: bit-rot after the write,
                # which restore must catch
                faults.fire("ckpt_save_file", file=os.path.join(tmp, fname),
                            key=key)
                manifest["params"][key] = {"file": fname, "dtype": dtype,
                                           "shape": shape, "sha256": digest}
            # a crash here: arrays on disk, no manifest, the temp dir
            # invisible to latest_step/complete_steps
            faults.fire("ckpt_save_arrays", step=step, path=path)
            mpath = os.path.join(tmp, MANIFEST)
            with open(mpath, "w") as f:
                json.dump(manifest, f, indent=1)
                f.flush()
                os.fsync(f.fileno())
            _fsync_file(tmp)
            # a crash here: a whole temp dir, not yet published
            faults.fire("ckpt_save_pre_commit", step=step, path=path)
            if os.path.isdir(path):  # a re-save of the same step
                shutil.rmtree(path)
            os.replace(tmp, path)
            _fsync_file(parent)
        _barrier(mesh)


def load_manifest(path: str) -> dict:
    """The checkpoint's manifest; :class:`CheckpointError` when missing or
    unreadable."""
    mpath = os.path.join(path, MANIFEST)
    try:
        with open(mpath) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointError(f"{path}: unreadable manifest ({e})") from e


def is_complete(path: str) -> bool:
    """True iff ``path`` holds a committed checkpoint."""
    try:
        return bool(load_manifest(path).get("complete"))
    except CheckpointError:
        return False


def _whole_shape(path: str, t: torch.Tensor, *, placement, mesh,
                 expert_tp: bool) -> tuple:
    """The shape of the whole leaf whose shard (in the placement's physical
    layout) is ``t``."""
    shape = list(t.shape)
    if not _is_expert(path):
        return tuple(shape)
    if placement is not None:
        shape[0] = int(getattr(placement, "geometry", placement).num_experts)
    elif mesh is not None:
        shape[0] *= mesh.axes_size(mesh.expert_axes)
    if mesh is not None and expert_tp:
        shape[_hidden_dim(path)] *= mesh.shape["data"]
    return tuple(shape)


def _shard(path: str, t: torch.Tensor, *, placement, mesh,
           expert_tp: bool) -> torch.Tensor:
    """The whole leaf in logical order -> this rank's shard in the
    placement's physical layout."""
    if not _is_expert(path):
        return t
    if placement is not None:
        from repro_torch.placement.migrate import from_logical
        t = _get(from_logical(_one_leaf(path, t), placement), path)
    if mesh is None:
        return t
    from repro_torch import interop
    S = _num_shadow(placement)
    E = t.shape[0]
    if S and mesh.axes_size(mesh.expert_axes) > 1:
        # the rank's owned block of the physical order, then every shadow
        own = _one_leaf(path, t[:E - S])
        mine = _get(interop.shard_params(own, mesh, expert_tp=expert_tp), path)
        return torch.cat([mine, t[E - S:]])
    return _get(interop.shard_params(_one_leaf(path, t), mesh,
                                     expert_tp=expert_tp), path)


def restore(path: str, like: Any, *, placement=None, verify: bool = True,
            mesh=None, expert_tp: bool = False, inplace: bool = False) -> Any:
    """Restore into the structure of ``like`` (the port's tree, a rank's
    shard on a mesh, in ``placement``'s physical layout), validating keys,
    shapes and dtypes.

    Refuses an incomplete checkpoint and (with ``verify``, the default) an
    array whose sha256 no longer matches the manifest, both
    :class:`CheckpointError`; every checksum is checked before any array
    is loaded.  The dtypes must match ``like``'s exactly; the one coercion
    is bf16's f32 storage.  Returns a new tree on ``like``'s devices, or
    with ``inplace`` copies into ``like``'s tensors and returns ``like``
    (a Python int leaf, AdamW's step, comes back in the returned tree).
    """
    with obs_trace.span("ckpt_restore", path=path):
        manifest = load_manifest(path)
        if not manifest.get("complete"):
            raise CheckpointError(
                f"{path}: incomplete checkpoint (manifest lacks the "
                f"'complete' marker)")
        flat_like = _flatten(_view(like))
        missing = set(flat_like) - set(manifest["params"])
        extra = set(manifest["params"]) - set(flat_like)
        if missing or extra:
            raise ValueError(
                f"checkpoint mismatch: missing={sorted(missing)[:5]} "
                f"extra={sorted(extra)[:5]}")
        if verify:  # every file hashed (a few at once) before any load
            from concurrent.futures import ThreadPoolExecutor
            metas = [(k, m) for k, m in manifest["params"].items()
                     if "sha256" in m]
            with ThreadPoolExecutor(_WRITERS) as pool:
                got = pool.map(_sha256, [os.path.join(path, m["file"])
                                         for _, m in metas])
                for (key, meta), digest in zip(metas, got):
                    if digest != meta["sha256"]:
                        raise CheckpointError(
                            f"{path}: checksum mismatch for {key} "
                            f"({meta['file']}): {digest[:12]} != "
                            f"{meta['sha256'][:12]}")
        kw = dict(placement=placement, mesh=mesh, expert_tp=expert_tp)
        loaded = {}  # port path -> restored leaf
        for key, leaf in flat_like.items():
            meta = manifest["params"][key]
            want = _dtype_name(leaf.parts[0][1])
            if meta["dtype"] != want:
                raise ValueError(
                    f"{key}: manifest dtype {meta['dtype']} != {want} in the "
                    f"restore target — refusing the silent cast (only the "
                    f"bf16 storage round-trip is coerced)")
            arr = np.load(os.path.join(path, meta["file"]))
            for i, (p, v) in enumerate(leaf.parts):
                a = arr[i] if leaf.stacked else arr
                if not isinstance(v, torch.Tensor):
                    if tuple(a.shape) != np.shape(v):
                        raise ValueError(f"{key}: shape {a.shape} != "
                                         f"{np.shape(v)}")
                    loaded[p] = type(v)(a) if np.ndim(v) == 0 else a
                    continue
                whole = _whole_shape(p, v, **kw)
                if tuple(a.shape) != whole:
                    raise ValueError(f"{key}: shape "
                                     f"{(len(arr),) * leaf.stacked + a.shape}"
                                     f" != {(len(leaf.parts),) * leaf.stacked + whole}")
                t = torch.from_numpy(np.ascontiguousarray(a)).to(v.device,
                                                                 v.dtype)
                t = _shard(p, t, **kw)
                if inplace:
                    with torch.no_grad():
                        v.copy_(t)
                    t = v
                loaded[p] = t
            del arr
        return _rebuild(like, loaded, "")


def _rebuild(like: Any, loaded: dict, path: str) -> Any:
    join = (lambda k: f"{path}/{k}") if path else str
    if isinstance(like, dict):
        out = {k: _rebuild(v, loaded, join(k)) for k, v in like.items()}
        return out
    if hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, f), loaded, join(f))
                            for f in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, loaded, join(i))
                          for i, v in enumerate(like))
    return loaded[path]


def step_path(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:08d}")


def complete_steps(root: str) -> list:
    """``[(step, path)]`` of the *complete* checkpoints under ``root``,
    sorted numerically (``step_9`` < ``step_10000``).  A directory with a
    missing or unreadable manifest, or without the ``"complete"`` marker,
    is skipped: a torn write never wins."""
    if not os.path.isdir(root):
        return []
    out = []
    for d in os.listdir(root):
        m = _STEP_RE.match(d)
        p = os.path.join(root, d)
        if m is None or not os.path.isdir(p) or not is_complete(p):
            continue
        out.append((int(m.group(1)), p))
    return sorted(out)


def latest_step(root: str) -> str | None:
    """Path of the newest *complete* checkpoint under ``root`` (or None)."""
    steps = complete_steps(root)
    return steps[-1][1] if steps else None


def gc_checkpoints(root: str, *, keep: int = 3) -> list:
    """Remove all but the newest ``keep`` complete checkpoints, plus any
    stale ``.tmp-*`` dirs of crashed saves.  Returns the removed paths."""
    removed = []
    if not os.path.isdir(root) or keep < 1:
        return removed
    for n, p in complete_steps(root)[:-keep]:
        shutil.rmtree(p)
        removed.append(p)
    pid_suffix = f".{os.getpid()}"
    for d in os.listdir(root):
        p = os.path.join(root, d)
        if (d.startswith(".tmp-") and os.path.isdir(p)
                and not d.endswith(pid_suffix)):  # not this process's own
            shutil.rmtree(p)
            removed.append(p)
    return removed
