"""The port's train layout (``repro_torch.launch.sharding``) against the
JAX package's sharding rules, and the sharded train step across ranks.

Spec parity: for every registered arch, the port's spec of each leaf of
its own (unstacked, meta-device) param tree equals the reference's
``tree_specs`` of ``jax.eval_shape(lm.init_params)`` for the stacked leaf
without its leading L dim, on the reference's 16x16 and 2x16x16 meshes
(shape only), in train and serve mode, with and without ``cfg`` (the
head-aware rules).  ``cache_specs``, ``batch_spec``, ``sync_report`` and
``model_flops_for`` are held to the reference's too, and ``shard_leaf``
round-trips through ``unshard_leaf``.

The sharded step: one spawn of 4 gloo ranks (processes of this file run as
a script, one thread each, a ``FileStore`` in the job dir) runs reduced
fastmoe-gpt (2 layers, 4 experts, remat on, the balance loss weighted 0 so
that the single-device step is the exact counterpart of a sharded one:
its per-shard aux is not the whole batch's) in the train layout on three
meshes in turn: 2x2, 1x4, and the node mesh 1x2x2 (data, node, model); on
2x2 also under expert-internal TP (capacity, ``tp_axis="data"``), under a
forced placement with two shadowed experts, with the §5.2 chunks
(``overlap_chunks=2``), and in the psum mode (``PSUM_B`` rows, which do
not split over 4 ranks: the experts' hidden dim gathered over ``data``
beside the psum all-reduce).  Each rank's loss and grad norm, and the
updated params gathered whole, are held to the JAX package's
single-device ``make_train_step`` on the same params and tokens
(``LOSS_RTOL``, ``PARAM_ATOL`` of each leaf's largest magnitude); each
rank's resident param and moment bytes equal the sum of its spec shards;
a checkpoint the 2x2 ranks save is restored whole by the JAX package and
at 1x1 by the port.  A node axis of size 1 folds away in the port's mesh
(2x1x2 is the 2x2 mesh), so the node case runs at 1x2x2.
"""
import dataclasses
import datetime
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
SPAWN_TIMEOUT = 120
STORE_TIMEOUT = datetime.timedelta(seconds=90)
MESHES = {"2x2": (2, 1, 2), "1x4": (1, 1, 4), "1x2x2": (1, 2, 2)}
B, S = 4, 16
PSUM_B = 2  # rows of the psum case: a data rank's block each, not a rank's
LR, WARMUP, TOTAL = 1e-3, 2, 10
LOSS_RTOL = 1e-4
PARAM_ATOL = 1e-4  # of the leaf's largest magnitude
# physical slot -> logical expert: rank 0 owns 2, rank 1 owns 0; 3 and 1
# shadowed on both
PLAN = dict(num_experts=4, num_ranks=2, physical_to_logical=(2, 0, 3, 1),
            num_shadow=2)


def _cfg(package="repro_torch", dispatch="ragged"):
    import importlib
    configs = importlib.import_module(f"{package}.configs")
    cfg = configs.reduced(configs.get_config("fastmoe-gpt"), num_layers=2,
                          d_model=64)
    return dataclasses.replace(cfg, remat="full", moe=dataclasses.replace(
        cfg.moe, dispatch=dispatch, capacity_factor=8.0,
        balance_loss_weight=0.0))


def _tokens(rows=B):
    return np.random.default_rng(7).integers(0, 512, (B, S)).astype(
        np.int32)[:rows]


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat):
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        *path, leaf = key.split("/")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


# ---------------------------------------------------------------------------
# Rank side (repro_torch only)
# ---------------------------------------------------------------------------


def _gather_whole(params, layout, mesh):
    """Every leaf gathered over each sharded dim of its spec."""
    from repro_torch.core import comm
    from repro_torch.launch.sharding import entry_axes, flat_paths, \
        sharded_dims
    from repro_torch.optim.adamw import tree_map
    out = []
    for path, t in flat_paths(params):
        for d, e in sharded_dims(layout.spec(path)):
            axes = entry_axes(e)
            if mesh.axes_size(axes) > 1:
                t = comm.all_gather_rows(t.detach(), mesh.group(axes), d)
        out.append(t.detach())
    it = iter(out)
    return tree_map(lambda _: next(it), params)


def _case(key, mesh, params_np, out, job, *, dispatch="ragged",
          expert_tp=False, placed=False, save=False, rows=B,
          overlap_chunks=0):
    from repro_torch import interop
    from repro_torch import placement as TP
    from repro_torch.checkpoint import ckpt
    from repro_torch.core.fmoe import moe_dist
    from repro_torch.launch import train
    from repro_torch.launch.sharding import make_layout, spec_bytes
    from repro_torch.models import lm
    from repro_torch.optim import AdamW
    from repro_torch.optim.adamw import tree_leaves

    cfg = _cfg(dispatch=dispatch)
    layout = make_layout(cfg, mesh, "train")
    plan = TP.ExpertPlacement(**PLAN) if placed else None
    dist = moe_dist(cfg, mesh, rows, seq_len=S, layout=layout,
                    expert_tp=expert_tp, placement=plan,
                    overlap_chunks=overlap_chunks)
    assert dist.mode == ("a2a" if rows == B else "psum")
    assert dist.layout is layout and dist.overlap_chunks == overlap_chunks
    assert (dist.tp_axis, dist.fsdp_axis) == (
        ("data", None) if expert_tp else (None, "data"))
    params = interop.from_jax(params_np, cfg, device="cpu", layout=layout)
    opt = AdamW(lr=LR)
    state = opt.init(params)
    whole = lm.init_params(cfg, device="meta", param_dtype="float32")
    nbytes = lambda tree: sum(t.numel() * t.element_size()
                              for t in tree_leaves(tree))
    out[f"{key}/resident"] = np.asarray(
        [nbytes(params), nbytes((state.mu, state.nu)),
         spec_bytes(whole, layout, rank=mesh.rank),
         spec_bytes(whole, layout, 8, rank=mesh.rank)])
    if plan is not None:
        for tree in (params, state.mu, state.nu):
            TP.from_logical(tree, plan, mesh=mesh)
    step = train.make_train_step(cfg, opt, dist=dist, warmup=WARMUP,
                                 total_steps=TOTAL, impl="fused",
                                 device="cpu")
    params, state, m = step(params, state,
                            {"tokens": torch.from_numpy(_tokens(rows))}, 0)
    out[f"{key}/loss"] = m["loss"].detach()
    out[f"{key}/grad_norm"] = m["grad_norm"].detach()
    if plan is not None:
        TP.to_logical(params, plan, mesh=mesh)
    for k, v in _flatten(interop.to_jax(_gather_whole(params, layout,
                                                      mesh))).items():
        out[f"{key}/params/{k}"] = v
    if save:
        ckpt.save(str(job / "ckpt"), {"params": params}, step=1,
                  layout=layout)


def _rank_main(job: Path, rank: int) -> None:
    import torch.distributed as tdist
    from repro_torch.launch.mesh import init_distributed, make_local_mesh

    torch.set_num_threads(1)
    init_distributed("cpu", rank=rank, world_size=4,
                     store=tdist.FileStore(str(job / "store"), 4),
                     timeout=STORE_TIMEOUT)
    params_np = _unflatten(dict(np.load(job / "params.npz")))
    out: dict = {}
    for name, (data, node, model) in MESHES.items():
        mesh = make_local_mesh(data, model, node)
        _case(name, mesh, params_np, out, job, save=name == "2x2")
        if name == "2x2":
            _case("2x2_tp", mesh, params_np, out, job, dispatch="capacity",
                  expert_tp=True)
            _case("2x2_placed", mesh, params_np, out, job, placed=True)
            _case("2x2_chunks", mesh, params_np, out, job, overlap_chunks=2)
            _case("2x2_psum", mesh, params_np, out, job, rows=PSUM_B)
    np.savez(job / f"rank{rank}.npz",
             **{k: (v.numpy() if isinstance(v, torch.Tensor)
                    else np.asarray(v)) for k, v in out.items()})
    tdist.barrier()
    tdist.destroy_process_group()


# ---------------------------------------------------------------------------
# Test process
# ---------------------------------------------------------------------------


def _spawn(job: Path, world: int):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    logs = [job / f"rank{r}.log" for r in range(world)]
    procs = []
    for r, log in enumerate(logs):
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, str(job), str(r)], env=env,
                cwd=ROOT, stdout=f, stderr=subprocess.STDOUT))
    start = time.monotonic()

    def wait():
        ok = True
        for p in procs:
            left = max(1.0, SPAWN_TIMEOUT - (time.monotonic() - start))
            try:
                p.wait(timeout=left)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                p.wait()
                ok = False
            ok &= p.returncode == 0
        return ok, "\n".join(f"{log.name}: {log.read_text()[-3000:]}"
                              for log in logs)
    return wait


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The 4-rank spawn and, meanwhile, the JAX single-device step."""
    import jax
    import jax.numpy as jnp
    from repro.launch.train import make_train_step
    from repro.models import lm as jlm
    from repro.optim import AdamW as JAdamW

    job = tmp_path_factory.mktemp("sharded")
    jcfg = _cfg("repro")
    params = jlm.init_params(jax.random.PRNGKey(3), jcfg)
    np.savez(job / "params.npz",
             **_flatten(jax.tree.map(np.asarray, params)))
    t0 = time.monotonic()
    wait = _spawn(job, 4)
    opt = JAdamW(lr=LR)
    step = jax.jit(make_train_step(jcfg, opt, warmup=WARMUP, total_steps=TOTAL,
                                   impl="einsum"))
    refs = {}
    for rows in (B, PSUM_B):
        new, _, m = step(params, opt.init(params),
                         {"tokens": jnp.asarray(_tokens(rows))}, 0)
        refs[rows] = dict(loss=float(m["loss"]), gnorm=float(m["grad_norm"]),
                          params=_flatten(jax.tree.map(np.asarray, new)))
    ok, logs = wait()
    ranks = ([dict(np.load(job / f"rank{r}.npz")) for r in range(4)]
             if ok else None)
    return dict(job=job, ok=ok, logs=logs, ranks=ranks,
                wall=time.monotonic() - t0, params=params, refs=refs)


def _ranks(sharded):
    assert sharded["ok"], sharded["logs"]
    return sharded["ranks"]


CASES = ["2x2", "1x4", "1x2x2", "2x2_tp", "2x2_placed", "2x2_chunks",
         "2x2_psum"]


@pytest.mark.parametrize("key", CASES)
def test_sharded_step_matches_jax_single_device(sharded, key):
    """Loss and grad norm on every rank, and the params after one AdamW
    step gathered whole, against the JAX package's single-device step on
    the same rows."""
    ref = sharded["refs"][PSUM_B if key.endswith("psum") else B]
    for r in _ranks(sharded):
        np.testing.assert_allclose(r[f"{key}/loss"], ref["loss"],
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(r[f"{key}/grad_norm"], ref["gnorm"],
                                   rtol=LOSS_RTOL)
        for k, want in ref["params"].items():
            got = r[f"{key}/params/{k}"]
            scale = float(np.max(np.abs(want))) or 1.0
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=PARAM_ATOL * scale, err_msg=k)


@pytest.mark.parametrize("key", ["2x2", "1x4", "1x2x2", "2x2_tp"])
def test_rank_holds_only_its_spec_shards(sharded, key):
    """Each rank's resident params (f32) and moments (8 B a param) are the
    sum of its spec shards, less than the whole on every mesh of 4."""
    whole = sum(v.size * 4 for v in _flatten(jax_free(sharded)).values())
    for r in _ranks(sharded):
        params, moments, spec_params, spec_moments = r[f"{key}/resident"]
        assert params == spec_params and moments == spec_moments, (
            key, r[f"{key}/resident"])
        assert params < whole


def jax_free(sharded):
    import jax
    return jax.tree.map(np.asarray, sharded["params"])


def test_sharded_spawn_is_quick(sharded):
    """The spawn and the JAX step together, inside the budget."""
    _ranks(sharded)
    assert sharded["wall"] < 45, sharded["wall"]


def test_2x2_checkpoint_restores_in_jax_and_at_1x1(sharded):
    """The 2x2 ranks' checkpoint (rank 0 writes the whole tree) restored by
    the JAX package whole and by the port at 1x1 equals the params the
    ranks gathered, bit for bit."""
    import jax
    from repro.checkpoint import ckpt as jckpt
    from repro_torch import interop
    from repro_torch.checkpoint import ckpt

    r0 = _ranks(sharded)[0]
    want = {k[len("2x2/params/"):]: v for k, v in r0.items()
            if k.startswith("2x2/params/")}
    path = str(sharded["job"] / "ckpt")
    jlike = {"params": jax.tree.map(np.zeros_like, sharded["params"])}
    got = _flatten(jax.tree.map(np.asarray,
                                jckpt.restore(path, jlike)["params"]))
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    like = interop.from_jax(jlike["params"], _cfg(), device="cpu")
    back = ckpt.restore(path, {"params": like})["params"]
    for k, v in _flatten(interop.to_jax(back)).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


# ---------------------------------------------------------------------------
# Spec parity with the reference (shape-only meshes)
# ---------------------------------------------------------------------------


def _meshes():
    from repro.compat import make_abstract_mesh
    from repro_torch.launch.sharding import ShapeMesh
    return [(make_abstract_mesh((16, 16), ("data", "model")),
             ShapeMesh.of(data=16, model=16)),
            (make_abstract_mesh((2, 16, 16), ("pod", "data", "model")),
             ShapeMesh.of(pod=2, data=16, model=16))]


def _port_vs_ref(port_flat: dict, ref_flat: dict) -> list:
    """Mismatches: a port path ``layers/3/x`` takes the reference's
    ``layers/x`` without its leading None."""
    bad = []
    for path, spec in port_flat.items():
        parts = path.split("/")
        if parts[0] in ("layers", "enc_layers"):
            ref = tuple(ref_flat["/".join([parts[0]] + parts[2:])])
            assert ref[0] is None, (path, ref)
            ref = ref[1:]
        else:
            ref = tuple(ref_flat[path])
        if tuple(spec) != ref:
            bad.append((path, spec, ref))
    return bad


def _archs():
    from repro_torch.configs import ARCHS
    return sorted(ARCHS)


@pytest.mark.parametrize("arch", _archs())
def test_spec_tree_matches_reference(arch):
    """Every leaf, both meshes, train and serve, with and without cfg."""
    import jax
    from repro.configs import get_config as jget
    from repro.launch import sharding as JS
    from repro.models import lm as jlm
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as S
    from repro_torch.models import lm

    cfg, jcfg = get_config(arch), jget(arch)
    shapes = jax.eval_shape(lambda: jlm.init_params(jax.random.PRNGKey(0),
                                                     jcfg))
    port = lm.init_params(cfg, device="meta", param_dtype=cfg.param_dtype)
    for jmesh, pmesh in _meshes():
        for mode in ("train", "serve"):
            for with_cfg in (False, True):
                ref = dict(JS._flat_paths(JS.tree_specs(
                    shapes, jmesh, mode, jcfg if with_cfg else None)))
                got = S.param_specs(port, pmesh, mode,
                                    cfg if with_cfg else None)
                assert set(got) and len(got) >= len(ref)
                bad = _port_vs_ref(got, ref)
                assert not bad, (arch, pmesh.shape, mode, with_cfg, bad[:4])


@pytest.mark.parametrize("arch,paged", [("granite-3-2b", False),
                                        ("deepseek-v2-236b", False),
                                        ("granite-3-2b", True),
                                        ("deepseek-v2-236b", True)])
def test_cache_specs_match_reference(arch, paged):
    """Ring caches (feature-sharded and, at a 32k ring, seq-sharded) and
    paged pools: each port layer's cache spec is the reference's stacked
    spec without its L dim."""
    import jax
    from repro.configs import get_config as jget
    from repro.launch import sharding as JS
    from repro.models import lm as jlm
    from repro_torch.configs import get_config
    from repro_torch.launch import sharding as S
    from repro_torch.models import lm

    cfg, jcfg = get_config(arch), jget(arch)
    cfg = dataclasses.replace(cfg, num_layers=2)
    jcfg = dataclasses.replace(jcfg, num_layers=2)
    batch, ring = 32, 32768
    if paged:
        jc = jax.eval_shape(lambda: jlm.init_paged_cache(jcfg, 64, 16))
        pc = lm.init_paged_cache(cfg, 64, 16, device="meta")
    else:
        jc = jax.eval_shape(lambda: jlm.init_cache(jcfg, batch, ring))
        pc = lm.init_cache(cfg, batch, ring, device="meta")
    for jmesh, pmesh in _meshes():
        for seq in (False, True):
            ref = dict(JS._flat_paths(JS.cache_specs(
                jc, jmesh, batch, seq_shard=seq, paged=paged)))
            got = dict(S.flat_paths(S.cache_specs(
                pc, pmesh, batch, seq_shard=seq, paged=paged)))
            assert got
            for path, spec in got.items():
                layer, rest = path.split("/", 1)
                want = tuple(ref[rest])
                assert tuple(spec) == want[1:] and want[0] is None, (
                    arch, path, spec, want)


def test_batch_spec_and_sync_report_match_reference():
    from repro.configs import get_config as jget
    from repro.core import sync as jsync
    from repro.launch import sharding as JS
    from repro_torch.configs import get_config
    from repro_torch.core import sync
    from repro_torch.launch import sharding as S
    from repro_torch.models import lm

    for jmesh, pmesh in _meshes():
        for b in (1, 2, 16, 32, 48, 256):
            for extra in (0, 1, 2):
                assert S.batch_spec(b, pmesh, extra) == tuple(
                    JS.batch_spec(b, jmesh, extra)), (b, extra)
        for arch in ("arctic-480b", "deepseek-v2-236b", "fastmoe-gpt"):
            cfg = get_config(arch)
            specs = S.param_specs(lm.init_params(cfg, device="meta"), pmesh)
            got = sync.sync_report(specs, pmesh.axis_names)
            want = jsync.sync_report(specs, jmesh.axis_names)
            assert got == want
            tags = {t for t, _ in got.values()}
            assert tags == {"world", "dp", "none"}, tags
    assert jget("fastmoe-gpt").name == "fastmoe-gpt"


def test_model_flops_match_reference():
    from repro.configs import INPUT_SHAPES as JSHAPES
    from repro.configs import get_config as jget
    from repro.launch.roofline import model_flops_for as jflops
    from repro_torch.configs import ARCHS, INPUT_SHAPES, get_config
    from repro_torch.launch.roofline import model_flops_for

    assert set(INPUT_SHAPES) == set(JSHAPES)
    for arch in ARCHS:
        for name, shape in INPUT_SHAPES.items():
            assert model_flops_for(get_config(arch), shape) == jflops(
                jget(arch), JSHAPES[name]), (arch, name)


@pytest.mark.parametrize("spec", [("data", None), (None, "model"),
                                  ("model", "data"),
                                  (("data", "model"), None),
                                  (("node", "model"), None, "data")])
def test_shard_leaf_round_trip(spec):
    """Every rank's block, put back together, is the whole; blocks of
    ranks that differ on a sharded axis differ."""
    from repro_torch.launch import sharding as S
    mesh = S.ShapeMesh.of(data=2, node=2, model=2)
    shape = (8, 4, 6)[:len(spec)]
    full = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(
        shape)
    world = 8
    shards = [S.shard_leaf(full, spec, mesh, r) for r in range(world)]
    assert shards[0].shape == S.shard_shape(shape, spec, mesh)
    assert torch.equal(S.unshard_leaf(shards, spec, mesh), full)
    if spec == (("node", "model"), None, "data"):
        # rank (d, n, m): block n * 2 + m of dim 0, block d of dim 2
        r = 1 * 4 + 1 * 2 + 0  # d=1, n=1, m=0
        assert torch.equal(shards[r], full[4:6, :, 3:6])


if __name__ == "__main__":
    _rank_main(Path(sys.argv[1]), int(sys.argv[2]))
