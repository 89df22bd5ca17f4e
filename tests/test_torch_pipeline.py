"""The §5.2 smart schedule and the two-level exchange of the port, in one
process, against the JAX package.

* ``resolve_chunks`` against ``repro.core.pipeline.resolve_chunks``;
* the two-level exchange's plans (``make_hier_agg``,
  ``ragged_recv_compact_hier``, ``hier_chunk_plans``) on seeded numpy
  counts against the reference's,
  exactly, with inter bounds that keep every row and bounds that drop
  (the reference's own cases of ``tests/test_hier_a2a.py`` among them);
* the wire dtype, ``moe_dist``'s options and its ``ragged_bound="auto"``
  without a load monitor, the node mesh (coordinates, groups' axes, the
  expert shard node-major, per-rank init equal to the whole's slices) and
  serving's refusal of a node axis.

The exchanges themselves run across gloo ranks in
``tests/test_torch_ep.py`` (the ``overlap`` and ``hier`` tasks).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")


def _counts(seed, shape, hi):
    return np.random.default_rng(seed).integers(0, hi, shape).astype(np.int32)


@pytest.mark.parametrize("requested,capacity", [
    (0, 56), (1, 56), (2, 56), (3, 56), (4, 56), (5, 56), (8, 56), (3, 128),
    (4, 40), (7, 7), (9, 7), (6, 1), (5, 24)])
def test_resolve_chunks_matches_jax(requested, capacity):
    from repro.core import pipeline as jp

    from repro_torch.core import pipeline
    got = pipeline.resolve_chunks(requested, capacity)
    assert got == jp.resolve_chunks(requested, capacity)
    assert capacity % got == 0 and 1 <= got <= max(1, requested)


# (n_nodes, n_inner, e_local, bound, inter_bound, seed); inter_bound None =
# the dropless bound of the counts (the largest node shard), 0 = n_inner *
# bound, and a number under the dropless one drops rows
AGG_CASES = [(2, 2, 2, 4, None, 0), (2, 2, 2, 4, 0, 1), (2, 3, 2, 5, 6, 2),
             (3, 2, 4, 8, 5, 3), (2, 4, 2, 16, 20, 4), (4, 2, 3, 6, None, 5)]


def _agg_counts(n_nodes, n_inner, e_local, bound, seed):
    """Kept counts whose sibling shards each fit ``bound``."""
    cnt = _counts(seed, (n_nodes, n_inner, e_local), bound // e_local + 2)
    while cnt.sum(-1).max() > bound:
        cnt = np.minimum(cnt, cnt - (cnt.sum(-1, keepdims=True) > bound))
        cnt = np.maximum(cnt, 0)
    return cnt


@pytest.mark.parametrize("case", AGG_CASES)
def test_make_hier_agg_matches_jax(case):
    import jax.numpy as jnp
    from repro.core import dispatch as JD

    from repro_torch.core import dispatch as D
    n_nodes, n_inner, e_local, bound, ib, seed = case
    cnt = _agg_counts(n_nodes, n_inner, e_local, bound, seed)
    if ib is None:
        ib = int(cnt.sum(axis=(1, 2)).max())
    ib = ib or n_inner * bound
    ref = JD.make_hier_agg(jnp.asarray(cnt), bound, ib)
    got = D.make_hier_agg(torch.from_numpy(cnt), bound, ib)
    np.testing.assert_array_equal(got.agg_dest.numpy(),
                                  np.asarray(ref.agg_dest))
    np.testing.assert_array_equal(got.kept_counts.numpy(),
                                  np.asarray(ref.kept_counts))
    assert float(got.dropped) == float(ref.dropped)
    assert got.agg_dest.dtype == got.kept_counts.dtype == torch.int32


def test_make_hier_agg_bound_drops_as_the_reference():
    """The reference's hand case (``test_hier_a2a.py``): node 0 holds 6
    rows, an inter bound of 5 cuts its last; node 1's 4 rows fit."""
    from repro_torch.core import dispatch as D
    cnt = torch.tensor([[[2, 1], [3, 0]], [[0, 2], [1, 1]]], dtype=torch.int32)
    plan = D.make_hier_agg(cnt, 4, 5)
    dest = plan.agg_dest.reshape(2, 2, 4)
    assert [int(d) for d in dest[0].flatten() if d < 10] == [0, 1, 2, 3, 4]
    np.testing.assert_array_equal(plan.kept_counts[0].numpy(),
                                  [[2, 1], [2, 0]])
    np.testing.assert_array_equal(plan.kept_counts[1].numpy(), cnt[1].numpy())
    assert float(plan.dropped) == 1.0


@pytest.mark.parametrize("case", AGG_CASES)
def test_ragged_recv_compact_hier_matches_jax_and_the_flat_order(case):
    """The receiver's map equals the reference's, and its group sizes are
    the flat compaction's (``ragged_recv_compact`` of the same counts)."""
    import jax.numpy as jnp
    from repro.core import dispatch as JD

    from repro_torch.core import dispatch as D
    n_nodes, n_inner, e_local, bound, ib, seed = case
    incoming = _agg_counts(n_nodes, n_inner, e_local, bound, seed + 10)
    ib = max(int(incoming.sum(axis=(1, 2)).max()), ib or n_inner * bound)
    rd, rgs = JD.ragged_recv_compact_hier(jnp.asarray(incoming), ib)
    dest, gs = D.ragged_recv_compact_hier(torch.from_numpy(incoming), ib)
    np.testing.assert_array_equal(dest.numpy(), np.asarray(rd))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(rgs))
    _, fgs = D.ragged_recv_compact(
        torch.from_numpy(incoming.reshape(n_nodes * n_inner, e_local)), bound)
    np.testing.assert_array_equal(gs.numpy(), fgs.numpy())
    valid = dest[dest < n_nodes * ib]
    np.testing.assert_array_equal(np.sort(valid.numpy()),
                                  np.arange(int(incoming.sum())))


@pytest.mark.parametrize("n_chunks", [1, 2, 4])
@pytest.mark.parametrize("case", AGG_CASES[:4])
def test_hier_chunk_plans_match_jax(case, n_chunks):
    """Per-chunk maps and group sizes equal the reference's; each chunk's
    valid rows fill its mini array once, and the chunks' group sizes sum
    to the whole receive's."""
    import jax.numpy as jnp
    from repro.core import dispatch as JD

    from repro_torch.core import dispatch as D
    n_nodes, n_inner, e_local, bound, _, seed = case
    incoming = _agg_counts(n_nodes, n_inner, e_local, bound, seed + 20)
    ib = n_inner * bound * n_chunks  # a multiple of every chunk count
    rdest, rgs = JD.hier_chunk_plans(jnp.asarray(incoming), ib, n_chunks)
    dest, gs = D.hier_chunk_plans(torch.from_numpy(incoming), ib, n_chunks)
    np.testing.assert_array_equal(dest.numpy(), np.asarray(rdest))
    np.testing.assert_array_equal(gs.numpy(), np.asarray(rgs))
    _, whole = D.ragged_recv_compact_hier(torch.from_numpy(incoming), ib)
    np.testing.assert_array_equal(gs.sum(0).numpy(), whole.numpy())
    w = ib // n_chunks
    for c in range(n_chunks):
        valid = dest[c][dest[c] < n_nodes * w]
        assert len(valid) == int(gs[c].sum())
        np.testing.assert_array_equal(np.sort(valid.numpy()),
                                      np.arange(len(valid)))


def test_wire_dtype_names():
    from repro_torch.core import pipeline
    assert pipeline.wire_torch_dtype(None) is None
    assert pipeline.wire_torch_dtype("bf16") is torch.bfloat16
    x = torch.randn(4, 3, dtype=torch.bfloat16)
    assert pipeline._to_wire(x, "bf16") is x  # already the wire dtype
    for name in ("fp8", "bfloat16"):  # the CLI's one name, "bf16"
        with pytest.raises(ValueError, match="bf16"):
            pipeline.wire_torch_dtype(name)


def test_moe_dist_carries_the_overlap_and_node_options():
    """moe_dist takes the reference's options into the a2a DistConfig and
    leaves them out of the psum fallbacks; a node mesh spans (node, model)
    with node_axis "node"; ragged_bound "auto" without a load monitor is
    the dropless 0 (item 4)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core import fmoe, pipeline
    from repro_torch.launch.mesh import Mesh

    cfg = reduced(get_config("fastmoe-gpt"))  # 4 experts
    opts = dict(overlap_chunks=4, wire_dtype="bf16", ragged_bound=48,
                inter_bound=64)
    d = fmoe.moe_dist(cfg, Mesh(2, 2), 8, **opts)
    assert (d.mode, d.expert_axes, d.node_axis) == ("a2a", ("model",), None)
    assert (d.overlap_chunks, d.wire_dtype, d.ragged_bound,
            d.inter_bound) == (4, "bf16", 48, 64)
    assert pipeline.wire_torch_dtype(d.wire_dtype) is torch.bfloat16
    assert d.decomposed(4)
    assert not d._replace(decompose=False).decomposed(4)
    node = Mesh(1, 2, node=2)
    d = fmoe.moe_dist(cfg, node, 8, **opts)
    assert (d.mode, d.expert_axes, d.node_axis, d.expert_parallelism) == (
        "a2a", ("node", "model"), "node", 4)
    psum = fmoe.moe_dist(cfg, node, 2, **opts)
    assert psum.mode == "psum" and psum.expert_axes == ("node", "model")
    assert (psum.overlap_chunks, psum.wire_dtype, psum.inter_bound,
            psum.node_axis) == (0, None, 0, None)
    assert fmoe.moe_dist(cfg, Mesh(1, 8, node=1), 8) is None  # 4 experts
    assert fmoe.moe_dist(cfg, Mesh(2, 2), 8,
                         ragged_bound="auto").ragged_bound == 0


def test_node_mesh_coordinates_and_expert_shard():
    """(data, node, model) ranks are row-major; the experts shard over
    (node, model) node-major, so rank (d, n, m) holds block n * M + m; the
    two-axis mesh keeps its behaviour and repr."""
    from repro_torch.launch.mesh import Mesh

    m2 = Mesh(2, 2, 3)
    assert m2.axis_names == ("data", "model") and m2.coords() == (1, 1)
    assert repr(m2) == "Mesh(data=2, model=2, rank=3)"
    assert m2.expert_shard(8, 16) == (slice(4, 8), slice(0, 16))
    mesh = Mesh(2, 3, 0, node=2)
    assert mesh.axis_names == ("data", "node", "model") and mesh.size == 12
    assert repr(mesh) == "Mesh(data=2, model=3, node=2, rank=0)"
    for rank in range(12):
        d, n, m = mesh.coords(rank)
        assert rank == (d * 2 + n) * 3 + m
        assert mesh.axis_index(("node", "model"), rank) == n * 3 + m
        e, h = mesh.expert_shard(12, 8, tp=True, rank=rank)
        i = n * 3 + m  # 12 experts over 6 (node, model) ranks: 2 each
        assert (e, h) == (slice(2 * i, 2 * i + 2), slice(d * 4, d * 4 + 4))
    with pytest.raises(ValueError):
        Mesh(1, 2, 4, node=2)


def test_node_mesh_per_rank_init_equals_the_whole_slices():
    """Reduced fastmoe-gpt on a 1x2x2 mesh: each rank's own init under the
    layout (the experts over (node, model), node-major) equals
    ``interop.shard_params`` of the whole, bit for bit."""
    from repro_torch import interop
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.sync import tagged_leaves
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.sharding import make_layout
    from repro_torch.models import lm

    cfg = reduced(get_config("fastmoe-gpt"), num_layers=2, d_model=64)
    whole = lm.init_params(cfg, seed=0, device="cpu")
    for rank in range(4):
        layout = make_layout(cfg, Mesh(1, 2, rank, node=2), "serve")
        mine = dict(tagged_leaves(lm.init_params(cfg, seed=0, device="cpu",
                                                 layout=layout)))
        want = dict(tagged_leaves(interop.shard_params(whole, layout)))
        assert mine.keys() == want.keys()
        for k in mine:
            assert torch.equal(mine[k], want[k]), (rank, k)
        e = mine["layers/0/ffn/experts/wo"].shape[0]
        assert e == cfg.moe.num_experts // 4


def test_serving_refuses_a_node_axis():
    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.scheduler import ContinuousBatcher
    from repro_torch.launch.serve_api import ServeConfig
    from repro_torch.models import lm
    from repro_torch.configs import get_config, reduced

    cfg = reduced(get_config("fastmoe-gpt"), num_layers=2, d_model=64)
    params = lm.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="node"):
        ServeConfig(slots=2, mesh="1x2x2").mesh_shape()
    with pytest.raises(NotImplementedError, match="node"):
        ContinuousBatcher(params, cfg, ServeConfig(slots=2),
                          mesh=Mesh(1, 2, node=2), device="cpu")


def test_node_axis_must_lead_the_expert_axes():
    """On a node mesh the experts shard over ("node", "model"): another
    expert axis is refused, and a two-level exchange over an axis that
    does not lead them (ranks are node-major) raises, as the
    reference's."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.core import fmoe
    from repro_torch.launch.mesh import Mesh

    mesh = Mesh(1, 2, node=2)
    cfg = MoEConfig(dispatch="ragged", num_experts=8, top_k=2,
                    d_expert_hidden=16)
    params = fmoe.fmoe_init(torch.Generator().manual_seed(0), 8, cfg,
                            device="cpu", shard=(slice(0, 2), slice(None)))
    x = torch.randn(4, 8, generator=torch.Generator().manual_seed(1))
    axes = tuple(mesh.axis_names)
    with pytest.raises(ValueError, match="experts shard over"):
        fmoe.fmoe_apply(params, x, cfg, dist=fmoe.DistConfig(mesh, axes))
    dist = fmoe.DistConfig(mesh, axes, expert_axis=("node", "model"),
                           node_axis="model")
    with pytest.raises(ValueError, match="must lead"):
        fmoe.fmoe_apply(params, x, cfg, dist=dist)
