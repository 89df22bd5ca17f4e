"""The ragged token shuffle through the plan's inverse table, ``slot_rows``,
against the JAX package: the source-major gather's plain version, the
table itself, the combine through it, its weights read as stored, and the
dispatch -> combine gradients.

Inputs are made with numpy from a seed and fed to both packages; the JAX
``gather_rows`` Pallas kernel runs in interpret mode here.  Tolerances: the
gathers are copies and agree bit for bit; the combine sums k f32 products
in another order than the reference's einsum (1e-6); gradients sum a
token's k rows in slot order where the reference's autodiff scatters them
(1e-5).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import dispatch as JD  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import dispatch as TD  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import token_shuffle as ts  # noqa: E402

E = 8


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _routes(T, k, seed):
    """Top-k expert ids (distinct per token) of random scores; expert 0
    left empty."""
    scores = np.random.default_rng(seed).random((T, E - 1))
    return np.argsort(-scores, axis=1)[:, :k].astype(np.int64) + 1


def _plans(T, k, seed):
    ids = _routes(T, k, seed)
    return (JD.make_ragged_plan(jnp.asarray(ids, jnp.int32), E),
            TD.make_ragged_plan(torch.from_numpy(ids), E))


@pytest.mark.parametrize("k", [1, 2, 6])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_by_source_gather_bitwise_vs_jax(k, dtype):
    """The source-major route's plain version, the routing wrapper and the
    ragged dispatch all equal the JAX gather_rows kernel bit for bit."""
    T, d = 13, 64
    jplan, tplan = _plans(T, k, 10 + k)
    x = _np((T, d), 11)
    ref = np.asarray(jops.gather_tokens(jnp.asarray(x, dtype),
                                        jplan.token_rows).astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    assert ts.by_source_fits(tx, tplan.slot_rows)
    for got in (ts.gather_rows_by_source_plain(tx, tplan.slot_rows),
                ts.gather_rows(tx, tplan.token_rows, tplan.slot_rows),
                TD.dispatch_ragged(tx, tplan)):
        np.testing.assert_array_equal(got.float().numpy(), ref)


@pytest.mark.parametrize("d,dtype,fits", [
    (3, torch.bfloat16, False), (36, torch.bfloat16, False),
    (36, torch.float32, True), (1024, torch.bfloat16, True),
    (5120, torch.bfloat16, True)])
def test_by_source_shape_check(d, dtype, fits):
    """Rows of whole 16-byte chunks take the source-major route; others the
    per-destination route, with the same result."""
    T, k = 7, 2
    _, tplan = _plans(T, k, d)
    x = torch.from_numpy(_np((T, d), d)).to(dtype)
    assert ts.by_source_fits(x, tplan.slot_rows) == fits
    assert not ts.by_source_fits(x, tplan.slot_rows.repeat(1, 17))  # k 34
    assert torch.equal(ts.gather_rows(x, tplan.token_rows, tplan.slot_rows),
                       ts.gather_rows_plain(x, tplan.token_rows))


@pytest.mark.parametrize("k", [1, 2, 6])
def test_slot_rows_inverts_the_sort(k):
    """slot_rows is sort_idx's inverse, shaped (T, k), and the combine
    through it matches the reference's combine_ragged."""
    T, d = 17, 24
    jplan, tplan = _plans(T, k, 20 + k)
    assert isinstance(tplan, tuple) and tplan._fields == (
        "sort_idx", "group_sizes", "token_rows", "slot_rows")
    sr = tplan.slot_rows
    assert sr.shape == (T, k) and sr.dtype == torch.int32
    assert torch.equal(sr.reshape(-1)[tplan.sort_idx],
                       torch.arange(T * k, dtype=torch.int32))
    assert torch.equal(tplan.token_rows[sr.long()],
                       torch.arange(T, dtype=torch.int32)[:, None].expand(T, k))
    ys = _np((T * k, d), 21)
    cw = np.random.default_rng(22).random((T, k)).astype(np.float32)
    ref = JD.combine_ragged(jnp.asarray(ys), jplan, jnp.asarray(cw))
    got = TD.combine_ragged(torch.from_numpy(ys), tplan, torch.from_numpy(cw))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("k", [1, 2, 6])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_combine_weights_read_as_stored(k, dtype):
    """combine_topk with bf16 weights equals the same weights cast to f32
    bit for bit, and no weights equals weights of 1."""
    T, d = 11, 40
    _, tplan = _plans(T, k, 30 + k)
    src = torch.from_numpy(_np((T * k, d), 31)).to(dtype)
    w = torch.from_numpy(np.random.default_rng(32).random((T, k))
                         .astype(np.float32)).to(torch.bfloat16)
    got = ts.combine_topk(src, tplan.slot_rows, w)
    assert got.dtype == dtype
    assert torch.equal(got, ts.combine_topk(src, tplan.slot_rows, w.float()))
    assert torch.equal(ts.combine_topk(src, tplan.slot_rows),
                       ts.combine_topk(src, tplan.slot_rows,
                                       torch.ones(T, k)))
    assert torch.equal(tops.combine_tokens(src, tplan.slot_rows, w), got)


@pytest.mark.parametrize("k", [2, 6])
def test_dispatch_combine_grads_match_jax(k):
    """Gather -> scale -> combine through the plan: the gradients of the
    tokens, the sorted rows and the gate weights against jax.grad of the
    reference's dispatch and combine."""
    T, d = 12, 16
    jplan, tplan = _plans(T, k, 40 + k)
    x, rows = _np((T, d), 41), _np((T * k, d), 42)
    w = np.random.default_rng(43).random((T, k)).astype(np.float32)
    dy = _np((T, d), 44)

    def jf(a, r, c):
        ys = JD.dispatch_ragged(a, jplan) * r
        return (JD.combine_ragged(ys, jplan, c) * jnp.asarray(dy)).sum()
    jg = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(rows),
                                         jnp.asarray(w))
    tx, tr, tw = (torch.from_numpy(a).requires_grad_() for a in (x, rows, w))
    ys = TD.dispatch_ragged(tx, tplan) * tr
    (TD.combine_ragged(ys, tplan, tw) * torch.from_numpy(dy)).sum().backward()
    for got, ref in zip((tx, tr, tw), jg):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k", [2, 6])
def test_gather_backward_slot_order(k):
    """The gather's gradient through slot_rows (slot order) against the
    sort of token_rows (row order): bit for bit at k = 2, where two f32
    terms add in either order alike; within 1e-6 at k = 6."""
    T, d = 30, 32
    _, tplan = _plans(T, k, 50 + k)
    x = torch.from_numpy(_np((T, d), 51)).requires_grad_()
    dy = torch.from_numpy(_np((T * k, d), 52))
    grads = [torch.autograd.grad(tops.gather_tokens(x, tplan.token_rows, s),
                                 x, dy)[0] for s in (tplan.slot_rows, None)]
    if k == 2:
        assert torch.equal(*grads)
    else:
        torch.testing.assert_close(*grads, rtol=1e-6, atol=1e-6)
