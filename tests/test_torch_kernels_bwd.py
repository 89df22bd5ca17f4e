"""The backward ops of the port on CPU tensors (the kernels' plain versions
and the autograd Functions of ``repro_torch.kernels.ops``) against the JAX
package: its fused-FFN backward Pallas kernels in interpret mode, and the
VJPs of its ``ops.fused_grouped_ffn`` and ``ops.grouped_matmul``.

Inputs are made with numpy from a seed and fed to both packages, in f32.
Tolerance rtol/atol 1e-5, as tests/test_torch_kernels.py: the products
reassociate differently in the two packages (the Pallas kernels accumulate
in tiles), a few f32 ulps of sums over <= 64 terms.  ``gradcheck`` runs the
four autograd Functions in f64 on tiny shapes (its own default tolerances).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core.dispatch import pad_to_tiles  # noqa: E402
from repro.kernels import fused_ffn_bwd as jfb  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import dispatch as TD  # noqa: E402
from repro_torch.kernels import fused_ffn_bwd as tfb  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
ACTS = ["gelu", "swiglu", "rwkv", "silu"]
# M, K, H, N, group sizes: an empty group, a sum short of M (trailing zero
# rows) and, with bh 32, a 16-wide hidden tail (H = 48)
M, K, H, N = 24, 32, 48, 24
SIZES = np.asarray([7, 0, 11, 3], np.int32)
BM, BH = 8, 32


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(act, seed=0):
    E = len(SIZES)
    x = _np((M, K), seed)
    x[SIZES.sum():] = 0.0  # the ops contract: trailing rows arrive zero
    ws = [_np((E, K, H), seed + 1 + i, 0.2)
          for i in range(2 if act == "swiglu" else 1)]
    wo = _np((E, H, N), seed + 4, 0.2)
    dy = _np((M, N), seed + 5)
    return x, ws, wo, dy


@pytest.mark.parametrize("act", ACTS)
def test_plain_bwd_matches_pallas_kernels(act):
    """dX and dW of the plain versions against the JAX Pallas kernels
    (interpret mode) run on the padded tile layout the JAX ops build."""
    x, ws, wo, dy = _inputs(act)
    E = len(SIZES)
    n = int(SIZES.sum())
    tiled = pad_to_tiles(jnp.asarray(x), jnp.asarray(SIZES), BM, E)
    dy_p = jnp.zeros((tiled.x.shape[0], N)).at[tiled.dest].set(
        jnp.asarray(dy))
    jws = tuple(map(jnp.asarray, ws))
    dx_p = jfb.fused_ffn_bwd_dx_tiled(tiled.x, jws, jnp.asarray(wo), dy_p,
                                      tiled.tile_group, act=act, bm=BM, bh=BH,
                                      interpret=True)
    jdws, jdwo = jfb.fused_ffn_bwd_dw_tiled(tiled.x, jws, jnp.asarray(wo),
                                            dy_p, tiled.tile_group, act=act,
                                            bm=BM, bh=BH, interpret=True)
    ref_dx = np.asarray(dx_p[tiled.dest])[:n]

    tws = tuple(map(_t, ws))
    dx = tfb.fused_ffn_bwd_dx(_t(x), tws, _t(wo), _t(dy), _t(SIZES), act)
    dws, dwo = tfb.fused_ffn_bwd_dw(_t(x), tws, _t(wo), _t(dy), _t(SIZES), act)
    np.testing.assert_allclose(dx.numpy()[:n], ref_dx, **TOL)
    assert not dx[n:].any()  # rows past sum(group_sizes)
    used = SIZES > 0  # the JAX kernel never visits an empty group's block
    for got, ref in zip((*dws, dwo), (*jdws, jdwo)):
        np.testing.assert_allclose(got.numpy()[used], np.asarray(ref)[used],
                                   **TOL)
        assert not got[~torch.from_numpy(used)].any()


@pytest.mark.parametrize("act", ACTS)
def test_fused_ffn_vjp_matches_jax_ops(act):
    """The autograd Function against jax.vjp of the reference's
    ``ops.fused_grouped_ffn`` (kernels + padding glue + empty-group mask)."""
    x, ws, wo, dy = _inputs(act, seed=10)
    jws = tuple(map(jnp.asarray, ws))
    y, vjp = jax.vjp(lambda a, b, c: jops.fused_grouped_ffn(
        a, b, c, jnp.asarray(SIZES), act, BM, BH),
        jnp.asarray(x), jws, jnp.asarray(wo))
    jdx, jdws, jdwo = vjp(jnp.asarray(dy))

    tx, two = _t(x).requires_grad_(), _t(wo).requires_grad_()
    tws = tuple(_t(w).requires_grad_() for w in ws)
    ty = tops.fused_grouped_ffn(tx, tws, two, _t(SIZES), act)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y), **TOL)
    ty.backward(_t(dy))
    for got, ref in zip((tx, *tws, two), (jdx, *jdws, jdwo)):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("impl", ["pallas", "plain"])
def test_grouped_matmul_vjp_matches_jax_ops(impl):
    """dX (the grouped kernel reading w transposed) and the per-group dW
    against jax.vjp of the reference's ``ops.grouped_matmul``."""
    E = len(SIZES)
    x, w, dy = _np((M, K), 20), _np((E, K, N), 21, 0.2), _np((M, N), 22)
    x[SIZES.sum():] = 0.0
    _, vjp = jax.vjp(lambda a, b: jops.grouped_matmul(
        a, b, jnp.asarray(SIZES), "pallas", BM), jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    tops.grouped_matmul(tx, tw, _t(SIZES), impl).backward(_t(dy))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jdw), **TOL)


def test_ragged_dispatch_vjp_matches_jax():
    """Gather -> combine through the ragged plan: the gradients of the
    tokens, the sorted rows and the gate weights against the JAX
    dispatch/combine (plain jnp there)."""
    from repro.core import dispatch as JD
    T, k, d, E = 10, 2, 16, 4
    ids = np.random.default_rng(30).integers(0, E, (T, k))
    ids[:, 1] = (ids[:, 0] + 1) % E
    x, w = _np((T, d), 31), np.random.default_rng(32).random((T, k)).astype(
        np.float32)
    rows = _np((T * k, d), 33)  # stands in for the expert outputs
    dy = _np((T, d), 34)
    jplan = JD.make_ragged_plan(jnp.asarray(ids, jnp.int32), E)

    def jf(a, r, c):
        return (JD.dispatch_ragged(a, jplan) * r).sum() + \
            (JD.combine_ragged(r, jplan, c) * jnp.asarray(dy)).sum()
    jg = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(rows),
                                         jnp.asarray(w))
    tplan = TD.make_ragged_plan(torch.from_numpy(ids), E)
    tx, tr, tw = (_t(a).requires_grad_() for a in (x, rows, w))
    loss = (TD.dispatch_ragged(tx, tplan) * tr).sum() + \
        (TD.combine_ragged(tr, tplan, tw) * _t(dy)).sum()
    loss.backward()
    for got, ref in zip((tx, tr, tw), jg):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref), **TOL)


def _f64(shape, seed, scale=1.0):
    return torch.from_numpy(_np(shape, seed, scale).astype(np.float64))


@pytest.mark.parametrize("act", ACTS)
def test_gradcheck_fused_grouped_ffn(act):
    sizes = torch.tensor([3, 0, 2], dtype=torch.int32)
    E, m, k, h, n = 3, 6, 5, 7, 4
    x = _f64((m, k), 40)
    x[int(sizes.sum()):] = 0
    ws = tuple(_f64((E, k, h), 41 + i, 0.5).requires_grad_()
               for i in range(2 if act == "swiglu" else 1))
    wo = _f64((E, h, n), 44, 0.5).requires_grad_()
    torch.autograd.gradcheck(
        lambda a, o, *w: tops.fused_grouped_ffn(a, w, o, sizes, act),
        (x.requires_grad_(), wo, *ws))


@pytest.mark.parametrize("impl", ["pallas", "plain"])
def test_gradcheck_grouped_matmul(impl):
    sizes = torch.tensor([2, 0, 3], dtype=torch.int32)
    x = _f64((6, 4), 50)
    x[5:] = 0
    w = _f64((3, 4, 5), 51)
    torch.autograd.gradcheck(
        lambda a, b: tops.grouped_matmul(a, b, sizes, impl),
        (x.requires_grad_(), w.requires_grad_()))


def _ragged_layout(T, k, E, seed):
    """(token_rows, slot_rows) of the ragged dispatch for random routes:
    the token of each expert-sorted row, and the row of each (token, slot)."""
    ids = torch.from_numpy(np.random.default_rng(seed).integers(0, E, (T, k)))
    plan = TD.make_ragged_plan(ids, E)
    inv = torch.empty_like(plan.sort_idx)
    inv[plan.sort_idx] = torch.arange(T * k)
    return plan.token_rows, inv.reshape(T, k)


def test_gradcheck_gather_and_combine_tokens():
    T, k, E = 5, 2, 3
    token_rows, slot_rows = _ragged_layout(T, k, E, 60)
    x = _f64((T, 3), 61).requires_grad_()
    torch.autograd.gradcheck(lambda a: tops.gather_tokens(a, token_rows), (x,))
    src = _f64((T * k, 3), 62).requires_grad_()
    w = _f64((T, k), 63).requires_grad_()
    torch.autograd.gradcheck(
        lambda s, c: tops.combine_tokens(s, slot_rows, c), (src, w))


@pytest.mark.parametrize("k", [1, 2, 4])
def test_token_shuffle_grads_match_indexing(k):
    """Gather, scale each row, combine: the kernel-served gradients equal
    autograd through plain indexing, f32 (the k-term sums may add in
    another order)."""
    T, E, d = 9, 5, 6
    token_rows, slot_rows = _ragged_layout(T, k, E, 70 + k)
    rng = np.random.default_rng(80 + k)
    leaves = [torch.from_numpy(_np((T, d), 81)),
              torch.from_numpy(rng.random((T * k, 1)).astype(np.float32)),
              torch.from_numpy(rng.random((T, k)).astype(np.float32))]
    g = torch.from_numpy(_np((T, d), 82))

    def run(gather, combine):
        x, r, w = (a.clone().requires_grad_() for a in leaves)
        y = combine(gather(x) * r, w)
        return torch.autograd.grad((y * g).sum(), (x, r, w))

    got = run(lambda x: tops.gather_tokens(x, token_rows),
              lambda s, w: tops.combine_tokens(s, slot_rows, w))
    ref = run(lambda x: x[token_rows.long()],
              lambda s, w: (w[..., None] * s[slot_rows.long()]).sum(1))
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)


def test_token_shuffle_grads_reject_other_layouts():
    """The backward derives its index maps from the ragged layout; other
    layouts raise rather than give a wrong gradient."""
    x = torch.randn(3, 4, requires_grad=True)
    y = tops.gather_tokens(x, torch.tensor([0, 1, 2, 0, 1]))
    with pytest.raises(ValueError, match="k times"):
        y.sum().backward()
    src = torch.randn(5, 4, requires_grad=True)
    y = tops.combine_tokens(src, torch.tensor([[0, 1], [2, 3]]),
                            torch.ones(2, 2))
    with pytest.raises(ValueError, match="one \\(token, slot\\) per row"):
        y.sum().backward()
