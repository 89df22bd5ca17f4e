"""Parity of the port's flash attention (``kernels/ops.flash_attention``; on
CPU tensors the plain masked softmax and its autograd) with the JAX
package: its Pallas kernel ``ops.flash_attention`` run in interpret mode
as ``tests/test_gate_variants.py`` runs it (S a multiple of its tiles), and
the jnp ``blockwise_attention`` scan with a chunk smaller than S, at an S
that is no tile multiple.

Inputs are made with numpy from a seed.  Tolerance: f32 throughout, so
only the order of the sums differs — rtol/atol 2e-5 on outputs (the JAX
kernel tests' own), and gradients to 1e-5 of each gradient's largest entry.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.models.attention as JA  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
from repro_torch.models.blocks import FULL_WINDOW  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = 1e-5
WINDOWS = [1, 5, 16, FULL_WINDOW]


def _inputs(B, S, H, KV, d, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, d)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, d)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, d)).astype(np.float32)
    return q, k, v


def _port(q, k, v, **kw):
    return ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               **kw).numpy()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("G,d", [(1, 32), (3, 64)])
def test_matches_jax_pallas_kernel(causal, window, G, d):
    q, k, v = _inputs(1, 32, 2 * G, 2, d, seed=window % 97)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                window=window, causal=causal, bq=16, bk=16)
    got = _port(q, k, v, window=window, causal=causal)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", WINDOWS)
@pytest.mark.parametrize("G,d", [(1, 32), (3, 64)])
def test_matches_jax_blockwise(causal, window, G, d):
    """S = 37 against 8-key chunks: the last chunk is padded on the JAX
    side, and no tile size divides S."""
    q, k, v = _inputs(2, 37, 2 * G, 2, d, seed=window % 89)
    want = JA.blockwise_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  window=window, chunk=8, causal=causal)
    got = _port(q, k, v, window=window, causal=causal)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    # the model's entry point is the same op
    np.testing.assert_array_equal(
        TA.blockwise_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                               window=window, causal=causal).numpy(), got)


def test_query_offset_matches_jax_blockwise():
    """Queries at absolute positions q_offset.. against a longer key run."""
    rng = np.random.default_rng(7)
    q = rng.standard_normal((1, 12, 6, 32)).astype(np.float32)
    k = rng.standard_normal((1, 30, 2, 32)).astype(np.float32)
    v = rng.standard_normal((1, 30, 2, 32)).astype(np.float32)
    want = JA.blockwise_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  window=9, q_offset=18, chunk=8)
    got = _port(q, k, v, window=9, q_offset=18)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("causal,window,G", [(True, 1, 3), (True, 16, 1),
                                             (True, FULL_WINDOW, 3),
                                             (False, 5, 3)])
def test_backward_matches_jax_vjp(causal, window, G):
    """dq, dk, dv of the port's op (autograd through its Function, whose CPU
    backward is autograd of the plain version) against jax.vjp of the
    blockwise scan, in f32."""
    q, k, v = _inputs(2, 37, 2 * G, 2, 32, seed=3)
    do = np.random.default_rng(4).standard_normal(q.shape).astype(np.float32)

    def f(q, k, v):
        return JA.blockwise_attention(q, k, v, window=window, chunk=8,
                                      causal=causal)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    ops.flash_attention(tq, tk, tv, window=window,
                        causal=causal).backward(torch.from_numpy(do))
    for name, got, ref in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        ref = np.asarray(ref)
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got.numpy(), ref, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * scale, err_msg=f"d{name}")


def test_plain_lse_and_backward_agree_with_autograd():
    """The plain forward's log-sum-exp is the softmax's normaliser, and
    flash_attention_bwd on CPU tensors is autograd of the plain version."""
    q, k, v = (torch.from_numpy(a).double() for a in _inputs(1, 20, 4, 2, 32))
    o, lse = fa.flash_attention_fwd(q, k, v, window=6)
    assert lse.shape == (1, 4, 20) and lse.dtype == torch.float32
    s = torch.einsum("bshd,bchd->bhsc", q, k.repeat_interleave(2, 2)) * 32 ** -0.5
    i = torch.arange(20)
    mask = ((i[:, None] - i[None]) < 6) & (i[:, None] >= i[None])
    ref = torch.logsumexp(s.masked_fill(~mask, -1e30), -1)
    torch.testing.assert_close(lse, ref.float(), rtol=1e-6, atol=1e-6)
    do = torch.randn(o.shape, dtype=o.dtype, generator=torch.Generator().manual_seed(0))
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, window=6)
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    fa.attention_plain(qr, kr, vr, window=6).backward(do)
    for a, b in zip(got, (qr.grad, kr.grad, vr.grad)):
        torch.testing.assert_close(a, b)


@pytest.mark.parametrize("window,q_offset,S,Skv", [(0, 0, 8, 8), (3, 10, 8, 8),
                                                   (2, 0, 12, 8)])
def test_rows_without_keys_are_refused(window, q_offset, S, Skv):
    """window >= 1 and every row must see a key (q_offset + S - window <
    Skv): the contract under which the kernels skip tiles outside the band."""
    q = torch.zeros(1, S, 2, 32)
    k = torch.zeros(1, Skv, 2, 32)
    with pytest.raises(ValueError, match="every row must see a key"):
        ops.flash_attention(q, k, k, window=window, q_offset=q_offset)


# ---------------------------------------------------------------------------
# v narrower than q and k (dv != dk), as MLA has it: the reduced deepseek
# shape, dk 48 (32 nope + 16 rope) and dv 32.  The scale stays dk^-1/2 and
# the output is (B, Sq, H, dv).  f32: outputs to 1e-5, gradients to 1e-4.
# ---------------------------------------------------------------------------

MLA_DK, MLA_DV = 48, 32
MLA_TOL = dict(rtol=1e-5, atol=1e-5)
MLA_GRAD_TOL = 1e-4


def _mla_inputs(B, S, H, KV, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, MLA_DK)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, MLA_DK)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, MLA_DV)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("causal,window", [(True, FULL_WINDOW), (True, 5),
                                           (False, 16)])
def test_dv_differs_from_dk_matches_jax_blockwise(causal, window):
    """The port's blockwise_attention against the jnp scan at S = 37 with
    8-key chunks."""
    q, k, v = _mla_inputs(2, 37, 4, 2, seed=11)
    want = JA.blockwise_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  window=window, chunk=8, causal=causal)
    got = TA.blockwise_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 window=window, causal=causal).numpy()
    assert got.shape == (2, 37, 4, MLA_DV)
    np.testing.assert_allclose(got, np.asarray(want), **MLA_TOL)


@pytest.mark.parametrize("causal,window", [(True, FULL_WINDOW), (True, 5),
                                           (False, 16)])
def test_dv_differs_from_dk_matches_jax_pallas_kernel(causal, window):
    """The port's blockwise_attention against the Pallas kernel in
    interpret mode (S 32, tiles of 16)."""
    q, k, v = _mla_inputs(1, 32, 6, 2, seed=12)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                window=window, causal=causal, bq=16, bk=16)
    got = TA.blockwise_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                                 window=window, causal=causal).numpy()
    assert got.shape == (1, 32, 6, MLA_DV)
    np.testing.assert_allclose(got, np.asarray(want), **MLA_TOL)


@pytest.mark.parametrize("causal,window", [(True, FULL_WINDOW), (True, 5),
                                           (False, 16)])
def test_dv_differs_from_dk_backward_matches_jax_vjp(causal, window):
    """dq, dk (width dk) and dv (width dv) of the port's op against jax.vjp
    of the blockwise scan."""
    q, k, v = _mla_inputs(2, 37, 4, 2, seed=13)
    do = np.random.default_rng(14).standard_normal(
        (2, 37, 4, MLA_DV)).astype(np.float32)

    def f(q, k, v):
        return JA.blockwise_attention(q, k, v, window=window, chunk=8,
                                      causal=causal)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    ops.flash_attention(tq, tk, tv, window=window,
                        causal=causal).backward(torch.from_numpy(do))
    for name, got, ref in zip("qkv", (tq.grad, tk.grad, tv.grad), want):
        ref = np.asarray(ref)
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got.numpy(), ref, rtol=MLA_GRAD_TOL,
                                   atol=MLA_GRAD_TOL * scale, err_msg=f"d{name}")
