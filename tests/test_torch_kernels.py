"""Parity of the port's kernel plain versions (repro_torch.kernels.ops on CPU
tensors) with the JAX ops, whose Pallas kernels run in interpret mode here.

Inputs are made with numpy from a seed and fed to both packages.
Tolerance: f32 products reassociate differently in the two packages (the
Pallas kernels accumulate in tiles; torch in its own blocking), so values
agree to a few f32 ulps of the sums: rtol/atol 1e-5.  The gather is a copy
and must agree bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# group sizes with empty groups, and sums short of M (trailing zero rows)
SIZES = [(24, [0, 10, 0, 6]), (24, [5, 0, 9, 3]), (16, [16, 0, 0, 0])]


@pytest.mark.parametrize("M,sizes", SIZES)
def test_grouped_matmul_matches_pallas(M, sizes):
    E, K, N = len(sizes), 32, 24
    x, w = _np((M, K), 1), _np((E, K, N), 2, 0.2)
    gs = np.asarray(sizes, np.int32)
    x[gs.sum():] = 0.0  # the JAX contract: trailing rows arrive zero-filled
    ref = jops.grouped_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs),
                              "pallas", 8)
    got = tops.grouped_matmul(_t(x), _t(w), _t(gs), "pallas")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert not got[int(gs.sum()):].any()


@pytest.mark.parametrize("act", ["gelu", "swiglu", "rwkv", "silu"])
def test_fused_ffn_matches_pallas_all_acts(act):
    """H=48 with bh=32: the last hidden tile is a 16-wide tail."""
    M, K, H, N = 24, 32, 48, 24
    sizes = np.asarray([7, 0, 11, 3], np.int32)  # empty group, 3 trailing rows
    E = len(sizes)
    x = _np((M, K), 3)
    x[sizes.sum():] = 0.0
    nw = 2 if act == "swiglu" else 1
    ws = [_np((E, K, H), 4 + i, 0.2) for i in range(nw)]
    wo = _np((E, H, N), 7, 0.2)
    ref = jops.fused_grouped_ffn(jnp.asarray(x), tuple(map(jnp.asarray, ws)),
                                 jnp.asarray(wo), jnp.asarray(sizes), act, 8, 32)
    got = tops.fused_grouped_ffn(_t(x), tuple(map(_t, ws)), _t(wo), _t(sizes),
                                 act)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    assert not got[int(sizes.sum()):].any()
    two = tops.ffn_two_pass(_t(x), tuple(map(_t, ws)), _t(wo), _t(sizes), act,
                            "pallas")
    ref2 = jops.ffn_two_pass(jnp.asarray(x), tuple(map(jnp.asarray, ws)),
                             jnp.asarray(wo), jnp.asarray(sizes), act, "pallas",
                             8)
    np.testing.assert_allclose(two.numpy(), np.asarray(ref2), **TOL)


def test_fused_ffn_check_gating():
    x = torch.zeros(4, 8)
    w = torch.zeros(2, 8, 16)
    with pytest.raises(ValueError, match="swiglu"):
        tops.fused_grouped_ffn(x, (w,), torch.zeros(2, 16, 8),
                               torch.tensor([2, 2]), "swiglu")
    with pytest.raises(ValueError, match="swiglu"):
        tops.fused_grouped_ffn(x, (w, w), torch.zeros(2, 16, 8),
                               torch.tensor([2, 2]), "gelu")


@pytest.mark.parametrize("d", [128, 36])
def test_gather_tokens_bitwise(d):
    x = _np((64, d), 8)
    idx = np.random.default_rng(0).integers(0, 64, 50).astype(np.int32)
    ref = jops.gather_tokens(jnp.asarray(x), jnp.asarray(idx))
    got = tops.gather_tokens(_t(x), _t(idx))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("k", [1, 2, 4])
def test_combine_tokens_matches_pallas(k):
    rng = np.random.default_rng(k)
    src = _np((32, 128), 9)
    idx = rng.integers(0, 32, (20, k)).astype(np.int32)
    w = rng.random((20, k)).astype(np.float32)
    ref = jops.combine_tokens(jnp.asarray(src), jnp.asarray(idx), jnp.asarray(w))
    got = tops.combine_tokens(_t(src), _t(idx), _t(w))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
