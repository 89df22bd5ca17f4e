"""The CUDA kernels against their plain PyTorch versions on the card, at
small and awkward shapes (unaligned widths, hidden tails, empty groups,
rows past sum(group_sizes)), the fused FFN's backward kernels and flash
attention (tails of both tile sizes, window 1, GQA, non-causal, a query
offset) included.
``python3 chip_smoke.py`` checks the same at the serving and training
shapes.  Skips on hosts without a card; on the GPU machine:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``tests/conftest.py`` imports JAX, which the GPU machine does not have.)

Tolerances: bf16 outputs come from f32 sums of identical bf16 products
rounded once, so kernel and plain differ by at most a bf16 ulp where a sum
straddles a rounding boundary (rtol/atol 2e-2); f32 by reassociation
(1e-4).  The gather is a copy: bitwise.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import fused_ffn as ff  # noqa: E402
from repro_torch.kernels import fused_ffn_bwd as fb  # noqa: E402
from repro_torch.kernels import grouped_gemm as gg  # noqa: E402
from repro_torch.kernels import token_shuffle as ts  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = {torch.bfloat16: dict(rtol=2e-2, atol=2e-2),
       torch.float32: dict(rtol=1e-4, atol=1e-4)}
DTYPES = [torch.bfloat16, torch.float32]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine, or "
                    "python3 chip_smoke.py there)")
    return torch.device("cuda")


def _inputs(dev, dtype, M, K, sizes, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    x = torch.randn(M, K, generator=g, device=dev).to(dtype)
    x[int(gs.sum()):] = 0
    return g, x, gs


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,K,N,sizes", [
    (70, 36, 24, [0, 40, 0, 27]),       # K, N not multiples of 8; sum < M
    (130, 64, 200, [64, 0, 65, 0, 1]),  # tiles straddle groups, N tail
    (5, 1024, 2048, [0, 0, 3, 0]),      # decode-like: one short group
])
def test_grouped_gemm(dev, dtype, M, K, N, sizes):
    g, x, gs = _inputs(dev, dtype, M, K, sizes)
    w = (torch.randn(len(sizes), K, N, generator=g, device=dev) * K ** -0.5).to(dtype)
    got = gg.grouped_gemm(x, w, gs)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, gg.grouped_gemm_plain(x, w, gs), **TOL[dtype])
    assert not got[int(gs.sum()):].any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("M,K,N,sizes", [
    (70, 36, 24, [0, 40, 0, 27]),
    (130, 64, 200, [64, 0, 65, 0, 1]),
])
def test_grouped_gemm_trans_w(dev, dtype, M, K, N, sizes):
    """The backward's dX: x @ w^T with w (E, N, K) read in place."""
    g, x, gs = _inputs(dev, dtype, M, K, sizes)
    w = (torch.randn(len(sizes), N, K, generator=g, device=dev) * K ** -0.5).to(dtype)
    got = gg.grouped_gemm(x, w, gs, trans_w=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, gg.grouped_gemm_plain(x, w, gs, True),
                               **TOL[dtype])
    assert not got[int(gs.sum()):].any()


FFN_SHAPES = [
    (40, 48, 200, 72, [9, 0, 17, 5]),   # H tail 72 of 128, N not a BN2 multiple
    (33, 30, 128, 20, [0, 33]),          # K, N unaligned, one full group
    (150, 64, 256, 64, [70, 0, 3, 66]),  # groups longer than a dW row pass
]


def _ffn_inputs(dev, dtype, act, M, K, H, N, sizes):
    g, x, gs = _inputs(dev, dtype, M, K, sizes, seed=1)
    E = len(sizes)
    nw = 2 if act == "swiglu" else 1
    ws = tuple((torch.randn(E, K, H, generator=g, device=dev) * K ** -0.5).to(dtype)
               for _ in range(nw))
    wo = (torch.randn(E, H, N, generator=g, device=dev) * H ** -0.5).to(dtype)
    dy = torch.randn(M, N, generator=g, device=dev).to(dtype)
    return x, gs, ws, wo, dy


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ["gelu", "swiglu", "rwkv", "silu"])
@pytest.mark.parametrize("M,K,H,N,sizes", FFN_SHAPES)
def test_fused_ffn_bwd_dx(dev, dtype, act, M, K, H, N, sizes):
    x, gs, ws, wo, dy = _ffn_inputs(dev, dtype, act, M, K, H, N, sizes)
    got = fb.fused_ffn_bwd_dx(x, ws, wo, dy, gs, act)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, fb.fused_ffn_bwd_dx_plain(x, ws, wo, dy, gs, act),
                               **TOL[dtype])
    assert not got[int(gs.sum()):].any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ["gelu", "swiglu", "rwkv", "silu"])
@pytest.mark.parametrize("M,K,H,N,sizes", FFN_SHAPES)
def test_fused_ffn_bwd_dw(dev, dtype, act, M, K, H, N, sizes):
    """f32 outputs from bf16 products: the tolerance of the working dtype."""
    x, gs, ws, wo, dy = _ffn_inputs(dev, dtype, act, M, K, H, N, sizes)
    dws, dwo = fb.fused_ffn_bwd_dw(x, ws, wo, dy, gs, act)
    torch.cuda.synchronize()
    rws, rwo = fb.fused_ffn_bwd_dw_plain(x, ws, wo, dy, gs, act)
    for got, ref in zip((*dws, dwo), (*rws, rwo)):
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, ref.float(), **TOL[dtype])
    empty = gs == 0
    assert not dwo[empty].any() and not dws[0][empty].any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act", ["gelu", "swiglu", "rwkv", "silu"])
@pytest.mark.parametrize("M,K,H,N,sizes", FFN_SHAPES[:2])
def test_fused_ffn(dev, dtype, act, M, K, H, N, sizes):
    x, gs, ws, wo, _ = _ffn_inputs(dev, dtype, act, M, K, H, N, sizes)
    got = ff.fused_ffn(x, ws, wo, gs, act)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ff.fused_ffn_plain(x, ws, wo, gs, act),
                               **TOL[dtype])
    assert not got[int(gs.sum()):].any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [1024, 36, 3])
def test_gather_rows(dev, dtype, d):
    x = torch.randn(50, d, device=dev).to(dtype)
    idx = torch.randint(0, 50, (77,), device=dev, dtype=torch.int32)
    got = ts.gather_rows(x, idx)
    torch.cuda.synchronize()
    assert torch.equal(got, ts.gather_rows_plain(x, idx))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,d", [(1, 1024), (2, 36), (4, 200)])
def test_combine_topk(dev, dtype, k, d):
    src = torch.randn(64, d, device=dev).to(dtype)
    idx = torch.randint(0, 64, (30, k), device=dev, dtype=torch.int32)
    w = torch.rand(30, k, device=dev)
    got = ts.combine_topk(src, idx, w)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ts.combine_topk_plain(src, idx, w),
                               **TOL[dtype])


# (B, Sq, Skv, H, KV, d, window, q_offset, causal): tails of both tile
# sizes, window 1, GQA groups, non-causal, a query offset.
FLASH_CASES = [
    (2, 100, 100, 6, 2, 64, 1, 0, True),
    (1, 130, 130, 4, 1, 128, 5, 0, True),
    (2, 70, 70, 3, 3, 64, 16, 0, False),
    (1, 200, 200, 2, 1, 128, 1 << 30, 0, True),
    (1, 200, 200, 4, 2, 64, 1 << 30, 0, False),
    (1, 40, 90, 4, 2, 64, 30, 50, True),
    (2, 257, 257, 12, 4, 128, 64, 0, True),
]


# Each output and gradient as a whole: relative Frobenius error (the
# elementwise tolerance alone is loose where |o| ~ 1/sqrt(keys)).  An
# all-zero reference (dq, dk at window 1) is held elementwise only.
FLASH_FRO = {torch.bfloat16: 1e-2, torch.float32: 1e-4}


def _assert_fro(got, ref, dtype):
    den = ref.float().norm().item()
    if den == 0.0:
        return
    err = (got.float() - ref.float()).norm().item() / den
    assert err <= FLASH_FRO[dtype], f"relative Frobenius error {err:.3e}"


def _flash_inputs(dev, dtype, B, Sq, Skv, H, KV, d, seed=2):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn(B, Sq, H, d, generator=g, device=dev).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(B, Skv, KV, d, generator=g, device=dev).to(dtype)
            for _ in range(2))
    return q, k, v, do


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Sq,Skv,H,KV,d,window,q_offset,causal", FLASH_CASES)
def test_flash_attention_fwd(dev, dtype, B, Sq, Skv, H, KV, d, window,
                             q_offset, causal):
    q, k, v, _ = _flash_inputs(dev, dtype, B, Sq, Skv, H, KV, d)
    kw = dict(window=window, q_offset=q_offset, causal=causal)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    ro, rlse = fa.flash_attention_fwd_plain(q, k, v, **kw)
    torch.testing.assert_close(o, ro, **TOL[dtype])
    _assert_fro(o, ro, dtype)
    torch.testing.assert_close(lse, rlse, **TOL[torch.float32])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Sq,Skv,H,KV,d,window,q_offset,causal", FLASH_CASES)
def test_flash_attention_bwd(dev, dtype, B, Sq, Skv, H, KV, d, window,
                             q_offset, causal):
    """dq, dk, dv against autograd of the plain version; each held at the
    dtype's tolerance scaled by that gradient's largest entry, and to a
    relative Frobenius error."""
    q, k, v, do = _flash_inputs(dev, dtype, B, Sq, Skv, H, KV, d)
    kw = dict(window=window, q_offset=q_offset, causal=causal)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, fa.flash_attention_bwd_plain(q, k, v, do, **kw)):
        scale = max(b.float().abs().max().item(), 1.0)
        tol = dict(rtol=TOL[dtype]["rtol"], atol=TOL[dtype]["atol"] * scale)
        torch.testing.assert_close(a.float(), b.float(), **tol)
        _assert_fro(a, b, dtype)


def test_flash_attention_op_autograd(dev):
    """ops.flash_attention runs the kernels both ways on the card."""
    from repro_torch.kernels import ops
    q, k, v, do = _flash_inputs(dev, torch.bfloat16, 2, 96, 96, 4, 2, 64)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    f0, b0 = fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches
    ops.flash_attention(q, k, v, window=33).backward(do)
    assert fa.flash_attention_fwd.launches == f0 + 1
    assert fa.flash_attention_bwd.launches == b0 + 1
    assert all(torch.isfinite(t.grad).all() for t in (q, k, v))
