"""The CUDA kernels against their plain PyTorch versions on the card, at
small and awkward shapes (unaligned widths, hidden tails, empty groups,
rows past sum(group_sizes)), the grouped GEMM's ring kernel at the model
widths and its routing of other shapes to the simple kernel, the fused
FFN's ring kernel (all acts, hidden tails, empty groups, the decode,
prefill and training row counts at full width) and its simple route, its
backward kernels, and flash attention (tails of both tile sizes, window 1,
GQA, non-causal, a query offset, one query row; the bf16 forward at both
of its tile choices, also bit for bit on >= 99% of outputs) included.
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
    (50, 200, 72, [0, 20, 25]),         # bf16 ring: K and N tails of 8
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
    (50, 200, 72, [0, 20, 25]),
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


def _routed_sizes(M, E, seed):
    """Ragged sizes over E groups summing to M - 3, some groups empty."""
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, E, (M - 3,), generator=g)
    ids = ids[ids % 7 != 3]  # every 7th group from 3 on stays empty
    sizes = torch.bincount(ids, minlength=E)
    sizes[0] += M - 3 - int(sizes.sum())
    return sizes.tolist()


@pytest.mark.parametrize("trans_w", [False, True])
@pytest.mark.parametrize("K,N", [(1024, 2048), (2048, 1024)])
@pytest.mark.parametrize("M,bm", [(16, 16), (96 * 20, 32), (96 * 40, 64)])
def test_grouped_gemm_ring_kernel(dev, M, bm, K, N, trans_w):
    """The bf16 ring kernel over 96 experts, one case per row tile: decode
    (16 rows), prefill-like and training-like rows per expert."""
    E = 96
    assert gg.tile_config(M, N, E)[0] == bm
    g, x, gs = _inputs(dev, torch.bfloat16, M, K, _routed_sizes(M, E, M))
    shape = (E, N, K) if trans_w else (E, K, N)
    w = (torch.randn(*shape, generator=g, device=dev) * K ** -0.5).to(torch.bfloat16)
    ring, simple = gg.grouped_gemm.launches, gg.grouped_gemm_simple.launches
    got = gg.grouped_gemm(x, w, gs, trans_w)
    torch.cuda.synchronize()
    assert gg.grouped_gemm.launches == ring + 1
    assert gg.grouped_gemm_simple.launches == simple
    torch.testing.assert_close(got, gg.grouped_gemm_plain(x, w, gs, trans_w),
                               **TOL[torch.bfloat16])
    assert not got[int(gs.sum()):].any()


@pytest.mark.parametrize("case", ["K36", "N36", "misaligned", "f32"])
def test_grouped_gemm_simple_route(dev, case):
    """Shapes the ring kernel does not take run the simple kernel, right."""
    K, N, dtype = {"K36": (36, 64, torch.bfloat16), "N36": (64, 36, torch.bfloat16),
                   "misaligned": (64, 64, torch.bfloat16),
                   "f32": (64, 64, torch.float32)}[case]
    M, sizes = 40, [0, 17, 20]
    g, x, gs = _inputs(dev, dtype, M, K, sizes)
    if case == "misaligned":
        buf = torch.zeros(M * K + 8, dtype=dtype, device=dev)
        x = buf[1:1 + M * K].view(M, K).copy_(x)
    w = (torch.randn(len(sizes), K, N, generator=g, device=dev) * K ** -0.5).to(dtype)
    assert gg.route(x, w) == "simple"
    ring, simple = gg.grouped_gemm.launches, gg.grouped_gemm_simple.launches
    got = gg.grouped_gemm(x, w, gs)
    torch.cuda.synchronize()
    assert gg.grouped_gemm.launches == ring
    assert gg.grouped_gemm_simple.launches == simple + 1
    torch.testing.assert_close(got, gg.grouped_gemm_plain(x, w, gs), **TOL[dtype])
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


def test_flash_attention_bwd_bf16_group_twice(dev):
    """The bf16 backward at a starcoder2-like group (12 query heads over one
    kv head of 128), a window shorter than the sequence, a tail Sq and a
    query offset, run twice: dq's atomic adds land in another order each
    run, and both runs must hold to the plain version."""
    B, Sq, Skv, H, KV, d, window, q_offset = 1, 150, 300, 12, 1, 128, 100, 140
    q, k, v, do = _flash_inputs(dev, torch.bfloat16, B, Sq, Skv, H, KV, d, seed=4)
    kw = dict(window=window, q_offset=q_offset, causal=True)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    ref = fa.flash_attention_bwd_plain(q, k, v, do, **kw)
    for _ in range(2):
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            scale = max(b.float().abs().max().item(), 1.0)
            torch.testing.assert_close(a.float(), b.float(), rtol=2e-2,
                                       atol=2e-2 * scale)
            _assert_fro(a, b, torch.bfloat16)


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


# ---------------------------------------------------------------------------
# the fused FFN's ring kernel and the flash forward's tile choices
# ---------------------------------------------------------------------------

RING_SHAPES = [
    # (M, K, H, N, sizes): hidden tails (H % 64), empty groups, rows past
    # sum(group_sizes), an expert over several row tiles
    (40, 48, 200, 72, [9, 0, 17, 5]),
    (150, 64, 264, 64, [70, 0, 3, 66]),
    (300, 128, 136, 200, [0, 130, 0, 120, 41]),
    # nine hidden splits of 64
    (40, 48, 576, 72, [9, 0, 17, 5]),
]


@pytest.mark.parametrize("act", ["gelu", "swiglu", "rwkv", "silu"])
@pytest.mark.parametrize("M,K,H,N,sizes", RING_SHAPES)
def test_fused_ffn_ring_kernel(dev, act, M, K, H, N, sizes):
    x, gs, ws, wo, _ = _ffn_inputs(dev, torch.bfloat16, act, M, K, H, N, sizes)
    assert ff.route(x, ws, wo) == "ring"
    ring, simple = ff.fused_ffn.launches, ff.fused_ffn_simple.launches
    got = ff.fused_ffn(x, ws, wo, gs, act)
    torch.cuda.synchronize()
    assert ff.fused_ffn.launches == ring + 1
    assert ff.fused_ffn_simple.launches == simple
    torch.testing.assert_close(got, ff.fused_ffn_plain(x, ws, wo, gs, act),
                               **TOL[torch.bfloat16])
    assert not got[int(gs.sum()):].any()


@pytest.mark.parametrize("act", ["gelu", "swiglu"])
@pytest.mark.parametrize("M,bm", [(16, 16), (2048, 32), (4096, 64)])
def test_fused_ffn_ring_kernel_model_rows(dev, act, M, bm):
    """fastmoe-gpt widths over 96 experts at the decode, prefill and
    training row counts (one row tile per case), some experts empty and
    three rows past the groups."""
    E, K, H, N = 96, 1024, 2048, 1024
    assert ff.plan(M, E, H, gated=act == "swiglu").bm == bm
    x, gs, ws, wo, _ = _ffn_inputs(dev, torch.bfloat16, act, M, K, H, N,
                                   _routed_sizes(M, E, M))
    got = ff.fused_ffn(x, ws, wo, gs, act)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ff.fused_ffn_plain(x, ws, wo, gs, act),
                               **TOL[torch.bfloat16])
    assert not got[int(gs.sum()):].any()


@pytest.mark.parametrize("case", ["K36", "H100", "misaligned", "f32"])
def test_fused_ffn_simple_route(dev, case):
    """Shapes the ring kernel does not take run the simple kernel, right;
    fused_ffn.launches counts them too."""
    K, H, dtype = {"K36": (36, 128, torch.bfloat16), "H100": (64, 100, torch.bfloat16),
                   "misaligned": (64, 128, torch.bfloat16),
                   "f32": (64, 128, torch.float32)}[case]
    M, N, sizes = 40, 64, [0, 17, 20]
    x, gs, ws, wo, _ = _ffn_inputs(dev, dtype, "gelu", M, K, H, N, sizes)
    if case == "misaligned":
        buf = torch.zeros(M * K + 8, dtype=dtype, device=dev)
        x = buf[1:1 + M * K].view(M, K).copy_(x)
    assert ff.route(x, ws, wo) == "simple"
    ring, simple = ff.fused_ffn.launches, ff.fused_ffn_simple.launches
    got = ff.fused_ffn(x, ws, wo, gs, "gelu")
    torch.cuda.synchronize()
    assert ff.fused_ffn.launches == ring + 1
    assert ff.fused_ffn_simple.launches == simple + 1
    torch.testing.assert_close(got, ff.fused_ffn_plain(x, ws, wo, gs, "gelu"),
                               **TOL[dtype])
    assert not got[int(gs.sum()):].any()


# (B, Sq, Skv, H, KV, d, window, q_offset, causal): both tile choices of the
# bf16 forward at d 64 and 128 (the last three take 128-row q tiles),
# tails of 333, one query row, a window, GQA, a query offset, non-causal
FLASH_FWD_CASES = [
    (1, 1, 333, 4, 1, 128, 1 << 30, 332, True),
    (1, 1, 333, 8, 2, 64, 50, 332, True),
    (2, 333, 333, 4, 2, 128, 100, 0, True),
    (3, 333, 333, 16, 16, 64, 1 << 30, 0, False),
    (1, 150, 333, 12, 1, 128, 64, 183, True),
    (4, 333, 333, 48, 4, 128, 100, 0, True),
    (4, 333, 333, 48, 48, 64, 1 << 30, 0, False),
    (3, 600, 700, 48, 6, 64, 200, 100, True),
]
FLASH_EQUAL = 0.99  # of bf16 outputs bit-equal to the plain version's


@pytest.mark.parametrize("B,Sq,Skv,H,KV,d,window,q_offset,causal", FLASH_FWD_CASES)
def test_flash_attention_fwd_bf16_tiles(dev, B, Sq, Skv, H, KV, d, window,
                                        q_offset, causal):
    q, k, v, _ = _flash_inputs(dev, torch.bfloat16, B, Sq, Skv, H, KV, d, seed=5)
    kw = dict(window=window, q_offset=q_offset, causal=causal)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    ro, rlse = fa.flash_attention_fwd_plain(q, k, v, **kw)
    torch.testing.assert_close(o, ro, **TOL[torch.bfloat16])
    _assert_fro(o, ro, torch.bfloat16)
    assert (o == ro).float().mean().item() >= FLASH_EQUAL
    torch.testing.assert_close(lse, rlse, **TOL[torch.float32])


@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("bq", [64, 128])
def test_flash_fwd_config_matches_the_kernel(dev, d, bq):
    """The host's mirror of the forward's shared memory is what the kernel
    asks for."""
    from repro_torch.kernels import _build
    lib = _build.load("flash_attention", fa._SIGS)
    cfg = fa.fwd_config(1, 1 if bq == 64 else 1 << 20, 64, d)
    assert cfg.bq == bq
    assert lib.flash_attention_fwd_smem(d, bq) == cfg.smem
