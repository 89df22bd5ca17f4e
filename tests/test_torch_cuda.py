"""The CUDA kernels against their plain PyTorch versions on the card, at
small and awkward shapes (unaligned widths, hidden tails, empty groups,
rows past sum(group_sizes)), the grouped GEMM's ring kernel at the model
widths and its routing of other shapes to the simple kernel, the fused
FFN's ring kernel (all acts, hidden tails, empty groups, the decode,
prefill and training row counts at full width) and its simple route, its
backward kernels (the dX and dW ring kernels over the same cases, an
expert over the dW kernel's 64-row batch, and their simple route), the
expert kernels at the hidden shards of expert-internal tensor
parallelism (1024 and 512 of fastmoe-gpt's 2048), the §5.2 schedule's
capacity micro-shards (a chunk's launch equal to the whole buffer's rows
bit for bit), the shadowed experts' launch of expert placement (its rows
bit-equal to the whole buffer's launch, and a placed layer over a 1x1
NCCL mesh against its plain version and the unplaced layer), and
flash attention (tails of both tile sizes, window 1, GQA, non-causal, a
query offset, one query row; the bf16 forward at both of its tile choices,
also bit for bit on >= 99% of outputs; the bf16 backward's dq bit for bit
over two runs; MLA's (dk 192, dv 128) forward and backward, the bf16
backward's dq, dk and dv bit for bit over two runs; a pair without an
instance refused) included.
``python3 chip_smoke.py`` checks the same at the serving and training
shapes.  Skips on hosts without a card; on the GPU machine:

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``tests/conftest.py`` imports JAX, which the GPU machine does not have.)

Tolerances: bf16 outputs come from f32 sums of identical bf16 products
rounded once, so kernel and plain differ by at most a bf16 ulp where a sum
straddles a rounding boundary (rtol/atol 2e-2); f32 by reassociation
(1e-4).  The gather is a copy: bitwise, on both of its kernels.
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


def _ragged_tables(dev, T, k, E, seed):
    """(token_rows, slot_rows) of a real ragged plan on the card."""
    from repro_torch.core import dispatch as D
    g = torch.Generator().manual_seed(seed)
    ids = torch.rand(T, E, generator=g).topk(k, dim=-1).indices.to(dev)
    plan = D.make_ragged_plan(ids, E)
    return plan.token_rows, plan.slot_rows


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [3, 36, 1024, 5120])
@pytest.mark.parametrize("k", [1, 2, 6])
def test_gather_rows_by_source(dev, dtype, d, k):
    """The ragged dispatch's gather through slot_rows: bitwise equal to the
    plain gather; 16-byte rows take the source-major kernel, others (bf16
    at d 3 and 36) the per-destination kernel, by shape."""
    token_rows, slot_rows = _ragged_tables(dev, 300, k, 16, d + k)
    x = torch.randn(300, d, device=dev).to(dtype)
    fits = d * x.element_size() % 16 == 0
    assert ts.by_source_fits(x, slot_rows) == fits
    before = (ts.gather_rows.launches, ts.gather_rows_by_source.launches)
    got = ts.gather_rows(x, token_rows, slot_rows)
    torch.cuda.synchronize()
    assert torch.equal(got, ts.gather_rows_plain(x, token_rows))
    assert (ts.gather_rows.launches - before[0],
            ts.gather_rows_by_source.launches - before[1]) == \
        ((0, 1) if fits else (1, 0))
    if fits:
        assert torch.equal(ts.gather_rows_by_source_plain(x, slot_rows), got)


@pytest.mark.parametrize("T,d,k", [(2, 5120, 6), (8, 1024, 2), (1000, 1024, 2),
                                   (1000, 5120, 6), (300, 8, 1), (40, 6144, 3)])
def test_gather_rows_by_source_items(dev, T, d, k):
    """Both item sizes (a lane's one chunk where the rows are few, four
    otherwise), rows of one 16-byte chunk (f32 at d 8: half a warp's
    lanes idle) to 24 KB (f32 at d 6144), bitwise."""
    token_rows, slot_rows = _ragged_tables(dev, T, k, 40, T + d)
    x = torch.randn(T, d, device=dev)
    got = ts.gather_rows_by_source(x, slot_rows)
    torch.cuda.synchronize()
    assert torch.equal(got, ts.gather_rows_plain(x, token_rows))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k,d", [(1, 1024), (2, 36), (6, 5120), (40, 64)])
def test_combine_topk_weight_dtypes(dev, dtype, k, d):
    """Weights read as stored: bf16 weights give the bits of the same
    weights cast to f32, no weights the bits of weights of 1; both within
    the tolerance of the plain version (k 40: more slots than a warp)."""
    src = torch.randn(64, d, device=dev).to(dtype)
    idx = torch.randint(0, 64, (30, k), device=dev, dtype=torch.int32)
    idx[0, 0] = 64  # past the rows: adds nothing
    w = torch.rand(30, k, device=dev).to(torch.bfloat16)
    got = ts.combine_topk(src, idx, w)
    torch.cuda.synchronize()
    assert torch.equal(got, ts.combine_topk(src, idx, w.float()))
    torch.testing.assert_close(
        got, ts.combine_topk_plain(src, idx.clamp(max=63), w * (idx < 64)),
        **TOL[dtype])
    ones = ts.combine_topk(src, idx, None)
    assert torch.equal(ones, ts.combine_topk(src, idx, torch.ones_like(w)))


@pytest.mark.parametrize("k", [2, 6])
def test_gather_backward_through_slot_rows(dev, k):
    """The gather's gradient through the plan's table (slot order) against
    the sort of token_rows (row order): bit for bit at k = 2, within the
    f32 tolerance at k = 6."""
    from repro_torch.kernels import ops
    token_rows, slot_rows = _ragged_tables(dev, 500, k, 24, 90 + k)
    x = torch.randn(500, 256, device=dev, requires_grad=True)
    dy = torch.randn(500 * k, 256, device=dev)
    grads = [torch.autograd.grad(ops.gather_tokens(x, token_rows, s), x, dy)[0]
             for s in (slot_rows, None)]
    if k == 2:
        assert torch.equal(*grads)
    else:
        torch.testing.assert_close(*grads, **TOL[torch.float32])


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
    query offset, run twice: its dQ scratch has a slot per kv tile (the
    shape is within dq_scratch's budget), so dq, dk and dv must be equal
    bit for bit over the two runs, and both runs must hold to the plain
    version."""
    B, Sq, Skv, H, KV, d, window, q_offset = 1, 150, 300, 12, 1, 128, 100, 140
    q, k, v, do = _flash_inputs(dev, torch.bfloat16, B, Sq, Skv, H, KV, d, seed=4)
    assert fa.dq_scratch(q, Skv).dim() == 5
    kw = dict(window=window, q_offset=q_offset, causal=True)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    ref = fa.flash_attention_bwd_plain(q, k, v, do, **kw)
    runs = []
    for _ in range(2):
        got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
        torch.cuda.synchronize()
        runs.append(got)
        for a, b in zip(got, ref):
            scale = max(b.float().abs().max().item(), 1.0)
            torch.testing.assert_close(a.float(), b.float(), rtol=2e-2,
                                       atol=2e-2 * scale)
            _assert_fro(a, b, torch.bfloat16)
    for name, a, b in zip(("dq", "dk", "dv"), *runs):
        assert torch.equal(a, b), f"{name} differs between two runs"


def test_flash_attention_bwd_ranged_dq_equals_all_slots(dev, monkeypatch):
    """The bf16 backward with its dQ slot budget forced down to two slots
    (the kv tiles in ranges of two, each summed in order into one f32
    accumulator) gives dq, dk and dv bit-equal to the run with a slot per
    kv tile: the same additions in the same order."""
    B, Sq, Skv, H, KV, d, window, q_offset = 1, 150, 300, 12, 1, 128, 100, 140
    q, k, v, do = _flash_inputs(dev, torch.bfloat16, B, Sq, Skv, H, KV, d, seed=4)
    kw = dict(window=window, q_offset=q_offset, causal=True)
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    assert fa.dq_slots(q, Skv) == 5 and fa.dq_accumulator(q, Skv) is None
    whole = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    monkeypatch.setattr(fa, "DQ_SLOT_BUDGET", 2 * q.numel() * 4)
    assert fa.dq_slots(q, Skv) == 2 and fa.dq_accumulator(q, Skv) is not None
    ranged = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), whole, ranged):
        assert torch.equal(a, b), f"{name}: ranged != all slots"


def test_flash_attention_bwd_starcoder2_group_twice(dev):
    """One starcoder2-15b kv group at 2 x 8192 (12 query heads over one kv
    head of 128, its sliding window): its slots would exceed the budget,
    so the kv tiles run in ranges; two runs are bit-equal."""
    B, S, H, KV, d = 2, 8192, 12, 1, 128
    q, k, v, do = _flash_inputs(dev, torch.bfloat16, B, S, S, H, KV, d, seed=9)
    kw = dict(window=4096, q_offset=0, causal=True)
    assert fa.dq_slots(q, S) < S // fa.BWD_KV_TILE
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    runs = [fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
            for _ in range(2)]
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), *runs):
        assert torch.isfinite(a.float()).all(), name
        assert torch.equal(a, b), f"{name} differs between two runs"


# MLA's pair (deepseek-v2: dk 192 = 128 nope + 64 rope, dv 128), H = KV:
# tails of both forward tiles and of the backward's 16-row q steps, a
# window, non-causal, a query offset, and both forward tile choices
MLA_CASES = [
    (2, 333, 333, 8, 8, 1 << 30, 0, True),
    (1, 150, 300, 4, 4, 100, 150, True),
    (2, 97, 97, 4, 4, 40, 0, False),
    (1, 1024, 1024, 128, 128, 1 << 30, 0, True),  # bq 128: 2-stage ring
]


def _mla_inputs(dev, dtype, B, Sq, Skv, H, KV, seed=6):
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(B, Sq, H, 192, generator=g, device=dev).to(dtype)
    k = torch.randn(B, Skv, KV, 192, generator=g, device=dev).to(dtype)
    v = torch.randn(B, Skv, KV, 128, generator=g, device=dev).to(dtype)
    do = torch.randn(B, Sq, H, 128, generator=g, device=dev).to(dtype)
    return q, k, v, do


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,Sq,Skv,H,KV,window,q_offset,causal", MLA_CASES)
def test_flash_attention_dv_differs_from_dk(dev, dtype, B, Sq, Skv, H, KV,
                                            window, q_offset, causal):
    """The kernels at (dk 192, dv 128): o (B, Sq, H, 128) and lse against
    the plain version (bf16 also bit for bit on >= 99% of outputs); dq,
    dk, dv against its autograd at the dtype's tolerance scaled by each
    gradient's largest entry and to a relative Frobenius error; the bf16
    backward run twice, equal bit for bit (the 128-head case, whose slots
    would exceed the budget, runs its kv tiles in ranges)."""
    q, k, v, do = _mla_inputs(dev, dtype, B, Sq, Skv, H, KV)
    kw = dict(window=window, q_offset=q_offset, causal=causal)
    f0, b0 = fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches
    o, lse = fa.flash_attention_fwd(q, k, v, **kw)
    runs = [fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
            for _ in range(2 if dtype == torch.bfloat16 else 1)]
    torch.cuda.synchronize()
    assert (fa.flash_attention_fwd.launches - f0,
            fa.flash_attention_bwd.launches - b0) == (1, len(runs))
    assert o.shape == (B, Sq, H, 128)
    ro, rlse = fa.flash_attention_fwd_plain(q, k, v, **kw)
    torch.testing.assert_close(o, ro, **TOL[dtype])
    _assert_fro(o, ro, dtype)
    if dtype == torch.bfloat16:
        assert (o == ro).float().mean().item() >= FLASH_EQUAL
    torch.testing.assert_close(lse, rlse, **TOL[torch.float32])
    ref = fa.flash_attention_bwd_plain(q, k, v, do, **kw)
    for got in runs:
        for a, b in zip(got, ref):
            assert a.shape == b.shape
            scale = max(b.float().abs().max().item(), 1.0)
            tol = dict(rtol=TOL[dtype]["rtol"], atol=TOL[dtype]["atol"] * scale)
            torch.testing.assert_close(a.float(), b.float(), **tol)
            _assert_fro(a, b, dtype)
    if dtype == torch.bfloat16:
        for name, a, b in zip(("dq", "dk", "dv"), *runs):
            assert torch.equal(a, b), f"{name} differs between two runs"


@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_flash_attention_pair_without_instance_is_refused(dev, which):
    """The reduced MLA pair (dk 48, dv 32) has no instance on the card:
    both kernels refuse it, naming the pairs they take, never fall back to
    the plain version and count no launch."""
    q, k, _, do = _flash_inputs(dev, torch.bfloat16, 1, 64, 64, 4, 2, 48)
    v = torch.randn(1, 64, 2, 32, device=dev).to(torch.bfloat16)
    do = do[..., :32].contiguous()
    f0, b0 = fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches
    with pytest.raises(ValueError, match=r"\(192, 128\).*got \(48, 32\)"):
        if which == "fwd":
            fa.flash_attention_fwd(q, k, v, window=64)
        else:
            lse = torch.zeros(1, 4, 64, device=dev)
            fa.flash_attention_bwd(q, k, v, do, lse, do, window=64)
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches) == (f0, b0)


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
    """fastmoe-gpt widths over 96 experts at row counts that pick each row
    tile (the training rows pick 64), some experts empty and three rows
    past the groups."""
    E, K, H, N = 96, 1024, 2048, 1024
    assert ff.plan(M, E, H, gated=act == "swiglu").bm == bm
    x, gs, ws, wo, _ = _ffn_inputs(dev, torch.bfloat16, act, M, K, H, N,
                                   _routed_sizes(M, E, M))
    got = ff.fused_ffn(x, ws, wo, gs, act)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ff.fused_ffn_plain(x, ws, wo, gs, act),
                               **TOL[torch.bfloat16])
    assert not got[int(gs.sum()):].any()


# (E, C, chunk rows, K, H, N): fastmoe-gpt's training buffer (96 x 56) cut
# into the chunks of 2 and 4 micro-shards, and 8 experts of 320 rows whose
# 80-row chunks would plan another hidden split (hc 64, 32 partials, where
# the whole buffer's launch takes 256 and 8) unless given the whole's rows
CHUNK_CASES = [(96, 56, 28, 1024, 2048, 1024), (96, 56, 14, 1024, 2048, 1024),
               (8, 320, 80, 256, 2048, 256)]


@pytest.mark.parametrize("act", ["gelu", "swiglu"])
@pytest.mark.parametrize("E,C,rows,K,H,N", CHUNK_CASES)
def test_chunk_launches_equal_the_whole_buffers_rows(dev, act, E, C, rows, K,
                                                     H, N):
    """A capacity buffer (E, C) cut into micro-shards of ``rows`` a expert,
    each launched alone with ``plan_rows`` = the whole buffer's rows: the
    fused FFN's output and its dX, and the grouped GEMM's output, equal the
    whole launch's rows bit for bit.  The row tile ``bm`` follows the
    chunk's rows and does not change a row's arithmetic; the hidden split
    follows ``plan_rows``, so a row sums the same partials in the same
    order.  (dW sums over rows: a chunk's is a part of the whole's.)"""
    M = E * C
    x, gs, ws, wo, dy = _ffn_inputs(dev, torch.bfloat16, act, M, K, H, N,
                                    [C] * E)
    gated = act == "swiglu"
    whole = ff.fused_ffn(x, ws, wo, gs, act)
    whole_dx = fb.fused_ffn_bwd_dx(x, ws, wo, dy, gs, act)
    whole_gg = gg.grouped_gemm(x, ws[0], gs)
    cs = torch.full((E,), rows, dtype=torch.int32, device=dev)
    for c in range(C // rows):
        part = slice(c * rows, (c + 1) * rows)

        def cut(t):
            return t.view(E, C, -1)[:, part].reshape(E * rows, -1)
        assert (ff.plan(E * rows, E, H, gated, split_rows=M).splits
                == ff.plan(M, E, H, gated).splits)
        got = ff.fused_ffn(cut(x), ws, wo, cs, act, plan_rows=M)
        got_dx = fb.fused_ffn_bwd_dx(cut(x), ws, wo, cut(dy), cs, act,
                                     plan_rows=M)
        got_gg = gg.grouped_gemm(cut(x), ws[0], cs)
        torch.cuda.synchronize()
        assert torch.equal(got, cut(whole)), (c, "forward")
        assert torch.equal(got_dx, cut(whole_dx)), (c, "dX")
        assert torch.equal(got_gg, cut(whole_gg)), (c, "grouped GEMM")


@pytest.mark.parametrize("case", ["K36", "H100", "misaligned", "f32", "f32_wide"])
def test_fused_ffn_simple_route(dev, case):
    """Shapes the ring kernel does not take run the simple kernel, right;
    fused_ffn.launches counts them too.  f32_wide: deepseek-v2's K 5120
    and an N over three of the kernel's 1024-column blocks, the last
    partial."""
    K, H, N, dtype = {"K36": (36, 128, 64, torch.bfloat16),
                      "H100": (64, 100, 64, torch.bfloat16),
                      "misaligned": (64, 128, 64, torch.bfloat16),
                      "f32": (64, 128, 64, torch.float32),
                      "f32_wide": (5120, 200, 2100, torch.float32)}[case]
    M, sizes = 40, [0, 17, 20]
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


@pytest.mark.parametrize("dk,dv", fa.HEAD_DIM_PAIRS)
@pytest.mark.parametrize("bq", [64, 128])
def test_flash_fwd_config_matches_the_kernel(dev, dk, dv, bq):
    """The host's mirror of the forward's shared memory is what the kernel
    asks for."""
    from repro_torch.kernels import _build
    lib = _build.load("flash_attention", fa._SIGS)
    cfg = fa.fwd_config(1, 1 if bq == 64 else 1 << 20, 64, dk, dv)
    assert cfg.bq == bq
    assert lib.flash_attention_fwd_smem(dk, dv, bq) == cfg.smem


# ---------------------------------------------------------------------------
# the fused FFN backward's ring kernels
# ---------------------------------------------------------------------------

BWD_RING_SHAPES = [
    # (M, K, H, N, sizes): hidden tails (H % 128 and % 64), empty experts,
    # rows past sum(group_sizes), experts over several dX row tiles
    (40, 48, 200, 72, [9, 0, 17, 5]),
    (300, 128, 136, 200, [0, 130, 0, 120, 41]),
    # an expert of 300 rows (five 64-row dW batches: the later four add to
    # the first's output) beside one of 100 and one of 3
    (420, 64, 264, 64, [300, 0, 3, 100]),
    # nine hidden splits of 256 at the smallest row tile
    (40, 48, 2216, 72, [9, 0, 17, 5]),
]
# dW sums over an expert's rows products of bf16-rounded h and dg: where the
# kernel's f32 recompute and the plain version's differ in the last bit an
# intermediate may round to the neighbouring bf16 value, so dW is held as
# chip_smoke.py holds it (DW_TOL, DW_FRO)
DW_TOL, DW_FRO = dict(rtol=2e-2, atol=0.25), 1e-3


def _check_dw(got, ref, gs):
    dws, dwo = got
    rws, rwo = ref
    for a, b in zip((*dws, dwo), (*rws, rwo)):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b.float(), **DW_TOL)
        assert ((a - b).norm() / b.norm()).item() <= DW_FRO
    empty = gs == 0
    assert not dwo[empty].any() and not any(w[empty].any() for w in dws)


@pytest.mark.parametrize("act", ["gelu", "swiglu", "rwkv", "silu"])
@pytest.mark.parametrize("M,K,H,N,sizes", BWD_RING_SHAPES)
def test_fused_ffn_bwd_dx_ring_kernel(dev, act, M, K, H, N, sizes):
    x, gs, ws, wo, dy = _ffn_inputs(dev, torch.bfloat16, act, M, K, H, N, sizes)
    assert fb.route(x, ws, wo, dy) == "ring"
    ring, simple = fb.fused_ffn_bwd_dx.launches, fb.fused_ffn_bwd_dx_simple.launches
    got = fb.fused_ffn_bwd_dx(x, ws, wo, dy, gs, act)
    torch.cuda.synchronize()
    assert fb.fused_ffn_bwd_dx.launches == ring + 1
    assert fb.fused_ffn_bwd_dx_simple.launches == simple
    torch.testing.assert_close(got, fb.fused_ffn_bwd_dx_plain(x, ws, wo, dy, gs, act),
                               **TOL[torch.bfloat16])
    assert not got[int(gs.sum()):].any()


@pytest.mark.parametrize("act", ["gelu", "swiglu", "rwkv", "silu"])
@pytest.mark.parametrize("M,K,H,N,sizes", BWD_RING_SHAPES)
def test_fused_ffn_bwd_dw_ring_kernel(dev, act, M, K, H, N, sizes):
    x, gs, ws, wo, dy = _ffn_inputs(dev, torch.bfloat16, act, M, K, H, N, sizes)
    assert fb.route(x, ws, wo, dy) == "ring"
    ring, simple = fb.fused_ffn_bwd_dw.launches, fb.fused_ffn_bwd_dw_simple.launches
    got = fb.fused_ffn_bwd_dw(x, ws, wo, dy, gs, act)
    torch.cuda.synchronize()
    assert fb.fused_ffn_bwd_dw.launches == ring + 1
    assert fb.fused_ffn_bwd_dw_simple.launches == simple
    _check_dw(got, fb.fused_ffn_bwd_dw_plain(x, ws, wo, dy, gs, act), gs)


@pytest.mark.parametrize("act", ["gelu", "swiglu"])
@pytest.mark.parametrize("M,bm", [(16, 16), (2048, 32), (4096, 64)])
def test_fused_ffn_bwd_ring_kernels_model_rows(dev, act, M, bm):
    """fastmoe-gpt widths over 96 experts at row counts that pick each row
    tile (the training rows pick 64), some experts empty and three rows
    past the groups."""
    E, K, H, N = 96, 1024, 2048, 1024
    assert fb.plan_bwd(M, E, H).bm == bm
    x, gs, ws, wo, dy = _ffn_inputs(dev, torch.bfloat16, act, M, K, H, N,
                                    _routed_sizes(M, E, M))
    dx = fb.fused_ffn_bwd_dx(x, ws, wo, dy, gs, act)
    torch.cuda.synchronize()
    torch.testing.assert_close(dx, fb.fused_ffn_bwd_dx_plain(x, ws, wo, dy, gs, act),
                               **TOL[torch.bfloat16])
    assert not dx[int(gs.sum()):].any()
    del dx
    _check_dw(fb.fused_ffn_bwd_dw(x, ws, wo, dy, gs, act),
              fb.fused_ffn_bwd_dw_plain(x, ws, wo, dy, gs, act), gs)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H", [1024, 512])
def test_expert_kernels_at_tp_hidden_shards(dev, dtype, H):
    """Expert-internal tensor parallelism hands each data rank a hidden
    slice of fastmoe-gpt's 2048 (1024 over 2 ranks, 512 over 4): the fused
    FFN forward, its dX and dW and the grouped GEMM (x @ wi, h @ wo, and dX
    reading wi transposed) at the training rows' capacity buffer (96
    experts x 56 slots, slots past a load of ~43 zero), against their plain
    versions; bf16 on the ring kernels."""
    E, K, N, C = 96, 1024, 1024, 56
    loads = [C - (e % 3) * 7 for e in range(E)]
    x, gs, ws, wo, dy = _ffn_inputs(dev, dtype, "gelu", E * C, K, H, N,
                                    [C] * E)
    slot = torch.arange(C, device=dev)
    empty = slot[None] >= torch.tensor(loads, device=dev)[:, None]
    x.view(E, C, K)[empty] = 0
    if dtype == torch.bfloat16:
        assert ff.route(x, ws, wo) == "ring" == fb.route(x, ws, wo, dy)
    got = ff.fused_ffn(x, ws, wo, gs, "gelu")
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ff.fused_ffn_plain(x, ws, wo, gs, "gelu"),
                               **TOL[dtype])
    dx = fb.fused_ffn_bwd_dx(x, ws, wo, dy, gs, "gelu")
    torch.cuda.synchronize()
    torch.testing.assert_close(
        dx, fb.fused_ffn_bwd_dx_plain(x, ws, wo, dy, gs, "gelu"), **TOL[dtype])
    _check_dw(fb.fused_ffn_bwd_dw(x, ws, wo, dy, gs, "gelu"),
              fb.fused_ffn_bwd_dw_plain(x, ws, wo, dy, gs, "gelu"), gs)
    h = torch.randn(E * C, H, device=dev).to(dtype)
    for a, w, trans in ((x, ws[0], False), (h, wo, False), (h, ws[0], True)):
        out = gg.grouped_gemm(a, w, gs, trans)
        torch.cuda.synchronize()
        torch.testing.assert_close(out, gg.grouped_gemm_plain(a, w, gs, trans),
                                   **TOL[dtype])


@pytest.mark.parametrize("case", ["K36", "H100", "misaligned", "f32", "f32_wide"])
def test_fused_ffn_bwd_simple_route(dev, case):
    """Shapes the ring kernels do not take run the first versions, right;
    the kernels' launch counters count them too.  f32_wide: deepseek-v2's
    K 5120, dX over five of the dX kernel's 1024-column blocks."""
    K, H, N, dtype = {"K36": (36, 128, 64, torch.bfloat16),
                      "H100": (64, 100, 64, torch.bfloat16),
                      "misaligned": (64, 128, 64, torch.bfloat16),
                      "f32": (64, 128, 64, torch.float32),
                      "f32_wide": (5120, 200, 2100, torch.float32)}[case]
    M, sizes = 40, [0, 17, 20]
    x, gs, ws, wo, dy = _ffn_inputs(dev, dtype, "gelu", M, K, H, N, sizes)
    if case == "misaligned":
        buf = torch.zeros(M * N + 8, dtype=dtype, device=dev)
        dy = buf[1:1 + M * N].view(M, N).copy_(dy)
    assert fb.route(x, ws, wo, dy) == "simple"
    counts = [f.launches for f in (fb.fused_ffn_bwd_dx, fb.fused_ffn_bwd_dx_simple,
                                   fb.fused_ffn_bwd_dw, fb.fused_ffn_bwd_dw_simple)]
    dx = fb.fused_ffn_bwd_dx(x, ws, wo, dy, gs, "gelu")
    got = fb.fused_ffn_bwd_dw(x, ws, wo, dy, gs, "gelu")
    torch.cuda.synchronize()
    assert [f.launches for f in (fb.fused_ffn_bwd_dx, fb.fused_ffn_bwd_dx_simple,
                                 fb.fused_ffn_bwd_dw, fb.fused_ffn_bwd_dw_simple)] \
        == [c + 1 for c in counts]
    torch.testing.assert_close(dx, fb.fused_ffn_bwd_dx_plain(x, ws, wo, dy, gs, "gelu"),
                               **TOL[dtype])
    for a, b in zip((*got[0], got[1]),
                    (*fb.fused_ffn_bwd_dw_plain(x, ws, wo, dy, gs, "gelu")[0],
                     fb.fused_ffn_bwd_dw_plain(x, ws, wo, dy, gs, "gelu")[1])):
        torch.testing.assert_close(a, b.float(), **TOL[dtype])


@pytest.mark.parametrize("kind", [0, 1])
def test_fused_ffn_bwd_smem_matches_the_kernel(dev, kind):
    """The host's mirrors of the ring kernels' shared memory are what the
    kernels ask for, at every instance."""
    from repro_torch.kernels import _build
    lib = _build.load("fused_ffn_bwd", fb._SIGS)
    for gated in (False, True):
        if kind == 0:
            for bm in ff.ROW_TILES:
                assert lib.fused_ffn_bwd_smem(0, bm, int(gated)) == \
                    fb.dx_smem(bm, gated)
        else:
            assert lib.fused_ffn_bwd_smem(1, 0, int(gated)) == fb.dw_smem(gated)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl,dispatch", [("fused", "ragged"),
                                           ("pallas", "capacity")])
def test_continuous_paged_equals_ring(dev, dtype, impl, dispatch):
    """Reduced fastmoe-gpt (2 layers, d_model 256: heads of 64, which the
    flash kernels take) served by continuous batching through the kernels:
    the paged pool's greedy tokens equal the ring's bit for bit over a
    stream with admissions, retires, idle slots and partial tail blocks
    (max_len 48 = 6 blocks of 8), the kernels launched, and the null block
    of every pool unwritten."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.scheduler import ContinuousBatcher
    from repro_torch.launch.serve_api import Request, ServeConfig
    from repro_torch.models import attention as A
    from repro_torch.models import lm

    cfg = reduced(get_config("fastmoe-gpt"), num_layers=2, d_model=256)
    cfg = dataclasses.replace(cfg, dtype=dtype, moe=dataclasses.replace(
        cfg.moe, dispatch=dispatch))
    params = lm.init_params(cfg, seed=0, device=dev)
    rng = np.random.RandomState(0)
    reqs = [(i, rng.randint(0, cfg.vocab_size, rng.randint(3, 20)),
             int(rng.randint(2, 12))) for i in range(9)]
    expert = {"fused": ff.fused_ffn, "pallas": gg.grouped_gemm
              if dtype == "bfloat16" else gg.grouped_gemm_simple}[impl]
    kernel = (fa.flash_attention_fwd, expert)
    out = {}
    for paged in (True, False):
        before = [k.launches for k in kernel]
        b = ContinuousBatcher(params, cfg, ServeConfig(
            slots=3, max_len=48, block_size=8, paged=paged), impl=impl,
            device=dev)
        for i, p, n in reqs:
            b.submit(Request(id=i, prompt=p, max_new_tokens=n, arrival=0.0))
        b.run()
        out[paged] = {c.request_id: c.tokens for c in b.completions}
        assert all(k.launches > n for k, n in zip(kernel, before))
        if paged:
            for pool in b.pool:
                assert (pool.positions[A.NULL_BLOCK] == -1).all()
                assert not pool.k[A.NULL_BLOCK].any()
    assert sorted(out[True]) == list(range(len(reqs)))
    assert out[True] == out[False]


def _moe_case(dev, router, dispatch, top_k=2, policy="softmax_topk",
              renormalize=True, E=16, d=256, h=512, T=512, act="gelu"):
    """A bf16 MoE layer on the card (params from a seed) and its input."""
    from repro_torch.configs.base import MoEConfig
    from repro_torch.core import fmoe

    cfg = MoEConfig(num_experts=E, top_k=top_k, d_expert_hidden=h,
                    router=router, dispatch=dispatch, gate_policy=policy,
                    renormalize=renormalize, capacity_factor=1.25)
    g = torch.Generator(device=dev).manual_seed(0)
    params = fmoe.fmoe_init(g, d, cfg, act=act, device=dev,
                            dtype=torch.bfloat16)
    x = torch.randn(T, d, generator=g, device=dev).to(torch.bfloat16)
    return cfg, params, x


def _layer_fwd_bwd(params, x, cfg, impl, act="gelu"):
    """y and the gradients of sum(y * r) w.r.t. every leaf and x."""
    from repro_torch.core import fmoe

    p = {k: {n: t.detach().clone().requires_grad_() for n, t in v.items()}
         for k, v in params.items()}
    xs = x.detach().clone().requires_grad_()
    y, _ = fmoe.fmoe_apply(p, xs, cfg, act=act, impl=impl)
    r = torch.randn(y.shape, generator=torch.Generator(
        device=y.device).manual_seed(1), device=y.device).to(y.dtype)
    leaves = [t for v in p.values() for t in v.values()] + [xs]
    return [y, *torch.autograd.grad((y.float() * r.float()).sum(), leaves,
                                    allow_unused=True,
                                    materialize_grads=True)]


def test_ec_gather_and_combine_are_deterministic(dev):
    """Expert-choice's gather (the by-destination kernel; its gradient sums
    a variable count of rows a token with combine_topk in row order) and
    combine_ec at fastmoe-gpt's training shape (2048 tokens, 96 experts, C
    26): forward bitwise the plain gather, gradients bit-equal over two
    runs and within bf16 of the f32 sums."""
    from repro_torch.core import dispatch as D
    from repro_torch.core import gate

    T, E, d = 2048, 96, 1024
    g = torch.Generator(device=dev).manual_seed(3)
    probs = torch.softmax(torch.randn(T, E, generator=g, device=dev), -1)
    C = D.ec_capacity(T, E, 1.25)
    w, idx = gate.topk_lower_index(probs.T, C)
    x = torch.randn(T, d, generator=g, device=dev).to(torch.bfloat16)
    dy = torch.randn(E, C, d, generator=g, device=dev).to(torch.bfloat16)
    runs = []
    for _ in range(2):
        before = ts.gather_rows.launches, ts.combine_topk.launches
        xs = x.clone().requires_grad_()
        out = D.gather_ec(xs, idx)
        assert torch.equal(out, x[idx])
        (dx,) = torch.autograd.grad(out, xs, dy)
        assert (ts.gather_rows.launches, ts.combine_topk.launches) == (
            before[0] + 1, before[1] + 1)
        o = dy.clone().requires_grad_()
        wv = w.clone().requires_grad_()
        y = D.combine_ec(o, idx, wv, T)
        gy = torch.randn(y.shape, generator=torch.Generator(
            device=dev).manual_seed(4), device=dev).to(y.dtype)
        runs.append([dx, y, *torch.autograd.grad(y, [o, wv], gy)])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    want = torch.zeros(T, d, device=dev).index_add_(
        0, idx.reshape(-1), dy.reshape(-1, d).float())
    torch.testing.assert_close(runs[0][0].float(), want, **TOL[torch.bfloat16])


@pytest.mark.parametrize("dispatch", ["capacity", "ragged"])
@pytest.mark.parametrize("impl", ["fused", "pallas"])
def test_ec_layer_repeats_bit_for_bit(dev, impl, dispatch):
    """An expert-choice layer's forward and every gradient repeat bit for
    bit on the card, and sit within bf16 of the einsum path."""
    cfg, params, x = _moe_case(dev, "expert_choice", dispatch)
    a, b = (_layer_fwd_bwd(params, x, cfg, impl) for _ in range(2))
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    ref = _layer_fwd_bwd(params, x, cfg, "einsum")
    torch.testing.assert_close(a[0].float(), ref[0].float(), rtol=5e-2,
                               atol=5e-2)


@pytest.mark.parametrize("dispatch,impl", [("ragged", "fused"),
                                           ("capacity", "pallas"),
                                           ("ragged", "pallas"),
                                           ("capacity", "fused")])
def test_top1_paths(dev, dispatch, impl):
    """The k = 1 paths of switch-base-128 (topk_softmax, no renormalize,
    GELU, 128 experts): the source-major gather and the combine at k = 1,
    the expert kernels, and their backward, against the einsum path within
    bf16, and repeating bit for bit."""
    cfg, params, x = _moe_case(dev, "topk", dispatch, top_k=1,
                               policy="topk_softmax", renormalize=False,
                               E=128, d=768, h=3072, T=1024)
    before = (ts.gather_rows_by_source.launches, ts.combine_topk.launches)
    a = _layer_fwd_bwd(params, x, cfg, impl)
    if dispatch == "ragged":
        assert ts.gather_rows_by_source.launches > before[0]
        assert ts.combine_topk.launches > before[1]
    b = _layer_fwd_bwd(params, x, cfg, impl)
    for u, v in zip(a, b):
        assert torch.equal(u, v)
    ref = _layer_fwd_bwd(params, x, cfg, "einsum")
    torch.testing.assert_close(a[0].float(), ref[0].float(), rtol=5e-2,
                               atol=5e-2)


@pytest.mark.parametrize("H", [2048, 512])
def test_shadow_launch_rows_equal_the_whole_launch(dev, H):
    """The shadowed experts' launch of a placed step (the last 8 of 96
    experts' capacity rows, planned for the whole buffer's rows): the fused
    FFN and its dX on it equal the same rows of the whole buffer's launch
    bit for bit, and the plain version within bf16."""
    E, C, d, S = 96, 56, 1024, 8
    g = torch.Generator(device=dev).manual_seed(5)
    bf = torch.bfloat16
    wi = (torch.randn(E, d, H, generator=g, device=dev) * d ** -0.5).to(bf)
    wo = (torch.randn(E, H, d, generator=g, device=dev) * H ** -0.5).to(bf)
    x = torch.randn(E * C, d, generator=g, device=dev).to(bf)
    dy = torch.randn(E * C, d, generator=g, device=dev).to(bf)
    whole = torch.full((E,), C, dtype=torch.int32, device=dev)
    tail = slice((E - S) * C, None)
    ws = (wi[E - S:],)
    y = ff.fused_ffn(x, (wi,), wo, whole, "gelu")
    y_s = ff.fused_ffn(x[tail], ws, wo[E - S:], whole[:S], "gelu", E * C)
    assert torch.equal(y_s, y[tail])
    torch.testing.assert_close(
        y_s, ff.fused_ffn_plain(x[tail], ws, wo[E - S:], whole[:S], "gelu"),
        **TOL[bf])
    dx = fb.fused_ffn_bwd_dx(x, (wi,), wo, dy, whole, "gelu")
    dx_s = fb.fused_ffn_bwd_dx(x[tail], ws, wo[E - S:], dy[tail], whole[:S],
                               "gelu", E * C)
    assert torch.equal(dx_s, dx[tail])


@pytest.mark.parametrize("dispatch", ["capacity", "ragged"])
@pytest.mark.parametrize("impl", ["fused", "pallas"])
def test_placed_layer_on_the_card(dev, impl, dispatch):
    """A bf16 layer over a 1x1 NCCL mesh under a plan that permutes the
    experts and shadows 4 of them (their own launch, counted): its output
    equals the unplaced local layer's bit for bit, and its output and
    input gradient stay within bf16 of the placed layer's plain version
    (einsum) on the card."""
    import numpy as np
    import torch.distributed as tdist

    from repro_torch.core import fmoe
    from repro_torch.launch.mesh import init_distributed, make_local_mesh
    from repro_torch.placement import ExpertPlacement, from_logical

    cfg, params, x = _moe_case(dev, "topk", dispatch)
    E = cfg.num_experts
    perm = tuple(int(i) for i in np.random.default_rng(2).permutation(E))
    plan = ExpertPlacement(E, 1, perm, num_shadow=4)
    placed = from_logical({k: {n: t.clone() for n, t in v.items()}
                           for k, v in params.items()}, plan)
    init_distributed(dev, rank=0, world_size=1, store=tdist.HashStore())
    try:
        dist = fmoe.DistConfig(make_local_mesh(1, 1), ("data", "model"),
                               placement=plan)
        counter = ff.fused_ffn if impl == "fused" else gg.grouped_gemm
        before = counter.launches
        y0, _ = fmoe.fmoe_apply(params, x, cfg, act="gelu", impl=impl)
        mid = counter.launches
        y1, _ = fmoe.fmoe_apply(placed, x, cfg, act="gelu", impl=impl,
                                dist=dist)
        torch.cuda.synchronize()
        assert counter.launches - mid == 2 * (mid - before)  # the shadow launch
        assert torch.equal(y0, y1)
        outs = []
        for i in (impl, "einsum"):
            xs = x.clone().requires_grad_()
            y, _ = fmoe.fmoe_apply(placed, xs, cfg, act="gelu", impl=i,
                                   dist=dist)
            (gx,) = torch.autograd.grad(y.float().sum(), xs)
            outs.append((y, gx))
        for a, b in zip(*outs):
            torch.testing.assert_close(a.float(), b.float(), rtol=5e-2,
                                       atol=5e-2)
    finally:
        tdist.destroy_process_group()


@pytest.mark.parametrize("impl", ["fused", "pallas"])
def test_psum_tick_launches_equal_the_whole_launch(dev, impl):
    """A decode tick of the placed psum mode at full width (8 slots, top-2:
    16 sorted rows over 96 experts, 8 of them shadowed): the owned
    segment's launch (88 groups) and the shadowed tail's (8 groups), each
    planned for the whole buffer's rows and experts, equal the rows of the
    whole buffer's launch bit for bit, and their plain versions within
    bf16; ``combine_topk`` at k = 1 (the slot-wise combine) equals its
    plain version bit for bit."""
    E, S, n, d, H = 96, 8, 16, 1024, 2048
    g = torch.Generator(device=dev).manual_seed(7)
    bf = torch.bfloat16
    wi = (torch.randn(E, d, H, generator=g, device=dev) * d ** -0.5).to(bf)
    wo = (torch.randn(E, H, d, generator=g, device=dev) * H ** -0.5).to(bf)
    x = torch.randn(n, d, generator=g, device=dev).to(bf)
    ids = torch.randint(0, E, (n,), generator=g, device=dev).sort().values
    gs = torch.bincount(ids, minlength=E).to(torch.int32)
    lo = int(gs[:E - S].sum())

    def run(xs, w_i, w_o, sizes, **plan):
        if impl == "fused":
            return ff.fused_ffn(xs, (w_i,), w_o, sizes, "gelu", **plan)
        h = ff.activate(gg.grouped_gemm(xs, w_i, sizes), None, "gelu")
        return gg.grouped_gemm(h, w_o, sizes)

    whole = run(x, wi, wo, gs)
    plan = dict(plan_rows=n, plan_groups=E) if impl == "fused" else {}
    own = torch.zeros_like(x)
    own[:lo] = x[:lo]
    tail = torch.zeros_like(x)
    tail[:n - lo] = x[lo:]
    y_own = run(own, wi[:E - S], wo[:E - S], gs[:E - S], **plan)
    y_sh = run(tail, wi[E - S:], wo[E - S:], gs[E - S:], **plan)
    torch.cuda.synchronize()
    assert torch.equal(y_own[:lo], whole[:lo])
    assert torch.equal(y_sh[:n - lo], whole[lo:])
    torch.testing.assert_close(
        y_sh, ff.fused_ffn_plain(tail, (wi[E - S:],), wo[E - S:], gs[E - S:],
                                 "gelu"), **TOL[bf])
    if impl == "fused":
        assert (ff.plan(lo, E - S, H, split_rows=n, split_groups=E).hc
                == ff.plan(n, E, H).hc
                == ff.plan(n - lo, S, H, split_rows=n, split_groups=E).hc)
    rows = torch.randperm(n, generator=g, device=dev).to(torch.int32)[:, None]
    w = torch.rand(n, 1, generator=g, device=dev).to(bf)
    got = ts.combine_topk(whole, rows, w)
    assert torch.equal(got, ts.combine_topk_plain(whole, rows, w))


@pytest.mark.parametrize("dispatch", ["capacity", "ragged"])
@pytest.mark.parametrize("impl", ["fused", "pallas"])
def test_placed_psum_layer_on_the_card(dev, impl, dispatch):
    """The psum mode over a 1x1 NCCL mesh in bf16 under a plan that
    permutes the experts and shadows 4 of them (outside the all-reduce,
    their own launch): bit for bit the identity plan's output (both
    slot-wise), the ragged slot-wise combine on the ``combine_topk``
    kernel; within bf16 of the unplaced psum layer (the combined
    reduction) and of the placed layer's plain version (einsum)."""
    import numpy as np
    import torch.distributed as tdist

    from repro_torch.core import fmoe
    from repro_torch.launch.mesh import init_distributed, make_local_mesh
    from repro_torch.placement import (ExpertPlacement, from_logical,
                                       identity_placement)

    cfg, params, x = _moe_case(dev, "topk", dispatch)
    E = cfg.num_experts
    perm = tuple(int(i) for i in np.random.default_rng(2).permutation(E))
    plan = ExpertPlacement(E, 1, perm, num_shadow=4)
    placed = from_logical({k: {n: t.clone() for n, t in v.items()}
                           for k, v in params.items()}, plan)
    init_distributed(dev, rank=0, world_size=1, store=tdist.HashStore())
    try:
        psum = fmoe.DistConfig(make_local_mesh(1, 1), ("data",))
        counter = ff.fused_ffn if impl == "fused" else gg.grouped_gemm
        kw = dict(act="gelu", impl=impl)
        y0, _ = fmoe.fmoe_apply(params, x, cfg, dist=psum, **kw)
        ident = identity_placement(E, 1)
        y_id, _ = fmoe.fmoe_apply(params, x, cfg, **kw,
                                  dist=psum._replace(placement=ident),
                                  l2p=torch.arange(E, device=dev))
        before, combines = counter.launches, ts.combine_topk.launches
        y1, _ = fmoe.fmoe_apply(placed, x, cfg, dist=psum._replace(
            placement=plan), **kw)
        torch.cuda.synchronize()
        assert counter.launches - before == 2 * (2 if impl == "pallas" else 1)
        if dispatch == "ragged":
            assert ts.combine_topk.launches - combines == 2  # owned, shadow
        assert torch.equal(y1, y_id)
        torch.testing.assert_close(y1.float(), y0.float(), rtol=2e-2,
                                   atol=2e-2)
        y_plain, _ = fmoe.fmoe_apply(placed, x, cfg, act="gelu",
                                     impl="einsum",
                                     dist=psum._replace(placement=plan))
        torch.testing.assert_close(y1.float(), y_plain.float(), rtol=5e-2,
                                   atol=5e-2)
    finally:
        tdist.destroy_process_group()
