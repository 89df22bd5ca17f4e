"""Host-side choices of the bf16 kernels, checked on the CPU with no kernel
launched: the grouped GEMM's tile shape (``tile_config``) and its routing
between the ring kernel and the simple one (``route``), the f32 dQ
scratch of the flash backward (``dq_scratch``: per-kv-tile slots within a
budget, else ranges of the kv tiles summed into ``dq_accumulator``), the fused FFN's tiling (``plan``)
and routing (``route``), its backward's (``plan_bwd``, ``route``, the
shared memory mirrors ``dx_smem`` / ``dw_smem``), and the flash forward's
tiles and shared memory (``fwd_config``) at every (dk, dv) pair with an
instance, and the refusal of a pair without one before any card is
needed.  The SM count they plan for is ``_build.SMS``."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import fused_ffn as ff  # noqa: E402
from repro_torch.kernels import fused_ffn_bwd as fb  # noqa: E402
from repro_torch.kernels import grouped_gemm as gg  # noqa: E402

E = 96  # fastmoe-gpt experts


@pytest.mark.parametrize("M,N,expected", [
    (16, 2048, (16, 64)),     # decode: 8 tokens top-2, x @ wi
    (16, 1024, (16, 64)),     # decode: h @ wo
    (2048, 2048, (32, 128)),  # prefill: 1024 tokens top-2
    (4096, 2048, (64, 128)),  # training: 2048 tokens top-2, forward
    (4096, 1024, (64, 128)),  # training: dX = dy @ wi^T
    (E * 56, 2048, (64, 128)),  # training, capacity rows
    (E * 8, 2048, (16, 128)),   # capacity decode: 8 slots an expert
])
def test_tile_config_model_shapes(M, N, expected):
    assert gg.tile_config(M, N, E) == expected


@pytest.mark.parametrize("per_group,bm", [
    (1, 16), (16, 16), (17, 32), (32, 32), (33, 64), (64, 64), (65, 64),
    (500, 64)])
def test_tile_config_row_tile_boundaries(per_group, bm):
    """The smallest row tile that holds a group of average size, at most
    64 rows."""
    assert gg.tile_config(E * per_group, 2048, E)[0] == bm
    assert gg.tile_config(E * per_group - (E - 1), 2048, E)[0] == bm


@pytest.mark.parametrize("N", [1024, 2048])
def test_tile_config_fills_the_card_at_decode(N):
    """16 decode rows touch at most 16 experts: their row tiles times the
    column tiles must give every SM a block."""
    bm, bn = gg.tile_config(16, N, E)
    assert min(16, E) * math.ceil(N / bn) >= _build.SMS


def _w(E_, K, N, dtype, trans_w=False):
    return torch.zeros((E_, N, K) if trans_w else (E_, K, N), dtype=dtype)


@pytest.mark.parametrize("trans_w", [False, True])
@pytest.mark.parametrize("K,N,dtype,expected", [
    (1024, 2048, torch.bfloat16, "mma"),
    (64, 200, torch.bfloat16, "mma"),       # N a multiple of 8, not of 64
    (36, 24, torch.bfloat16, "simple"),     # K not a multiple of 8
    (64, 36, torch.bfloat16, "simple"),     # N not a multiple of 8
    (1024, 2048, torch.float32, "simple"),  # f32 keeps the FMA kernel
])
def test_route_dtype_and_shape(trans_w, K, N, dtype, expected):
    x = torch.zeros(16, K, dtype=dtype)
    assert gg.route(x, _w(4, K, N, dtype, trans_w), trans_w) == expected


@pytest.mark.parametrize("which", ["x", "w"])
def test_route_misaligned_operand_takes_the_simple_kernel(which):
    """A view that starts 2 bytes into a buffer cannot feed 16-byte copies."""
    K, N = 64, 128
    buf = torch.zeros(4 * K * N + 8, dtype=torch.bfloat16)
    off = buf[1:]
    x = off[:16 * K].view(16, K) if which == "x" else torch.zeros(16, K, dtype=torch.bfloat16)
    w = off[:4 * K * N].view(4, K, N) if which == "w" else _w(4, K, N, torch.bfloat16)
    assert gg.route(x, w) == "simple"


@pytest.mark.parametrize("shape,skv,slots", [
    ((8, 256, 16, 64), 256, 4),       # fastmoe-gpt training: 4 x 8.4 MB
    ((2, 333, 12, 128), 333, 6),      # tails of both tile sizes
    ((2, 8192, 12, 128), 8192, 42),   # a starcoder2 kv group: 128 tiles
])
def test_dq_scratch_bf16(shape, skv, slots):
    """One f32 slot of q's shape per 64-row kv tile where they fit the
    budget (each kv tile stores its part, summed in order: deterministic),
    else as many slots as fit, the kv tiles in ranges of that many, and an
    f32 accumulator of q's shape the ranges are summed into in order."""
    q = torch.zeros(shape, dtype=torch.bfloat16, device="meta")  # no memory
    acc = fa.dq_scratch(q, skv)
    assert fa.dq_slots(q, skv) == slots
    assert acc.dtype == torch.float32 and acc.is_contiguous()
    assert acc.device == q.device
    assert acc.shape == (slots, *shape)
    assert acc.numel() * 4 <= fa.DQ_SLOT_BUDGET
    total = fa.dq_accumulator(q, skv)
    if slots == math.ceil(skv / 64):
        assert total is None
    else:
        assert math.ceil(skv / 64) * q.numel() * 4 > fa.DQ_SLOT_BUDGET
        assert total.shape == q.shape and total.dtype == torch.float32


def test_dq_scratch_f32_is_none():
    """The f32 backward's dQ kernel owns each row: no scratch."""
    assert fa.dq_scratch(torch.zeros(1, 8, 2, 64), 8) is None


# ---------------------------------------------------------------------------
# fused FFN: plan, row tiles, route
# ---------------------------------------------------------------------------

HIDDEN = 2048  # fastmoe-gpt


def _topk_sizes(tokens, k, seed, lo=0):
    """Group sizes of `tokens` tokens routed top-k over experts lo..E-1 by
    random scores (the chip smoke test's routing)."""
    rng = np.random.default_rng(seed)
    ids = np.argsort(-rng.random((tokens, E - lo)), axis=1)[:, :k] + lo
    return np.bincount(ids.ravel(), minlength=E).tolist()


def row_tiles(group_sizes, M, bm):
    """A model of the row tiles ``find_tile`` (``csrc/common.cuh``) hands
    the blocks, as (group, row0, row1) in block order: group e owns
    ceil(size_e / bm) tiles of its rows, empty groups none; tiles past
    sum(group_sizes) are zero tiles (group -1).  The kernel's own lookup is
    held to the plain version by the ``cuda`` ring-kernel tests (empty
    groups, rows past the groups, experts over several tiles)."""
    tiles, start = [], 0
    for e, size in enumerate(group_sizes):
        for r0 in range(start, start + size, bm):
            tiles.append((e, min(r0, M), min(r0 + bm, start + size, M)))
        start += size
    for r0 in range(start, M, bm):
        tiles.append((-1, r0, min(r0 + bm, M)))
    return tiles


def grid_rows(M, bm):
    """The ring kernel's row blocks (``launch_ring`` in
    ``csrc/fused_ffn.cu``): ceil(M / bm) + min(E, M) + 1."""
    return math.ceil(M / bm) + min(E, M) + 1


FFN_MAIN_PATH = {
    # name: (M rows, group sizes): decode (8 tokens top-2, one short), prefill
    # (1020 of 1024 tokens, experts 0..9 empty), ragged training (2044 of 2048
    # tokens, experts 0..5 empty), capacity training (96 x 56 slots)
    "decode": (16, _topk_sizes(7, 2, 0)),
    "prefill": (2048, _topk_sizes(1020, 2, 1, lo=10)),
    "train": (4096, _topk_sizes(2044, 2, 2, lo=6)),
    "capacity": (E * 56, [56] * E),
}


@pytest.mark.parametrize("shape,expected", [
    ("decode", (16, 64, 32)), ("prefill", (32, 256, 8)),
    ("train", (64, 256, 8)), ("capacity", (64, 256, 8))])
def test_ffn_plan_main_path(shape, expected):
    M, sizes = FFN_MAIN_PATH[shape]
    assert tuple(ff.plan(M, E, HIDDEN)) == expected


@pytest.mark.parametrize("shape", list(FFN_MAIN_PATH))
@pytest.mark.parametrize("gated", [False, True])
def test_ffn_plan_fills_the_card_within_the_grid(shape, gated):
    """At every main-path shape the blocks with rows (row tiles x splits)
    give each SM at least two, the hidden chunks cover H exactly, and the
    grid's row blocks hold every row tile of the routed sizes."""
    M, sizes = FFN_MAIN_PATH[shape]
    p = ff.plan(M, E, HIDDEN, gated=gated)
    tiles = row_tiles(sizes, M, p.bm)
    real = [t for t in tiles if t[0] >= 0]
    assert len(real) * p.splits >= 2 * _build.SMS
    assert p.splits == math.ceil(HIDDEN / p.hc) and (p.splits - 1) * p.hc < HIDDEN
    assert len(tiles) <= grid_rows(M, p.bm)


@pytest.mark.parametrize("shape", ["decode", "train", "capacity"])
@pytest.mark.parametrize("shadow", [1, 8, 48])
def test_ffn_plan_split_follows_the_whole_buffer(shape, shadow):
    """A launch on a part of a buffer (the placed psum mode's owned segment
    of E - S experts, its shadowed tail of S), planned for the whole
    buffer's rows and experts, takes the whole launch's hidden split, so
    its rows sum the same f32 partials; unplanned, a narrow launch (few
    groups) may take another."""
    M, sizes = FFN_MAIN_PATH[shape]
    whole = ff.plan(M, E, HIDDEN)
    for m, e in ((sum(sizes[:E - shadow]), E - shadow),
                 (sum(sizes[E - shadow:]), shadow)):
        p = ff.plan(max(m, 1), e, HIDDEN, split_rows=M, split_groups=E)
        assert (p.hc, p.splits) == (whole.hc, whole.splits), (m, e)
    if shape != "decode":  # unplanned, 8 experts' rows take another split
        assert ff.plan(sum(sizes[E - 8:]), 8, HIDDEN).hc != whole.hc


@pytest.mark.parametrize("per_group,bm", [(1, 16), (16, 16), (17, 32), (32, 32),
                                          (33, 64), (500, 64)])
def test_ffn_plan_row_tile_holds_an_average_expert(per_group, bm):
    assert ff.plan(E * per_group, E, HIDDEN).bm == bm


@pytest.mark.parametrize("H", [64, 200, 2048, 2000, 8192])
@pytest.mark.parametrize("gated", [False, True])
def test_ffn_plan_hidden_chunk(H, gated):
    """A chunk the kernel has (<= 128 when gated), the largest that still
    fills the card, and a split count that covers H."""
    for M in (16, 2048, 4096):
        p = ff.plan(M, E, H, gated=gated)
        assert p.hc in ((64, 128) if gated else ff.HIDDEN_CHUNKS)
        assert p.splits == math.ceil(H / p.hc)
        rows = max(math.ceil(M / p.bm), min(M, E))
        bigger = [c for c in ff.HIDDEN_CHUNKS if c > p.hc and not (gated and c > 128)]
        assert all(rows * math.ceil(H / c) < 2 * _build.SMS for c in bigger)


@pytest.mark.parametrize("seed", range(5))
def test_ffn_grid_rows_hold_every_tile(seed):
    """Random group sizes (empty groups, sum below M): the row tiles never
    outnumber the grid's row blocks."""
    rng = np.random.default_rng(seed)
    for bm in ff.ROW_TILES:
        sizes = rng.integers(0, 3 * bm, size=E)
        sizes[rng.random(E) < 0.3] = 0
        M = int(sizes.sum()) + int(rng.integers(0, 2 * bm))
        assert len(row_tiles(sizes.tolist(), M, bm)) <= grid_rows(M, bm)


def _ffn_w(K, H, N, dtype, E_=4):
    return (torch.zeros(E_, K, H, dtype=dtype),), torch.zeros(E_, H, N, dtype=dtype)


@pytest.mark.parametrize("K,H,N,dtype,gated,expected", [
    (1024, 2048, 1024, torch.bfloat16, False, "ring"),
    (1024, 2048, 1024, torch.bfloat16, True, "ring"),
    (48, 200, 72, torch.bfloat16, False, "ring"),   # multiples of 8, tails
    (36, 128, 64, torch.bfloat16, False, "simple"),  # K not a multiple of 8
    (64, 100, 64, torch.bfloat16, False, "simple"),  # H not a multiple of 8
    (64, 128, 20, torch.bfloat16, False, "simple"),  # N not a multiple of 8
    (1024, 2048, 1024, torch.float32, False, "simple"),  # f32: the FMA kernel
])
def test_ffn_route_dtype_and_shape(K, H, N, dtype, gated, expected):
    x = torch.zeros(16, K, dtype=dtype)
    ws, wo = _ffn_w(K, H, N, dtype)
    if gated:
        ws = ws * 2
    assert ff.route(x, ws, wo) == expected


@pytest.mark.parametrize("which", ["x", "wi", "wo"])
def test_ffn_route_misaligned_operand_takes_the_simple_kernel(which):
    """A view that starts 2 bytes into a buffer cannot feed 16-byte copies."""
    K, H, N = 64, 128, 64
    ws, wo = _ffn_w(K, H, N, torch.bfloat16)
    x = torch.zeros(16, K, dtype=torch.bfloat16)
    buf = torch.zeros(4 * K * H + 8, dtype=torch.bfloat16)[1:]
    if which == "x":
        x = buf[:16 * K].view(16, K)
    elif which == "wi":
        ws = (buf[:4 * K * H].view(4, K, H),)
    else:
        wo = buf[:4 * H * N].view(4, H, N)
    assert ff.route(x, ws, wo) == "simple"


# ---------------------------------------------------------------------------
# fused FFN backward: plan_bwd, shared memory, route
# ---------------------------------------------------------------------------

# the backward runs in training only: the ragged and the capacity rows
BWD_MAIN_PATH = ("train", "capacity")


@pytest.mark.parametrize("shape", BWD_MAIN_PATH)
def test_bwd_plan_main_path(shape):
    M, _ = FFN_MAIN_PATH[shape]
    assert tuple(fb.plan_bwd(M, E, HIDDEN)) == (64, 8)


@pytest.mark.parametrize("shape", BWD_MAIN_PATH)
def test_bwd_plan_fills_the_card_within_the_grid(shape):
    """dX: the routed row tiles times the splits give two waves of
    BLOCKS_PER_SM blocks on every SM, the chunks cover H, the grid's row
    blocks hold every row tile, and the row tile is the forward's.  dW:
    its (expert, chunk) blocks give two such waves."""
    M, sizes = FFN_MAIN_PATH[shape]
    p = fb.plan_bwd(M, E, HIDDEN)
    waves = 2 * fb.BLOCKS_PER_SM * _build.SMS
    tiles = row_tiles(sizes, M, p.bm)
    real = [t for t in tiles if t[0] >= 0]
    assert len(real) * p.splits >= waves
    assert p.splits == math.ceil(HIDDEN / fb.DX_CHUNK)
    assert len(tiles) <= grid_rows(M, p.bm)
    assert p.bm == ff.plan(M, E, HIDDEN).bm
    assert E * math.ceil(HIDDEN / fb.DW_CHUNK) >= waves


@pytest.mark.parametrize("per_group,bm", [(1, 16), (16, 16), (17, 32), (32, 32),
                                          (33, 64), (56, 64), (500, 64)])
def test_bwd_plan_row_tile_holds_an_average_expert(per_group, bm):
    assert fb.plan_bwd(E * per_group, E, HIDDEN).bm == bm


@pytest.mark.parametrize("H", [64, 200, 2000, 2048, 8192])
@pytest.mark.parametrize("E_", [8, E])
def test_bwd_plan_chunks_have_an_instance(H, E_):
    """Every row tile the plan picks has a kernel instance, and the splits
    cover H."""
    for M in (16, 2048, 4096, E_ * 56):
        p = fb.plan_bwd(M, E_, H)
        assert p.bm in ff.ROW_TILES
        assert p.splits == math.ceil(H / fb.DX_CHUNK)
        assert (p.splits - 1) * fb.DX_CHUNK < H <= p.splits * fb.DX_CHUNK


SM_SMEM = 233_472  # shared memory of an H100 SM; 1 KB of it reserved a block


@pytest.mark.parametrize("bm", ff.ROW_TILES)
@pytest.mark.parametrize("gated", [False, True])
def test_bwd_shared_memory_fits_a_block(bm, gated):
    """Every instance's dynamic shared memory (the host's mirror, which the
    chip smoke test and the cuda tests hold equal to the kernel's) fits a
    block's 232,448 bytes with dg [du] (and dW's h) of the chunk in it, and
    ungated, BLOCKS_PER_SM blocks fit an SM."""
    per_sm = 1 if gated else fb.BLOCKS_PER_SM
    smem = fb.dx_smem(bm, gated)
    assert bm * fb.DX_CHUNK * 2 * (2 if gated else 1) < smem <= fa.SMEM_LIMIT
    assert per_sm * (smem + 1024) <= SM_SMEM
    smem = fb.dw_smem(gated)
    assert fb.DW_ROWS * fb.DW_CHUNK * 2 * (3 if gated else 2) < smem <= fa.SMEM_LIMIT
    assert per_sm * (smem + 1024) <= SM_SMEM


@pytest.mark.parametrize("K,H,N,dtype,gated,expected", [
    (1024, 2048, 1024, torch.bfloat16, False, "ring"),
    (1024, 2048, 1024, torch.bfloat16, True, "ring"),
    (48, 200, 72, torch.bfloat16, False, "ring"),   # multiples of 8, tails
    (36, 128, 64, torch.bfloat16, False, "simple"),  # K not a multiple of 8
    (64, 100, 64, torch.bfloat16, True, "simple"),   # H not a multiple of 8
    (64, 128, 20, torch.bfloat16, False, "simple"),  # N not a multiple of 8
    (1024, 2048, 1024, torch.float32, False, "simple"),  # f32: the first version
])
def test_bwd_route_dtype_and_shape(K, H, N, dtype, gated, expected):
    x = torch.zeros(16, K, dtype=dtype)
    ws, wo = _ffn_w(K, H, N, dtype)
    if gated:
        ws = ws * 2
    assert fb.route(x, ws, wo, torch.zeros(16, N, dtype=dtype)) == expected


@pytest.mark.parametrize("which", ["x", "wi", "wo", "dy"])
def test_bwd_route_misaligned_operand_takes_the_simple_kernel(which):
    """A view that starts 2 bytes into a buffer cannot feed 16-byte copies."""
    K, H, N = 64, 128, 64
    ws, wo = _ffn_w(K, H, N, torch.bfloat16)
    x = torch.zeros(16, K, dtype=torch.bfloat16)
    dy = torch.zeros(16, N, dtype=torch.bfloat16)
    buf = torch.zeros(4 * K * H + 8, dtype=torch.bfloat16)[1:]
    if which == "x":
        x = buf[:16 * K].view(16, K)
    elif which == "wi":
        ws = (buf[:4 * K * H].view(4, K, H),)
    elif which == "wo":
        wo = buf[:4 * H * N].view(4, H, N)
    else:
        dy = buf[:16 * N].view(16, N)
    assert fb.route(x, ws, wo, dy) == "simple"


# ---------------------------------------------------------------------------
# flash forward: tiles and shared memory
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape,bq", [
    ((8, 128, 16, 64), 64),     # fastmoe-gpt prefill: 128 blocks of 128 rows
    ((8, 256, 16, 64), 64),     # fastmoe-gpt training: 256
    ((2, 8192, 12, 128), 128),  # one starcoder2 kv group
    ((2, 8192, 48, 128), 128),  # a starcoder2 layer
    ((1, 1, 4, 128), 64),       # one decode-like row
])
def test_flash_fwd_config_model_shapes(shape, bq):
    cfg = fa.fwd_config(*shape, shape[-1])
    assert cfg.bq == bq and cfg.bk == bq


@pytest.mark.parametrize("d", [dk for dk, dv in fa.HEAD_DIM_PAIRS if dk == dv])
@pytest.mark.parametrize("Sq", [1, 333, 4096, 1 << 16])
def test_flash_fwd_config_shared_memory(d, Sq):
    """Every tile choice fits a block's 232,448 bytes of dynamic shared
    memory, and two consumer warpgroups come only with four blocks an SM."""
    cfg = fa.fwd_config(2, Sq, 16, d, d)
    assert cfg.smem <= fa.SMEM_LIMIT
    assert cfg.smem >= cfg.bq * d * 2 + 2 * cfg.stages * cfg.bk * d * 2
    assert cfg.stages >= 2 and cfg.bq in (64, 128)
    assert (cfg.bq == 128) == (2 * 16 * math.ceil(Sq / 128) >= 4 * _build.SMS)


# MLA's pair: dk 192 (128 nope + 64 rope), dv 128.  By hand: 1024 bytes to
# align the base, Q (bq x 192 bf16), per stage a K (bk x 192) and a V (bk x
# 128) tile, and 8 bytes for each of 1 + 4 x stages barriers.
MLA_SMEM = {64: 1024 + 64 * 192 * 2 + 2 * (64 * 192 * 2 + 64 * 128 * 2) + 8 * 9,
            128: 1024 + 128 * 192 * 2 + 2 * (128 * 192 * 2 + 128 * 128 * 2) + 8 * 9}


@pytest.mark.parametrize("bq,shape", [
    (64, (1, 256, 16)),      # a short prompt: one warpgroup, several blocks an SM
    (128, (2, 4096, 128)),   # deepseek-v2 prefill, 2 x 4096, 128 heads
])
def test_flash_fwd_config_mla_shared_memory(bq, shape):
    cfg = fa.fwd_config(*shape, 192, 128)
    assert (cfg.bq, cfg.bk, cfg.stages) == (bq, bq, 2)
    assert cfg.smem == MLA_SMEM[bq] == {64: 107_592, 128: 214_088}[bq]
    assert cfg.smem <= fa.SMEM_LIMIT
    # a third stage would not fit two blocks an SM (bq 64) or one (bq 128)
    third = cfg.smem + cfg.bk * (192 + 128) * 2 + 32
    assert third > (fa.SMEM_LIMIT if bq == 128 else fa.SMEM_LIMIT // 2 - 1024)


@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_flash_pair_without_instance_is_refused_before_the_card(which):
    """The reduced MLA pair (48, 32) has no instance: ``_kernel_args``
    names the pairs the card takes before it asks for CUDA tensors (these
    are on the CPU), so the refusal needs no card and nothing launches."""
    q = torch.zeros(1, 8, 2, 48)
    v = torch.zeros(1, 8, 2, 32)
    more = (v, v) if which == "bwd" else ()
    f0, b0 = fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches
    with pytest.raises(ValueError, match=r"\(dk, dv\) in .*\(192, 128\).*got \(48, 32\)"):
        fa._kernel_args(f"flash_attention_{which}", q, q, v, 8, 0, True, *more)
    assert (fa.flash_attention_fwd.launches, fa.flash_attention_bwd.launches) == (f0, b0)


@pytest.mark.parametrize("pair", fa.HEAD_DIM_PAIRS)
def test_flash_pairs_with_an_instance_pass_the_pair_check(pair):
    """A pair with an instance gets past the pair check and stops, on the
    CPU, only at the next one: the tensors must be on the card."""
    dk, dv = pair
    q, v = torch.zeros(1, 8, 2, dk), torch.zeros(1, 8, 2, dv)
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        fa._kernel_args("flash_attention_fwd", q, q, v, 8, 0, True)
