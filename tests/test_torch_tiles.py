"""Host-side choices of the bf16 kernels, checked on the CPU with no kernel
launched: the grouped GEMM's tile shape (``tile_config``) and its routing
between the ring kernel and the simple one (``route``), and the f32 dQ
scratch the flash backward adds into (``dq_scratch``)."""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import flash_attention as fa  # noqa: E402
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
    assert min(16, E) * math.ceil(N / bn) >= gg.SMS


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


@pytest.mark.parametrize("shape", [(8, 256, 16, 64), (2, 333, 12, 128)])
def test_dq_scratch_bf16(shape):
    q = torch.zeros(shape, dtype=torch.bfloat16)
    acc = fa.dq_scratch(q)
    assert acc.shape == q.shape and acc.dtype == torch.float32
    assert acc.is_contiguous() and not acc.any()
    assert acc.device == q.device


def test_dq_scratch_f32_is_none():
    """The f32 backward's dQ kernel owns each row: no scratch."""
    assert fa.dq_scratch(torch.zeros(1, 8, 2, 64)) is None
