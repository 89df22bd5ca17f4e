"""The work of each hand-written kernel: the bytes it must move (each input
read once, each output written once) and the operations it does, from its
shapes and its routing.  One count serves the card's bound column
(``chip_smoke.py``: ``bound_ms`` is the larger of bytes over the memory rate
and operations over the peak rate) and the dry run's roofline
(``launch/dryrun``, ``launch/roofline``).

``n`` is the rows the groups hold and ``used`` the experts with rows: a
run's own routing on the card; on the meta device (the dry run) the groups
are even, so ``n`` = M and ``used`` = min(E, M) (:func:`even_groups`).

The meta branches of the kernel wrappers enter their kernel's counts here
(:func:`add`): :func:`tallied` is what the dry run reads.  Host
bookkeeping of shapes only: no tensor's values are read.
"""
from __future__ import annotations

import torch

_TALLY: dict = {}  # kernel name -> [calls, bytes, operations]


def add(name: str, nbytes: float, flops: float) -> None:
    """Enter one launch's bytes and operations under ``name``."""
    t = _TALLY.setdefault(name, [0, 0.0, 0.0])
    t[0] += 1
    t[1] += nbytes
    t[2] += flops


def reset() -> None:
    _TALLY.clear()


def tallied() -> dict:
    """{kernel: (calls, bytes, operations)} since the last :func:`reset`."""
    return {k: tuple(v) for k, v in _TALLY.items()}


def even_groups(M: int, E: int) -> tuple:
    """(n, used) of M rows split evenly over E groups."""
    return M, min(E, M)


def groups_of(group_sizes: torch.Tensor, M: int) -> tuple:
    """(n, used) of a routing: read from the sizes on a device, even on
    the meta device (which holds no values)."""
    if group_sizes.device.type == "meta":
        return even_groups(M, group_sizes.shape[0])
    return int(group_sizes.sum()), int((group_sizes > 0).sum())


def grouped_gemm(M: int, K: int, N: int, E: int, n: int, used: int,
                 e: int = 2) -> tuple:
    """(bytes, operations): x (M, K) and y (M, N), the used experts' (K, N)
    weights, the group sizes; 2 n K N."""
    return e * (M * K + used * K * N + M * N) + 4 * E, 2 * n * K * N


def fused_ffn(M: int, K: int, H: int, N: int, E: int, n: int, used: int,
              gates: int = 1, e: int = 2) -> tuple:
    """(bytes, operations): x, y, the used experts' wi (, wi_up) and wo;
    2 n H (gates K + N)."""
    return (e * (M * K + M * N + used * (gates * K * H + H * N)) + 4 * E,
            2 * n * H * (gates * K + N))


def fused_ffn_bwd_dx(M: int, K: int, H: int, N: int, E: int, n: int,
                     used: int, gates: int = 1, e: int = 2) -> tuple:
    """(bytes, operations): x, dy, dx, the used experts' weights; the
    hidden recomputed (gates K H), dh (N H) and dx (gates K H), 2 n each."""
    return (e * (2 * M * K + M * N + used * (gates * K * H + H * N)) + 4 * E,
            2 * n * H * (2 * gates * K + N))


def fused_ffn_bwd_dw(M: int, K: int, H: int, N: int, E: int, n: int,
                     used: int, gates: int = 1, e: int = 2) -> tuple:
    """(bytes, operations): x, dy, the used experts' weights, the f32 dW of
    every expert; the hidden and dh recomputed, dwo = h^T dy, dwi = x^T dg."""
    return (e * (M * K + M * N + used * (gates * K * H + H * N))
            + 4 * E * (gates * K * H + H * N) + 4 * E,
            2 * n * H * (2 * gates * K + 2 * N))


def grouped_dw(M: int, K: int, N: int, E: int, n: int, e: int = 2) -> tuple:
    """(bytes, operations) of the grouped dW product (the plain per-group
    x^T dy of ``grouped_gemm.grouped_dw_plain``): x and dy, the f32 dW."""
    return e * (M * K + M * N) + 4 * E * K * N, 2 * n * K * N


def visible_pairs(S: int, window: int) -> int:
    """Causal (i, j) pairs with 0 <= i - j < window over S positions: what
    this input needs (tiles outside the band are never computed)."""
    w = min(window, S)
    return w * (w + 1) // 2 + (S - w) * w


def band_pairs(Sq: int, Skv: int, window: int, q_offset: int = 0,
               causal: bool = True) -> int:
    """Visible (query, key) pairs of Sq queries at absolute positions
    q_offset.. over Skv keys: keys j with i - j < window, and j <= i where
    causal."""
    if causal and q_offset == 0 and Sq == Skv:
        return visible_pairs(Sq, window)
    total = 0
    for i in range(q_offset, q_offset + Sq):
        hi = min(i, Skv - 1) if causal else Skv - 1
        lo = max(0, i - window + 1)
        total += max(0, hi - lo + 1)
    return total


def flash(B: int, S: int, H: int, KV: int, dk: int, dv: int, window: int, *,
          backward: bool, Sq: int | None = None, q_offset: int = 0,
          causal: bool = True, e: int = 2) -> tuple:
    """(bytes, operations) of the flash forward (q, k, v, o once; 2 (dk +
    dv) per visible pair and head: q k^T and p v) or backward (q, k, v, o,
    dO, dq, dk, dv and the f32 lse once; 2 (3 dk + 2 dv) per pair and
    head: s, dp, dv, dk, dq).  S keys; Sq queries (default S)."""
    Sq = S if Sq is None else Sq
    q_side, kv_side = B * Sq * H * (dk + dv) * e, B * S * KV * (dk + dv) * e
    pairs = B * H * band_pairs(Sq, S, window, q_offset, causal)
    if backward:
        return (2 * q_side + 2 * kv_side + 4 * B * H * Sq,
                2 * (3 * dk + 2 * dv) * pairs)
    return q_side + kv_side, 2 * (dk + dv) * pairs


def gather_rows(T: int, d: int, unique: int, e: int = 2) -> tuple:
    """(bytes, operations) of a gather of T rows of d elements: the unique
    source rows read once, the T rows written, the int32 index."""
    return e * d * (unique + T) + 4 * T, 0


def combine_topk(T: int, k: int, d: int, unique: int, e: int = 2,
                 w_e: int = 4) -> tuple:
    """(bytes, operations) of the weighted sum of k rows a token: the
    unique source rows, the T rows written, the int32 index and the
    weights; 2 T k d."""
    return e * d * (unique + T) + (4 + w_e) * T * k, 2 * T * k * d
