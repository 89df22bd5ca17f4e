"""The expert exchange's schedule — paper §5.2, serial half.

The reference splits the ``(mp, E_local, C, d)`` exchange into
``n_chunks`` micro-shards and pipelines sends, expert compute and returns
(the smart schedule).  The port runs the serial schedule, ``n_chunks ==
1``: one tiled all-to-all each way around the expert compute
(``core/comm``).  Chunking and a narrower wire dtype raise
``NotImplementedError`` (ROADMAP §1 item 2, overlap).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core import comm


def _check_serial(n_chunks: int, wire_dtype) -> None:
    what = (f"a chunked exchange (n_chunks={n_chunks})" if n_chunks > 1
            else f"wire_dtype={wire_dtype!r}" if wire_dtype is not None
            else None)
    if what:
        raise NotImplementedError(
            f"{what} is the §5.2 overlap, not ported to repro_torch yet "
            f"(ROADMAP §1 item 2); the port runs the serial exchange")


def chunked_all_to_all(x: torch.Tensor, group, mp: int, n_chunks: int = 1, *,
                       wire_dtype=None) -> torch.Tensor:
    """x: (mp, ...) one slice per destination rank -> (mp, ...) one slice
    per source rank.  Serial only (``n_chunks == 1``)."""
    _check_serial(n_chunks, wire_dtype)
    assert x.shape[0] == mp, (x.shape, mp)
    return comm.all_to_all(x, group)


def counts_all_to_all(counts: torch.Tensor, group, mp: int) -> torch.Tensor:
    """The Fig-2 "exchange sizes" step: (mp, E_local) per-destination counts
    -> (mp, E_local) per-source counts.  Integer, no gradient."""
    assert counts.shape[0] == mp, (counts.shape, mp)
    return comm.exchange_counts(counts.reshape(-1), group)


def resolve_chunks(requested: int, capacity: int) -> int:
    """Largest divisor of ``capacity`` that is <= ``requested`` (>= 1)."""
    n = max(1, min(int(requested), int(capacity)))
    while capacity % n:
        n -= 1
    return n


def ragged_pipelined_exchange(send: torch.Tensor, group, mp: int,
                              n_chunks: int = 1, *,
                              wire_dtype=None) -> torch.Tensor:
    """Forward half of the ragged exchange: (mp, bound, d) pad-to-max-per-
    peer shards -> the shards received from each source rank."""
    return chunked_all_to_all(send, group, mp, n_chunks, wire_dtype=wire_dtype)


def pipelined_expert_exchange(
        buf: torch.Tensor, group, mp: int, n_chunks: int,
        compute_fn: Callable[[torch.Tensor], torch.Tensor], *,
        wire_dtype=None) -> torch.Tensor:
    """Dispatch all-to-all -> expert compute -> return all-to-all.

    buf: (mp, E_local, C, d), dim 0 the destination rank.  ``compute_fn``
    takes (E_local, mp * C, d) rows, source-major within an expert, and
    returns (E_local, mp * C, d_out).  Returns (mp, E_local, C, d_out),
    dim 0 the expert's rank."""
    _check_serial(n_chunks, wire_dtype)
    mp_, E_local, C, d = buf.shape
    assert mp_ == mp, (buf.shape, mp)
    out = comm.return_tokens(
        compute_fn(comm.exchange_tokens(buf.reshape(mp * E_local, C, d),
                                        group)), group)
    return out.reshape(mp, E_local, C, -1)
