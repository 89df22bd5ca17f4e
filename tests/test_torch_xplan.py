"""The index math of the port's ragged (dropless) exchange against the JAX
package: ``make_ragged_xplan`` and ``ragged_recv_compact`` on the same
group sizes give the same plans, exactly (integers), and the port's
packing and compaction (``scatter_rows`` / ``gather_rows_fill``) carry
every kept row to its expert segment and back to the slot it came from.

The cases mirror ``tests/test_ragged_a2a.py``'s host tests: a dropless
round trip, a bound that drops trailing experts, a source with zero rows,
empty groups.  The exchange itself is emulated on the host (shard r of a
receiver's buffer is source r's shard for it), as ``tests/dist_utils.py``
does for the reference.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.core import dispatch as JD  # noqa: E402
from repro_torch.core import dispatch as D  # noqa: E402


def _seeded(seed, mp, e_local, rows):
    rng = np.random.default_rng(seed)
    ids = [rng.integers(0, mp * e_local, size=rows) for _ in range(mp)]
    return [np.bincount(i, minlength=mp * e_local) for i in ids]


CASES = {
    # group sizes (E,) of each of the mp source ranks; rows per peer shard
    "round_trip": dict(gs=_seeded(0, 4, 2, 16), mp=4, bound=16),
    "bound_drops_trailing_experts": dict(
        gs=[[5, 4, 0, 1], [1, 2, 3, 4]], mp=2, bound=6),
    "bound_drops_seeded": dict(gs=_seeded(3, 4, 3, 24), mp=4, bound=4),
    "source_with_zero_rows": dict(
        gs=[[0, 0, 0, 0], [3, 2, 4, 1]], mp=2, bound=10),
    "empty_groups": dict(
        gs=[[0, 3, 0, 0, 2, 0, 0, 1], [0, 0, 0, 0, 0, 0, 6, 0]], mp=2,
        bound=6),
}


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


@pytest.mark.parametrize("case", list(CASES))
def test_ragged_plans_match_jax(case):
    spec = CASES[case]
    mp, bound = spec["mp"], spec["bound"]
    gss = [np.asarray(g, np.int32) for g in spec["gs"]]
    E = gss[0].size
    e_local = E // mp
    plans = []
    for gs in gss:
        n = int(gs.sum())
        got = D.make_ragged_xplan(torch.from_numpy(gs), n, E, mp, bound)
        ref = JD.make_ragged_xplan(jnp.asarray(gs), n, E, mp, bound)
        for field in got._fields:
            a, b = _np(getattr(got, field)), _np(getattr(ref, field))
            assert a.dtype == b.dtype, (case, field, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=f"{case} {field}")
        plans.append((gs, n, got))
    _exchange_round_trip(case, plans, mp, e_local, bound)


def _exchange_round_trip(case, plans, mp, e_local, bound):
    """Rows tagged (source, sorted row + 1) go out through the port's
    packing, across the emulated exchange, into each receiver's compact
    array and back again."""
    sends = []
    for s, (_, n, xp) in enumerate(plans):
        tags = torch.stack([torch.full((n,), float(s)),
                            torch.arange(1, n + 1, dtype=torch.float32)], 1)
        sends.append((tags, D.scatter_rows(tags, xp.send_dest,
                                           mp * bound).reshape(mp, bound, 2)))
    rets = [[None] * mp for _ in range(mp)]
    for r in range(mp):
        recv = torch.stack([sends[s][1][r] for s in range(mp)])
        incoming = torch.stack([plans[s][2].peer_counts[r] for s in range(mp)])
        cplan, gs_local = D.ragged_recv_compact(incoming, bound)
        jcplan, jgs = JD.ragged_recv_compact(jnp.asarray(incoming.numpy()),
                                             bound)
        np.testing.assert_array_equal(cplan.numpy(), np.asarray(jcplan))
        np.testing.assert_array_equal(gs_local.numpy(), np.asarray(jgs))
        xs = D.scatter_rows(recv.reshape(mp * bound, 2), cplan, mp * bound)
        # each expert segment holds that expert's rows, source-major
        off = 0
        for e in range(e_local):
            seg = xs[off:off + int(gs_local[e])]
            assert (seg[:, 1] > 0).all(), (case, "hole in a segment")
            assert (torch.diff(seg[:, 0]) >= 0).all(), (case, "not src-major")
            for src, row in seg.tolist():
                gs = plans[int(src)][0]
                ends = np.cumsum(gs)
                expert = int(np.searchsorted(ends, int(row) - 1, side="right"))
                assert expert == r * e_local + e, (case, src, row)
            off += int(gs_local[e])
        assert (xs[off:] == 0).all(), (case, "rows past the valid prefix")
        back = D.gather_rows_fill(xs, cplan).reshape(mp, bound, 2)
        for s in range(mp):
            rets[s][r] = back[s]
    for s, (_, n, xp) in enumerate(plans):
        ret = torch.stack(rets[s]).reshape(mp * bound, 2)
        out = D.gather_rows_fill(ret, xp.send_dest)
        tags = sends[s][0]
        keep = xp.keep
        torch.testing.assert_close(out[keep], tags[keep], rtol=0, atol=0)
        assert (out[~keep] == 0).all(), (case, "a dropped row came back")
