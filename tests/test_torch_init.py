"""Per-rank init of the port (``repro_torch.models.lm.init_params(layout=)``).

A rank of a ``(data, model)`` mesh makes only its shard of the params
under a ``launch.sharding`` layout: every leaf but the routed expert
stacks drawn whole from the seed's generator and cut by its spec; its
experts one at a time, each from a generator seeded by (seed, layer,
leaf, expert) alone, sliced to its hidden units where the spec splits
them over ``data`` (the train-mode specs; the serve-mode specs keep them
whole).  The rule held here, on the CPU at the reduced sizes of
``fastmoe-gpt`` (GELU) and ``deepseek-v2-236b`` (SwiGLU, a shared
expert): each rank's shard equals ``interop.shard_params`` of the whole
init under the same layout bit for bit, and the expert shards of every
rank reassemble the whole.  ``python3 chip_smoke.py`` holds the same rule
on the card at full width.  Meshes need shape and rank only (no process
group).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import interop  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.sync import tagged_leaves  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.launch.sharding import make_layout  # noqa: E402
from repro_torch.models import lm  # noqa: E402

ARCHS = ("fastmoe-gpt", "deepseek-v2-236b")
# (data, model, mode): the train-mode specs split the experts' hidden dim
# over data, the serve-mode specs do not
MESHES = [(1, 1, "serve"), (1, 2, "serve"), (2, 2, "serve"), (2, 2, "train"),
          (1, 4, "serve"), (2, 4, "serve"), (2, 4, "train")]
SEED = 3


def _init(cfg, layout=None, dtype="float32"):
    return lm.init_params(cfg, seed=SEED, device="cpu", param_dtype=dtype,
                          layout=layout)


def _leaves(tree):
    return dict(tagged_leaves(tree))


@pytest.fixture(scope="module")
def whole():
    return {a: _init(reduced(get_config(a))) for a in ARCHS}


@pytest.mark.parametrize("data,model,mode", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_rank_shard_is_the_whole_slice(whole, arch, data, model, mode):
    """Every rank's own init under the layout equals its slice of the whole
    init, bit for bit; the expert shards of the ranks, put back together
    (experts over the model axis, hidden units over the data axis under
    the train-mode specs), are the whole stacks."""
    cfg = reduced(get_config(arch))
    tp = mode == "train"
    ref = _leaves(whole[arch])
    shards = []
    for rank in range(data * model):
        layout = make_layout(cfg, Mesh(data, model, rank), mode)
        got = _leaves(_init(cfg, layout))
        want = _leaves(interop.shard_params(whole[arch], layout))
        assert got.keys() == want.keys() == ref.keys()
        for path, t in got.items():
            assert t.dtype == want[path].dtype, path
            assert torch.equal(t, want[path]), (arch, data, model, mode, rank,
                                                path)
        shards.append(got)
    for path, t in ref.items():
        if "experts" not in path.split("/"):
            continue
        dim = 1 if path.endswith("wo") else 2
        rows = [torch.cat([shards[d * model + m][path] for d in range(data)],
                          dim) if tp else shards[m][path]
                for m in range(model)]
        assert torch.equal(torch.cat(rows, 0), t), path
        e_local = t.shape[0] // model
        h_local = t.shape[dim] // (data if tp else 1)
        assert shards[-1][path].shape[0] == e_local
        assert shards[-1][path].shape[dim] == h_local


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_dtype_shard_is_the_whole_slice(arch):
    """In the serving dtype (layers kept in bf16) a rank's shard is still
    the whole's slice bit for bit: each expert is drawn in f32 and cast
    once, as the whole stack is."""
    cfg = reduced(get_config(arch))
    full = _init(cfg, dtype="bfloat16")
    layout = make_layout(cfg, Mesh(2, 2, 3), "train")
    got = _leaves(_init(cfg, layout, dtype="bfloat16"))
    want = _leaves(interop.shard_params(full, layout))
    for path, t in got.items():
        assert t.dtype == want[path].dtype
        assert torch.equal(t, want[path]), path


def test_expert_draws_are_independent_and_scaled(whole):
    """Each expert, leaf and layer has its own draw (none repeats another),
    at the JAX package's scales: wi ~ N(0, 1/d), wo ~ N(0, 1/h); the seed
    moves every expert."""
    cfg = reduced(get_config("deepseek-v2-236b"))
    d, h = cfg.d_model, cfg.moe.d_expert_hidden
    layers = whole["deepseek-v2-236b"]["layers"]
    ex = [layer["ffn"]["experts"] for layer in layers]
    draws = [t[e] for layer in ex for t in layer.values()
             for e in range(t.shape[0])]
    firsts = torch.stack([w.flatten()[:64] for w in draws])
    assert torch.unique(firsts, dim=0).shape[0] == len(draws)
    for name, scale in (("wi_gate", d ** -0.5), ("wi_up", d ** -0.5),
                        ("wo", h ** -0.5)):
        std = float(torch.cat([layer[name].flatten() for layer in ex]).std())
        assert abs(std / scale - 1) < 0.05, (name, std, scale)
    other = lm.init_params(cfg, seed=SEED + 1, device="cpu",
                           param_dtype="float32")
    for a, b in zip(ex, (layer["ffn"]["experts"] for layer in other["layers"])):
        for name in a:
            assert not any(torch.equal(x, y) for x, y in zip(a[name], b[name]))


def test_shard_needs_the_widths_to_split():
    """A mesh whose model axis does not divide the experts is refused; a
    hidden dim that does not split over the data axis stays whole in the
    train-mode layout (the specs' divisibility guard), and the rank's draw
    is then the whole's."""
    cfg = reduced(get_config("fastmoe-gpt"))  # 4 experts, hidden 512
    with pytest.raises(ValueError, match="do not shard"):
        _init(cfg, make_layout(cfg, Mesh(1, 3, 0), "serve"))
    layout = make_layout(cfg, Mesh(3, 1, 0), "train")
    assert layout.spec("layers/0/ffn/experts/wi")[2] is None
    got = _leaves(_init(cfg, layout))
    want = _leaves(_init(cfg))
    experts = [k for k in got if "experts" in k.split("/")]
    assert experts and all(torch.equal(got[k], want[k]) for k in experts)
