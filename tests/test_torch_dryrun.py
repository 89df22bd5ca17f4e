"""The meta-device dry run (``repro_torch.launch.dryrun``) at full width:
fastmoe-gpt training at 8 x 256 on one process, the deepseek-v2 prefill on
a 16x16 mesh of a fake process group, and hymba-1.5b training at a short
sequence on 2x2.  The state bytes it reports equal a hand sum over the
rank's spec shards (params and gradients in the param dtype, 8 B of AdamW
moments a param; serving params in the config's dtype, the routed experts
cut over the model axis), every kernel on the path is counted, and the dry
run says fastmoe-gpt trains at the 10 layers the card ran (PERF.md §4).
Serving draws its params under the serving layout
(``launch.sharding.serve_layout``): the deepseek-v2 prefill under the
train-mode specs, and qwen2-72b whole (80 layers) as one rank of a 1x4
mesh under ``serve_tp``, whose bytes are ``spec_bytes`` of the whole
tree under the serve layout."""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import InputShape, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import sharding as S  # noqa: E402
from repro_torch.models import lm  # noqa: E402


def _fastmoe(dispatch="ragged"):
    cfg = get_config("fastmoe-gpt")
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch=dispatch))


def _numel(tree, layout=None):
    if layout is None:
        return sum(t.numel() for _, t in S.flat_paths(tree))
    return sum(math.prod(S.shard_shape(t.shape, layout.spec(p),
                                       layout.mesh))
               for p, t in S.flat_paths(tree))


def test_fastmoe_train_state_and_fit_at_ten_layers():
    cfg = _fastmoe()
    rec = dryrun.dry_run(cfg, InputShape("train_8x256", 256, 8, "train"),
                         "1x1", depth=10)
    whole = lm.init_params(dataclasses.replace(cfg, num_layers=10),
                           device="meta", param_dtype="float32")
    n = _numel(whole)
    assert rec["params_bytes"] == 4 * n and rec["grads_bytes"] == 4 * n
    assert rec["moments_bytes"] == 8 * n
    assert rec["fits"] and rec["peak_bytes"] > 16 * n
    assert dryrun.largest_depth(rec, dryrun.CARD_BYTES) >= 10
    rl = rec["roofline"]
    assert rl["flops_per_dev"] >= rl["model_flops"] > 0
    assert rl["collective_bytes"] == {}
    for k in ("fused_ffn", "fused_ffn_bwd_dx", "fused_ffn_bwd_dw",
              "flash_attention_fwd", "flash_attention_bwd",
              "gather_rows_by_source", "combine_topk"):
        assert rec["kernels_per_layer"][k][0] > 0, k


def test_deepseek_prefill_on_16x16():
    cfg = get_config("deepseek-v2-236b")
    rec = dryrun.dry_run(cfg, InputShape("prefill_2x4096", 4096, 32,
                                         "prefill"), "16x16", depth=4)
    whole = lm.init_params(dataclasses.replace(cfg, num_layers=4),
                           device="meta")
    # serving holds the reference's train-mode specs: the routed experts
    # cut over the 16 ranks of the model axis and their hidden dim over
    # the 16 of data, every other leaf over data on its embed dim and over
    # model on heads, ffn and vocab where it splits
    layout = S.make_layout(dataclasses.replace(cfg, num_layers=4),
                           S.ShapeMesh.of(data=16, model=16), "train")
    want = sum(math.prod(S.shard_shape(t.shape, layout.spec(p),
                                       layout.mesh)) * t.element_size()
               for p, t in S.flat_paths(whole))
    assert 100 * want < sum(t.numel() * t.element_size()
                            for _, t in S.flat_paths(whole))
    assert rec["params_bytes"] == want
    assert rec["cache_bytes"] > 0 and rec["peak_bytes"] > want
    assert rec["roofline"]["collective_bytes"]["all-reduce"] > 0
    assert rec["kernels_per_layer"]["fused_ffn"][0] > 0


def test_hymba_train_short_sequence_on_2x2():
    cfg = get_config("hymba-1.5b")
    rec = dryrun.dry_run(cfg, InputShape("train_4x32", 32, 4, "train"),
                         "2x2")
    mesh = S.ShapeMesh.of(data=2, model=2)
    whole = lm.init_params(cfg, device="meta", param_dtype=cfg.param_dtype)
    layout = S.Layout(mesh, S.param_specs(whole, mesh, "train"))
    n = _numel(whole, layout)
    assert rec["params_bytes"] == 4 * n and rec["moments_bytes"] == 8 * n
    assert n < _numel(whole)
    coll = rec["roofline"]["collective_bytes"]
    assert coll["all-gather"] > 0 and coll["reduce-scatter"] > 0
    assert rec["fits"]


def test_qwen2_72b_whole_as_a_rank_of_1x4_under_serve_tp():
    """On meta, the serving params a rank of a 1x4 mesh draws for qwen2-72b
    whole (80 layers) under ``opts={"serve_tp": True}`` (the dry run's set-
    up, a fake process group) are ``spec_bytes`` of the whole tree under
    the serve layout: 37.60 GB, a quarter of every leaf but the norms —
    the layers' 36.36 GB in bf16 and the f32 table and head's 1.25 GB —
    which one H100 holds; the whole model (150.4 GB) does not."""
    cfg = get_config("qwen2-72b")
    shape = InputShape("prefill_2x2048", 2048, 2, "prefill")
    with dryrun._FakeWorld("1x4") as world:
        params, dist, rows = dryrun._serve_setup(cfg, shape, world.mesh,
                                                 {"serve_tp": True})
        got = dryrun._tensor_bytes(params)
        assert rows == 2 and dist.layout.mesh.shape == {"data": 1, "model": 4}
    whole = lm.init_params(cfg, device="meta")
    serve = S.make_layout(cfg, S.ShapeMesh.of(data=1, model=4), "serve")
    assert got == S.spec_bytes(whole, serve) == 37_600_804_864
    whole_bytes = sum(t.numel() * t.element_size()
                      for _, t in S.flat_paths(whole))
    assert got < dryrun.CARD_BYTES < whole_bytes
