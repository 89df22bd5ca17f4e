"""Guards of the port's boundaries: it imports no JAX and nothing of the JAX
package, and its entry points never fall back to the CPU."""
import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core.fmoe import DistConfig  # noqa: E402
from repro_torch.kernels import flash_attention, token_shuffle  # noqa: E402
from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.launch import serve, train  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.optim import AdamW  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_and_chip_smoke_import_no_jax_or_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    bad = [(f.relative_to(ROOT).as_posix(), m) for f in files
           for m in _imported_modules(f) if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


@pytest.mark.parametrize("rel", ["models/rwkv6.py", "models/mamba.py",
                                 "core/fmoefy.py"])
def test_family_modules_import_no_jax_or_repro(rel):
    """The recurrences and the fmoefy plugin (the JAX package's module
    names) import neither JAX nor the JAX package; fmoefy, a config
    rewrite, nothing of the port but its configs."""
    f = ROOT / "src" / "repro_torch" / rel
    mods = list(_imported_modules(f))
    assert not FORBIDDEN & {m.split(".")[0] for m in mods}, (rel, mods)
    if rel == "core/fmoefy.py":
        ours = [m for m in mods if m.startswith("repro_torch")]
        assert ours == ["repro_torch.configs.base"], ours


@pytest.mark.parametrize("sub", ["checkpoint", "resilience", "obs"])
def test_resilience_and_telemetry_import_no_jax_or_repro(sub):
    """The checkpoint, resilience and telemetry subpackages (the JAX
    package's module names) import neither JAX nor the JAX package; the
    trace, sink and events modules only the standard library and numpy."""
    import sys
    files = sorted((ROOT / "src" / "repro_torch" / sub).glob("*.py"))
    names = {f.stem for f in files}
    assert names >= {"checkpoint": {"__init__", "ckpt"},
                     "resilience": {"__init__", "faults", "guard",
                                    "recovery"},
                     "obs": {"__init__", "counters", "events", "sink",
                             "stats", "trace"}}[sub], names
    for f in files:
        mods = [m.split(".")[0] for m in _imported_modules(f)]
        assert not FORBIDDEN & set(mods), (f.name, mods)
        if sub == "obs" and f.stem in ("trace", "sink", "events"):
            bad = [m for m in mods if m not in sys.stdlib_module_names
                   and m not in ("__future__", "numpy")]
            assert not bad, (f.name, bad)


def test_lower_layers_import_no_upper_layer():
    """The MoE layer, gradient sync, the optimizer and the kernels import
    nothing of the planner, the models or the entry points, at the top of a
    module or inside a function."""
    pkg = ROOT / "src" / "repro_torch"
    upper = {"repro_torch.placement", "repro_torch.models",
             "repro_torch.launch"}
    files = [f for d in ("core", "optim", "kernels")
             for f in sorted((pkg / d).rglob("*.py"))]
    assert len(files) > 5
    bad = [(f.relative_to(ROOT).as_posix(), m) for f in files
           for m in _imported_modules(f)
           if any(m == u or m.startswith(u + ".") for u in upper)]
    assert not bad, bad


def test_entry_points_raise_without_cuda():
    """Called without ``device`` on a host with no CUDA, every entry point
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: this guard is for hosts without one")
    cfg = reduced(get_config("fastmoe-gpt"), num_layers=1, d_model=64)
    params = lm.init_params(cfg, device="cpu")
    cache = lm.init_cache(cfg, 1, 8, device="cpu")
    prompt = torch.zeros(1, 4, dtype=torch.long)
    dist = DistConfig(launch_mesh.Mesh(1, 1), ("data", "model"))
    calls = [lambda: serve.generate(params, cfg, prompt, 2),
             lambda: lm.decode_step(params, cfg, prompt[:, :1], 0, cache),
             lambda: lm.prefill(params, cfg, prompt, cache),
             lambda: lm.init_params(cfg),
             lambda: lm.init_cache(cfg, 1, 8),
             lambda: train.make_train_step(cfg, AdamW(), dist=dist),
             lambda: launch_mesh.init_distributed()]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_kernel_wrapper_never_falls_back(monkeypatch):
    """A tensor that is neither on the CPU nor on a card is refused, not
    routed to the plain version: a mix of meta and CPU tensors raises.  All
    meta tensors (the dry run's) take the wrapper's meta branch alone: the
    output's shape on meta, the kernel's work entered in ``kernels.cost``,
    no launch counted and no plain version called."""
    from repro_torch.kernels import cost, fused_ffn, fused_ffn_bwd, \
        grouped_gemm

    def refuse(*a, **k):
        raise AssertionError("a meta tensor reached a plain version")
    for mod, name in ((token_shuffle, "gather_rows_plain"),
                      (token_shuffle, "gather_rows_by_source_plain"),
                      (token_shuffle, "combine_topk_plain"),
                      (flash_attention, "flash_attention_fwd_plain"),
                      (flash_attention, "flash_attention_bwd_plain"),
                      (grouped_gemm, "grouped_gemm_plain"),
                      (fused_ffn, "fused_ffn_plain"),
                      (fused_ffn_bwd, "fused_ffn_bwd_dx_plain"),
                      (fused_ffn_bwd, "fused_ffn_bwd_dw_plain")):
        monkeypatch.setattr(mod, name, refuse)
    meta = dict(device="meta")
    x = torch.empty(4, 8, **meta)
    idx = torch.zeros(2, dtype=torch.int32, **meta)
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        token_shuffle.gather_rows(x, torch.zeros(2, dtype=torch.int32))
    q = torch.empty(1, 8, 4, 64, **meta)
    kv = torch.empty(1, 8, 2, 64, **meta)
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        flash_attention.flash_attention_fwd(q, kv, torch.empty(1, 8, 2, 64),
                                            window=8)
    lse = torch.empty(1, 4, 8, **meta)
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        flash_attention.flash_attention_bwd(q, kv, kv, q, torch.empty(1, 4, 8), q,
                                            window=8)
    w = torch.empty(2, 8, 16, **meta)
    wo = torch.empty(2, 16, 8, **meta)
    gs = torch.empty(2, dtype=torch.int32, **meta)
    launches = [f.launches for f in (
        token_shuffle.gather_rows, flash_attention.flash_attention_fwd,
        flash_attention.flash_attention_bwd, grouped_gemm.grouped_gemm,
        fused_ffn.fused_ffn, fused_ffn_bwd.fused_ffn_bwd_dx,
        fused_ffn_bwd.fused_ffn_bwd_dw, token_shuffle.combine_topk)]
    cost.reset()
    outs = [token_shuffle.gather_rows(x, idx),
            *flash_attention.flash_attention_fwd(q, kv, kv, window=8),
            *flash_attention.flash_attention_bwd(q, kv, kv, q, lse, q,
                                                 window=8),
            grouped_gemm.grouped_gemm(x, w, gs),
            fused_ffn.fused_ffn(x, (w,), wo, gs, "gelu"),
            fused_ffn_bwd.fused_ffn_bwd_dx(x, (w,), wo, x, gs, "gelu"),
            *fused_ffn_bwd.fused_ffn_bwd_dw(x, (w,), wo, x, gs, "gelu")[0],
            token_shuffle.combine_topk(x, idx.reshape(1, 2), None)]
    assert all(o.device.type == "meta" for o in outs)
    assert [o.shape[-1] for o in outs[:2]] == [8, 64]
    assert set(cost.tallied()) == {
        "gather_rows", "flash_attention_fwd", "flash_attention_bwd",
        "grouped_gemm", "fused_ffn", "fused_ffn_bwd_dx", "fused_ffn_bwd_dw",
        "combine_topk"}
    assert launches == [f.launches for f in (
        token_shuffle.gather_rows, flash_attention.flash_attention_fwd,
        flash_attention.flash_attention_bwd, grouped_gemm.grouped_gemm,
        fused_ffn.fused_ffn, fused_ffn_bwd.fused_ffn_bwd_dx,
        fused_ffn_bwd.fused_ffn_bwd_dw, token_shuffle.combine_topk)]


@pytest.mark.parametrize("rel", ["launch/sharding.py", "launch/roofline.py",
                                 "launch/dryrun.py", "core/naive.py",
                                 "kernels/cost.py"])
def test_slice18_modules_import_no_jax_or_repro(rel):
    """The sharding rules, the roofline, the dry run, the naive baselines
    and the kernels' cost counts import neither JAX nor the JAX package;
    the naive baselines and the cost counts nothing of the launch layer."""
    f = ROOT / "src" / "repro_torch" / rel
    mods = list(_imported_modules(f))
    assert not FORBIDDEN & {m.split(".")[0] for m in mods}, (rel, mods)
    if rel.startswith(("core/", "kernels/")):
        assert not [m for m in mods if m.startswith("repro_torch.launch")]
