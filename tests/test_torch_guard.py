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


def test_kernel_wrapper_never_falls_back():
    """A tensor that is neither on the CPU nor on a card is refused, not
    routed to the plain version."""
    x = torch.empty(4, 8, device="meta")
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        token_shuffle.gather_rows(x, torch.zeros(2, dtype=torch.int32,
                                                 device="meta"))
    q = torch.empty(1, 8, 4, 64, device="meta")
    kv = torch.empty(1, 8, 2, 64, device="meta")
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        flash_attention.flash_attention_fwd(q, kv, kv, window=8)
    lse = torch.empty(1, 4, 8, device="meta")
    with pytest.raises(ValueError, match="expected CUDA tensors"):
        flash_attention.flash_attention_bwd(q, kv, kv, q, lse, q, window=8)
