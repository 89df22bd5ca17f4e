"""Parity of the port's training path with the JAX package at reduced
``fastmoe-gpt`` (2 layers, d_model 64, 4 experts, expert hidden 128,
vocab 512), f32.

The JAX params move through ``repro_torch.interop.from_jax`` (f32
masters); batches are numpy.  The JAX Pallas kernels run in interpret
mode, as its own tests run them.  Tolerances:
* gradients per leaf: rtol 1e-4 and atol 1e-4 x the leaf's largest
  magnitude — f32 reassociation only (measured ~1.5e-6 of the leaf scale);
* losses over 3 AdamW steps: rtol/atol 1e-4 — the same, through the
  optimizer (step 1 of Adam is sign-like, so near-zero gradient entries can
  move by lr; the loss barely feels it);
* AdamW and the schedules against ``repro.optim``: f32 math on the same
  inputs, rtol 1e-5 (bf16 moments: one bf16 ulp, rtol 1e-2);
* synthetic batches: bitwise.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import optim as joptim  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import reduced as jreduced  # noqa: E402
from repro.data import SyntheticLM as JSyntheticLM  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch import optim as toptim  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data import SyntheticLM  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402

B, S = 2, 16


def _cfgs(dispatch, remat="none"):
    def make(get, red):
        cfg = red(get("fastmoe-gpt"), num_layers=2, d_model=64)
        return dataclasses.replace(
            cfg, remat=remat,
            moe=dataclasses.replace(cfg.moe, dispatch=dispatch))
    return make(jget_config, jreduced), make(get_config, reduced)


@pytest.fixture(scope="module")
def jparams():
    jcfg, _ = _cfgs("capacity")
    return jax.tree.map(np.asarray, jlm.init_params(jax.random.PRNGKey(0), jcfg))


def _tokens(seed=0):
    return np.random.default_rng(seed).integers(0, 512, (B, S)).astype(np.int32)


def _assert_tree_close(got: dict, ref: dict, rel: float):
    """Per leaf: rtol rel and atol rel x the leaf's largest magnitude."""
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    assert len(flat_got) == len(flat_ref)
    for path, a in flat_got:
        b = np.asarray(flat_ref[path])
        np.testing.assert_allclose(a, b, rtol=rel,
                                   atol=rel * float(np.abs(b).max()),
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("seed", [0, 5])
def test_synthetic_batches_bitwise(seed):
    ref = JSyntheticLM(512, 32, seed=seed).batches(4)
    got = SyntheticLM(512, 32, seed=seed).batches(4)
    for _ in range(3):
        np.testing.assert_array_equal(next(got)["tokens"], next(ref)["tokens"])


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_adamw_matches_jax(moment_dtype):
    """Three updates of a random tree with clipping active (grad norm ~30
    against clip_norm 1) and the warmup-cosine scale."""
    rng = np.random.default_rng(1)
    shapes = {"a": (4, 3), "b": {"c": (5,), "d": (2, 2, 3)}}
    params = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32),
                          shapes, is_leaf=lambda s: isinstance(s, tuple))
    grads = [jax.tree.map(lambda p: (10 * rng.standard_normal(p.shape)
                                     ).astype(np.float32), params)
             for _ in range(3)]
    jopt = joptim.AdamW(lr=1e-2, moment_dtype=moment_dtype)
    topt = toptim.AdamW(lr=1e-2, moment_dtype=moment_dtype)
    jp, jst = jax.tree.map(jnp.asarray, params), None
    jst = jopt.init(jp)
    tp = jax.tree.map(torch.from_numpy, params)
    tst = topt.init(tp)
    mom_tol = 1e-2 if moment_dtype == "bfloat16" else 1e-5
    for step, g in enumerate(grads):
        scale = joptim.warmup_cosine(step, warmup=2, total=10)
        jp, jst, jn = jopt.update(jax.tree.map(jnp.asarray, g), jst, jp,
                                  lr_scale=scale)
        tp, tst, tn = topt.update(jax.tree.map(torch.from_numpy, g), tst, tp,
                                  lr_scale=toptim.warmup_cosine(
                                      step, warmup=2, total=10))
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-5)
        for got, ref in zip(tree_leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=1e-5, atol=1e-5)
        for got, ref in zip(tree_leaves(tst.mu) + tree_leaves(tst.nu),
                            jax.tree.leaves(jst.mu) + jax.tree.leaves(jst.nu)):
            np.testing.assert_allclose(got.float().numpy(),
                                       np.asarray(ref, np.float32),
                                       rtol=mom_tol, atol=1e-6)
    assert tst.step == int(jst.step) == 3


def test_schedules_match_jax():
    for step in [0, 1, 5, 99, 100, 101, 5000, 9999, 20000]:
        for fn in ("warmup_cosine", "warmup_linear"):
            ref = float(getattr(joptim.schedule, fn)(step, warmup=100,
                                                     total=10000))
            got = getattr(toptim, fn)(step, warmup=100, total=10000)
            np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dispatch", ["capacity", "ragged"])
@pytest.mark.parametrize("impl", ["einsum", "pallas", "fused"])
def test_step0_grads_match_jax(jparams, impl, dispatch):
    jcfg, tcfg = _cfgs(dispatch)
    tokens = _tokens()
    (jloss, jaux), jgrads = jax.value_and_grad(
        lambda p: jlm.loss_fn(p, jcfg, {"tokens": jnp.asarray(tokens)},
                              impl=impl), has_aux=True)(jparams)
    tparams = interop.from_jax(jparams, tcfg, device="cpu")
    loss, aux, grads = train.loss_and_grads(
        tparams, tcfg, {"tokens": torch.from_numpy(tokens)}, impl=impl,
        device="cpu")
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    for k in ("ce", "aux_loss", "z_loss", "drop_frac", "load"):
        np.testing.assert_allclose(aux[k].numpy(), np.asarray(jaux[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    _assert_tree_close(interop.to_jax(grads),
                       jax.tree.map(np.asarray, jgrads), 1e-4)


def test_train_steps_match_jax(jparams):
    """Three steps of ``make_train_step`` (fused experts, ragged dispatch)
    on the same numpy batches: the losses and the final params."""
    jcfg, tcfg = _cfgs("ragged")
    batches = list(zip(range(3), SyntheticLM(512, S, seed=3).batches(B)))
    opt_kw = dict(lr=1e-3)
    jstep = jax.jit(jtrain.make_train_step(jcfg, joptim.AdamW(**opt_kw),
                                           warmup=2, total_steps=10,
                                           impl="fused"))
    jp = jax.tree.map(jnp.asarray, jparams)
    jst = joptim.AdamW(**opt_kw).init(jp)
    topt = toptim.AdamW(**opt_kw)
    tstep = train.make_train_step(tcfg, topt, warmup=2, total_steps=10,
                                  impl="fused", device="cpu")
    tp = interop.from_jax(jparams, tcfg, device="cpu")
    tst = topt.init(tp)
    for step, batch in batches:
        jp, jst, jm = jstep(jp, jst, {"tokens": jnp.asarray(batch["tokens"])},
                            jnp.int32(step))
        tp, tst, tm = tstep(tp, tst, {"tokens": torch.from_numpy(
            batch["tokens"])}, step)
        for k in ("loss", "grad_norm", "ce"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       atol=1e-4, err_msg=f"step {step} {k}")
    _assert_tree_close(interop.to_jax(tp), jax.tree.map(np.asarray, jp), 1e-4)


def test_microbatched_steps_match_jax(jparams):
    """Two steps of ``make_train_step`` with the batch split into 2
    microbatches (einsum experts, capacity dispatch) against the reference's
    microbatched step: losses, grad norms and the final params."""
    jcfg, tcfg = _cfgs("capacity")
    opt_kw = dict(lr=1e-3)
    jstep = jax.jit(jtrain.make_train_step(jcfg, joptim.AdamW(**opt_kw),
                                           num_microbatches=2, warmup=2,
                                           total_steps=10))
    jp = jax.tree.map(jnp.asarray, jparams)
    jst = joptim.AdamW(**opt_kw).init(jp)
    topt = toptim.AdamW(**opt_kw)
    tstep = train.make_train_step(tcfg, topt, num_microbatches=2, warmup=2,
                                  total_steps=10, device="cpu")
    tp = interop.from_jax(jparams, tcfg, device="cpu")
    tst = topt.init(tp)
    for step in range(2):
        tokens = _tokens(10 + step)
        jp, jst, jm = jstep(jp, jst, {"tokens": jnp.asarray(tokens)},
                            jnp.int32(step))
        tp, tst, tm = tstep(tp, tst, {"tokens": torch.from_numpy(tokens)},
                            step)
        for k in ("loss", "grad_norm", "ce", "aux_loss"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4,
                                       atol=1e-4, err_msg=f"step {step} {k}")
    _assert_tree_close(interop.to_jax(tp), jax.tree.map(np.asarray, jp), 1e-4)


def test_microbatches_must_split_the_batch(jparams):
    _, tcfg = _cfgs("capacity")
    topt = toptim.AdamW(lr=1e-3)
    tp = interop.from_jax(jparams, tcfg, device="cpu")
    tstep = train.make_train_step(tcfg, topt, num_microbatches=4,
                                  device="cpu")
    with pytest.raises(ValueError, match="equal microbatches"):
        tstep(tp, topt.init(tp), {"tokens": torch.from_numpy(_tokens())}, 0)


@pytest.mark.parametrize("dispatch,impl", [("capacity", "fused"),
                                           ("ragged", "pallas")])
def test_remat_matches_no_remat(jparams, dispatch, impl):
    """Recomputing each layer in the backward (cfg.remat == "full") gives
    the same loss and gradients as keeping the activations."""
    out = []
    for remat in ("full", "none"):
        _, tcfg = _cfgs(dispatch, remat)
        tparams = interop.from_jax(jparams, tcfg, device="cpu")
        loss, _, grads = train.loss_and_grads(
            tparams, tcfg, {"tokens": torch.from_numpy(_tokens(1))},
            impl=impl, device="cpu")
        out.append((loss, tree_leaves(grads)))
    torch.testing.assert_close(out[0][0], out[1][0], rtol=0, atol=0)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_train_cli_smoke(capsys):
    train.main(["--arch", "fastmoe-gpt", "--reduced", "--device", "cpu",
                "--steps", "2", "--impl", "fused", "--dispatch", "ragged",
                "--log_every", "1", "--batch", "4", "--seq", "32"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("step")]
    assert len(lines) == 2
    losses = [float(ln.split("loss")[1].split()[0]) for ln in lines]
    assert all(np.isfinite(losses)) and 5.0 < losses[0] < 8.0


def test_train_cli_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: this guard is for hosts without one")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--reduced", "--steps", "1"])
