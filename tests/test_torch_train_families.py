"""Training every family of the port against the JAX package, on the CPU at
the small geometry (8 kHz, 5 octaves x 12 bins, 0.5-s blocks, latent 16,
complexity 1): one whole step of FiLM + skips and Mag + skips against the
JAX ``"packed"`` step from the same weights, gradient accumulation
against ``optax.MultiSteps`` and against one step on the whole batch.
MagDB's step, the level VJPs of the new stages, the forward's gradients,
checkpoints, the step measurement and the public API are in
``tests/test_torch_train_stages.py``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from timbre_trap_tpu.models import TimbreTrapFiLM as JaxTimbreTrapFiLM
from timbre_trap_tpu.models import TimbreTrapMag as JaxTimbreTrapMag
from timbre_trap_tpu.train import step as jax_step
from timbre_trap_tpu_torch.interop import state_dict_from_jax
from timbre_trap_tpu_torch.models import TimbreTrap, TimbreTrapFiLM, TimbreTrapMag
from timbre_trap_tpu_torch.train import (AdamW, MultiSteps, TrainConfig,
                                         init_train_state, make_optimizer,
                                         make_train_step, synthetic_batch)

torch.set_num_threads(2)

HP = dict(sample_rate=8000, n_octaves=5, bins_per_octave=12,
          secs_per_block=0.5, latent_size=16, model_complexity=1)
# Skip weights other than their ones at init, so their scaling shows.
SKIP_WEIGHTS = np.asarray([0.5, 1.5, -0.7, 2.0, 0.9], np.float32)
FAMILIES = {"film": (JaxTimbreTrapFiLM, TimbreTrapFiLM),
            "mag": (JaxTimbreTrapMag, TimbreTrapMag)}


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def jax_family_step(request):
    """One JAX packed step of a skip model of the family from its initial
    weights (skip weights set), on a seeded batch: (family, params0,
    audio, gt, new params, Adam mu, metrics)."""
    jax_cls, _ = FAMILIES[request.param]
    m = jax_cls(**HP, skip_connections=True)
    params = dict(jax.tree.map(np.asarray, m.params),
                  skip_weights=SKIP_WEIGHTS)
    cfg = TrainConfig()
    rng = np.random.default_rng(1)
    L, M = m.sliCQ.block_length, m.sliCQ.max_window_length
    audio = (rng.standard_normal((2, 1, L)) * 0.1).astype(np.float32)
    gt = (rng.uniform(size=(2, m.sliCQ.n_bins, M)) > 0.95).astype(np.float32)
    step = jax.jit(jax_step.make_train_step(m, cfg, mpe_batch_size=2,
                                            conv_backend="packed"))
    opt = jax_step.make_optimizer(cfg).init(params)
    new, opt, metrics = step(params, opt, jnp.asarray(audio),
                             jnp.asarray(gt), 1e-3)
    to_np = lambda t: jax.tree.map(np.asarray, t)   # noqa: E731
    return (request.param, params, audio, gt, to_np(new), to_np(opt[1].mu),
            {k: float(v) for k, v in metrics.items()})


@pytest.mark.parametrize("backend", ["packed", "pallas"])
def test_skip_family_step_matches_jax(jax_family_step, backend):
    """One port step of FiLM + skips and Mag + skips ("packed": autograd
    through the twin; "pallas": the K1/K3 Function, plain on the CPU)
    against the JAX packed step from the same weights: every loss key
    within rel 1e-4, Adam's first moment (0.1 * the clipped gradient)
    within 1e-4 x each leaf's max, the parameters within 5e-4. Gradients
    reach ``skip_weights`` and, for FiLM, ``film_layer.*``."""
    family, params0, audio, gt, want_params, want_mu, want_metrics = \
        jax_family_step
    m = FAMILIES[family][1](**HP, skip_connections=True, device="cpu")
    m.load_jax_params(params0)
    cfg = TrainConfig()
    state = init_train_state(m, cfg)
    metrics = make_train_step(m, cfg, 2, conv_backend=backend)(
        state, audio, gt, 1e-3)
    assert set(want_metrics) == set(metrics)
    for key, want in want_metrics.items():
        assert float(metrics[key]) == pytest.approx(want, rel=1e-4), key
    for name, want in state_dict_from_jax(want_mu).items():
        scale = float(np.abs(want.numpy()).max())
        np.testing.assert_allclose(state["mu"][name].numpy(), want.numpy(),
                                   atol=1e-4 * scale, err_msg=name)
    got = m.net.state_dict()
    for name, want in state_dict_from_jax(want_params).items():
        np.testing.assert_allclose(got[name].numpy(), want.numpy(),
                                   atol=5e-4, err_msg=name)
    moved = [n for n in got if n == "skip_weights" or n.startswith("film")]
    assert moved and all(float(state["mu"][n].abs().max()) > 0
                         for n in moved)


# --------------------------------------------------------------------- #
# Gradient accumulation                                                  #
# --------------------------------------------------------------------- #

def test_multisteps_matches_optax_multisteps():
    """Six calls of the port's ``MultiSteps(AdamW, 3)`` on fixed gradient
    arrays equal ``optax.MultiSteps`` over the JAX package's chain (the
    clip active on one boundary, not on the other): the parameters, the
    running mean, the inner count and Adam's moments within 1e-7, and the
    parameters bit for bit unchanged off the boundaries."""
    rng = np.random.default_rng(4)
    k = 3
    cfg = TrainConfig(grad_accum_steps=k)
    params = {"a": rng.standard_normal((5, 7)).astype(np.float32),
              "b": rng.standard_normal(11).astype(np.float32)}
    grads = [{n: (rng.standard_normal(v.shape)
                  * (40.0 if i < k else 0.2)).astype(np.float32)
              for n, v in params.items()} for i in range(2 * k)]
    tx = jax_step.make_optimizer(cfg)
    assert isinstance(tx, optax.MultiSteps)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = tx.init(jp)
    opt = make_optimizer(cfg)
    assert isinstance(opt, MultiSteps) and isinstance(opt.inner, AdamW)
    tp = {n: torch.from_numpy(v.copy()) for n, v in params.items()}
    tstate = opt.init(tp)
    for i, g in enumerate(grads):
        before = {n: v.clone() for n, v in tp.items()}
        updates, jstate = tx.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = jax.tree.map(lambda p, u: p + u * 3e-3, jp, updates)
        opt.update(tp, {n: torch.from_numpy(v) for n, v in g.items()},
                   tstate, 3e-3)
        boundary = (i + 1) % k == 0
        assert tstate["mini_step"] == int(jstate.mini_step)
        assert tstate["count"] == int(jstate.inner_opt_state[1].count)
        for n in params:
            np.testing.assert_allclose(tp[n].numpy(), np.asarray(jp[n]),
                                       atol=1e-7, err_msg=f"call {i} {n}")
            np.testing.assert_allclose(tstate["acc"][n].numpy(),
                                       np.asarray(jstate.acc_grads[n]),
                                       atol=1e-7)
            np.testing.assert_allclose(
                tstate["mu"][n].numpy(),
                np.asarray(jstate.inner_opt_state[1].mu[n]), atol=1e-7)
            assert torch.equal(tp[n], before[n]) != boundary
    assert tstate["count"] == 2


@pytest.mark.parametrize("backend", ["packed", "pallas"])
def test_grad_accumulation_matches_full_batch(backend):
    """k = 2 accumulation micro-steps on halves of a batch equal one step
    on the whole batch (the port's version of the JAX package's
    ``tests/test_train.py::test_grad_accumulation_matches_full_batch``):
    the parameters unchanged bit for bit after the first micro-step, and
    within rtol 2e-3 / atol 1e-6 of the one-step result after the second;
    each micro-step returns its own metrics and telemetry."""
    cfg_full = TrainConfig(multiplier_consistency=0.0)
    cfg_acc = TrainConfig(multiplier_consistency=0.0, grad_accum_steps=2)
    m = TimbreTrap(**HP, seed=2, device="cpu")
    audio, gt = synthetic_batch(m, 4, 0.5, seed=3)
    w0 = {n: v.clone() for n, v in m.net.state_dict().items()}

    make_train_step(m, cfg_full, 4, conv_backend=backend)(
        init_train_state(m, cfg_full), audio, gt, 1e-3)
    full = {n: v.clone() for n, v in m.net.state_dict().items()}

    m.load_state_dict(w0)
    state = init_train_state(m, cfg_acc)
    step = make_train_step(m, cfg_acc, 2, conv_backend=backend)
    metrics = step(state, audio[:2], gt[:2], 1e-3)
    assert state["count"] == 0 and state["mini_step"] == 1
    assert {"loss/total", "avg_norm/encoder"} <= set(metrics)
    for n, v in m.net.state_dict().items():
        assert torch.equal(v, w0[n]), n
    step(state, audio[2:], gt[2:], 1e-3)
    assert state["count"] == 1 and state["mini_step"] == 0
    assert all(float(a.abs().max()) == 0.0 for a in state["acc"].values())
    for n, v in m.net.state_dict().items():
        np.testing.assert_allclose(v.numpy(), full[n].numpy(), rtol=2e-3,
                                   atol=1e-6, err_msg=n)
