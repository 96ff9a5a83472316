"""The rest of the port's training slice against the JAX package, on the CPU
at the small geometry (8 kHz, 5 octaves x 12 bins, 0.5-s blocks, latent
16, complexity 1): the level VJP of the stages the families add (the
standalone convin and convout of the skip route, the one-channel convin
and convout of Mag and MagDB), the training forward's gradients of every
family x skips against autograd through the NCHW network, one whole MagDB
step against the JAX ``"packed"`` step, checkpoints and exact resume, the
recipe step's measurement, and the public ``encode``, ``decode`` and
``forward`` API. The FiLM + skips and Mag + skips steps and gradient
accumulation are in ``tests/test_torch_train_families.py``."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from timbre_trap_tpu.models import TimbreTrapFiLM as JaxTimbreTrapFiLM
from timbre_trap_tpu.models import TimbreTrapMag as JaxTimbreTrapMag
from timbre_trap_tpu.models import TimbreTrapMagDB as JaxTimbreTrapMagDB
from timbre_trap_tpu.models.fused import _conv2d_level_spec as jax_level_spec
from timbre_trap_tpu.ops import fused_level as jfl
from timbre_trap_tpu.ops import packed_conv as jpc
from timbre_trap_tpu.train import step as jax_step
from timbre_trap_tpu_torch.interop import hwio_params, state_dict_from_jax
from timbre_trap_tpu_torch.models import (TimbreTrap, TimbreTrapFiLM,
                                          TimbreTrapMag, TimbreTrapMagDB)
from timbre_trap_tpu_torch.models.fused import packed_train_forward
from timbre_trap_tpu_torch.ops import fused_level as fl
from timbre_trap_tpu_torch.ops.packed_conv import pack_nchw
from timbre_trap_tpu_torch.train import (CHECKPOINT_FILE, TrainConfig,
                                         init_train_state, latest_checkpoint,
                                         load_checkpoint, load_params,
                                         make_train_step,
                                         reference_recipe_step_time,
                                         save_checkpoint,
                                         step_gradients_reference,
                                         synthetic_batch)

torch.set_num_threads(2)

HP = dict(sample_rate=8000, n_octaves=5, bins_per_octave=12,
          secs_per_block=0.5, latent_size=16, model_complexity=1)
FAMILIES = {"base": TimbreTrap, "film": TimbreTrapFiLM, "mag": TimbreTrapMag,
            "magdb": TimbreTrapMagDB}
CONFIGS = [(v, s) for v in FAMILIES for s in (False, True)]
SKIP_WEIGHTS = [0.5, 1.5, -0.7, 2.0, 0.9]


def _id(config):
    return f"{config[0]}-{'skips' if config[1] else 'noskips'}"


def _leaves(params):
    return jax.tree.map(
        lambda a: torch.tensor(np.asarray(a), requires_grad=True), params)


# --------------------------------------------------------------------- #
# The level VJP on the families' new stages                              #
# --------------------------------------------------------------------- #

# (c_in, c_out, ELU): the skip route's standalone convin and convout, and
# the one-channel convin and convout of Mag and MagDB. 135 frequencies:
# the one-channel side has 135 rows (a block and 7), the four-channel side
# 540 (four blocks and 28).
STAGES = {"convin-2-4": (2, 4, True), "convout-4-2": (4, 2, False),
          "convin-1-4": (1, 4, True), "convout-4-1": (4, 1, False)}


@pytest.mark.parametrize("name", list(STAGES))
def test_new_stage_level_vjp_matches_jax_pallas(name):
    """A one-conv level (``conv2d_level_spec``) of each new stage through
    the port's differentiable level on the CPU (the autograd Function over
    ``level_backward_reference``) against JAX ``make_fused_level_train``
    in Pallas interpret mode: the output, dX within 1e-4, the kernel's and
    bias's gradients within atol 1e-4 / rtol 1e-3."""
    c_in, c_out, act = STAGES[name]
    rng = np.random.default_rng(c_in * 10 + c_out)
    f, t = 135, 24
    params = {"kernel": (rng.standard_normal((3, 3, c_in, c_out))
                         / np.sqrt(9 * c_in)).astype(np.float32),
              "bias": (0.1 * rng.standard_normal(c_out)).astype(np.float32)}
    xp = jpc.pack_nhwc(jnp.asarray(rng.standard_normal(
        (1, f, t, c_in)).astype(np.float32)))
    w_ref = rng.standard_normal((1, f * c_out, t)).astype(np.float32)

    def loss(params, xp):
        spec = jax_level_spec(params, f, act, with_adjoints=True)
        fn = jfl.make_fused_level_train(spec, tile_t=128, interpret=True)
        arrays = (spec.weight_arrays(jnp.float32)
                  + spec.adjoint_arrays(jnp.float32))
        return jnp.sum(fn(xp, *arrays) * w_ref)

    want_loss, (g_params, g_x) = jax.value_and_grad(loss, argnums=(0, 1))(
        params, xp)
    tparams = _leaves(params)
    x = torch.tensor(np.asarray(xp), requires_grad=True)
    spec = fl.conv2d_level_spec(tparams, f, act, with_adjoints=True)
    assert (spec.r_in, spec.r_out) == (f * c_in, f * c_out)
    got = torch.sum(fl.fused_level_train(x, spec) * torch.from_numpy(w_ref))
    got.backward()
    assert got.item() == pytest.approx(float(want_loss), rel=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_x), atol=1e-4,
                               rtol=1e-4)
    for key in ("kernel", "bias"):
        np.testing.assert_allclose(tparams[key].grad.numpy(),
                                   np.asarray(g_params[key]), atol=1e-4,
                                   rtol=1e-3, err_msg=key)


# --------------------------------------------------------------------- #
# The training forward's gradients against the NCHW network              #
# --------------------------------------------------------------------- #

def _nchw_train_forward(net, features):
    """The reference's training forward (consistency on) through the port's
    NCHW network, outputs packed as ``packed_train_forward`` gives them."""
    latents, emb = net.encode(features.movedim(-1, 1))
    emb = net.apply_skip_connections(emb)
    rec, trn = (net.decode(latents, emb, t) for t in (False, True))
    latents_t, emb_t = net.encode(trn)
    emb_t = net.apply_skip_connections(emb_t)
    trn_rec, trn_scr = (net.decode(latents_t, emb_t, t) for t in (False, True))
    return (pack_nchw(rec), latents, pack_nchw(trn), pack_nchw(trn_rec),
            pack_nchw(trn_scr))


@pytest.mark.parametrize("backend", ["packed", "pallas"])
@pytest.mark.parametrize("config", CONFIGS, ids=_id)
def test_train_forward_gradients_match_nchw_net(config, backend):
    """The gradients of a fixed linear functional of all five outputs of
    ``packed_train_forward`` ("packed": autograd through the twin;
    "pallas": the K1/K3 Function, plain on the CPU) equal torch autograd
    through the NCHW ``TimbreTrapNet`` within 1e-4 x each leaf's max|g|,
    for every family x skips; every parameter, ``skip_weights`` and
    ``film_layer.*`` included, gets a gradient."""
    variant, skip = config
    net = FAMILIES[variant](**HP, skip_connections=skip, seed=3,
                            device="cpu").net
    if skip:
        with torch.no_grad():
            net.skip_weights.copy_(torch.tensor(SKIP_WEIGHTS))
    rng = np.random.default_rng(len(variant) + skip)
    c = net.in_channels
    feats = torch.from_numpy(rng.standard_normal((2, 60, 24, c)).astype(
        np.float32))
    weights = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in [(2, 60 * c, 24), (2, 16, 24)] + [(2, 60 * c, 24)] * 3]
    params = dict(net.named_parameters())

    def grads(outputs):
        for p in params.values():
            p.grad = None
        sum(torch.sum(o * w) for o, w in zip(outputs, weights)).backward()
        return {n: p.grad for n, p in params.items()}

    want = grads(_nchw_train_forward(net, feats))
    got = grads(packed_train_forward(hwio_params(net), net, feats, True,
                                     backend))
    assert all(g is not None for g in got.values())
    for name, g in want.items():
        scale = float(g.abs().max())
        assert scale > 0, name
        np.testing.assert_allclose(got[name].numpy(), g.numpy(),
                                   atol=1e-4 * scale, rtol=0, err_msg=name)


# --------------------------------------------------------------------- #
# The whole MagDB step against JAX                                       #
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def jax_magdb_step():
    """One JAX packed step of a MagDB model (no skips) from its initial
    weights on a seeded batch: (params0, audio, gt, the JAX features, new
    params, Adam mu, metrics)."""
    m = JaxTimbreTrapMagDB(**HP)
    params = jax.tree.map(np.asarray, m.params)
    cfg = TrainConfig()
    rng = np.random.default_rng(2)
    L, M = m.sliCQ.block_length, m.sliCQ.max_window_length
    audio = (rng.standard_normal((2, 1, L)) * 0.1).astype(np.float32)
    gt = (rng.uniform(size=(2, m.sliCQ.n_bins, M)) > 0.95).astype(np.float32)
    step = jax.jit(jax_step.make_train_step(m, cfg, mpe_batch_size=2,
                                            conv_backend="packed"))
    opt = jax_step.make_optimizer(cfg).init(params)
    new, opt, metrics = step(params, opt, jnp.asarray(audio),
                             jnp.asarray(gt), 1e-3)
    features = np.asarray(m.features_from_audio(jnp.asarray(audio)))
    to_np = lambda t: jax.tree.map(np.asarray, t)   # noqa: E731
    return (params, audio, gt, features, to_np(new), to_np(opt[1].mu),
            {k: float(v) for k, v in metrics.items()})


@pytest.mark.parametrize("backend", ["packed", "pallas"])
def test_magdb_step_matches_jax(jax_magdb_step, backend):
    """One port step of MagDB against the JAX packed step from the same
    weights, each on its own dB features (which part by at most 1e-4 of
    their range: the two FFTs' rounding, amplified near the 80-dB floor):
    losses within rel 1e-4, Adam's mu within 1e-4 x each leaf's max, the
    parameters within 5e-4."""
    params0, audio, gt, features, want_params, want_mu, want_metrics = \
        jax_magdb_step
    m = TimbreTrapMagDB(**HP, device="cpu")
    m.load_jax_params(params0)
    own = m.features_from_audio(audio).numpy()
    assert own.shape == features.shape
    np.testing.assert_allclose(own, features, atol=1e-4)
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
    for name, want in state_dict_from_jax(want_params).items():
        np.testing.assert_allclose(m.net.state_dict()[name].numpy(),
                                   want.numpy(), atol=5e-4, err_msg=name)


def test_step_gradients_reference_tracks_the_step():
    """``step_gradients_reference`` (a float64 run of one step's loss
    through the NCHW network) gives the gradients the float32 step takes,
    within 1e-4 x each leaf's max, and leaves the model as it was."""
    m = TimbreTrapFiLM(**HP, skip_connections=True, seed=7, device="cpu")
    audio, gt = synthetic_batch(m, 2, 0.5, seed=8)
    cfg = TrainConfig()
    w0 = {k: v.clone() for k, v in m.net.state_dict().items()}
    g64 = step_gradients_reference(m, cfg, 2, audio, gt,
                                   compact_audio_grid=True)
    assert all(torch.equal(v, w0[k]) for k, v in m.net.state_dict().items())
    assert all(g.dtype == torch.float64 for g in g64.values())
    make_train_step(m, cfg, 2, conv_backend="packed",
                    compact_audio_grid=True)(init_train_state(m, cfg),
                                             audio, gt, 1e-3)
    for name, p in m.net.named_parameters():
        scale = float(g64[name].abs().max())
        np.testing.assert_allclose(p.grad.double().numpy(),
                                   g64[name].numpy(), atol=1e-4 * scale,
                                   rtol=0, err_msg=name)


# --------------------------------------------------------------------- #
# Checkpoints and the step measurement                                   #
# --------------------------------------------------------------------- #

def _steps(model, cfg, batches, state):
    step = make_train_step(model, cfg, 1, conv_backend="pallas_bf16")
    return [{k: float(v) for k, v in step(state, a, g, 1e-3).items()}
            for a, g in batches]


@pytest.mark.parametrize("accum", [1, 2])
def test_checkpoint_resume_is_exact(tmp_path, accum):
    """Save after step 1 (FiLM + skips, bf16 storage on the twins), load
    into a fresh model: steps 2 and 3 are bit for bit those of the run
    that went on, the optimizer state (and the accumulator) included."""
    cfg = TrainConfig(grad_accum_steps=accum)
    kw = dict(HP, skip_connections=True, device="cpu")
    m = TimbreTrapFiLM(**kw, seed=1)
    audio, gt = synthetic_batch(m, 3, 0.5, seed=2)
    batches = [(audio[i:i + 1], gt[i:i + 1]) for i in range(3)]
    state = init_train_state(m, cfg)
    _steps(m, cfg, batches[:1], state)
    path = save_checkpoint(str(tmp_path / "model-1"), m, state, step=1)
    assert os.listdir(path) == [CHECKPOINT_FILE]
    going_on = _steps(m, cfg, batches[1:], state)

    loaded = load_checkpoint(path)
    assert loaded["step"] == 1
    fresh = TimbreTrapFiLM(**kw, seed=9)
    fresh.load_state_dict(loaded["params"])
    resumed = _steps(fresh, cfg, batches[1:], loaded["opt_state"])
    assert resumed == going_on
    for name, v in m.net.state_dict().items():
        assert torch.equal(fresh.net.state_dict()[name], v), name
    assert loaded["opt_state"]["count"] == state["count"]
    for key in ("mu", "nu") + (("acc",) if accum > 1 else ()):
        for name, v in state[key].items():
            assert torch.equal(loaded["opt_state"][key][name], v), name


def test_checkpoint_layouts_and_latest(tmp_path):
    """``save_checkpoint`` replaces a checkpoint in place and takes a model,
    a module or a state_dict; ``load_params`` reads a trainer checkpoint
    and a ``TimbreTrap.save`` directory alike; ``latest_checkpoint`` picks
    the highest step of the prefix and ignores other names."""
    m = TimbreTrapMag(**HP, skip_connections=True, seed=4, device="cpu")
    sd = m.net.state_dict()
    a = save_checkpoint(str(tmp_path / "run" / "model-2"), m.net.state_dict())
    save_checkpoint(str(tmp_path / "run" / "model-2"), m, step=2)
    save_checkpoint(str(tmp_path / "run" / "model-10"), m.net, step=10)
    os.makedirs(tmp_path / "run" / "model-x")
    os.makedirs(tmp_path / "run" / "other-99")
    assert latest_checkpoint(str(tmp_path / "run")) == str(
        tmp_path / "run" / "model-10")
    assert latest_checkpoint(str(tmp_path / "none")) is None
    assert load_checkpoint(a)["step"] == 2
    assert "opt_state" not in load_checkpoint(a)
    saved = m.save(str(tmp_path / "saved"))
    for path in (a, saved):
        got = load_params(path)
        assert got.keys() == sd.keys()
        assert all(torch.equal(got[k], v) for k, v in sd.items())


def test_reference_recipe_step_time_on_cpu():
    """The step measurement at batch 1, one block, one iteration: a
    positive time, a finite first loss, the model's weights stepped;
    a peak-memory request on the CPU raises."""
    m = TimbreTrapMagDB(**HP, skip_connections=True, seed=6, device="cpu")
    w0 = m.net.state_dict()["skip_weights"].clone()
    secs, loss = reference_recipe_step_time(m, "pallas_bf16", batch=1,
                                            blocks=1, iters=1)
    assert secs > 0 and np.isfinite(loss)
    assert not torch.equal(m.net.state_dict()["skip_weights"], w0)
    with pytest.raises(ValueError, match="card"):
        reference_recipe_step_time(m, "packed", batch=1, blocks=1, iters=1,
                                   return_memory=True)


# --------------------------------------------------------------------- #
# The public encode / decode / forward API                               #
# --------------------------------------------------------------------- #

API_FAMILIES = {"film-skips": (JaxTimbreTrapFiLM, TimbreTrapFiLM, True),
                "mag-noskips": (JaxTimbreTrapMag, TimbreTrapMag, False)}


def _nhwc_to_nchw(y):
    return np.moveaxis(np.asarray(y), -1, 1)


@pytest.mark.parametrize("name", list(API_FAMILIES))
def test_public_api_matches_jax(name):
    """``encode``, ``apply_skip_connections``, ``decode`` and ``forward``
    (consistency on) against the JAX model's on the same weights and
    audio, the JAX package's NHWC embeddings transposed to the port's
    NCHW: every output within 1e-4 x its max; the port's outputs carry
    autograd to the weights."""
    jax_cls, port_cls, skip = API_FAMILIES[name]
    ref = jax_cls(**HP, skip_connections=skip)
    params = jax.tree.map(np.asarray, ref.params)
    if skip:
        params = dict(params, skip_weights=np.float32(SKIP_WEIGHTS))
    ref.params = params
    port = port_cls(**HP, skip_connections=skip, device="cpu")
    port.load_jax_params(params)
    audio = (np.random.default_rng(7).standard_normal((1, 1, 4000))
             * 0.1).astype(np.float32)

    def close(got, want, what):
        want = np.asarray(want)
        scale = max(float(np.abs(want).max()), 1e-6)
        np.testing.assert_allclose(got.detach().numpy(), want,
                                   atol=1e-4 * scale, err_msg=what)

    latents, emb, losses = port.encode(audio)
    j_latents, j_emb, _ = ref.encode(audio)
    assert losses == {}
    close(latents, j_latents, "latents")
    assert len(emb) == len(j_emb) == 5
    for i, (e, je) in enumerate(zip(emb, j_emb)):
        close(e, _nhwc_to_nchw(je), f"embedding {i}")
    scaled = port.apply_skip_connections(emb)
    j_scaled = ref.apply_skip_connections(j_emb)
    assert (scaled is None) == (j_scaled is None) == (not skip)
    for transcribe in (False, True):
        got = port.decode(latents, scaled, transcribe)
        close(got, ref.decode(j_latents, j_scaled, transcribe),
              f"decode transcribe={transcribe}")
    got = port(audio, consistency=True)
    want = ref(audio, consistency=True)
    for i, (g, w) in enumerate(zip(got[:5], want[:5])):
        close(g, w, f"forward output {i}")
    assert got[0].requires_grad and got[5] == {}
    assert port.forward(audio)[3] is None
