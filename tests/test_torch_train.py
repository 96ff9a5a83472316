"""The port's training slice (timbre_trap_tpu_torch.train and the level
backward) against the JAX package, on the CPU at small sizes.

On the CPU the level backward runs its plain twin
(``level_backward_reference``), so these tests hold the algorithm, the
adjoint blocks, the objectives, the optimizer and the whole step against
the JAX functions; the kernels of ``csrc/banded_conv_bwd.cu`` are held
against the twin on the card (``tests/test_torch_kernels.py`` and
``chip_smoke.py``). The small geometry is 8 kHz, 5 octaves x 12 bins,
0.5-s blocks, latent 16, complexity 1.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from timbre_trap_tpu import objectives as jax_objectives
from timbre_trap_tpu.models import TimbreTrap as JaxTimbreTrap
from timbre_trap_tpu.models.modules import DecoderBlock as JaxDecoderBlock
from timbre_trap_tpu.models.modules import EncoderBlock as JaxEncoderBlock
from timbre_trap_tpu.ops import fused_level as jfl
from timbre_trap_tpu.ops import packed_conv as jpc
from timbre_trap_tpu.train import schedules as jax_schedules
from timbre_trap_tpu.train import step as jax_step
from timbre_trap_tpu_torch import objectives
from timbre_trap_tpu_torch.interop import state_dict_from_jax
from timbre_trap_tpu_torch.models import TimbreTrap
from timbre_trap_tpu_torch.ops import fused_level as fl
from timbre_trap_tpu_torch.ops import packed_conv as pc
from timbre_trap_tpu_torch.train import (AdamW, PlateauDecay, TrainConfig,
                                         compact_audio, compact_ground_truth,
                                         cosine_warmup, init_train_state,
                                         make_train_step, synthetic_batch)

torch.set_num_threads(2)

HP = dict(sample_rate=8000, n_octaves=5, bins_per_octave=12,
          secs_per_block=0.5, latent_size=16, model_complexity=1)


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _leaves(params):
    """A flax param tree as torch leaf tensors that collect gradients."""
    return jax.tree.map(
        lambda a: torch.tensor(np.asarray(a), requires_grad=True), params)


def _assert_tree_close(got_tree, want_tree, **tol):
    want = dict(jax.tree_util.tree_leaves_with_path(want_tree))
    for path, got in jax.tree_util.tree_leaves_with_path(got_tree):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want[path]),
                                   err_msg=str(path), **tol)


# --------------------------------------------------------------------- #
# Adjoint blocks                                                         #
# --------------------------------------------------------------------- #

def _adjoint_cases():
    rng = np.random.default_rng(2)
    cases = {}
    for d in (1, 2, 3):
        k, b = _rand(rng, 3, 3, 4, 4), _rand(rng, 4)
        cases[f"conv2d-d{d}"] = (
            lambda m, k=k, b=b, d=d: m.build_conv2d_blocks(k, b, 40, d),
            lambda f, cb, k=k, d=d: f._attach_conv2d_adjoint(cb, k, 40, d))
    ks, bs = _rand(rng, 4, 1, 8, 16), _rand(rng, 16)
    cases["sconv"] = (
        lambda m: m.build_sconv_blocks(ks, bs, 41, stride=2),
        lambda f, cb: f._attach_sconv_adjoint(cb, ks, 41, stride=2))
    kt, bt = _rand(rng, 4, 1, 16, 8), _rand(rng, 8)
    cases["tconv"] = (
        lambda m: m.build_tconv_blocks(kt, bt, 19, stride=2,
                                       output_padding=1),
        lambda f, cb: f._attach_tconv_adjoint(cb, kt, stride=2))
    return cases


_ADJ = _adjoint_cases()


def _as_torch(a):
    return torch.from_numpy(a) if isinstance(a, np.ndarray) else a


@pytest.mark.parametrize("name", sorted(_ADJ))
def test_adjoint_blocks_equal_jax(name):
    build, attach = _ADJ[name]
    want = attach(jfl, build(jpc)).adjoint

    class _Torch:
        def __getattr__(self, fn):
            return lambda *a, **k: getattr(pc, fn)(*map(_as_torch, a), **k)

    got = attach(fl, build(_Torch())).adjoint
    assert (got.dts, got.col_adv, got.margin, got.k, got.r_in, got.r_out) == \
        (want.dts, want.col_adv, want.margin, want.k, want.r_in, want.r_out)
    np.testing.assert_allclose(got.blocks.numpy(), np.asarray(want.blocks),
                               atol=1e-6)
    assert not got.blocks.requires_grad


@pytest.mark.parametrize("kind", ["conv3x3-d2", "sconv", "tconv"])
@pytest.mark.parametrize("c,f", [(4, 540), (32, 65)])
def test_block_builder_and_its_vjp_match_jax(kind, c, f):
    """The port's one-hot block builder equals both JAX builder forms
    (tests/test_packed_conv.py::test_builder_forms_identical_blocks), and
    its autograd (the gradient that reaches the HWIO kernel) equals the VJP
    of JAX's training form (``vjp_einsum``)."""
    rng = np.random.default_rng(c + len(kind))
    if kind == "conv3x3-d2":
        k, b = _rand(rng, 3, 3, c, c), _rand(rng, c)
        build = lambda m, k, **kw: m.build_conv2d_blocks(k, b, f, 2, **kw)  # noqa: E731
    elif kind == "sconv":
        k, b = _rand(rng, 4, 1, c, 2 * c), _rand(rng, 2 * c)
        build = lambda m, k, **kw: m.build_sconv_blocks(k, b, f, 2, **kw)  # noqa: E731
    else:
        k, b = _rand(rng, 4, 1, c, c // 2), _rand(rng, c // 2)
        build = lambda m, k, **kw: m.build_tconv_blocks(  # noqa: E731
            k, b, f, 2, output_padding=1, **kw)
    kt = torch.tensor(k, requires_grad=True)
    got = build(pc, kt)
    for form in (False, True):
        np.testing.assert_array_equal(
            got.blocks.detach().numpy(),
            np.asarray(build(jpc, k, vjp_einsum=form).blocks))
    ct = _rand(rng, *got.blocks.shape)
    _, vjp = jax.vjp(lambda kk: build(jpc, kk, vjp_einsum=True).blocks,
                     jnp.asarray(k))
    got.blocks.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(kt.grad.numpy(), np.asarray(vjp(ct)[0]),
                               rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------- #
# The level VJP                                                          #
# --------------------------------------------------------------------- #

def _level_case(kind):
    """(flax params, spec builder over a param tree, packed input, w_ref),
    the geometries of tests/test_fused.py's level-VJP tests."""
    if kind == "encoder":
        rng = np.random.default_rng(0)
        B, T, C, F = 1, 24, 4, 40
        x0 = jnp.asarray(_rand(rng, B, F, T, C))
        params = JaxEncoderBlock(out_channels=2 * C).init(
            jax.random.PRNGKey(1), x0)["params"]

        def build(mod, p):
            return mod.encoder_level_spec(p, F, with_adjoints=True)
    else:
        rng = np.random.default_rng(7)
        B, T, c, F, pad = 1, 24, 8, 40, 1
        x0 = jnp.asarray(_rand(rng, B, F, T, c))
        params = dict(JaxDecoderBlock(out_channels=c // 2, padding=pad).init(
            jax.random.PRNGKey(2), x0)["params"])
        if kind == "decoder+convout":
            params["convout"] = {
                "kernel": jnp.asarray(_rand(rng, 3, 3, c // 2, 2) * 0.2),
                "bias": jnp.asarray(_rand(rng, 2) * 0.1)}

        def build(mod, p):
            return mod.decoder_level_spec(
                {k: v for k, v in p.items() if k != "convout"}, F,
                output_padding=pad, convout_params=p.get("convout"),
                with_adjoints=True)
    xp = jpc.pack_nhwc(x0)
    w_ref = _rand(rng, B, build(jfl, params).r_out, T)
    return params, build, xp, w_ref


@pytest.mark.parametrize("kind", ["encoder", "decoder", "decoder+convout"])
def test_level_vjp_matches_jax_pallas(kind):
    """The port's differentiable level on the CPU (the autograd Function
    over level_backward_reference) against JAX make_fused_level_train in
    Pallas interpret mode: dX and every flax parameter's gradient."""
    params, build, xp, w_ref = _level_case(kind)

    def loss(params, xp):
        spec = build(jfl, params)
        fn = jfl.make_fused_level_train(spec, tile_t=128, interpret=True)
        arrays = (spec.weight_arrays(jnp.float32)
                  + spec.adjoint_arrays(jnp.float32))
        return jnp.sum(fn(xp, *arrays) * w_ref)

    want_loss, (g_params, g_x) = jax.value_and_grad(loss, argnums=(0, 1))(
        params, xp)

    tparams = _leaves(params)
    x = torch.tensor(np.asarray(xp), requires_grad=True)
    got = torch.sum(fl.fused_level_train(x, build(fl, tparams))
                    * torch.from_numpy(w_ref))
    got.backward()
    assert got.item() == pytest.approx(float(want_loss), rel=1e-5)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(g_x), atol=1e-4,
                               rtol=1e-4)
    _assert_tree_close(tparams, g_params, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("kind", ["encoder", "decoder+convout"])
@pytest.mark.parametrize("input_grad", [True, False])
def test_level_backward_reference_matches_autograd(kind, input_grad):
    """level_backward_reference == torch autograd of packed_level_apply in
    float32: dX and the dW/dBias of every conv."""
    params, build, xp, w_ref = _level_case(kind)
    spec = build(fl, _leaves(params))
    x = torch.tensor(np.asarray(xp), requires_grad=True)
    w = torch.from_numpy(w_ref)
    arrays = [a for cb in spec.convs() for a in (cb.blocks, cb.bias)]
    want = torch.autograd.grad(
        torch.sum(fl.packed_level_apply(x, spec) * w), [x] + arrays)
    with torch.no_grad():
        dx, grads = fl.level_backward_reference(x.detach(), spec, w,
                                                input_grad=input_grad)
    got = [g for pair in grads for g in pair]
    if input_grad:
        got = [dx] + got
    else:
        assert dx is None
        want = want[1:]
    for g, r in zip(got, want):
        scale = float(r.abs().max())
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-5,
                                   atol=1e-5 * max(scale, 1.0))


def test_fused_level_train_bf16_tracks_f32():
    """bfloat16 storage with float32 accumulation: the level's output and
    gradients stay within 5e-2 x max|ref| of float32 autograd, as
    tests/test_fused.py holds the JAX mixed-precision level; dX comes back
    at the input's dtype and parameter gradients in float32."""
    params, build, xp, w_ref = _level_case("encoder")
    w = torch.from_numpy(w_ref)
    runs = []
    for dtype in (torch.float32, torch.bfloat16):
        tparams = _leaves(params)
        x = torch.tensor(np.asarray(xp), requires_grad=True)
        y = fl.fused_level_train(x, build(fl, tparams), dtype)
        assert y.dtype == dtype
        torch.sum(y.float() * w).backward()
        assert x.grad.dtype == torch.float32
        runs.append([x.grad] + [t.grad for t in jax.tree.leaves(tparams)])
    for g16, g32 in zip(*runs[::-1]):
        assert g16.dtype == torch.float32
        scale = max(1e-3, float(g32.abs().max()))
        assert float((g16 - g32).abs().max()) <= 5e-2 * scale


def test_fused_level_train_needs_adjoints():
    params, build, xp, _ = _level_case("encoder")
    spec = fl.encoder_level_spec(_leaves(params), 40)
    with pytest.raises(ValueError, match="with_adjoints"):
        fl.fused_level_train(torch.from_numpy(np.asarray(xp)), spec)


# --------------------------------------------------------------------- #
# Objectives, optimizer, schedules, compact uploads                      #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("weighted", [False, True])
def test_objectives_match_jax(weighted):
    rng = np.random.default_rng(5)
    est = rng.uniform(size=(2, 30, 17)).astype(np.float32)
    tgt = (rng.uniform(size=(2, 30, 17)) > 0.8).astype(np.float32)
    tgt[0, :, 3] = 0.0                    # a frame with no positives
    got = objectives.compute_transcription_loss(
        torch.from_numpy(est), torch.from_numpy(tgt), weighted)
    want = jax_objectives.compute_transcription_loss(est, tgt, weighted)
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    a, b, c = (_rand(rng, 2, 2, 30, 17) for _ in range(3))
    got = objectives.compute_consistency_loss(*map(torch.from_numpy, (a, b, c)))
    want = jax_objectives.compute_consistency_loss(a, b, c)
    for g, w in zip(got, want):
        assert float(g) == pytest.approx(float(w), rel=1e-6)
    assert float(objectives.compute_reconstruction_loss(
        torch.from_numpy(a), torch.from_numpy(c))) == pytest.approx(
        float(jax_objectives.compute_reconstruction_loss(a, c)), rel=1e-6)


@pytest.mark.parametrize("clip_active", [False, True])
def test_optimizer_matches_optax_chain(clip_active):
    """Two updates of the port's AdamW equal the JAX package's optax chain
    (clip_by_global_norm -> scale_by_adam -> add_decayed_weights ->
    scale(-1), times lr) within 1e-7, with the clip active and not."""
    rng = np.random.default_rng(9)
    cfg = TrainConfig()
    scale = 30.0 if clip_active else 0.1
    params = {"a": _rand(rng, 5, 7), "b": _rand(rng, 11)}
    grads = [{k: _rand(rng, *v.shape, scale=scale) for k, v in params.items()}
             for _ in range(2)]
    norm = np.sqrt(sum(float(np.sum(g ** 2)) for g in grads[0].values()))
    assert (norm > cfg.grad_clip) == clip_active

    tx = jax_step.make_optimizer(cfg)
    jp = jax.tree.map(jnp.asarray, params)
    state = tx.init(jp)
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = jax.tree.map(lambda p, u: p + u * 3e-3, jp, updates)

    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    opt = AdamW(cfg.grad_clip, cfg.weight_decay)
    tstate = opt.init(tp)
    for g in grads:
        opt.update(tp, {k: torch.from_numpy(v) for k, v in g.items()},
                   tstate, 3e-3)
    assert tstate["count"] == 2
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-7)
        np.testing.assert_allclose(tstate["mu"][k].numpy(),
                                   np.asarray(state[1].mu[k]), atol=1e-7)


def test_schedules_and_compact_helpers_match_jax():
    for n in (0, 10):
        ours, ref = cosine_warmup(n), jax_schedules.cosine_warmup(n)
        for step in (0, 3, 9, 10, 25):
            assert ours(step) == ref(step)
    ours, ref = PlateauDecay(2, cooldown=1), jax_schedules.PlateauDecay(2, 1)
    for v in (0.5, 0.5, 0.5, 0.5, 0.5, 0.6, 0.55):
        assert ours.step(v) == ref.step(v)
    rng = np.random.default_rng(1)
    audio = np.clip(rng.standard_normal((2, 1, 64)) * 2, -9, 9)
    np.testing.assert_array_equal(compact_audio(audio),
                                  jax_step.compact_audio(audio))
    gt = rng.random((2, 6, 8)).astype(np.float32)
    gt[0, 0, 0], gt[1, 2, 3] = 0.0, 1.0
    g8 = compact_ground_truth(gt)
    np.testing.assert_array_equal(g8, jax_step.compact_ground_truth(gt))
    assert g8[0, 0, 0] == 0 and g8[1, 2, 3] == 255


def test_step_rejects_what_is_not_ported():
    m = TimbreTrap(**HP, device="cpu")
    with pytest.raises(NotImplementedError):
        make_train_step(m, TrainConfig(grad_accum_steps=2), 1)
    with pytest.raises(ValueError, match="conv_backend"):
        make_train_step(m, TrainConfig(), 1, conv_backend="flax")


# --------------------------------------------------------------------- #
# The whole step                                                         #
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def jax_step_result():
    """One JAX packed step from the initial weights of a small model, on a
    seeded batch: (params0, audio, gt, new params, Adam mu, metrics)."""
    m = JaxTimbreTrap(**HP)
    cfg = TrainConfig()
    rng = np.random.default_rng(0)
    L, M = m.sliCQ.block_length, m.sliCQ.max_window_length
    audio = (rng.standard_normal((2, 1, L)) * 0.1).astype(np.float32)
    gt = (rng.uniform(size=(2, m.sliCQ.n_bins, M)) > 0.95).astype(np.float32)
    step = jax.jit(jax_step.make_train_step(m, cfg, mpe_batch_size=2,
                                            conv_backend="packed"))
    params, opt = jax_step.init_train_state(m, cfg)
    new, opt, metrics = step(params, opt, jnp.asarray(audio), jnp.asarray(gt),
                             1e-3)
    to_np = lambda t: jax.tree.map(np.asarray, t)   # noqa: E731
    return (to_np(params), audio, gt, to_np(new), to_np(opt[1].mu),
            {k: float(v) for k, v in metrics.items()})


def _port_model(params0):
    m = TimbreTrap(**HP, device="cpu")
    m.load_jax_params(params0)
    return m


@pytest.mark.parametrize("backend", ["packed", "pallas"])
def test_step_matches_jax(jax_step_result, backend):
    """One port step ("packed": autograd through the twin; "pallas": the
    K1/K3 Function, plain on the CPU) against the JAX packed step from the
    same weights: every loss key within rel 1e-4, gradients (through Adam's
    first moment, mu = 0.1 * clip(g)) within 1e-4 x each leaf's max, and the
    updated parameters within 5e-4."""
    params0, audio, gt, want_params, want_mu, want_metrics = jax_step_result
    m = _port_model(params0)
    cfg = TrainConfig()
    state = init_train_state(m, cfg)
    metrics = make_train_step(m, cfg, 2, conv_backend=backend)(
        state, audio, gt, 1e-3)
    assert set(want_metrics) == set(metrics)
    for key, want in want_metrics.items():
        assert float(metrics[key]) == pytest.approx(want, rel=1e-4), key
    mu = state_dict_from_jax(want_mu)
    for name, want in mu.items():
        got = state["mu"][name].numpy()
        scale = float(np.abs(want.numpy()).max())
        np.testing.assert_allclose(got, want.numpy(), atol=1e-4 * scale,
                                   err_msg=name)
    for name, want in state_dict_from_jax(want_params).items():
        np.testing.assert_allclose(m.net.state_dict()[name].numpy(),
                                   want.numpy(), atol=5e-4, err_msg=name)


def test_bf16_step_tracks_f32_and_trains(jax_step_result):
    params0, audio, gt, _, _, want_metrics = jax_step_result
    m = _port_model(params0)
    cfg = TrainConfig()
    state = init_train_state(m, cfg)
    step = make_train_step(m, cfg, 2, conv_backend="pallas_bf16")
    losses = [float(step(state, audio, gt, 1e-3)["loss/total"])
              for _ in range(3)]
    assert losses[0] == pytest.approx(want_metrics["loss/total"], rel=2e-2)
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_compact_inputs_match_f32_step(jax_step_result):
    """int16 audio on the compact grid and uint8 ground truth give the f32
    step's result; dequantized exactly, they give the same bits."""
    params0, audio, gt, _, _, _ = jax_step_result
    cfg = TrainConfig()
    a16, g8 = compact_audio(audio), compact_ground_truth(gt)
    inputs = {"f32": (audio, gt), "compact": (a16, g8),
              "snapped": (a16.astype(np.float32) / 4096.0,
                          g8.astype(np.float32) / 255.0)}
    out = {}
    for name, (a, g) in inputs.items():
        m = _port_model(params0)
        step = make_train_step(m, cfg, 2, conv_backend="pallas",
                               compact_audio_grid=True)
        out[name] = (step(init_train_state(m, cfg), a, g, 1e-3),
                     m.net.state_dict())
    np.testing.assert_array_equal(g8.astype(np.float32) / 255.0, gt)
    for key in ("loss/total", "loss/transcription"):
        assert float(out["compact"][0][key]) == pytest.approx(
            float(out["f32"][0][key]), rel=2e-3)
        assert float(out["compact"][0][key]) == float(out["snapped"][0][key])
    for name, p in out["compact"][1].items():
        assert torch.equal(p, out["snapped"][1][name]), name


def test_transcribe_after_step_uses_new_weights(jax_step_result):
    """The step drops the model's cached inference chains: transcribe()
    after a step equals a fresh model loaded with the stepped weights."""
    params0, audio, gt, _, _, _ = jax_step_result
    m = _port_model(params0)
    clip = audio[:1, :, :6000]
    before = m.transcribe(clip)
    assert m._specs
    cfg = TrainConfig()
    make_train_step(m, cfg, 2, conv_backend="pallas")(
        init_train_state(m, cfg), audio, gt, 1e-3)
    fresh = TimbreTrap(**HP, device="cpu")
    fresh.load_state_dict(m.net.state_dict())
    after = m.transcribe(clip)
    assert not torch.equal(after, before)
    assert torch.equal(after, fresh.transcribe(clip))


def test_step_parts_compose_to_the_step(jax_step_result):
    """``step.parts`` (upload, loss_fn, update), run one after another,
    give the step's metrics and weights bit for bit."""
    params0, audio, gt, _, _, _ = jax_step_result
    cfg = TrainConfig()
    out = []
    for whole in (True, False):
        m = _port_model(params0)
        state = init_train_state(m, cfg)
        step = make_train_step(m, cfg, 2, conv_backend="pallas")
        if whole:
            metrics = step(state, audio, gt, 1e-3)
        else:
            upload, loss_fn, update = step.parts
            total, metrics = loss_fn(*upload(audio, gt))
            total.backward()
            metrics = update(state, metrics, 1e-3)
        out.append((metrics, m.net.state_dict()))
    assert set(out[0][0]) == set(out[1][0])
    for key, v in out[0][0].items():
        assert torch.equal(v, out[1][0][key]), key
    for name, p in out[0][1].items():
        assert torch.equal(p, out[1][1][name]), name


def test_synthetic_batch_is_seeded_and_shaped():
    """The recipe's synthetic batch: int16 audio on the compact grid,
    uint8 ground truth of the model's (F, frames) with about 3 % on, the
    same for one seed and different for another."""
    m = TimbreTrap(**HP, device="cpu")
    audio, gt = synthetic_batch(m, 3, 1.0, seed=4)
    frames = m.sliCQ.get_expected_frames(8000)
    assert audio.dtype == np.int16 and audio.shape == (3, 1, 8000)
    assert gt.dtype == np.uint8 and gt.shape == (3, m.sliCQ.n_bins, frames)
    assert set(np.unique(gt)) <= {0, 255}
    assert 0.01 < (gt > 0).mean() < 0.05
    again = synthetic_batch(m, 3, 1.0, seed=4)
    assert np.array_equal(audio, again[0]) and np.array_equal(gt, again[1])
    assert not np.array_equal(audio, synthetic_batch(m, 3, 1.0, seed=5)[0])
