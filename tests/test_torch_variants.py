"""The port's model families (base, FiLM, Mag, MagDB), each with and
without skip connections, against the JAX package at the small geometry
(8 kHz, 5 octaves x 12 bins, 0.5-s blocks, latent 16, complexity 1): the
weight layout, the NCHW network, the packed inference routes, ``transcribe``
and ``reconstruct``, and ``save`` / ``load`` / ``load_model``."""

import json
import os

import numpy as np
import pytest
import torch

import jax

from timbre_trap_tpu.interop.torch_import import export_torch_state_dict
from timbre_trap_tpu.models import (TimbreTrap as JaxTimbreTrap,
                                    TimbreTrapFiLM as JaxTimbreTrapFiLM,
                                    TimbreTrapMag as JaxTimbreTrapMag,
                                    TimbreTrapMagDB as JaxTimbreTrapMagDB)
from timbre_trap_tpu.models.fused import fused_forward as jax_fused_forward
from timbre_trap_tpu_torch.interop import hwio_params, state_dict_from_jax
from timbre_trap_tpu_torch.models import (TimbreTrap, TimbreTrapFiLM,
                                          TimbreTrapMag, TimbreTrapMagDB,
                                          fused_forward, load_model)

torch.set_num_threads(2)

HP = dict(sample_rate=8000, n_octaves=5, bins_per_octave=12,
          secs_per_block=0.5, latent_size=16, model_complexity=1)
FAMILIES = {"base": (JaxTimbreTrap, TimbreTrap),
            "film": (JaxTimbreTrapFiLM, TimbreTrapFiLM),
            "mag": (JaxTimbreTrapMag, TimbreTrapMag),
            "magdb": (JaxTimbreTrapMagDB, TimbreTrapMagDB)}
CONFIGS = [(v, s) for v in FAMILIES for s in (False, True)]
# Skip weights other than their ones at init, so the scaling shows.
SKIP_WEIGHTS = np.asarray([0.5, 1.5, -0.7, 2.0, 0.9], np.float32)


def _id(config):
    return f"{config[0]}-{'skips' if config[1] else 'noskips'}"


def _clip(seed, secs=1.2):
    """Noise under a rising envelope (chunks of unequal loudness), 3 blocks:
    7 chunks, so a group of 4 and one of 3."""
    n = int(secs * 8000)
    rng = np.random.default_rng(seed)
    env = np.linspace(0.02, 1.0, n, dtype=np.float32)
    return (0.3 * rng.standard_normal((1, 1, n)) * env).astype(np.float32)


def _nhwc_to_nchw(y):
    return np.moveaxis(np.asarray(y), -1, 1)


@pytest.fixture(scope="module", params=CONFIGS, ids=_id)
def case(request):
    """The JAX model, the port (CPU, float32) with the same weights, seeded
    features (1, 60, 24, C_in) and the flax training forward's two
    decoder branches on them (NCHW)."""
    variant, skip = request.param
    jax_cls, port_cls = FAMILIES[variant]
    ref = jax_cls(**HP, skip_connections=skip)
    params = jax.tree.map(np.asarray, ref.params)
    if skip:
        params = dict(params, skip_weights=SKIP_WEIGHTS)
    ref.params = params
    port = port_cls(**HP, skip_connections=skip, fused="f32", device="cpu")
    port.load_jax_params(params)
    c = port.net.in_channels
    x = np.random.default_rng(3).standard_normal((1, 60, 24, c)).astype(
        np.float32)
    rec, _, trn, _, _, _ = ref.net.apply({"params": params}, x, False)
    flax = {False: _nhwc_to_nchw(rec), True: _nhwc_to_nchw(trn)}
    return ref, port, x, flax


def test_state_dict_from_jax_round_trips(case):
    """The FiLM Dense kernels transpose, ``skip_weights`` stays flat, and
    the names are the reference's; ``hwio_params`` gives the tree back."""
    ref, port, _, _ = case
    want = export_torch_state_dict(ref.params,
                                   like=port.net.state_dict().keys())
    got = state_dict_from_jax(ref.params)
    assert set(got) == set(want) == set(port.net.state_dict())
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)
    back = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.detach().numpy(), hwio_params(port.net)))
    flat = dict(jax.tree_util.tree_leaves_with_path(ref.params))
    assert len(back) == len(flat)
    for path, value in back:
        np.testing.assert_array_equal(value, flat[path], err_msg=str(path))


def test_net_forward_matches_flax(case):
    """The NCHW network of the port against flax ``net.apply``, float32,
    both decoder branches."""
    _, port, x, flax = case
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for transcribe in (False, True):
        with torch.no_grad():
            got = port.net(xt, transcribe).numpy()
        np.testing.assert_allclose(got, flax[transcribe], atol=1e-4,
                                   rtol=1e-3)


@pytest.mark.parametrize("transcribe", [True, False])
def test_fused_forward_matches_flax(case, transcribe):
    """The packed inference route (one chain, or the skip route) on the
    plain twins against the flax decode branch: float32 within 1e-4, the
    bf16 chain within 5e-2 x max|ref|."""
    _, port, x, flax = case
    want = flax[transcribe]
    xt = torch.from_numpy(x)
    got = fused_forward(port.net, xt, transcribe)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-3)
    got16 = fused_forward(port.net, xt, transcribe, dtype=torch.bfloat16)
    err = np.abs(got16.numpy() - want).max()
    assert err <= 5e-2 * np.abs(want).max()


# The JAX package's Pallas forward in interpret mode costs ~8-25 s a call
# here, so two cases stand for the routes (every case is held to flax
# above): the skip route with the indicator row on the reconstruction
# branch, and a one-channel family's single chain with its sigmoid.
@pytest.mark.parametrize("config, transcribe", [
    (("base", True), False), (("magdb", False), True)],
    ids=lambda v: _id(v) if isinstance(v, tuple) else f"transcribe={v}")
def test_fused_forward_matches_jax_interpret(config, transcribe):
    variant, skip = config
    jax_cls, port_cls = FAMILIES[variant]
    ref = jax_cls(**HP, skip_connections=skip)
    params = jax.tree.map(np.asarray, ref.params)
    if skip:
        params = dict(params, skip_weights=SKIP_WEIGHTS)
    port = port_cls(**HP, skip_connections=skip, device="cpu")
    port.load_jax_params(params)
    x = np.random.default_rng(4).standard_normal(
        (1, 60, 24, port.net.in_channels)).astype(np.float32)
    want = np.asarray(jax_fused_forward(params, ref.net, x, transcribe,
                                        interpret=True))
    got = fused_forward(port.net, torch.from_numpy(x), transcribe).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)


def test_transcribe_matches_jax(case):
    """Activations of a 1.2-s clip against the JAX model (float32, within
    1e-4), and the bf16 chain within 5e-2 of the float32 one. Chunks run 4
    a group, so MagDB's dB scale must be each chunk's own."""
    ref, port, _, _ = case
    assert port.chunk_group == ref.chunk_group == 4
    audio = _clip(0)
    want = np.asarray(ref.transcribe(audio))
    got = port.transcribe(audio)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    port.fused = "auto"
    try:
        got16 = port.transcribe(audio)
    finally:
        port.fused = "f32"
    np.testing.assert_allclose(got16.numpy(), got.numpy(), atol=5e-2)


def test_reconstruct_matches_jax_or_raises(case):
    """The two-channel families resynthesise as the JAX model does (within
    1e-4); Mag and MagDB have no phase and raise in both packages."""
    ref, port, _, _ = case
    audio = _clip(1)
    if port.net.in_channels == 1:
        with pytest.raises(IndexError):
            ref.reconstruct(audio)
        with pytest.raises(ValueError, match="real and imaginary"):
            port.reconstruct(audio)
        return
    want = np.asarray(ref.reconstruct(audio))
    got = port.reconstruct(audio)
    assert tuple(got.shape) == want.shape
    assert float(got.abs().max()) == pytest.approx(1.0, abs=1e-6)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_magdb_features_are_per_chunk():
    """The dB floor and rescale follow each item's own maximum: a loud and
    a quiet chunk in one batch give each its features alone."""
    port = TimbreTrapMagDB(**HP, device="cpu")
    L = port.sliCQ.block_length
    rng = np.random.default_rng(5)
    chunks = torch.from_numpy((rng.standard_normal((2, 1, L))
                               * np.asarray([1.0, 1e-3])[:, None, None]
                               ).astype(np.float32))
    both = port.features_from_audio(chunks)
    for i in range(2):
        alone = port.features_from_audio(chunks[i:i + 1])
        np.testing.assert_allclose(both[i:i + 1].numpy(), alone.numpy(),
                                   atol=1e-6)
    assert float(both.amax(dim=(1, 2, 3)).min()) == pytest.approx(1.0)


def test_save_load_model_round_trip(case, tmp_path):
    """``save`` writes the JAX package's hparams and the reference-named
    weights; ``load_model`` and ``TimbreTrap.load`` rebuild the same
    family with equal hparams, the same weights and the same outputs, bit
    for bit."""
    ref, port, _, _ = case
    assert port.hparams == ref.hparams
    path = port.save(str(tmp_path / "ckpt"))
    assert sorted(os.listdir(path)) == ["hparams.json", "weights.pt"]
    audio = torch.from_numpy(_clip(2)[..., :port.sliCQ.block_length])
    want = port.inference(audio, transcribe=True)
    for loaded in (load_model(path, overrides={"device": "cpu",
                                               "fused": "f32"}),
                   type(port).load(path, device="cpu")):
        assert type(loaded) is type(port)
        assert loaded.hparams == port.hparams
        state = loaded.net.state_dict()
        for key, value in port.net.state_dict().items():
            assert torch.equal(state[key], value), key
        loaded.fused = port.fused
        assert torch.equal(loaded.inference(audio, transcribe=True), want)


def test_load_model_hparams_lookup(tmp_path):
    """A weights file finds its hparams beside it (``<path>.hparams.json``)
    or in its directory; a bare file takes ``defaults``; ``overrides``
    join the stored hparams (a None value is ignored); no hparams and no
    defaults raise."""
    port = TimbreTrapFiLM(**HP, skip_connections=True, seed=3, device="cpu")
    weights = {k: v.clone() for k, v in port.net.state_dict().items()}

    def same(model):
        assert type(model) is TimbreTrapFiLM
        assert model.hparams == port.hparams
        assert all(torch.equal(model.net.state_dict()[k], v)
                   for k, v in weights.items())

    run = tmp_path / "run" / "models"
    run.mkdir(parents=True)
    torch.save(weights, run / "model-3")
    with pytest.raises(ValueError, match="no hparams.json"):
        load_model(str(run / "model-3"))
    same(load_model(str(run / "model-3"),
                    defaults=dict(port.hparams, device="cpu")))
    (run / "model-3.hparams.json").write_text(json.dumps(port.hparams))
    same(load_model(str(run / "model-3"), overrides={"device": "cpu"}))
    (run / "model-3.hparams.json").unlink()
    (run / "hparams.json").write_text(json.dumps(port.hparams))
    m = load_model(str(run / "model-3"),
                   overrides={"device": "cpu", "fused": "f32",
                              "latent_size": None})
    same(m)
    assert m.fused == "f32"


def test_load_model_refuses_a_jax_checkpoint(tmp_path):
    """A JAX package save directory (``hparams.json`` and the orbax
    ``weights/`` directory) is not read: the error names the converter."""
    path = tmp_path / "jax"
    (path / "weights").mkdir(parents=True)
    (path / "hparams.json").write_text(json.dumps(
        TimbreTrapFiLM(**HP, device="cpu").hparams))
    with pytest.raises(ValueError, match="state_dict_from_jax"):
        load_model(str(path), overrides={"device": "cpu"})
