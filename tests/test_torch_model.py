"""The port's TimbreTrap (timbre_trap_tpu_torch.models) against the JAX
package at the small geometry (8 kHz, 5 octaves x 12 bins, 0.5-s blocks,
latent 16, complexity 1): transcribe, and reconstruct on the native and the
``cqt_pytorch`` compat frame; transcribe and reconstruct at complexity 3
and 4; plus its device and import contracts."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from timbre_trap_tpu.models import TimbreTrap as JaxTimbreTrap
from timbre_trap_tpu_torch.models import TimbreTrap, TimbreTrapFiLM
from timbre_trap_tpu_torch.transform import CQT

torch.set_num_threads(2)

HP = dict(sample_rate=8000, n_octaves=5, bins_per_octave=12,
          secs_per_block=0.5, latent_size=16, model_complexity=1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def models():
    """The JAX model and the port (CPU, f32) with the same weights."""
    ref = JaxTimbreTrap(**HP)
    port = TimbreTrap(**HP, fused="f32", device="cpu")
    port.load_jax_params(jax.tree.map(np.asarray, ref.params))
    return ref, port


def _clip(seed, secs):
    rng = np.random.default_rng(seed)
    return (0.3 * rng.standard_normal((1, 1, int(secs * 8000)))
            ).astype(np.float32)


def test_transcribe_matches_jax(models):
    ref, port = models
    audio = _clip(0, 7.3)
    want = np.asarray(ref._transcribe_jit(ref.params, jnp.asarray(audio)))
    got = port.transcribe(audio)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_streaming_matches_single_program(models):
    """Piece-by-piece transcribe (piece_blocks=3) == one pass over the
    whole clip (a tensor input), frame-exact."""
    _, port = models
    audio = _clip(1, 7.3)
    whole = port.transcribe(torch.from_numpy(audio))
    port.piece_blocks = 3
    try:
        streamed = port.transcribe(audio)
    finally:
        port.piece_blocks = TimbreTrap.piece_blocks
    assert streamed.shape == whole.shape
    np.testing.assert_allclose(streamed.numpy(), whole.numpy(), atol=2e-5)


def test_transcribe_accepts_int16_and_f16(models):
    ref, port = models
    rng = np.random.default_rng(1)
    pcm = (rng.standard_normal((1, 1, 6000)) * 8000).astype(np.int16)
    deq = pcm.astype(np.float32) / 32768.0
    want = port.transcribe(deq).numpy()
    np.testing.assert_allclose(port.transcribe(pcm).numpy(), want, atol=1e-6)
    np.testing.assert_allclose(port.transcribe(pcm).numpy(),
                               np.asarray(ref.transcribe(pcm)), atol=1e-4)
    port.pad_short_to_piece = True
    try:
        got_piece = port.transcribe(pcm).numpy()
        got_f16 = port.transcribe(deq.astype(np.float16)).numpy()
    finally:
        port.pad_short_to_piece = False
    np.testing.assert_allclose(got_piece, want, atol=2e-5)
    np.testing.assert_allclose(got_f16, want, atol=5e-3)


def test_short_clip_piece_pad_matches_single_program(models):
    _, port = models
    audio = _clip(2, 1.2)
    whole = port.transcribe(audio).numpy()
    port.pad_short_to_piece = True
    try:
        padded = port.transcribe(audio).numpy()
    finally:
        port.pad_short_to_piece = False
    assert padded.shape == whole.shape
    np.testing.assert_allclose(padded, whole, atol=2e-5)


def test_inference_and_chunked_shapes_match_jax(models):
    ref, port = models
    L = port.sliCQ.block_length
    audio = _clip(3, 2.5 * L / 8000)
    got = port.chunked_inference(audio, transcribe=True)
    want = np.asarray(ref.chunked_inference(audio, transcribe=True))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    one = port.inference(audio[..., :L], transcribe=False)
    assert tuple(one.shape) == (1, 2, 60, port.sliCQ.max_window_length)
    acts = port.to_activations(got)
    assert acts.min() >= 0 and acts.max() <= 1


def test_bf16_transcribe_close_to_f32(models):
    _, port = models
    audio = _clip(4, 2.0)
    f32 = port.transcribe(audio)
    port.fused = "auto"
    try:
        bf16 = port.transcribe(audio)
    finally:
        port.fused = "f32"
    np.testing.assert_allclose(bf16.numpy(), f32.numpy(), atol=5e-2)


@pytest.fixture(scope="module")
def compat_models():
    """``models`` on the ``cqt_pytorch`` compat frame."""
    ref = JaxTimbreTrap(**HP, transform_compat="cqt_pytorch")
    port = TimbreTrap(**HP, fused="f32", transform_compat="cqt_pytorch",
                      device="cpu")
    port.load_jax_params(jax.tree.map(np.asarray, ref.params))
    return ref, port


@pytest.mark.parametrize("frame", ["native", "cqt_pytorch"])
def test_reconstruct_matches_jax(models, compat_models, frame):
    """The normalised resynthesis of a 7.3-s clip (15 blocks: one pass in
    both packages) against the JAX ``reconstruct`` with the same
    weights."""
    ref, port = models if frame == "native" else compat_models
    assert port.sliCQ.compat == frame
    audio = _clip(5, 7.3)
    want = np.asarray(ref.reconstruct(audio))
    got = port.reconstruct(audio)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == (
        1, 1, 15 * port.sliCQ.block_length)
    assert float(got.abs().max()) == pytest.approx(1.0, abs=1e-6)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.fixture(scope="module", params=[3, 4])
def wide_models(request):
    """``models`` at model complexity 3 and 4 (widths up to 128 and 256):
    the JAX package runs them through its flax route, the port through
    ``forward_spec`` and K1's twin, with two period-2 stages at
    complexity 4 (a 256-channel output frequency spans two 128-row
    blocks)."""
    hp = dict(HP, model_complexity=request.param)
    ref = JaxTimbreTrap(**hp)
    port = TimbreTrap(**hp, fused="f32", device="cpu")
    port.load_jax_params(jax.tree.map(np.asarray, ref.params))
    periods = sorted({cb.period for cb in port._spec(True).convs()
                      if cb.col_adv})
    assert periods == ([1, 2] if request.param == 4 else [1])
    return ref, port


def test_wide_transcribe_matches_jax(wide_models):
    """A 2.3-s clip (5 blocks), within the complexity-1 test's 1e-4 (both
    float32; the port measures about 3e-5 away)."""
    ref, port = wide_models
    audio = _clip(7, 2.3)
    want = np.asarray(ref._transcribe_jit(ref.params, jnp.asarray(audio)))
    got = port.transcribe(audio)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_wide_reconstruct_matches_jax(wide_models):
    """The normalised resynthesis of the same clip, within 1e-4 (the port
    measures about 3e-6 away)."""
    ref, port = wide_models
    audio = _clip(7, 2.3)
    want = np.asarray(ref.reconstruct(audio))
    got = port.reconstruct(audio)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("secs", [7.3, 1.2])
def test_streaming_reconstruct_matches_single_program(models, secs):
    """Piece-by-piece reconstruct (piece_blocks=3: per-piece synthesis,
    the global infinity-norm after the concatenation) == one pass over the
    whole clip (a tensor input), for a streamed and a short clip."""
    _, port = models
    audio = _clip(6, secs)
    whole = port.reconstruct(torch.from_numpy(audio))
    port.piece_blocks = 3
    try:
        assert port._piece_route(audio) == (secs > 3)
        streamed = port.reconstruct(audio)
    finally:
        port.piece_blocks = TimbreTrap.piece_blocks
    assert streamed.shape == whole.shape
    np.testing.assert_allclose(streamed.numpy(), whole.numpy(), atol=2e-5)


def test_reconstruct_accepts_int16_and_f16(models):
    """PCM16 dequantizes by 1/32768 and float16 casts, streamed or not."""
    ref, port = models
    rng = np.random.default_rng(7)
    pcm = (rng.standard_normal((1, 1, 6000)) * 8000).astype(np.int16)
    deq = pcm.astype(np.float32) / 32768.0
    want = port.reconstruct(deq).numpy()
    np.testing.assert_allclose(port.reconstruct(pcm).numpy(), want,
                               atol=1e-6)
    np.testing.assert_allclose(port.reconstruct(pcm).numpy(),
                               np.asarray(ref.reconstruct(pcm)), atol=1e-4)
    port.pad_short_to_piece = True
    try:
        got_piece = port.reconstruct(pcm).numpy()
        got_f16 = port.reconstruct(deq.astype(np.float16)).numpy()
    finally:
        port.pad_short_to_piece = False
    np.testing.assert_allclose(got_piece, want, atol=2e-5)
    np.testing.assert_allclose(got_f16, want, atol=5e-3)


def test_fused_mode_is_validated():
    with pytest.raises(ValueError, match="fused"):
        TimbreTrap(**HP, fused="off", device="cpu")


@pytest.mark.parametrize("entry", ["TimbreTrap", "CQT", "TimbreTrap-compat",
                                   "TimbreTrapFiLM", "TimbreTrap-skips"])
def test_no_cpu_fallback_without_cuda(entry):
    """device=None means the card: with no CUDA device it raises. The
    model's entry points (``transcribe``, ``reconstruct``) run on the device
    the constructor resolved, so the constructor is where the rule holds,
    on either transform frame, for every family, with or without skip
    connections."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "TimbreTrap":
            TimbreTrap(**HP)
        elif entry == "TimbreTrap-compat":
            TimbreTrap(**HP, transform_compat="cqt_pytorch")
        elif entry == "TimbreTrapFiLM":
            TimbreTrapFiLM(**HP)
        elif entry == "TimbreTrap-skips":
            TimbreTrap(**HP, skip_connections=True)
        else:
            CQT(HP["n_octaves"], HP["bins_per_octave"], HP["sample_rate"],
                HP["secs_per_block"])


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import timbre_trap_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'timbre_trap_tpu')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith(p.__name__)]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 31
