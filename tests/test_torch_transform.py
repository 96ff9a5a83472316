"""The port's sliCQ (timbre_trap_tpu_torch.transform) vs the JAX package, on
the native and the ``cqt_pytorch`` compat frame: equal plan tables; encode
within atol 1e-4 and decode within 1e-5 * max|x| at the small geometry
(the unaligned plans) and for flagship blocks (the 128-aligned plans,
which the JAX package decodes by a one-hot matmul and the port by the
gather); round trips, the coefficient helpers, batch-wide normalisation
and the calibration helpers."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from timbre_trap_tpu.transform import CQT as JaxCQT
from timbre_trap_tpu.transform import identify_transform as jax_identify
from timbre_trap_tpu.transform.design import (
    design_cqt_pytorch as jax_design_compat)
from timbre_trap_tpu.transform.design import design_slicq as jax_design
from timbre_trap_tpu_torch.transform import (CQT, identify_transform,
                                             load_tables, save_tables)
from timbre_trap_tpu_torch.transform.design import (design_cqt_pytorch,
                                                    design_slicq)

torch.set_num_threads(2)

SMALL = dict(n_octaves=5, bins_per_octave=12, sample_rate=8000,
             secs_per_block=0.5)
FLAGSHIP = dict(n_octaves=9, bins_per_octave=60, sample_rate=22050,
                secs_per_block=3)


def _assert_plans_equal(want, got):
    for name in want.__dataclass_fields__:
        a, b = getattr(want, name), getattr(got, name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(b, a, err_msg=name)
        else:
            assert a == b, name


def _design_args(cfg):
    return (cfg["sample_rate"], cfg["n_octaves"], cfg["bins_per_octave"],
            int(cfg["secs_per_block"] * cfg["sample_rate"]))


@pytest.mark.parametrize("cfg", [SMALL, FLAGSHIP], ids=["small", "flagship"])
def test_design_slicq_tables_equal(cfg):
    _assert_plans_equal(jax_design(*_design_args(cfg)),
                        design_slicq(*_design_args(cfg)))


@pytest.mark.parametrize("cfg", [SMALL, FLAGSHIP], ids=["small", "flagship"])
def test_design_cqt_pytorch_tables_equal(cfg):
    want = jax_design_compat(*_design_args(cfg))
    got = design_cqt_pytorch(*_design_args(cfg))
    assert got.variant == "cqt_pytorch" and got.scatter_idx.shape[0] == 3
    _assert_plans_equal(want, got)


@pytest.mark.parametrize("cfg,blocks", [(SMALL, 2.3), (FLAGSHIP, 1.0)],
                         ids=["small-gather", "flagship-aligned"])
def test_encode_matches_jax(cfg, blocks):
    ref_cqt, cqt = JaxCQT(**cfg), CQT(**cfg, device="cpu")
    assert cqt.plan.alignment == (128 if cfg is FLAGSHIP else 1)
    rng = np.random.default_rng(0)
    n = int(blocks * cqt.block_length)
    audio = (0.5 * rng.standard_normal((2, 1, n))).astype(np.float32)
    want = np.asarray(ref_cqt.encode(jnp.asarray(audio)))
    got = cqt.encode(torch.from_numpy(audio)).numpy()
    assert got.shape == want.shape == (2, 1, cqt.n_bins,
                                       cqt.get_expected_frames(n))
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_coefficient_helpers_match_jax():
    ref_cqt, cqt = JaxCQT(**SMALL), CQT(**SMALL, device="cpu")
    rng = np.random.default_rng(1)
    coeffs = rng.standard_normal((2, 1, 60, 40)) + 1j * rng.standard_normal(
        (2, 1, 60, 40))
    coeffs = coeffs.astype(np.complex64)
    real = cqt.to_real(torch.from_numpy(coeffs))
    np.testing.assert_array_equal(real.numpy(),
                                  np.asarray(ref_cqt.to_real(coeffs)))
    mag = cqt.to_magnitude(real)
    np.testing.assert_allclose(mag.numpy(),
                               np.asarray(ref_cqt.to_magnitude(real.numpy())),
                               rtol=1e-6)
    for rescale in (True, False):
        np.testing.assert_allclose(
            cqt.to_decibels(mag, rescale).numpy(),
            np.asarray(ref_cqt.to_decibels(mag.numpy(), rescale)),
            rtol=1e-5, atol=1e-5)
    audio = np.ones((1, 1, 4100), np.float32)
    assert tuple(cqt.pad_to_block_length(torch.from_numpy(audio)).shape) == \
        ref_cqt.pad_to_block_length(audio).shape
    for n in (1, 4000, 4001, 12345):
        assert cqt.get_expected_frames(n) == ref_cqt.get_expected_frames(n)
    np.testing.assert_array_equal(cqt.get_times(17), ref_cqt.get_times(17))
    np.testing.assert_array_equal(cqt.get_midi_freqs(),
                                  ref_cqt.get_midi_freqs())


FRAMES = ["native", "cqt_pytorch"]


def _snr_db(reference, estimate):
    reference = np.asarray(reference, dtype=np.float64)
    noise = reference - np.asarray(estimate, dtype=np.float64)
    return 10.0 * np.log10(np.sum(reference ** 2)
                           / max(np.sum(noise ** 2), 1e-300))


@pytest.mark.parametrize("cfg,blocks", [(SMALL, 2.3), (FLAGSHIP, 1.0)],
                         ids=["small-gather", "flagship-aligned"])
def test_compat_encode_matches_jax(cfg, blocks):
    """The port's one analysis (``build_encode``) serves the compat plan
    unchanged."""
    ref_cqt = JaxCQT(**cfg, compat="cqt_pytorch")
    cqt = CQT(**cfg, compat="cqt_pytorch", device="cpu")
    assert cqt.compat == "cqt_pytorch"
    assert cqt.plan.alignment == (128 if cfg is FLAGSHIP else 1)
    rng = np.random.default_rng(5)
    n = int(blocks * cqt.block_length)
    audio = (0.5 * rng.standard_normal((2, 1, n))).astype(np.float32)
    want = np.asarray(ref_cqt.encode(jnp.asarray(audio)))
    got = cqt.encode(torch.from_numpy(audio)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("frame", FRAMES)
@pytest.mark.parametrize("cfg,batch", [(SMALL, 2), (FLAGSHIP, 1)],
                         ids=["small-gather", "flagship-aligned"])
def test_decode_raw_matches_jax(cfg, batch, frame):
    """The same coefficients (the JAX encode of white noise) through the
    JAX decode (gather at the small geometry, one-hot matmul at the
    flagship) and the port's gather decode: within 1e-5 * max|x|."""
    ref_cqt = JaxCQT(**cfg, compat=frame)
    cqt = CQT(**cfg, compat=frame, device="cpu")
    rng = np.random.default_rng(6)
    x = rng.standard_normal((batch, 1, 2 * cqt.block_length)).astype(
        np.float32)
    coeffs = np.asarray(ref_cqt.encode(jnp.asarray(x)))
    want = np.asarray(ref_cqt.decode_raw(jnp.asarray(coeffs)))
    got = cqt.decode_raw(torch.from_numpy(coeffs.copy()))
    assert got.dtype == torch.float32 and got.shape == want.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want,
                               atol=1e-5 * float(np.abs(x).max()))


def test_decode_validates_like_jax():
    cqt = CQT(**SMALL, device="cpu")
    M = cqt.max_window_length
    with pytest.raises(ValueError, match="complex"):
        cqt.decode_raw(torch.zeros((1, 1, 60, M)))
    with pytest.raises(ValueError, match="bins"):
        cqt.decode_raw(torch.zeros((1, 1, 59, M), dtype=torch.complex64))
    with pytest.raises(ValueError, match="multiple"):
        cqt.decode_raw(torch.zeros((1, 1, 60, M + 1), dtype=torch.complex64))


@pytest.mark.parametrize("case", ["noise-3-blocks", "noise-flagship",
                                  "sinusoids"])
def test_native_round_trips(case):
    """As ``tests/test_transform.py`` holds the JAX package: white noise
    over 3 small blocks and one flagship block, and a chord, > 60 dB."""
    cfg = FLAGSHIP if case == "noise-flagship" else SMALL
    cqt = CQT(**cfg, device="cpu")
    L = cqt.block_length
    rng = np.random.default_rng(7)
    if case == "sinusoids":
        t = np.arange(2 * L) / cqt.sample_rate
        audio = sum(0.3 * np.sin(2 * np.pi * f * t)
                    for f in (261.63, 329.63, 392.0))[None, None, :]
    else:
        n = L if case == "noise-flagship" else 3 * L
        audio = rng.standard_normal((2 if n == 3 * L else 1, 1, n))
    audio = torch.from_numpy(audio.astype(np.float32))
    coeffs = cqt.encode(audio)
    assert coeffs.shape[-1] == audio.shape[-1] // L * cqt.max_window_length
    assert _snr_db(audio, cqt.decode_raw(coeffs)) > 60.0


def test_to_real_complex_involution():
    cqt = CQT(**SMALL, device="cpu")
    rng = np.random.default_rng(8)
    c = (rng.standard_normal((2, 1, 60, 8))
         + 1j * rng.standard_normal((2, 1, 60, 8))).astype(np.complex64)
    real = cqt.to_real(torch.from_numpy(c))
    back = cqt.to_complex(real)
    assert back.shape == (2, 60, 8)
    assert torch.equal(back, torch.from_numpy(c[:, 0]))
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(JaxCQT.to_complex(real.numpy())))


def test_compat_covered_content_exact():
    """Canonical-dual synthesis is exact on the spectrum the compat
    windows cover (> 80 dB)."""
    cqt = CQT(**SMALL, compat="cqt_pytorch", device="cpu")
    plan = cqt.plan
    covered = (plan.scatter_dual != 0).any(axis=0)
    assert 0.9 < covered.mean() <= 1.0
    rng = np.random.default_rng(9)
    X = (rng.standard_normal(plan.n_rfft)
         + 1j * rng.standard_normal(plan.n_rfft)) * covered
    X[0], X[-1] = X[0].real, X[-1].real
    x = np.fft.irfft(X, n=plan.block_length).astype(np.float32)[None, None]
    rec = cqt.decode_raw(cqt.encode(torch.from_numpy(x)))
    assert _snr_db(x, rec) > 80.0


@pytest.mark.parametrize("cfg", [SMALL, FLAGSHIP], ids=["small", "flagship"])
def test_compat_sinusoid_round_trip(cfg):
    """The compat frame is approximately invertible, as the reference
    transform is: a chord comes back above 30 dB."""
    cqt = CQT(**cfg, compat="cqt_pytorch", device="cpu")
    t = np.arange(2 * cqt.block_length) / cqt.sample_rate
    audio = sum(0.3 * np.sin(2 * np.pi * f * t)
                for f in (261.63, 392.0, 1244.5))[None, None, :]
    audio = torch.from_numpy(audio.astype(np.float32))
    assert _snr_db(audio, cqt.decode_raw(cqt.encode(audio))) > 30.0


@pytest.mark.parametrize("frame", FRAMES)
def test_decode_normalises_over_the_whole_batch(frame):
    """``decode`` divides by the infinity norm of the whole batch, not of
    each item, from complex (B, 1, F, T) or real (B, 2, F, T) input, as
    the JAX decode does; silence stays silence."""
    ref_cqt = JaxCQT(**SMALL, compat=frame)
    cqt = CQT(**SMALL, compat=frame, device="cpu")
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 1, 2 * cqt.block_length)).astype(np.float32)
    x[1] *= 0.1
    coeffs = cqt.encode(torch.from_numpy(x))
    raw = cqt.decode_raw(coeffs)
    for c in (coeffs, cqt.to_real(coeffs)):
        y = cqt.decode(c)
        assert y.shape == (2, 1, x.shape[-1])
        torch.testing.assert_close(y, raw / raw.abs().max(), rtol=0,
                                   atol=1e-6)
        assert float(y.abs().max()) == pytest.approx(1.0, abs=1e-6)
        assert float(y[1].abs().max()) < 0.2
        np.testing.assert_allclose(
            y.numpy(), np.asarray(ref_cqt.decode(c.numpy())), atol=1e-5)
    silent = cqt.decode(torch.zeros_like(coeffs))
    assert not silent.any() and bool(torch.isfinite(silent).all())


def test_compat_tables_validated():
    with pytest.raises(ValueError, match="compat_tables"):
        CQT(**SMALL, compat_tables={"starts": [0]}, device="cpu")
    with pytest.raises(ValueError, match="compat"):
        CQT(**SMALL, compat="nsgt", device="cpu")


def test_compat_tables_reject_unknown_keys():
    """The compat frame has one synthesis convention (canonical dual, zero
    on uncovered bins, 1/M scaling): any key beyond the measured analysis
    tables is refused, not silently ignored."""
    with pytest.raises(ValueError, match="unknown tables keys"):
        design_cqt_pytorch(4000, 3, 4, 1000,
                           tables={"starts": np.zeros(12, np.int64),
                                   "windows": [np.hanning(4)] * 12, "M": 8,
                                   "dual": "transpose"})


def test_identify_transform_round_trip():
    """Black-box calibration of a transform with another window convention
    (Blackman windows, floor-started crops, complex phase): the port's
    ``identify_transform`` returns the JAX package's tables, and the compat
    plan rebuilt from them reproduces the transform's encode."""
    sr, n_oct, bpo, spb = 4000, 3, 4, 0.25
    L = int(spb * sr)
    F = n_oct * bpo
    centers = sr / 2 / 2 ** n_oct * 2 ** (np.arange(F) / bpo)
    pos = centers * L / sr
    q = 1.0 / (2 ** (1 / bpo) - 2 ** (-1 / bpo))
    lengths = np.maximum((pos / q).astype(int) + 1, 3)
    starts = np.maximum(np.floor(pos - lengths / 2).astype(int), 0)
    M = 1 << int(np.ceil(np.log2(lengths.max())))
    wins = [np.blackman(n) * np.exp(1j * 0.37 * np.arange(n))
            for n in lengths]

    def stub_encode(batch):
        X = np.fft.fft(np.asarray(batch, dtype=np.float64), axis=-1)
        out = np.zeros(batch.shape[:2] + (F, M), dtype=np.complex128)
        for k in range(F):
            crop = np.zeros(batch.shape[:2] + (M,), dtype=np.complex128)
            crop[..., :lengths[k]] = (
                X[..., starts[k]:starts[k] + lengths[k]] * wins[k])
            out[..., k, :] = np.fft.ifft(crop, axis=-1)
        return out

    tables = identify_transform(stub_encode, L, F, batch=32)
    want = jax_identify(stub_encode, L, F, batch=32)
    np.testing.assert_array_equal(tables["starts"], starts)
    np.testing.assert_array_equal(tables["starts"], want["starts"])
    assert tables["M"] == want["M"] == M
    for a, b in zip(tables["windows"], want["windows"]):
        np.testing.assert_array_equal(a, b)
    cqt = CQT(n_oct, bpo, sr, spb, compat="cqt_pytorch",
              compat_tables=tables, device="cpu")
    audio = np.random.default_rng(11).standard_normal((2, 1, L)).astype(
        np.float32)
    ours = cqt.encode(torch.from_numpy(audio)).numpy()
    ref = stub_encode(audio)
    assert np.abs(ours - ref).max() / np.abs(ref).max() < 1e-4


def test_tables_save_load(tmp_path):
    tables = {"starts": np.array([1, 5]), "M": 8,
              "windows": [np.hanning(3), np.blackman(5) * 1j]}
    path = tmp_path / "tables.npz"
    save_tables(path, tables)
    loaded = load_tables(path)
    np.testing.assert_array_equal(loaded["starts"], tables["starts"])
    assert loaded["M"] == 8
    for a, b in zip(loaded["windows"], tables["windows"]):
        np.testing.assert_allclose(a, b)


def test_expected_samples_match_jax():
    ref_cqt, cqt = JaxCQT(**FLAGSHIP), CQT(**FLAGSHIP, device="cpu")
    for secs in (3.0, -1.0, 0.5, 100.0):
        assert cqt.get_expected_samples(secs) == \
            ref_cqt.get_expected_samples(secs)
