"""The port's comparison and parity CLIs
(timbre_trap_tpu_torch.experiments.comparison and .parity) against the JAX
package's ``experiments/comparison.py`` and ``experiments/parity.py``,
loaded in this process by ``runpy.run_path``, on the CPU:

* comparison: on the toy Bach10 of ``tests/test_comparison_cli.py`` (two
  pure tones, 22.05 kHz, the CLI's fixed 9 x 60-bin CQT), the lin-CQT and
  log-CQT ``mpe/*`` results of the port's ``main([... "--device",
  "cpu"])`` within 1e-6 of the JAX CLI's ``build_estimators`` +
  ``evaluate_method``; ``--basic-pitch`` and ``--deep-salience`` print
  SKIP and the native baselines still run;
* parity: a toy ``.pt`` exported the JAX way (no ``.0`` segments) and the
  same weights under the port's ``.0`` names, at the small geometry (8 kHz,
  5 octaves x 12 bins, 0.5-s blocks, latent 16, complexity 1) on the compat
  frame: every loss within 1e-4 relative, the SDR within 1e-3 dB and the
  F1 within 1e-6 of JAX ``evaluate()`` on the tree the JAX importer reads
  from the same file; the JSON and the Markdown table written; a
  checkpoint of another shape refused with ``_validate``'s message.
"""

import json
import os
import runpy
import sys

import numpy as np
import pytest
import scipy.io
import torch

from timbre_trap_tpu.data.datasets.MixedMultiPitch import \
    Bach10 as JaxBach10
from timbre_trap_tpu.eval import evaluate as jax_evaluate
from timbre_trap_tpu.interop import export_torch_state_dict as jax_export
from timbre_trap_tpu.interop import import_torch_state_dict as jax_import
from timbre_trap_tpu.interop import load_torch_checkpoint as jax_load
from timbre_trap_tpu.models import TimbreTrap as JaxTimbreTrap
from timbre_trap_tpu_torch.data import download
from timbre_trap_tpu_torch.data.io import save_wav
from timbre_trap_tpu_torch.experiments import comparison, parity
from timbre_trap_tpu_torch.interop import state_dict_from_jax
from timbre_trap_tpu_torch.transform.design import midi_to_hz

torch.set_num_threads(2)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SMALL = dict(sample_rate=8000, n_octaves=5, bins_per_octave=12,
             secs_per_block=0.5, latent_size=16, model_complexity=1)
SMALL_FLAGS = ["--sample-rate", "8000", "--n-octaves", "5",
               "--bins-per-octave", "12", "--secs-per-block", "0.5",
               "--latent-size", "16", "--model-complexity", "1"]
MULTIPLIERS = {"reconstruction": 1, "transcription": 1, "consistency": 1}


def _write_bach10(root, sr, n_frames, midis):
    track = "01-AchGottundHerr"
    d = root / track
    d.mkdir(parents=True)
    secs = 0.023 + 0.010 * n_frames + 0.1
    t = np.arange(int(secs * sr)) / sr
    audio = sum(0.4 * np.sin(2 * np.pi * float(midi_to_hz(m)) * t)
                for m in midis)
    save_wav(str(d / f"{track}.wav"), audio.astype(np.float32), sr)
    gtf0 = np.zeros((4, n_frames))
    for i, m in enumerate(midis):
        gtf0[i, :] = m
    scipy.io.savemat(str(d / f"{track}-GTF0s.mat"), {"GTF0s": gtf0})
    return str(root)


@pytest.fixture(scope="module")
def toy_bach10(tmp_path_factory):
    """The toy Bach10 of tests/test_comparison_cli.py: ~4 s of C4 + G4."""
    return _write_bach10(tmp_path_factory.mktemp("bach10"), 22050, 400,
                         [60.0, 67.0])


@pytest.fixture(scope="module")
def jax_comparison():
    return runpy.run_path(os.path.join(REPO, "experiments", "comparison.py"),
                          run_name="jax_comparison")


def _assert_mpe_close(got, want, tol=1e-6):
    keys = [k for k in want if k.startswith("mpe/")]
    assert keys and sorted(k for k in got if k.startswith("mpe/")) == \
        sorted(keys)
    for key in keys:
        assert abs(got[key] - want[key]) <= tol, (key, got[key], want[key])


def test_comparison_baselines_match_jax(toy_bach10, jax_comparison, capsys):
    got = comparison.main(["--bach10-dir", toy_bach10, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "[Bach10/lin-CQT]" in out and "[Bach10/log-CQT]" in out

    args = jax_comparison["parse_args"](["--bach10-dir", toy_bach10])
    cqt = jax_comparison["CQT"](n_octaves=9, bins_per_octave=60,
                                sample_rate=args.sample_rate,
                                secs_per_block=3)
    estimators = dict(jax_comparison["build_estimators"](args, cqt))
    eval_set = jax_comparison["build_eval_sets"](args, cqt)[0]
    assert list(got) == ["Bach10"] and list(got["Bach10"]) == list(estimators)
    for tag, estimator in estimators.items():
        want = jax_comparison["evaluate_method"](eval_set, estimator,
                                                 tag=tag)
        _assert_mpe_close(got["Bach10"][tag], want)
    assert got["Bach10"]["lin-CQT"]["mpe/f1-score"] > 0.3


def test_comparison_external_flags_skip(toy_bach10, monkeypatch, capsys):
    """--basic-pitch/--deep-salience without their dependencies print a
    SKIP line each and the native baselines still run."""
    for name in ("basic_pitch", "tensorflow", "librosa"):
        monkeypatch.setitem(sys.modules, name, None)

    def no_download(url, *args, **kwargs):
        raise AssertionError(f"download attempted: {url}")

    monkeypatch.setattr(download, "stream_url_resource", no_download)
    got = comparison.main(["--bach10-dir", toy_bach10, "--device", "cpu",
                           "--basic-pitch", "--deep-salience"])
    out = capsys.readouterr().out
    assert "[basic-pitch] SKIPPED:" in out
    assert "[deep-salience] SKIPPED:" in out
    assert list(got["Bach10"]) == ["lin-CQT", "log-CQT"]


@pytest.fixture(scope="module")
def small_bach10(tmp_path_factory):
    return _write_bach10(tmp_path_factory.mktemp("bach10_8k"), 8000, 150,
                         [60.0, 67.0, 72.0])


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """{kind: path} of one small model's weights: exported the JAX way
    (no ``.0`` segments) and under the port's names; and a latent-32
    model's, which does not fit."""
    tmp = tmp_path_factory.mktemp("ckpt")
    params = JaxTimbreTrap(**SMALL, seed=4).params
    exported = {k: torch.from_numpy(np.array(v))
                for k, v in jax_export(params).items()}
    other = jax_export(JaxTimbreTrap(**dict(SMALL, latent_size=32)).params)
    paths = {kind: str(tmp / f"{kind}.pt") for kind in
             ("jax_export", "port_names", "other_shape")}
    torch.save(exported, paths["jax_export"])
    torch.save(state_dict_from_jax(params), paths["port_names"])
    torch.save({k: torch.from_numpy(np.array(v)) for k, v in other.items()},
               paths["other_shape"])
    return paths


@pytest.fixture(scope="module")
def jax_parity(checkpoints, small_bach10):
    """JAX evaluate() on the tree its importer reads from the file, on the
    compat frame."""
    model = JaxTimbreTrap(**SMALL, transform_compat="cqt_pytorch")
    model.params = jax_import(jax_load(checkpoints["jax_export"]),
                              model.params)
    eval_set = JaxBach10(base_dir=small_bach10, splits=None,
                         sample_rate=SMALL["sample_rate"], cqt=model.sliCQ)
    return {k: float(v) for k, v in
            jax_evaluate(model, eval_set, MULTIPLIERS).items()}


@pytest.mark.parametrize("kind", ["jax_export", "port_names"])
def test_parity_cli_matches_jax(checkpoints, small_bach10, jax_parity,
                                tmp_path, capsys, kind):
    out_json = str(tmp_path / "parity.json")
    got = parity.main(["--checkpoint", checkpoints[kind], "--datasets",
                       "Bach10", "--base-dirs", small_bach10, "--out",
                       out_json, "--device", "cpu"] + SMALL_FLAGS)["Bach10"]
    out = capsys.readouterr().out
    assert "onto the cqt_pytorch frame" in out and "| Bach10 |" in out
    with open(out_json) as fh:
        written = json.load(fh)
    assert written["compat"] == "cqt_pytorch"
    assert written["results"]["Bach10"] == got

    want = jax_parity
    assert set(got) == set(want)
    _assert_mpe_close(got, want)
    for key in (k for k in want if k.startswith("loss/")):
        assert abs(got[key] - want[key]) <= 1e-4 * max(abs(want[key]), 1e-6), \
            (key, got[key], want[key])
    assert np.isfinite(got["reconstruction/SDR"])
    assert abs(got["reconstruction/SDR"] - want["reconstruction/SDR"]) <= 1e-3


def test_parity_cli_refuses_a_checkpoint_of_another_shape(checkpoints,
                                                         small_bach10):
    model = JaxTimbreTrap(**SMALL)
    with pytest.raises(ValueError) as want:
        jax_import(jax_load(checkpoints["other_shape"]), model.params)
    with pytest.raises(ValueError) as got:
        parity.main(["--checkpoint", checkpoints["other_shape"],
                     "--datasets", "Bach10", "--base-dirs", small_bach10,
                     "--device", "cpu"] + SMALL_FLAGS)
    assert str(got.value).startswith("shape mismatch at ")
    assert str(got.value) == str(want.value)
