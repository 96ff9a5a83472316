"""The port's utilities (timbre_trap_tpu_torch.utils: the gradient helpers,
``enable_nan_debugging``, ``debug_nans``, ``profiling``, ``visualization``)
and the latents CLI (timbre_trap_tpu_torch.experiments.latents), on the
CPU, against the JAX package where it has the same function:

* the gradient statistics of a JAX gradient tree (a small model's
  parameter tree stands in for one) and of its port-named copy (the flat
  {parameter name: tensor} form of ``p.grad``) within 1e-6 relative of
  the JAX package's, the cases of ``tests/test_utils.py``, the empty case,
  and ``log_gradient_norms``' tags;
* ``debug_nans`` on tensors and arrays; ``enable_nan_debugging`` switches
  autograd's anomaly mode and hands back the old setting;
* ``trace`` writes a Chrome trace that holds the ``annotate`` name;
  ``Timer``;
* ``plot_magnitude`` and ``plot_latents`` save their files;
* ``collect_latents`` of each Bach10 stem within 1e-4 x max|ref| of the
  JAX model's ``encode`` on the same weights (small geometry: 8 kHz, 5
  octaves x 12 bins, 0.5-s blocks, latent 16, complexity 1), and the
  latents CLI's PDF;
* ``timbre_trap_tpu_torch.utils`` and the new entry points import in a
  fresh interpreter with matplotlib and scikit-learn blocked, and load no
  JAX module.
"""

import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import scipy.io
import torch

import jax

from timbre_trap_tpu.interop import import_torch_state_dict as jax_import
from timbre_trap_tpu.models import TimbreTrap as JaxTimbreTrap
from timbre_trap_tpu.utils import experiments as jax_experiments
from timbre_trap_tpu_torch.data.datasets.SoloMultiPitch import Bach10
from timbre_trap_tpu_torch.data.io import save_wav
from timbre_trap_tpu_torch.experiments import latents
from timbre_trap_tpu_torch.interop import state_dict_from_jax
from timbre_trap_tpu_torch.models import TimbreTrap
from timbre_trap_tpu_torch.transform.design import midi_to_hz
from timbre_trap_tpu_torch.utils import (average_gradient_norms, debug_nans,
                                         enable_nan_debugging,
                                         get_max_gradient,
                                         get_max_gradient_norm,
                                         log_gradient_norms,
                                         sum_gradient_norms)
from timbre_trap_tpu_torch.utils.profiling import Timer, annotate, trace

torch.set_num_threads(2)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
HP = dict(sample_rate=8000, n_octaves=5, bins_per_octave=12,
          secs_per_block=0.5, latent_size=16, model_complexity=1)
STATS = ("sum_gradient_norms", "average_gradient_norms", "get_max_gradient",
         "get_max_gradient_norm")
PORT_STATS = dict(zip(STATS, (sum_gradient_norms, average_gradient_norms,
                              get_max_gradient, get_max_gradient_norm)))


class Recorder:
    def __init__(self):
        self.logged = {}

    def add_scalar(self, tag, value, step):
        self.logged[tag] = (value, step)


@pytest.fixture(scope="module")
def jax_grads():
    """A JAX gradient tree (numpy leaves): a small skip model's parameter
    tree."""
    return jax.tree.map(np.asarray,
                        JaxTimbreTrap(**HP, skip_connections=True,
                                      seed=2).params)


@pytest.mark.parametrize("stat", STATS)
def test_gradient_stats_match_jax(jax_grads, stat):
    want = getattr(jax_experiments, stat)(jax_grads)
    port_named = state_dict_from_jax(jax_grads)       # {name: tensor}
    for grads in (jax_grads, port_named):
        got = PORT_STATS[stat](grads)
        assert abs(got - want) <= 1e-6 * abs(want), (stat, got, want)


def test_gradient_stats_simple_and_empty():
    nested = {"encoder": {"w": np.array([3.0, 4.0])},      # norm 5
              "decoder": {"w": np.array([0.0, -2.0])}}     # norm 2
    flat = {"encoder.w": torch.tensor([3.0, 4.0]),
            "decoder.w": torch.tensor([0.0, -2.0]), "unused.w": None}
    for grads in (nested, flat):
        assert sum_gradient_norms(grads) == pytest.approx(7.0)
        assert average_gradient_norms(grads) == pytest.approx(3.5)
        assert get_max_gradient(grads) == pytest.approx(4.0)
        assert get_max_gradient_norm(grads) == pytest.approx(5.0)
    for fn in PORT_STATS.values():
        assert fn({}) == 0.0


def test_log_gradient_norms_tags(jax_grads):
    nested = {"encoder": {"w": np.array([3.0, 4.0])}}
    flat = {"encoder.w": torch.tensor([3.0, 4.0])}
    for grads in (nested, flat):
        writer = Recorder()
        log_gradient_norms(grads, writer, i=7)
        assert writer.logged == {"gradients/norm/encoder/w":
                                 (pytest.approx(5.0), 7)}
    want, got = Recorder(), Recorder()
    jax_experiments.log_gradient_norms(jax_grads, want, i=3, prefix="g")
    log_gradient_norms(jax_grads, got, i=3, prefix="g")
    assert got.logged.keys() == want.logged.keys()
    for tag, (value, step) in want.logged.items():
        assert got.logged[tag][1] == step
        assert got.logged[tag][0] == pytest.approx(value, rel=1e-6)


def test_debug_nans():
    for clean, dirty in ((torch.ones(3), torch.tensor([1.0, float("nan")])),
                         (np.ones(3), np.array([np.nan, 1.0]))):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert debug_nans(clean) is False
        with pytest.warns(UserWarning, match="acts contains NaNs"):
            assert debug_nans(dirty, tag="acts") is True


def test_enable_nan_debugging_switches_anomaly_mode():
    before = torch.is_anomaly_enabled()
    try:
        assert enable_nan_debugging(True) == before
        assert torch.is_anomaly_enabled()
        x = torch.tensor([-1.0], requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
        assert enable_nan_debugging(False) is True
        assert not torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(before)
    assert torch.is_anomaly_enabled() == before


def test_trace_writes_the_annotation(tmp_path):
    with trace(str(tmp_path / "trace")):
        with annotate("toy-op"):
            torch.ones(64, 64).sum()
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".json")
    with open(tmp_path / "trace" / files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == "toy-op" for e in events)


def test_timer():
    timer = Timer()
    for _ in range(3):
        with timer("a"):
            pass
    with timer("b"):
        sum(range(1000))
    summary = timer.summary()
    assert summary["a"]["count"] == 3 and summary["b"]["count"] == 1
    assert set(summary["a"]) == {"total_s", "count", "mean_ms"}
    assert summary["b"]["total_s"] >= 0.0


def test_plot_magnitude_saves(tmp_path, rng):
    pytest.importorskip("matplotlib")
    from timbre_trap_tpu_torch.utils.visualization import plot_magnitude

    out = str(tmp_path / "mag.png")
    fig = plot_magnitude(torch.from_numpy(rng.uniform(size=(30, 50))),
                         extent=[0, 1, 20, 80], colorbar=True, save_path=out)
    assert fig is not None and os.path.getsize(out) > 0


def test_plot_latents_saves(tmp_path, rng):
    pytest.importorskip("matplotlib")
    pytest.importorskip("sklearn")
    from timbre_trap_tpu_torch.utils.visualization import plot_latents

    out = str(tmp_path / "latents.pdf")
    plot_latents(rng.standard_normal((12, 8)).astype(np.float32),
                 ["violin"] * 6 + ["cello"] * 6, save_path=out)
    assert os.path.getsize(out) > 0


@pytest.fixture(scope="module")
def stems(tmp_path_factory):
    """A Bach10 piece with its four instrument stems at 8 kHz."""
    root = tmp_path_factory.mktemp("bach10")
    track = "01-AchGottundHerr"
    d = root / track
    d.mkdir()
    sr, n_frames = HP["sample_rate"], 150
    t = np.arange(int((0.023 + 0.010 * n_frames + 0.1) * sr)) / sr
    midis = [55.0, 60.0, 64.0, 67.0]
    for ins, m in zip(Bach10.INSTRUMENTS, midis):
        stem = 0.4 * np.sin(2 * np.pi * float(midi_to_hz(m)) * t)
        save_wav(str(d / f"{track}-{ins}.wav"), stem.astype(np.float32), sr)
    save_wav(str(d / f"{track}.wav"), np.zeros_like(t, np.float32), sr)
    scipy.io.savemat(str(d / f"{track}-GTF0s.mat"), {"GTF0s": np.tile(
        np.asarray(midis)[:, None], (1, n_frames))})
    return str(root)


def test_latents_match_jax_and_cli_plots(stems, tmp_path):
    model = TimbreTrap(**HP, seed=6, device="cpu")
    eval_set = Bach10(base_dir=stems, splits=None,
                      sample_rate=HP["sample_rate"], cqt=model.sliCQ)
    got, labels = latents.collect_latents(model, eval_set)
    assert labels == Bach10.INSTRUMENTS
    assert got.shape == (4, HP["latent_size"])

    jax_model = JaxTimbreTrap(**HP)
    jax_model.params = jax_import(model.net.state_dict(), jax_model.params)
    for row, data in zip(got, eval_set):
        audio = np.asarray(data["audio"], np.float32)[None]
        audio = np.pad(audio, [(0, 0), (0, 0),
                               (0, -audio.shape[-1] % model.sliCQ.block_length)])
        z, _, _ = jax_model.encode(audio)
        want = np.asarray(z)[0].mean(axis=-1)
        assert np.abs(row - want).max() <= 1e-4 * np.abs(want).max()

    pytest.importorskip("matplotlib")
    pytest.importorskip("sklearn")
    ckpt = str(tmp_path / "model")
    model.save(ckpt)
    out = str(tmp_path / "latents.pdf")
    assert latents.main(["--checkpoint", ckpt, "--bach10-dir", stems,
                         "--output", out, "--sample-rate",
                         str(HP["sample_rate"]), "--device", "cpu"]) == out
    assert os.path.getsize(out) > 1000


def test_import_needs_neither_matplotlib_nor_sklearn_nor_jax():
    code = ("import sys\n"
            "sys.modules['matplotlib'] = None\n"
            "sys.modules['sklearn'] = None\n"
            "import timbre_trap_tpu_torch.utils\n"
            "from timbre_trap_tpu_torch.utils import profiling, "
            "visualization\n"
            "from timbre_trap_tpu_torch.eval import external, quality\n"
            "from timbre_trap_tpu_torch.experiments import (comparison, "
            "latents, parity)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'timbre_trap_tpu', "
            "'tensorflow')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
