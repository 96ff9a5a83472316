"""The port's command-line entry points (timbre_trap_tpu_torch.experiments:
train, evaluate, sonify) against the JAX package's ``experiments/*.py``,
each loaded by path, on the CPU:

* train: with the Trainer replaced by a recorder, both CLIs build the same
  ``TrainerConfig``, the same loaders (batch split, workers, seeds) and the
  same training and validation datasets (class, splits, tracks, crop RNG),
  and print the same "skipping validation set" lines, for ``--debug``, the
  full split and ``--audio-datasets fma,medleydb_mixtures``;
* evaluate: both CLIs build the same five sets from the same flags; a
  small model (8 kHz, 5 octaves x 12 bins, latent 16, complexity 1),
  saved by the JAX package and rebuilt in the port from the same
  parameters, on a synthetic Bach10 set: every loss within 1e-4
  relative, the SDR within 1e-3 dB, ``mpe/*`` equal;
* sonify: the same model writes the same three WAVs a track, the audio
  within 1e-5 (``_ref``) and 1e-4 x max|ref| (``_rec``; ``_scr`` with the
  port's transcription chain in float32, the precision the JAX package runs
  on the CPU; bf16, the port's default, within 5e-2 x max|ref|);
* refusals: ``--n-devices 2`` in one process (``--distributed`` without
  a cluster trains on one device), and a missing card without ``--device
  cpu`` (that importing the CLIs loads no JAX module is
  held in ``tests/test_torch_datasets.py``).

A real training run through the train CLI, at its fixed latent 128 and
complexity 2, is ``chip_smoke.py``'s (phase 3g): on the CPU it would take
this file past its time budget. Everything here runs on the CPU; JAX is
imported only to compare.
"""

import ast
import dataclasses
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax

from test_datasets import SR, _tone, bach10_dir, trios_dir  # noqa: F401
from test_torch_datasets import fma_dir, medleydb_dir, su_dir  # noqa: F401
from timbre_trap_tpu.models import TimbreTrap as JaxTimbreTrap
from timbre_trap_tpu_torch.data.io import save_wav
from timbre_trap_tpu_torch.experiments import evaluate as port_evaluate
from timbre_trap_tpu_torch.experiments import sonify as port_sonify
from timbre_trap_tpu_torch.experiments import train as port_train
from timbre_trap_tpu_torch.models import TimbreTrap, load_model
from timbre_trap_tpu_torch.transform.design import midi_to_hz

torch.set_num_threads(2)

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
HP = dict(sample_rate=SR, n_octaves=5, bins_per_octave=12,
          secs_per_block=0.5, latent_size=16, model_complexity=1)
GEOMETRY = ["--sample-rate", str(SR), "--n-octaves", "5",
            "--bins-per-octave", "12"]
MODEL_FLAGS = GEOMETRY + ["--latent-size", "16", "--model-complexity", "1"]


def _load_jax_cli(name):
    """The JAX package's ``experiments/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_cli_{name}", os.path.join(REPO, "experiments", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def jax_cli():
    return {name: _load_jax_cli(name)
            for name in ("train", "evaluate", "sonify")}


# --------------------------------------------------------------------- #
# Corpora                                                                #
# --------------------------------------------------------------------- #

def _write_urmp_piece(root, piece, midis, secs=1.0):
    """A URMP piece directory: the mixture, one stem and one F0 file an
    instrument."""
    names = ["vn", "va", "vc"][:len(midis)]
    track = f"{piece}_" + "_".join(names)
    d = os.path.join(root, track)
    os.makedirs(d)
    save_wav(os.path.join(d, f"AuMix_{track}.wav"),
             sum(_tone(m, secs) for m in midis) / len(midis), SR)
    times = np.arange(0, secs, 0.01)
    for i, (ins, m) in enumerate(zip(names, midis), 1):
        stem = f"{i}_{ins}_{piece}"
        save_wav(os.path.join(d, f"AuSep_{stem}.wav"), _tone(m, secs), SR)
        np.savetxt(os.path.join(d, f"F0s_{stem}.txt"),
                   np.stack([times, np.full_like(times,
                                                 float(midi_to_hz(m)))], -1))


@pytest.fixture()
def urmp_corpus(tmp_path):
    """Two pieces of the validation splits (01, 12) and two of the
    training ones (03, 44)."""
    root = str(tmp_path / "URMP")
    for piece, midis in (("01_Jupiter", [69, 57]), ("12_Spring", [64, 60]),
                         ("03_Dance", [67, 55, 48]), ("44_Final", [72, 60])):
        _write_urmp_piece(root, piece, midis)
    return root


@pytest.fixture()
def gset_dir(tmp_path):
    root = tmp_path / "GuitarSet"
    (root / "annotation").mkdir(parents=True)
    (root / "audio_mono-mic").mkdir()
    for track in ("05_Funk1-97-C_comp", "00_Jazz1-130-D_solo"):
        data = [{"time": t, "duration": 0.0,
                 "value": {"frequency": 220.0, "voiced": True, "index": 0}}
                for t in np.arange(0.0, 0.9, 0.02)]
        jam = {"file_metadata": {"duration": 1.0},
               "annotations": [{"namespace": "pitch_contour", "data": data}]}
        with open(root / "annotation" / f"{track}.jams", "w") as fh:
            json.dump(jam, fh)
        save_wav(str(root / "audio_mono-mic" / f"{track}_mic.wav"),
                 _tone(57), SR)
    return str(root)


# --------------------------------------------------------------------- #
# (a) train: the same datasets, loaders and TrainerConfig                #
# --------------------------------------------------------------------- #

def _record_trainer(monkeypatch, module):
    """Replace ``module.Trainer`` by a recorder; returns what it records."""
    seen = {}

    class Recorder:
        def __init__(self, model, mpe_loader, audio_loader, validation_sets,
                     config, writer=None):
            seen.update(model=model, mpe_loader=mpe_loader,
                        audio_loader=audio_loader,
                        validation_sets=validation_sets, config=config,
                        writer=writer)

        def run(self):
            return None, None

    monkeypatch.setattr(module, "Trainer", Recorder)
    return seen


def _dataset(ds):
    return {"class": type(ds).__name__, "name": ds.name(),
            "tracks": ds.tracks, "n_secs": ds.n_secs,
            "sample_rate": ds.sample_rate, "base_dir": ds.base_dir,
            "rng": ds.rng.get_state()[1].tolist()}


def _loader(loader):
    if loader is None:
        return None
    return {"batch_size": loader.batch_size,
            "num_workers": loader.num_workers, "shuffle": loader.shuffle,
            "drop_last": loader.drop_last, "seed": loader.seed,
            "datasets": [_dataset(d) for d in loader.dataset.datasets]}


def _summary(seen, out):
    return {"config": dataclasses.asdict(seen["config"]),
            "hparams": seen["model"].hparams,
            "mpe_loader": _loader(seen["mpe_loader"]),
            "audio_loader": _loader(seen["audio_loader"]),
            "validation": [_dataset(d) for d in seen["validation_sets"]],
            "writer": type(seen["writer"]).__name__,
            "skipping": [line for line in out.splitlines()
                         if line.startswith("skipping")]}


@pytest.mark.parametrize("case", ["debug", "full", "audio"])
def test_train_cli_wires_what_the_jax_cli_wires(case, jax_cli, monkeypatch,
                                                capsys, tmp_path,
                                                urmp_corpus, trios_dir,
                                                gset_dir, fma_dir,
                                                medleydb_dir):
    argv = GEOMETRY + ["--urmp-dir", urmp_corpus,
                       "--root-dir", str(tmp_path / "run"),
                       "--max-epochs", "3", "--checkpoint-interval", "5"]
    if case == "debug":
        argv += ["--debug", "--batch-size", "2"]
    else:
        # Bach10 and Su are absent: both CLIs skip them (their wrappers
        # refuse to download). TRIOS and GuitarSet are present.
        argv += ["--trios-dir", trios_dir, "--gset-dir", gset_dir,
                 "--bach10-dir", str(tmp_path / "no_bach10"),
                 "--su-dir", str(tmp_path / "no_su"), "--n-workers", "6"]
    if case == "audio":
        argv += ["--audio-datasets", "fma,medleydb_mixtures",
                 "--fma-dir", fma_dir, "--medleydb-dir", medleydb_dir,
                 "--n-epochs-late-start", "1", "--conv-backend", "pallas"]

    seen = _record_trainer(monkeypatch, jax_cli["train"])
    monkeypatch.setattr(sys, "argv", ["train.py"] + argv)
    jax_cli["train"].main()
    want = _summary(seen, capsys.readouterr().out)

    seen = _record_trainer(monkeypatch, port_train)
    assert port_train.main(argv + ["--device", "cpu"]) == (None, None)
    got = _summary(seen, capsys.readouterr().out)

    assert got == want
    assert want["mpe_loader"]["batch_size"] == (2 if case == "debug" else
                                                4 if case == "audio" else 8)
    assert [v["class"] for v in want["validation"]] == (
        ["URMPMixtures"] if case == "debug"
        else ["URMPMixtures", "TRIOSMixtures", "GuitarSet"])
    if case != "debug":
        assert len(want["skipping"]) == 2
    if case == "audio":
        assert [d["class"] for d in want["audio_loader"]["datasets"]] == [
            "FMA_L", "MedleyDBMixtures"]


# --------------------------------------------------------------------- #
# (b) evaluate and (c) sonify on both packages, the same weights          #
# --------------------------------------------------------------------- #

@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """The small model saved by the JAX package, and the port's model of
    the same parameters saved by the port."""
    root = tmp_path_factory.mktemp("ckpt")
    jax_model = JaxTimbreTrap(**HP)
    jax_model.save(str(root / "jax"))
    port_model = TimbreTrap(**HP, device="cpu")
    port_model.load_jax_params(jax.tree.map(np.asarray, jax_model.params))
    port_model.save(str(root / "port"))
    return str(root / "jax"), str(root / "port")


def _printed_results(out):
    """{name: results} from the "[name] {...}" lines of the evaluate CLI."""
    results = {}
    for line in out.splitlines():
        if line.startswith("["):
            name, _, rest = line.partition("] ")
            results[name[1:]] = ast.literal_eval(rest)
    return results


def test_evaluate_cli_matches_jax(jax_cli, checkpoints, bach10_dir,
                                  monkeypatch, capsys, tmp_path):
    jax_ckpt, port_ckpt = checkpoints
    argv = ["--datasets", "Bach10", "--base-dirs", bach10_dir] + MODEL_FLAGS
    monkeypatch.setattr(sys, "argv", ["evaluate.py", "--checkpoint",
                                      jax_ckpt] + argv)
    jax_cli["evaluate"].main()
    want = _printed_results(capsys.readouterr().out)

    log = str(tmp_path / "eval.log")
    returned = port_evaluate.main(["--checkpoint", port_ckpt, "--device",
                                   "cpu", "--log-path", log] + argv)
    got = _printed_results(capsys.readouterr().out)
    assert got == returned
    with open(log) as fh:
        assert _printed_results(fh.read()) == got

    assert set(got) == set(want) == {"Bach10"}
    got, want = got["Bach10"], want["Bach10"]
    assert set(got) == set(want)
    for key, value in want.items():
        if key.startswith("mpe/"):
            assert got[key] == value, key
        elif key == "reconstruction/SDR":
            assert abs(got[key] - value) <= 1e-3, (key, got[key], value)
        else:
            assert got[key] == pytest.approx(value, rel=1e-4), key


def test_evaluate_cli_builds_the_jax_cli_sets(jax_cli, checkpoints,
                                              monkeypatch, capsys,
                                              urmp_corpus, bach10_dir,
                                              su_dir, trios_dir, gset_dir):
    """With ``evaluate`` replaced by a recorder, both CLIs build the same
    five sets (class, splits, tracks, sample rate) from the same flags."""
    names = ["Bach10", "URMP", "Su", "TRIOS", "GuitarSet"]
    argv = (["--datasets"] + names + ["--base-dirs", bach10_dir, urmp_corpus,
                                      su_dir, trios_dir, gset_dir]
            + MODEL_FLAGS)

    def record(module):
        sets = []
        monkeypatch.setattr(module, "evaluate", lambda model, ds, mult: (
            sets.append((_dataset(ds), mult)) or {}))
        return sets

    want = record(jax_cli["evaluate"])
    monkeypatch.setattr(sys, "argv", ["evaluate.py", "--checkpoint",
                                      checkpoints[0]] + argv)
    jax_cli["evaluate"].main()
    got = record(port_evaluate)
    port_evaluate.main(["--checkpoint", checkpoints[1], "--device", "cpu"]
                       + argv)
    capsys.readouterr()
    assert got == want
    assert [ds["class"] for ds, _ in got] == [
        "Bach10Mixtures", "URMPMixtures", "Su", "TRIOSMixtures", "GuitarSet"]
    assert got[-1][0]["tracks"] == ["05_Funk1-97-C_comp"]


def _record_wavs(monkeypatch, module):
    """Record the float audio ``module`` writes, by file name."""
    written = {}

    def record(path, audio, sample_rate):
        written[os.path.basename(path)] = np.array(audio, np.float32)
        save_wav(path, audio, sample_rate)

    monkeypatch.setattr(module, "save_wav", record)
    return written


def test_sonify_cli_matches_jax(jax_cli, checkpoints, bach10_dir,
                                monkeypatch, tmp_path):
    jax_ckpt, port_ckpt = checkpoints
    argv = ["--bach10-dir", bach10_dir] + MODEL_FLAGS

    want = _record_wavs(monkeypatch, jax_cli["sonify"])
    monkeypatch.setattr(sys, "argv", [
        "sonify.py", "--checkpoint", jax_ckpt,
        "--output-dir", str(tmp_path / "jax")] + argv)
    jax_cli["sonify"].main()

    runs = {}
    for fused in ("auto", "f32"):
        # The JAX package runs its transcription chain in float32 on the
        # CPU; the port's default runs it in bf16.
        monkeypatch.setattr(port_sonify, "load_model",
                            lambda path, overrides, defaults, fused=fused:
                            load_model(path, overrides=dict(overrides,
                                                            fused=fused),
                                       defaults=defaults))
        runs[fused] = _record_wavs(monkeypatch, port_sonify)
        out_dir = tmp_path / f"port_{fused}"
        port_sonify.main(["--checkpoint", port_ckpt, "--output-dir",
                          str(out_dir), "--device", "cpu"] + argv)
        assert sorted(os.listdir(out_dir)) == sorted(want)

    assert sorted(want) == ["01-AchGottundHerr_rec.wav",
                            "01-AchGottundHerr_ref.wav",
                            "01-AchGottundHerr_scr.wav"]
    for name, ref in want.items():
        scale = float(np.abs(ref).max())
        for fused, written in runs.items():
            got = written[name]
            assert got.shape == ref.shape and np.isfinite(got).all(), name
            err = float(np.abs(got - ref).max())
            if name.endswith("_ref.wav"):
                assert err <= 1e-5, (name, fused, err)
            elif name.endswith("_rec.wav") or fused == "f32":
                assert err <= 1e-4 * scale, (name, fused, err)
            else:
                assert err <= 5e-2 * scale, (name, fused, err)


# --------------------------------------------------------------------- #
# (d) refusals                                                           #
# --------------------------------------------------------------------- #

@pytest.mark.parametrize("flags", [["--n-devices", "2"], ["--distributed"]])
def test_train_cli_refuses_multi_device(flags, urmp_corpus, tmp_path,
                                        monkeypatch, caplog):
    """One process per device: ``--n-devices 2`` in one process exits
    with the ``torchrun`` command that starts two ranks, before it builds
    anything; ``--distributed`` with no cluster in the environment logs
    that and trains on one device (the Trainer replaced by a recorder)."""
    for key in ("WORLD_SIZE", "RANK", "MASTER_ADDR"):
        monkeypatch.delenv(key, raising=False)
    seen = _record_trainer(monkeypatch, port_train)
    argv = ["--debug", "--urmp-dir", urmp_corpus, "--root-dir",
            str(tmp_path / "run"), "--device", "cpu"] + GEOMETRY + flags
    if flags[0] == "--n-devices":
        with pytest.raises(SystemExit,
                           match="torchrun --nproc-per-node 2 -m "
                                 "timbre_trap_tpu_torch.experiments.train"):
            port_train.main(argv)
        assert not seen and not (tmp_path / "run").exists()
        return
    with caplog.at_level("INFO"):
        assert port_train.main(argv) == (None, None)
    assert "no cluster" in caplog.text
    assert not torch.distributed.is_initialized()
    assert seen["config"].n_devices is None
    assert seen["model"].device == torch.device("cpu")


@pytest.mark.parametrize("cli", ["train", "evaluate", "sonify"])
def test_clis_refuse_to_run_on_the_cpu_unasked(cli, monkeypatch, checkpoints,
                                               urmp_corpus, bach10_dir,
                                               tmp_path):
    """With no card and no ``--device``, each CLI raises instead of
    running on the CPU, and writes nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out"
    argv = {"train": (port_train, ["--debug", "--urmp-dir", urmp_corpus,
                                   "--root-dir", str(out)] + GEOMETRY),
            "evaluate": (port_evaluate, ["--checkpoint", checkpoints[1],
                                         "--base-dirs", bach10_dir]),
            "sonify": (port_sonify, ["--checkpoint", checkpoints[1],
                                     "--bach10-dir", bach10_dir,
                                     "--output-dir", str(out)])}
    module, args = argv[cli]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(args)
    assert not out.exists()

