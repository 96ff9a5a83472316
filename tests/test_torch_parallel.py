"""The port's multi-device layer (timbre_trap_tpu_torch.parallel, the
sharded train step and the data-parallel Trainer) against the JAX
package's, on the CPU at the small geometry (8 kHz, 5 octaves x 12 bins,
0.5-s blocks, latent 16, complexity 1), two torch threads a process.

The JAX package drives N devices from one process (the virtual 8-device
CPU mesh of ``tests/conftest.py``); the port runs one process per device.
So the port's side runs in gloo ranks that this file spawns as worker
processes (it doubles as the worker script, ``python
tests/test_torch_parallel.py <job> <rank> <world> <port> <workdir>``; the
workers import no JAX) and writes its results for the tests to compare:

* the row plan, ``local_batch_slice`` and ``initialize`` in-process;
* two ranks, one ``shard_train_step`` on a 2 + 2 batch ("packed" and
  "flax") against the JAX package's ``shard_train_step`` on
  ``make_mesh(2)`` (losses rel 1e-4, Adam's mu 1e-4 x each leaf's max,
  parameters 5e-4, the bars of ``test_torch_train.py``'s
  ``test_step_matches_jax``) and against the port's single-rank step on
  the whole batch (gradients and parameters within 1e-5 x each leaf's
  max, or, where two float32 gradients part by more, within 3x the
  single-rank step's distance from float64), and under gradient
  accumulation (each call's gradients reduced before they are folded);
* ``make_sharded_chunked_inference`` on two ranks (a 3.4-block clip,
  transcribe) and on four (B = 2, no transcribe) against the JAX
  package's on ``make_mesh(2)`` and ``make_mesh(4)`` (atol 2e-5, the JAX
  tests' bar) and against the port's ``chunked_inference``;
* the Trainer with ``n_devices=2`` against the single-device Trainer on
  the same corpus (rtol 2e-3, atol 2e-5 after 2 steps, the bar of the
  JAX package's ``test_trainer_data_parallel``); only rank 0 writes the
  run directory, and each rank's dataset loads only its rows.

Every rank joins its group with a timeout and every wait on a worker has
one, so a hung rank fails its test instead of eating the suite's time.
"""

import datetime
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from timbre_trap_tpu_torch import parallel  # noqa: E402
from timbre_trap_tpu_torch.data import DataLoader, MPEDataset  # noqa: E402
from timbre_trap_tpu_torch.data.io import save_wav  # noqa: E402
from timbre_trap_tpu_torch.models import TimbreTrap  # noqa: E402
from timbre_trap_tpu_torch.train import (TrainConfig, Trainer,  # noqa: E402
                                         TrainerConfig, init_train_state,
                                         make_train_step, shard_train_step)
from timbre_trap_tpu_torch.transform.design import midi_to_hz  # noqa: E402

torch.set_num_threads(2)

SR = 8000
HP = dict(sample_rate=SR, n_octaves=5, bins_per_octave=12,
          secs_per_block=0.5, latent_size=16, model_complexity=1)
STEP_BACKENDS = ("packed", "flax")
# A rank waits this long for the others; a test this long for its ranks.
JOIN_TIMEOUT = datetime.timedelta(seconds=120)
WAIT_S = 300


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class TrackingToyMPE(MPEDataset):
    """``tests/test_loop.py``'s toy corpus (a .wav and a .f0.npy a track),
    recording every item it loads."""

    accessed = None

    @staticmethod
    def available_splits():
        return ["all"]

    def get_tracks(self, split):
        return sorted(f[:-4] for f in os.listdir(self.base_dir)
                      if f.endswith(".wav"))

    def get_audio_path(self, track):
        return os.path.join(self.base_dir, f"{track}.wav")

    def get_ground_truth_path(self, track):
        return os.path.join(self.base_dir, f"{track}.f0.npy")

    def get_ground_truth(self, track):
        d = np.load(self.get_ground_truth_path(track),
                    allow_pickle=True).item()
        return d["times"], [np.asarray(p) for p in d["pitches"]]

    def __getitem__(self, index):
        if self.accessed is None:
            self.accessed = []
        self.accessed.append(int(index))
        return super().__getitem__(index)


def _model(workdir, **kw):
    m = TimbreTrap(**HP, device="cpu", **kw)
    m.load_state_dict(torch.load(os.path.join(workdir, "weights.pt")))
    return m


def _trainer(workdir, model, n_devices, root):
    """The data-parallel case of ``tests/test_loop.py``: batch 4 of whole
    tracks, 2 epochs of 1 step, a checkpoint and a sweep at step 2."""
    corpus = os.path.join(workdir, "corpus")
    train_set = TrackingToyMPE(base_dir=corpus, splits=["all"],
                               sample_rate=SR, cqt=model.sliCQ, n_secs=None,
                               seed=0)
    val_set = TrackingToyMPE(base_dir=corpus, splits=["all"], sample_rate=SR,
                             cqt=model.sliCQ, n_secs=None, seed=0)
    loader = DataLoader(train_set, batch_size=4, shuffle=False,
                        drop_last=True)
    config = TrainerConfig(max_epochs=2, checkpoint_interval=2, batch_size=4,
                           n_secs=None, learning_rate=1e-3,
                           n_epochs_warmup=1, n_devices=n_devices,
                           validation_criteria_set=val_set.name(),
                           conv_backend="flax", root_dir=root)
    return Trainer(model, loader, None, [val_set], config), train_set


def _step_result(model, state, metrics):
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.clone() for n, p in
                      model.net.named_parameters()},
            "mu": {n: t.clone() for n, t in state["mu"].items()},
            "params": {k: v.clone() for k, v in
                       model.net.state_dict().items()}}


# --------------------------------------------------------------------- #
# The worker (a rank)                                                    #
# --------------------------------------------------------------------- #

def _worker(job, rank, world, port, workdir):
    assert parallel.initialize(f"127.0.0.1:{port}", world, rank,
                               timeout=JOIN_TIMEOUT)
    assert parallel.is_multi_host()
    mesh = parallel.make_mesh(world)
    inputs = np.load(os.path.join(workdir, "inputs.npz"))
    rows = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    out = {"local_batch_slice": parallel.local_batch_slice(8),
           "shard_batch": parallel.shard_batch(mesh, {"x": rows,
                                                      "y": [rows[:4]]}),
           "shard_global_batch": parallel.shard_global_batch(
               mesh, (rows[:2],), local=True),
           "placements": (parallel.replicated(mesh),
                          parallel.batch_sharded(mesh))}
    if job == "two":
        plan = parallel.plan_local_rows(2, 2)
        audio, gt = inputs["audio"], inputs["gt"]
        local = (np.concatenate([audio[:2][plan.mpe_rows],
                                 audio[2:][plan.audio_rows]]),
                 gt[plan.mpe_rows])
        for backend in STEP_BACKENDS:
            model = _model(workdir)
            cfg = TrainConfig()
            state = init_train_state(model, cfg)
            step = shard_train_step(make_train_step(
                model, cfg, len(plan.gt_pos), conv_backend=backend), mesh)
            out[backend] = _step_result(model, state,
                                        step(state, *local, 1e-3))
        model = _model(workdir)
        cfg = TrainConfig(grad_accum_steps=2)
        state = init_train_state(model, cfg)
        step = shard_train_step(make_train_step(
            model, cfg, len(plan.gt_pos), conv_backend="flax"), mesh)
        for lr in (1e-3, 2e-3):
            step(state, *local, lr)
        out["accumulated"] = {k: v.clone() for k, v in
                              model.net.state_dict().items()}
        model = _model(workdir, fused="f32")
        run = parallel.make_sharded_chunked_inference(model, mesh, True)
        out["inference"] = run(inputs["clip"])
        trainer, train_set = _trainer(workdir, _model(workdir), world,
                                      os.path.join(workdir, f"run{rank}"))
        trainer.run()
        out["trainer"] = {"params": dict(trainer.model.net.state_dict()),
                          "accessed": train_set.accessed,
                          "batch_count": trainer.batch_count,
                          "best": (trainer.best_checkpoint,
                                   trainer.best_results)}
    else:
        model = _model(workdir)
        run = parallel.make_sharded_chunked_inference(model, mesh, False)
        out["inference"] = run(inputs["clip_b2"])
    torch.save(out, os.path.join(workdir, f"{job}-rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def _spawn(workdir, job, world):
    """Run ``job`` on ``world`` gloo ranks; returns each rank's results."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), job, str(r), str(world),
         str(port), workdir], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WAIT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {job} failed:\n{out}"
    return [torch.load(os.path.join(workdir, f"{job}-rank{r}.pt"),
                       weights_only=False) for r in range(world)]


# --------------------------------------------------------------------- #
# Fixtures: the shared inputs, the ranks' results, the JAX side          #
# --------------------------------------------------------------------- #

def _write_corpus(root):
    """Four 1.5-s tones with their f0, as ``tests/test_loop.py`` writes."""
    os.makedirs(root)
    for i, midi in enumerate([57.0, 60.0, 64.0, 69.0]):
        f = float(midi_to_hz(midi))
        n = int(1.5 * SR)
        audio = 0.5 * np.sin(2 * np.pi * f * np.arange(n) / SR)
        save_wav(os.path.join(root, f"tr{i}.wav"), audio.astype(np.float32),
                 SR)
        times = np.arange(0, 1.5, 0.01)
        np.save(os.path.join(root, f"tr{i}.f0.npy"),
                {"times": times, "pitches": [np.array([f])] * len(times)})


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The JAX model's initial weights (saved for the ranks as the port's
    state_dict), a 2 MPE + 2 audio-only batch, the two clips, the
    corpus: (workdir, JAX model, arrays)."""
    import jax

    from timbre_trap_tpu.models import TimbreTrap as JaxTimbreTrap
    from timbre_trap_tpu_torch.interop import state_dict_from_jax

    workdir = str(tmp_path_factory.mktemp("parallel"))
    ref = JaxTimbreTrap(**HP)
    torch.save(state_dict_from_jax(jax.tree.map(np.asarray, ref.params)),
               os.path.join(workdir, "weights.pt"))
    rng = np.random.default_rng(0)
    L, M = ref.sliCQ.block_length, ref.sliCQ.max_window_length
    arrays = {
        "audio": (rng.standard_normal((4, 1, L)) * 0.1).astype(np.float32),
        "gt": (rng.uniform(size=(2, ref.sliCQ.n_bins, M)) > 0.95
               ).astype(np.float32),
        "clip": rng.standard_normal((1, 1, int(3.4 * L))).astype(np.float32),
        "clip_b2": rng.standard_normal((2, 1, 2 * L)).astype(np.float32)}
    np.savez(os.path.join(workdir, "inputs.npz"), **arrays)
    _write_corpus(os.path.join(workdir, "corpus"))
    return workdir, ref, arrays


@pytest.fixture(scope="module")
def two_ranks(inputs):
    return _spawn(inputs[0], "two", 2)


@pytest.fixture(scope="module")
def four_ranks(inputs):
    return _spawn(inputs[0], "four", 4)


@pytest.fixture(scope="module")
def jax_sharded_step(inputs):
    """The JAX package's ``shard_train_step`` over ``make_mesh(2)`` on the
    global batch ("flax" backend): (new parameters, Adam mu, metrics), as
    numpy."""
    import jax

    from timbre_trap_tpu.parallel import make_mesh, shard_batch
    from timbre_trap_tpu.train import step as jax_step

    _, ref, arrays = inputs
    cfg = TrainConfig()
    mesh = make_mesh(2)
    # JAX's "flax" backend: the same function as its "packed" one, whose
    # jit takes several times as long on the CPU.
    step = jax_step.shard_train_step(jax_step.make_train_step(
        ref, cfg, mpe_batch_size=2, conv_backend="flax"), mesh)
    params, opt = jax_step.init_train_state(ref, cfg)
    audio, gt = shard_batch(mesh, (arrays["audio"], arrays["gt"]))
    new, opt, metrics = step(params, opt, audio, gt, 1e-3)
    to_np = lambda t: jax.tree.map(np.asarray, t)   # noqa: E731
    return (to_np(new), to_np(opt[1].mu),
            {k: float(v) for k, v in metrics.items()})


# --------------------------------------------------------------------- #
# In one process                                                         #
# --------------------------------------------------------------------- #

def test_parallel_exports_the_jax_packages_names():
    from timbre_trap_tpu import parallel as jax_parallel

    assert parallel.__all__ == jax_parallel.__all__
    assert all(callable(getattr(parallel, n)) or n == "DATA_AXIS"
               for n in parallel.__all__)
    assert parallel.DATA_AXIS == jax_parallel.DATA_AXIS


@pytest.mark.parametrize("mpe,audio,n", [(4, 4, 2), (4, 0, 4), (2, 2, 2)])
def test_plan_local_rows_keeps_each_item_on_one_rank(mpe, audio, n):
    """Rank p loads MPE rows [p m/n, (p+1) m/n) and audio-only rows
    [p a/n, (p+1) a/n): the ranks tile both loaders' batches, every
    ground-truth row's audio lies on its rank (``gt_pos`` and
    ``mpe_audio_pos`` select the same items), and a rank loads (m + a)/n
    items. One process needs no plan."""
    assert parallel.plan_local_rows(mpe, audio, n_processes=1,
                                    process_index=0) is None
    mpe_cover, audio_cover = [], []
    for p in range(n):
        plan = parallel.plan_local_rows(mpe, audio, n_processes=n,
                                        process_index=p)
        gt_items = [plan.mpe_rows[i] for i in plan.gt_pos]
        audio_items = [plan.mpe_rows[i] for i in plan.mpe_audio_pos]
        assert gt_items == audio_items == plan.mpe_rows
        assert plan.mpe_rows == list(range(p * mpe // n, (p + 1) * mpe // n))
        assert plan.audio_rows == list(range(p * audio // n,
                                             (p + 1) * audio // n))
        assert len(plan.mpe_rows) + len(plan.audio_rows) == (mpe + audio) // n
        mpe_cover += plan.mpe_rows
        audio_cover += plan.audio_rows
    assert mpe_cover == list(range(mpe)) and audio_cover == list(range(audio))


def test_plan_local_rows_refuses_indivisible_batches():
    for mpe, audio, n in [(3, 4, 2), (2, 1, 2), (4, 4, 3)]:
        with pytest.raises(ValueError, match="must divide"):
            parallel.plan_local_rows(mpe, audio, n_processes=n,
                                     process_index=0)


def test_local_batch_slice_and_mesh_in_one_process():
    """Without a process group: one rank, the whole batch, and a mesh of
    two devices refuses and says how to start two processes."""
    assert not torch.distributed.is_initialized()
    assert not parallel.is_multi_host()
    assert parallel.local_batch_slice(8) == (0, 8)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 2"):
        parallel.make_mesh(2)


def test_initialize_raises_on_an_unreachable_coordinator():
    """An explicitly requested group that cannot form raises (and logs),
    never degrading quietly to one process: rank 0 of 2 whose peer never
    comes, and an incomplete request."""
    port = _free_port()
    with pytest.raises(RuntimeError):
        parallel.initialize(f"127.0.0.1:{port}", 2, 0,
                            timeout=datetime.timedelta(seconds=2))
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="together"):
        parallel.initialize(num_processes=2, process_id=0)


def test_initialize_without_a_cluster_returns_false(monkeypatch, caplog):
    for key in ("WORLD_SIZE", "RANK", "MASTER_ADDR"):
        monkeypatch.delenv(key, raising=False)
    with caplog.at_level("INFO", logger=parallel.distributed.__name__):
        assert parallel.initialize() is False
    assert "no cluster" in caplog.text
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("local_rank,process_id,want", [
    (None, 3, 1), (None, 0, 0), (None, None, 0), ("1", 2, 1), ("0", 1, 0)])
def test_local_device_takes_local_rank_else_process_id(
        monkeypatch, local_rank, process_id, want):
    """On a machine of two cards: ``LOCAL_RANK`` names the card where
    ``torchrun`` set it; without it rank ``process_id`` takes card
    ``process_id % 2``, and a process with neither card 0. Without a card
    the device is the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    assert (parallel.distributed.local_device(process_id)
            == torch.device("cuda", want))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert parallel.distributed.local_device(process_id) == \
        torch.device("cpu")


def test_initialize_puts_explicit_ranks_on_their_own_cards(monkeypatch):
    """Ranks the caller starts with ``process_id`` and no ``LOCAL_RANK``
    on a machine of two cards: rank 1 sets card 1 current and binds its
    NCCL group there, over the coordinator's ``tcp://`` address."""
    calls = {}
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.setdefault("set_device", d))
    dist_mod = parallel.distributed.dist
    monkeypatch.setattr(dist_mod, "init_process_group",
                        lambda backend, **kw: calls.update(backend=backend,
                                                           **kw))
    monkeypatch.setattr(dist_mod, "get_rank", lambda: 1)
    monkeypatch.setattr(dist_mod, "get_world_size", lambda: 2)
    assert parallel.initialize("127.0.0.1:29500", 2, 1) is True
    assert calls["set_device"] == torch.device("cuda", 1)
    assert calls["device_id"] == torch.device("cuda", 1)
    assert calls["backend"] == "nccl"
    assert calls["init_method"] == "tcp://127.0.0.1:29500"
    assert (calls["world_size"], calls["rank"]) == (2, 1)


# --------------------------------------------------------------------- #
# Two and four gloo ranks                                                #
# --------------------------------------------------------------------- #

def test_ranks_see_their_slice(two_ranks, four_ranks):
    """Rank r of n holds rows [r B/n, (r+1) B/n) of every array of a
    global batch (``local_batch_slice``, ``shard_batch`` over a dict and a
    list), a local batch as it is (``shard_global_batch(local=True)``);
    the mesh's placements are PyTorch's ``Replicate`` and ``Shard(0)``."""
    from torch.distributed.tensor import Replicate, Shard

    rows = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    for ranks in (two_ranks, four_ranks):
        n = len(ranks)
        for r, got in enumerate(ranks):
            lo, hi = got["local_batch_slice"]
            assert (lo, hi) == (r * 8 // n, (r + 1) * 8 // n)
            assert torch.equal(got["shard_batch"]["x"], rows[lo:hi])
            assert torch.equal(got["shard_batch"]["y"][0],
                               rows[r * 4 // n:(r + 1) * 4 // n])
            assert torch.equal(got["shard_global_batch"][0], rows[:2])
            assert got["placements"] == ((Replicate(),), (Shard(0),))


@pytest.mark.parametrize("backend", STEP_BACKENDS)
def test_sharded_step_matches_jax(two_ranks, jax_sharded_step, backend):
    """Two ranks of 1 MPE + 1 audio-only row each against the JAX
    package's sharded step on the same 2 + 2 batch and weights: every loss
    within rel 1e-4, Adam's mu within 1e-4 x each leaf's max, the updated
    parameters within 5e-4; both ranks hold the same bits."""
    from timbre_trap_tpu_torch.interop import state_dict_from_jax

    want_params, want_mu, want_metrics = jax_sharded_step
    got = two_ranks[0][backend]
    assert set(got["metrics"]) == set(want_metrics)
    for key, want in want_metrics.items():
        assert got["metrics"][key] == pytest.approx(want, rel=1e-4), key
    for name, want in state_dict_from_jax(want_mu).items():
        scale = float(want.abs().max())
        np.testing.assert_allclose(got["mu"][name].numpy(), want.numpy(),
                                   atol=1e-4 * scale, err_msg=name)
    for name, want in state_dict_from_jax(want_params).items():
        np.testing.assert_allclose(got["params"][name].numpy(),
                                   want.numpy(), atol=5e-4, err_msg=name)
    other = two_ranks[1][backend]
    assert got["metrics"] == other["metrics"]
    for part in ("grads", "params"):
        assert all(torch.equal(v, other[part][k])
                   for k, v in got[part].items())


@pytest.mark.parametrize("backend", STEP_BACKENDS)
def test_sharded_step_matches_the_single_rank_step(inputs, two_ranks,
                                                   backend):
    """The mean of two ranks' gradients is the whole batch's: against the
    port's step in one process on the 2 + 2 batch, the losses within rel
    1e-5 and every gradient and parameter within 1e-5 x each leaf's max.
    Where a leaf's two float32 gradients part by more (bias gradients are
    sums over every pixel, and two ranks sum in another order), the
    sharded one lies within 3x the single-rank one's distance from a
    float64 run of the step (``step_gradients_reference``), the rule of
    the card checks in ``chip_smoke.py``."""
    from timbre_trap_tpu_torch.train import step_gradients_reference

    workdir, _, arrays = inputs
    model = _model(workdir)
    cfg = TrainConfig()
    ref64 = step_gradients_reference(model, cfg, 2, arrays["audio"],
                                     arrays["gt"])
    state = init_train_state(model, cfg)
    want = _step_result(model, state, make_train_step(
        model, cfg, 2, conv_backend=backend)(state, arrays["audio"],
                                             arrays["gt"], 1e-3))
    got = two_ranks[0][backend]
    for key, value in want["metrics"].items():
        assert got["metrics"][key] == pytest.approx(value, rel=1e-5,
                                                    abs=1e-7), key
    for name, w in want["grads"].items():
        g = got["grads"][name]
        scale = float(w.abs().max())
        if float((g - w).abs().max()) <= 1e-5 * scale:
            continue
        far = float((g.double() - ref64[name]).abs().max())
        near = float((w.double() - ref64[name]).abs().max())
        assert far <= 3 * near, (name, far / scale, near / scale)
    for name, w in want["params"].items():
        np.testing.assert_allclose(got["params"][name].numpy(), w.numpy(),
                                   atol=1e-5 * float(w.abs().max()),
                                   err_msg=name)


def test_sharded_step_accumulates_reduced_gradients(inputs, two_ranks):
    """Under ``grad_accum_steps=2`` each call's gradients are reduced
    before ``MultiSteps`` folds them: two sharded calls give the
    parameters of two single-rank calls on the whole batch, within 1e-5 x
    each leaf's max."""
    workdir, _, arrays = inputs
    model = _model(workdir)
    cfg = TrainConfig(grad_accum_steps=2)
    state = init_train_state(model, cfg)
    step = make_train_step(model, cfg, 2, conv_backend="flax")
    for lr in (1e-3, 2e-3):
        step(state, arrays["audio"], arrays["gt"], lr)
    got = two_ranks[0]["accumulated"]
    assert any(not torch.equal(got[k], v) for k, v in
               _model(workdir).net.state_dict().items())
    for name, w in model.net.state_dict().items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                   atol=1e-5 * float(w.abs().max()),
                                   err_msg=name)


@pytest.mark.parametrize("n_ranks", [2, 4])
def test_sharded_inference_matches_jax(inputs, two_ranks, four_ranks,
                                       n_ranks):
    """The chunk axis over 2 ranks (a 3.4-block clip, transcribe) and over
    4 (two clips of 2 blocks, no transcribe) against the JAX package's
    ``make_sharded_chunked_inference`` on ``make_mesh(2)`` / ``(4)`` and
    the port's ``chunked_inference``, atol 2e-5; every rank returns the
    same coefficients."""
    from timbre_trap_tpu.parallel import make_mesh as jax_make_mesh
    from timbre_trap_tpu.parallel import \
        make_sharded_chunked_inference as jax_sharded

    workdir, ref, arrays = inputs
    ranks, clip, transcribe = {
        2: (two_ranks, arrays["clip"], True),
        4: (four_ranks, arrays["clip_b2"], False)}[n_ranks]
    got = ranks[0]["inference"]
    assert all(torch.equal(r["inference"], got) for r in ranks[1:])
    want = np.asarray(jax_sharded(ref, jax_make_mesh(n_ranks), transcribe)(
        ref.params, clip))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    single = _model(workdir, fused="f32").chunked_inference(clip, transcribe)
    np.testing.assert_allclose(got.numpy(), single.numpy(), atol=2e-5)


def test_trainer_data_parallel_matches_one_device(inputs, two_ranks,
                                                  tmp_path):
    """``n_devices=2`` over two gloo ranks against the single-device
    Trainer on the same corpus: the parameters after 2 steps within rtol
    2e-3, atol 2e-5; both ranks take the same best-model decision from
    rank 0's sweep; only rank 0 wrote the run directory; each rank's
    dataset loaded only its 2 rows of each batch (4 loads against 8)."""
    workdir = inputs[0]
    trainer, train_set = _trainer(workdir, _model(workdir), None,
                                  str(tmp_path / "single"))
    trainer.run()
    assert trainer.batch_count == 2 and len(train_set.accessed) == 8
    want = trainer.model.net.state_dict()
    ranks = [r["trainer"] for r in two_ranks]
    for r in ranks:
        assert r["batch_count"] == 2
        for name, w in want.items():
            np.testing.assert_allclose(r["params"][name].numpy(), w.numpy(),
                                       rtol=2e-3, atol=2e-5, err_msg=name)
    assert ranks[0]["best"] == ranks[1]["best"]
    assert ranks[0]["best"][0] == trainer.best_checkpoint == 2
    # Batches of tracks [0, 1, 2, 3] in order: rank r loads tracks 2r, 2r+1.
    assert ranks[0]["accessed"] == [0, 1, 0, 1]
    assert ranks[1]["accessed"] == [2, 3, 2, 3]
    run0 = os.path.join(workdir, "run0")
    assert {"config.json", "run.json", "metrics.json", "_sources",
            "models"} <= set(os.listdir(run0))
    assert os.path.isdir(os.path.join(run0, "models", "model-2"))
    assert not os.path.exists(os.path.join(workdir, "run1"))


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
            int(sys.argv[4]), sys.argv[5])
