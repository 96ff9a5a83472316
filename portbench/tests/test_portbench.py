"""CPU tests of the benchmark at a small geometry, and one card test.

* every configuration, traffic, limit, metric and kernel file is found
  by name, and a new one of each is found by adding files and entries;
* the work counts match a hand count and the reference network's shapes;
* the plain reference agrees with the port's CPU twin;
* no module of JAX or of the JAX package is loaded;
* the control (the reference one precision below) and each fault a cell
  can have (a step that leaves the state unchanged, half the batch left
  out, an answer altered where it is produced) come out not correct.
"""

import json
import math
import os
import re
import shutil
import subprocess
import sys
import types

import pytest
import torch

from portbench import bench, calibrate, program, spec
from portbench.reference.model import Reference
from portbench.reference.net import TimbreTrapNet
from portbench.work import convs as work

SMALL = {"sample_rate": 8000, "n_octaves": 5, "bins_per_octave": 12,
         "secs_per_block": 0.5, "latent_size": 16, "model_complexity": 1}
CONTENT = {"voices": 3, "note_s": [0.2, 0.6], "midi": [50, 80]}
TRAFFIC = {
    "transcribe": dict(kind="transcribe", polyphony_s=30, **CONTENT,
                       lengths_s=[1, 8], n_lengths=4, warm_requests=1,
                       check_requests=2, check_span=3),
    "reconstruct": dict(kind="reconstruct", polyphony_s=30, **CONTENT,
                        lengths_s=[16, 24], n_lengths=3, warm_requests=1,
                        check_requests=2, check_span=2),
    "train": dict(kind="train", polyphony_s=40, **CONTENT, crop_s=1.5,
                  mpe_crops=2, audio_crops=2, pool_batches=4,
                  learning_rate=1e-3, warmup_steps=4, weight_decay=0.01,
                  grad_clip=10.0, conv_backend="pallas_bf16",
                  audio_scale=4096.0, checked_steps=3,
                  gain_db=[-12.0, 12.0]),
}
# A benchmark cell of each kind, whose limits the small cells take.
CELLS = {"transcribe": "tt-skips.transcribe-short",
         "reconstruct": "tt-base.reconstruct-long",
         "train": "tt-base.train-recipe"}
SEED = 2 ** 31 + 977
CPU = torch.device("cpu")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def small_cell(kind, skips=False, **traffic):
    real = spec.load_cell(CELLS[kind])
    cell = types.SimpleNamespace(**vars(real))
    cell.config = dict(real.config, model=dict(SMALL,
                                               skip_connections=skips))
    cell.traffic = dict(TRAFFIC[kind], **traffic)
    return cell


# -------------------------------------------------------------------- #
# Found by name                                                         #
# -------------------------------------------------------------------- #

def test_every_cell_finds_its_files():
    b = spec.load_benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    groups = spec.kernel_groups()
    assert {"k1", "k2", "k3"} <= set(groups)
    produced = {"transcribe": {"transcribe_rtf", "transcribe_p95_ms"},
                "reconstruct": {"reconstruct_rtf", "reconstruct_p95_ms"},
                "train": {"train_step_ms"}}
    for w in b["workloads"]:
        assert NAME.match(w["name"]) and w["chips"] == 1
        cell = spec.load_cell(w["name"])
        kind = cell.traffic["kind"]
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and names - {"setup_s"}
        assert names - {"setup_s"} <= produced[kind]
        assert cell.per_layer
        for m in cell.per_layer:
            assert callable(spec.metric_reader(m["name"]))
        assert set(cell.limits) and all(v >= 0 for v in cell.limits.values())
        assert cell.config["model"]["n_octaves"] * \
            cell.config["model"]["bins_per_octave"] == 540
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert set(m["workloads"]) <= cells
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_a_new_cell_metric_and_kernel_are_files_and_entries(tmp_path):
    repo = tmp_path / "repo"
    shutil.copytree(spec.ROOT, repo / "portbench",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    shutil.copy(os.path.join(spec.REPO, "BENCHMARK.json"), repo)
    root = repo / "portbench"
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    (root / "configs" / "tt-new.json").write_text(json.dumps(
        {"model": dict(SMALL, skip_connections=False)}))
    (root / "traffic" / "new-mix.json").write_text(json.dumps(
        TRAFFIC["transcribe"]))
    (root / "limits" / "tt-new.new-mix.json").write_text(json.dumps(
        {"act_max_gap": 0.5, "mask_mismatch": 0}))
    (root / "metrics" / "new_share.transcribe.py").write_text(
        "def read(ctx):\n    return 42.0\n")
    (root / "kernels" / "k1" / "new_stage_kernel.json").write_text(
        json.dumps({"pattern": r"\bnew_stage_kernel\b"}))
    b = json.loads((repo / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "tt-new", "source": "x",
                         "file": "portbench/configs/tt-new.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "tt-new.new-mix", "config": "tt-new",
                           "traffic": "new-mix", "chips": 1, "why": "x"})
    b["end_to_end"][0]["workloads"].append("tt-new.new-mix")
    b["per_layer"].append({"name": "new_share.transcribe", "unit": "%",
                           "better": "lower", "source": "device_trace",
                           "layer": "x", "moves": "transcribe_rtf",
                           "workloads": ["tt-new.new-mix"]})
    (repo / "BENCHMARK.json").write_text(json.dumps(b))
    cell = spec.load_cell("tt-new.new-mix", str(repo), str(root))
    assert cell.config["model"]["sample_rate"] == 8000
    assert cell.traffic["kind"] == "transcribe"
    assert [m["name"] for m in cell.per_layer] == ["new_share.transcribe"]
    assert spec.metric_reader("new_share.transcribe", str(root))({}) == 42.0
    groups = spec.kernel_groups(str(root))
    assert any(p.search("void new_stage_kernel(int)") for p in groups["k1"])
    assert all(p.read_bytes() == data for p, data in before.items())


# -------------------------------------------------------------------- #
# Work counts                                                           #
# -------------------------------------------------------------------- #

def test_work_counts_by_hand_and_by_shapes():
    convs = work.network_convs(dict(SMALL, skip_connections=False))
    by = {c.name: c for c in convs}
    assert len(convs) == 60
    T = 256
    # By hand, complexity 1: widths 2, 4, 8, 16, 32; F = 60 -> 29 -> 13
    # -> 5 -> 1; latent 16.
    ops, nbytes = work.forward_work([by["encoder.convin"]], T, 2)
    assert ops == 2 * 2 * 2 * 9 * 60 * T
    assert nbytes == (2 * 60 * T + 2 * 60 * T) * 2 + 2 * 2 * 9 * 2 + 2 * 4
    ops, _ = work.forward_work([by["encoder.block1.sconv"]], T, 2)
    assert ops == 2 * 2 * 4 * 4 * 29 * T
    ops, _ = work.forward_work([by["decoder.block4.tconv"]], T, 4)
    assert ops == 2 * 4 * 2 * 4 * 29 * T           # per input row
    _, nbytes = work.forward_work([by["encoder.block1.block1.conv2"]], T, 2)
    assert nbytes == (3 * 2 * 60 * T) * 2 + 2 * 2 * 2 + 2 * 4
    ops, nbytes = work.backward_work([by["encoder.convin"]], T, 2, False)
    assert ops == 2 * 2 * 2 * 9 * 60 * T
    assert nbytes == (2 * 60 * T * 2 + 2 * 60 * T) * 2 + 36 * 2 \
        + (36 + 2) * 4
    # Each conv's output rows against the reference network's shapes.
    net = TimbreTrapNet(60, 16, 1, False)
    rows = {}
    for name, mod in net.named_modules():
        if isinstance(mod, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            mod.register_forward_hook(
                lambda m, i, o, name=name: rows.__setitem__(
                    name.rsplit(".0", 1)[0], (i[0].shape, o.shape)))
    with torch.no_grad():
        latents, skips = net.encode(torch.zeros(1, 2, 60, 4))
        net.decode(latents, skips, True)
    assert set(rows) == set(by)
    for name, (x, y) in rows.items():
        c = by[name]
        assert (x[1], x[2], y[1], y[2]) == (c.c_in, c.f_in, c.c_out, c.f_out)


# -------------------------------------------------------------------- #
# The reference against the port's CPU twin                             #
# -------------------------------------------------------------------- #

@pytest.mark.parametrize("skips", [False, True])
def test_reference_agrees_with_the_port_cpu_twin(skips):
    cfg = {"model": dict(SMALL, skip_connections=skips)}
    weights = bench.make_weights(cfg, SEED, CPU, 0.1)
    model = program.build_model(cfg, weights, CPU)
    model.fused = "f32"
    ref = Reference(cfg, weights, CPU)
    clip = bench.gen.Polyphony(TRAFFIC["transcribe"], 8000, SEED,
                               CPU).clip(1234, 8000 * 3 + 77)
    act = model.transcribe(clip[None, None])
    r = ref.activations(clip)
    assert act.shape == r.shape
    assert float((act - r).abs().max()) < 1e-4
    y = model.reconstruct(clip[None, None])
    assert float((y - ref.reconstruct(clip)).abs().max()) < 1e-4


def test_reference_step_agrees_with_the_port_float32_step():
    cell = small_cell("train", conv_backend="pallas")
    runner = bench.Train(cell, SEED, CPU, program, bench._Spans(False))
    runner.free()
    ref = runner.reference_run()
    prog = (runner.first_losses, runner.first_grads, runner.after)
    numbers = calibrate.train_readings(prog, ref, runner.weights)
    assert numbers["loss_worst.total"] < 1e-4
    assert numbers["grad_gap_worst"] < 1e-3
    assert numbers["change_gap_worst"] < 1e-2
    numbers = bench.train_numbers(prog, ref, runner.weights)
    assert numbers["grad_diff"] < 1e-3
    assert numbers["change_diff"] < 1e-2


# -------------------------------------------------------------------- #
# No JAX                                                                #
# -------------------------------------------------------------------- #

def test_forbidden_names_compare_whole_top_level_names():
    assert bench.forbidden_modules(
        ["jax.numpy", "timbre_trap_tpu.models", "timbre_trap_tpu_torch.ops",
         "jaxtyping", "flax", "numpy"]) == ["flax", "jax", "timbre_trap_tpu"]


def test_a_run_loads_no_jax():
    code = (
        "import sys, torch\n"
        "from portbench import bench, program, run, calibrate, spec\n"
        "from portbench.tests.test_portbench import small_cell\n"
        "r = bench.run(small_cell('transcribe'), 5, 0.1, False,\n"
        "              torch.device('cpu'), program)\n"
        "assert r['correct'], r\n"
        "print(bench.forbidden_modules())\n")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.REPO,
                         capture_output=True, text=True, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


# -------------------------------------------------------------------- #
# The control and the faults come out not correct                       #
# -------------------------------------------------------------------- #

@pytest.mark.parametrize("kind", ["transcribe", "reconstruct", "train"])
def test_the_control_fails_and_the_program_passes(kind):
    cell = small_cell(kind)
    r = calibrate.readings(cell, SEED, CPU, program)
    assert bench.judge(r["program"], cell.limits)[0], r
    assert not bench.judge(r["control"], cell.limits)[0], r
    if kind == "train":
        assert not bench.judge(r["half_batch"], cell.limits)[0], r


def _run(cell):
    return bench.run(cell, SEED, 0.1, False, CPU, program)


def test_a_step_that_leaves_the_state_unchanged_fails(monkeypatch):
    from timbre_trap_tpu_torch.train import step as step_mod

    monkeypatch.setattr(step_mod.AdamW, "update",
                        lambda self, params, grads, state, lr: None)
    assert not _run(small_cell("train"))["correct"]


def test_half_the_batch_left_out_fails(monkeypatch):
    real = program.make_step

    def half(model, recipe):
        m, a = recipe["mpe_crops"], recipe["audio_crops"]
        step, state = real(model, dict(recipe, mpe_crops=m // 2))
        rows = list(range(m // 2)) + list(range(m, m + a // 2))

        def broken(state, audio, truth, lr):
            return step(state, audio[rows], truth[:m // 2], lr)

        return broken, state

    fake = types.SimpleNamespace(**vars(program))
    fake.make_step = half
    cell = small_cell("train")
    assert not bench.run(cell, SEED, 0.1, False, CPU, fake)["correct"]


def test_an_altered_mask_fails():
    def altered(act):
        mask = program.peak_mask(act).clone()
        mask[..., 0, 0] ^= 1
        return mask

    fake = types.SimpleNamespace(**vars(program))
    fake.peak_mask = altered
    r = bench.run(small_cell("transcribe"), SEED, 0.1, False, CPU, fake)
    assert not r["correct"] and r["checks"]["mask_mismatch"]["value"] > 0


def test_altered_audio_fails():
    def build(config, weights, device):
        model = program.build_model(config, weights, device)
        real = model.reconstruct

        def reconstruct(audio):
            y = real(audio).clone()
            y[..., y.shape[-1] // 2] += 0.25
            return y

        model.reconstruct = reconstruct
        return model

    fake = types.SimpleNamespace(**vars(program))
    fake.build_model = build
    assert not bench.run(small_cell("reconstruct"), SEED, 0.1, False, CPU,
                         fake)["correct"]


# -------------------------------------------------------------------- #
# On the card                                                           #
# -------------------------------------------------------------------- #

@pytest.mark.cuda
def test_a_short_run_of_each_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for w in spec.load_benchmark()["workloads"]:
        out = subprocess.run(
            [sys.executable, "-m", "portbench.run", "--workload", w["name"],
             "--seed", "7", "--seconds", "2", "--trace", "0"],
            cwd=spec.REPO, capture_output=True, text=True, timeout=900)
        assert out.returncode == 0, out.stderr[-3000:]
        result = json.loads(out.stdout.strip().splitlines()[-1])
        assert result["correct"], result["checks"]
        assert list(result)[-1] == "checks"
        assert not math.isnan(result["metrics"]["setup_s"]["value"])
