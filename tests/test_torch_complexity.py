"""Networks whose output frequencies span several 128-row blocks: model
complexity 3 and 4 through the port's normal path.

The widths are ``(2, 4, 8, 16, 32) * 2^(c - 1)``; at complexity 4 they
reach 256, and a 256-channel output frequency spans two 128-row blocks.
``_build_blocks`` then repeats its band pattern every P blocks (the
period, ``ConvBlocks.period``): P = 2 for encoder level 4's strided conv
128 -> 256 and, since a stride-2 transposed conv needs two output
frequencies a pattern, for decoder level 1's 256 -> 128. K1, K3's dX and
dW, and the kept operands carry P; every stage at complexity 3 and below
keeps P = 1.

On the CPU (two torch threads):

* period-P blocks (P = 2 and 4) of a strided and of a transposed conv
  against ``conv2d`` and ``conv_transpose2d``: the stage, computed from
  the blocks and from the bands alone, within 1e-5 x max|ref| (float32
  sums of up to 2,048 products in another order); the adjoint's dX and
  the blocks' dW and dBias, taken back to the kernel by ``_build_blocks``'
  backward, against autograd of the plain conv, within the same bar;
* at the small geometry of ``tests/test_model.py:246`` (8 kHz, 5 x 12
  bins, 0.5-s blocks, latent 16) at complexity 3 and 4: the port's
  float32 ``transcribe`` and ``reconstruct`` and its packed float32
  training step (the ``"pallas"`` backend: K1 and K3's twins over the kept
  specs) against the benchmark's plain reference (``portbench/reference``,
  an NCHW float32 network) on the harness's seeded weights. Activations
  and audio within 1e-4 (both are float32; the port sums in another order
  and measures within 4e-6, while the bfloat16 chain is 4e-2 away); the
  step's median leaf within 1e-3 of the gradient's norm and 1e-2 of the
  change's (the bars of ``portbench/tests``; the float32 step reads about
  1e-6 and 1e-5).

On the card (``cuda``, skipped without one), at the flagship geometry
with complexity 4 (K1, dX and dW on the period-2 stages against their
twins are cases of ``tests/test_torch_kernels.py``); run with

    python -m pytest --noconftest -p no:cacheprovider -s tests/test_torch_complexity.py

* a chunk group's graph replay bit-equal to the eager group, transcribe
  and reconstruct;
* a forward at (4, R, 1024) runs 60 K1 launches of its dtype's kernel and
  no cuDNN kernel;
* ``reconstruct`` at complexity 3 and 4, and three c4 recipe steps,
  against the plain reference, within ``tt-base.reconstruct-long``'s and
  ``tt-base.train-recipe``'s limits (printed as one JSON line each).
"""

import json
import os
import types

import numpy as np
import pytest
import torch

from portbench import bench, program, spec
from portbench.reference.model import Reference
from timbre_trap_tpu_torch.models import TimbreTrap, TimbreTrapNet
from timbre_trap_tpu_torch.models import timbre_trap
from timbre_trap_tpu_torch.models.fused import forward_spec, kept_level_specs
from timbre_trap_tpu_torch.models.modules import init_weights
from timbre_trap_tpu_torch.ops import fused_level as fl
from timbre_trap_tpu_torch.ops import packed_conv as pc
from timbre_trap_tpu_torch.utils.profiling import kernel_counts

torch.set_num_threads(2)

CPU = torch.device("cpu")
SEED = 2 ** 31 + 977
SMALL = dict(sample_rate=8000, n_octaves=5, bins_per_octave=12,
             secs_per_block=0.5, latent_size=16)
C4_FLAGSHIP = dict(sample_rate=22050, n_octaves=9, bins_per_octave=60,
                   secs_per_block=3, latent_size=128, model_complexity=4)
# One recipe step at the small geometry: one annotated crop of one block
# (the three objectives, consistency included), the float32 kernel
# backend.
SMALL_STEP = dict(kind="train", polyphony_s=40, voices=3, note_s=[0.2, 0.6],
                  midi=[50, 80], crop_s=0.5, mpe_crops=1, audio_crops=0,
                  pool_batches=1, learning_rate=1e-3, warmup_steps=4,
                  weight_decay=0.01, grad_clip=10.0, conv_backend="pallas",
                  audio_scale=4096.0, checked_steps=1, gain_db=[-12.0, 12.0])
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rand(rng, *shape, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape)
                             ).astype(np.float32))


def _close(got, want, tol, what):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item(), (what, err)


# -------------------------------------------------------------------- #
# Banded blocks at period P                                             #
# -------------------------------------------------------------------- #

# kind, c_in, c_out, f_in, the conv's period and its adjoint's (a
# transposed conv to 128 channels takes P = 2 for its stride).
PERIOD_CASES = {"sconv-P2": ("sconv", 128, 256, 13, 2, 2),
                "tconv-P2": ("tconv", 256, 128, 6, 2, 2),
                "sconv-P4": ("sconv", 128, 512, 9, 4, 2),
                "tconv-P4": ("tconv", 512, 256, 5, 4, 4)}


@pytest.mark.parametrize("case", list(PERIOD_CASES))
def test_period_blocks_match_the_plain_conv(case):
    """The stage from the blocks and from the bands, the adjoint's dX, and
    dW and dBias through the blocks' own backward, against the plain conv
    and its autograd."""
    kind, c_in, c_out, f_in, period, adj_period = PERIOD_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    kernel = _rand(rng, 4, 1, c_in, c_out, scale=(4 * c_in) ** -0.5)
    bias = _rand(rng, c_out, scale=0.1)
    kernel.requires_grad_(True)
    bias.requires_grad_(True)
    x = _rand(rng, 2, c_in, f_in, 9).requires_grad_(True)
    if kind == "sconv":
        cb = pc.build_sconv_blocks(kernel, bias, f_in)
        fl._attach_sconv_adjoint(cb, kernel, f_in)
        y = torch.nn.functional.conv2d(x, kernel.permute(3, 2, 0, 1), bias,
                                       stride=(2, 1))
    else:
        cb = pc.build_tconv_blocks(kernel, bias, f_in, output_padding=1)
        fl._attach_tconv_adjoint(cb, kernel)
        y = torch.nn.functional.conv_transpose2d(
            x, kernel.permute(2, 3, 0, 1), bias, stride=(2, 1),
            output_padding=(1, 0))
    assert (cb.period, cb.n_w, cb.adjoint.period) == (period, 2 * period,
                                                       adj_period)
    assert cb.blocks.shape[1] == pc.BLOCK_ROWS * period
    xp = pc.pack_nchw(x.detach())
    want = pc.pack_nchw(y.detach())
    with torch.no_grad():
        _close(pc.packed_conv_reference(xp, cb), want, 1e-5, "blocks")
        _close(pc.band_conv_reference(xp, cb), want, 1e-5, "bands")
    dy = _rand(rng, *y.shape)
    dx, dk, dbias = torch.autograd.grad(y, (x, kernel, bias), dy)
    dyp = pc.pack_nchw(dy)
    got_dx, _ = fl.banded_conv_dx_reference(dyp, cb.adjoint, torch.float32)
    _close(got_dx, pc.pack_nchw(dx), 1e-5, "dX")
    _close(pc.band_conv_reference(dyp, cb.adjoint), pc.pack_nchw(dx), 1e-5,
           "dX from the bands")
    dw, db = fl.banded_conv_dw_reference(dyp, xp, cb)
    assert dw.shape == cb.blocks.shape and db.shape == cb.bias.shape
    got_dk, got_db = torch.autograd.grad((cb.blocks, cb.bias),
                                         (kernel, bias), (dw, db))
    _close(got_dk, dk, 1e-5, "dW")
    _close(got_db, dbias, 1e-5, "dBias")


# -------------------------------------------------------------------- #
# The whole model at the small geometry                                 #
# -------------------------------------------------------------------- #

@pytest.mark.parametrize("complexity", [3, 4])
def test_wide_models_match_the_plain_reference(complexity):
    cfg = {"model": dict(SMALL, model_complexity=complexity,
                         skip_connections=False)}
    weights = bench.make_weights(cfg, SEED, CPU, 0.1)
    model = program.build_model(cfg, weights, CPU)
    model.fused = "f32"
    periods = {cb.period for cb in model._spec(True).convs() if cb.col_adv}
    assert periods == ({1, 2} if complexity == 4 else {1})
    ref = Reference(cfg, weights, CPU)
    clip = _rand(np.random.default_rng(complexity), int(0.4 * 8000),
                 scale=0.3)
    act = model.transcribe(clip[None, None].numpy())
    want = ref.activations(clip)
    assert act.shape == want.shape
    assert (act - want).abs().max().item() < 1e-4
    audio = model.reconstruct(clip[None, None].numpy())
    assert (audio - ref.reconstruct(clip)).abs().max().item() < 1e-4

    train = spec.load_cell("tt-base.train-recipe")
    cell = types.SimpleNamespace(**vars(train))
    cell.config = dict(train.config, model=cfg["model"])
    cell.traffic = SMALL_STEP
    runner = bench.Train(cell, SEED, CPU, program, bench._Spans(False))
    especs, dspecs = kept_level_specs(runner.model.net, True)
    convs = [cb for s in especs + dspecs for cb in s.convs()]
    assert {c.period for cb in convs if cb.col_adv
            for c in (cb, cb.adjoint)} == periods
    runner.free()
    numbers = bench.train_numbers(
        (runner.first_losses, runner.first_grads, runner.after),
        runner.reference_run(), runner.weights)
    assert numbers["grad_diff"] < 1e-3, numbers
    assert numbers["change_diff"] < 1e-2, numbers


# -------------------------------------------------------------------- #
# On the card                                                           #
# -------------------------------------------------------------------- #

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device for the hand-written kernels")
    return torch.device("cuda")


def _c4_net(device, seed=0):
    return init_weights(TimbreTrapNet(540, 128, 4),
                        torch.Generator().manual_seed(seed)).to(device)


K1 = ("band_wgmma_kernel", "band_wgmma_f32_kernel")


def _eager(monkeypatch, fn):
    """``fn()`` with every chunk group run eagerly on the card."""
    with monkeypatch.context() as mp:
        mp.setattr(timbre_trap, "_replays_graphs", lambda device: False)
        return fn()


@pytest.mark.cuda
@pytest.mark.parametrize("branch", ["transcribe", "reconstruct"])
def test_c4_replay_is_bit_equal_to_the_eager_group(cuda_device, monkeypatch,
                                                   branch):
    """A 10-block clip (21 chunks: groups of 4 and a last group of 1)."""
    m = TimbreTrap(**C4_FLAGSHIP, seed=11, device=cuda_device)
    run = getattr(m, branch)
    rng = np.random.default_rng(12)
    clip = (0.3 * rng.standard_normal((1, 1, int(29.3 * 22050)))
            ).astype(np.float32)
    got = run(clip)
    want = _eager(monkeypatch, lambda: run(clip))
    assert m._graphs
    assert torch.equal(got, want), (got - want).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_c4_forward_runs_on_k1_alone(cuda_device, dtype):
    """The c4 chain at the chunks' (4, R, 1024): 60 launches of its
    dtype's K1 kernel, two of them period-2 stages, and nothing of cuDNN."""
    dtype = getattr(torch, dtype)
    spec = forward_spec(_c4_net(cuda_device), True)
    convs = list(spec.convs())
    assert len(convs) == 60
    banded = sorted(cb.period for cb in convs if cb.col_adv)
    assert banded == [1] * 56 + [2] * 2
    x = _rand(np.random.default_rng(5), 4, spec.r_in, 1024,
              scale=0.3).to(cuda_device, dtype)
    with torch.no_grad(), kernel_counts() as counts:
        y = fl.fused_level_apply(x, spec, dtype)
    route = int(dtype == torch.float32)
    assert counts[K1[route]] == 60 and counts[K1[1 - route]] == 0, counts
    assert not [k for k in counts if "cudnn" in k.lower()
                or "conv" in k.lower()], counts
    assert torch.isfinite(y.float()).all()


def _c4_cell(name, complexity=4):
    """A benchmark cell's traffic and limits on the tt-c4 configuration (at
    ``complexity``)."""
    cell = types.SimpleNamespace(**vars(spec.load_cell(name)))
    with open(os.path.join(REPO, "portbench", "configs", "tt-c4.json")) as fh:
        cell.config = json.load(fh)
    cell.config["model"]["model_complexity"] = complexity
    return cell


@pytest.mark.cuda
@pytest.mark.parametrize("complexity", [3, 4])
def test_wide_reconstruct_matches_the_reference(cuda_device, complexity):
    """The first three requests of the long-reconstruction mix (142.5-457.5-s
    clips) at complexity 3 and 4 against the reference, within
    ``tt-base.reconstruct-long``'s ``audio_max_gap``."""
    cell = _c4_cell("tt-base.reconstruct-long", complexity)
    cell.traffic = dict(cell.traffic, warm_requests=0, check_requests=3,
                        check_span=3)
    runner = bench.Inference(cell, SEED, cuda_device, program,
                             bench._Spans(False))
    for i in range(3):
        runner.request(i)
    runner.free()
    numbers = runner.numbers()
    correct, checks = bench.judge(numbers, cell.limits)
    print(json.dumps({f"c{complexity}_reconstruct": numbers,
                      "checks": checks}))
    assert correct and numbers["checked_requests"] == 3, checks


@pytest.mark.cuda
def test_c4_recipe_steps_match_the_reference(cuda_device):
    """Three recipe steps of tt-c4 (``pallas_bf16``, the recipe's rates,
    clip, warm-up and objectives) on 2 annotated + 2 audio-only crops of
    3 s, against the reference, within ``tt-base.train-recipe``'s limits
    (the recipe's 4 + 4 crops of 9 s would ask the float32 reference for
    more than the card's memory at these widths)."""
    cell = _c4_cell("tt-base.train-recipe")
    cell.traffic = dict(cell.traffic, crop_s=3.0, mpe_crops=2, audio_crops=2,
                        pool_batches=3, checked_steps=3)
    runner = bench.Train(cell, SEED, cuda_device, program,
                         bench._Spans(False))
    runner.free()
    numbers = runner.numbers()
    correct, checks = bench.judge(numbers, cell.limits)
    print(json.dumps({"c4_recipe_steps": numbers, "checks": checks,
                      "peak_bytes": torch.cuda.max_memory_allocated()}))
    assert correct, checks
