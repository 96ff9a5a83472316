"""The port's hand-written CUDA kernels against their plain PyTorch twins.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed. The tests marked ``cuda`` need a card and skip
without one; on the card run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX).
"""

import numpy as np
import pytest
import torch

from timbre_trap_tpu_torch.interop import hwio_params
from timbre_trap_tpu_torch.models import TimbreTrap, TimbreTrapNet, forward_spec
from timbre_trap_tpu_torch.models.fused import level_specs
from timbre_trap_tpu_torch.models.modules import init_weights
from timbre_trap_tpu_torch.ops import packed_conv as pc
from timbre_trap_tpu_torch.ops.fused_level import (
    banded_conv, banded_conv_dw, banded_conv_dx, banded_conv_reference,
    chain_flops, elu_backward, fused_level_apply, level_backward,
    level_backward_reference, packed_level_apply, spec_time_reach)
from timbre_trap_tpu_torch.ops.peaks import peak_mask, peak_mask_reference

torch.set_num_threads(2)


def _rand(rng, *shape, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape)
                             ).astype(np.float32))


def _conv_cases(device="cpu"):
    """One ConvBlocks of every kind the flagship chain holds."""
    rng = np.random.default_rng(11)
    out = {}
    for d in (1, 2, 3):
        out[f"3x3-d{d}"] = pc.build_conv2d_blocks(
            _rand(rng, 3, 3, 4, 4), _rand(rng, 4), 540, d)
    out["1x1"] = pc.build_conv2d_blocks(_rand(rng, 1, 1, 32, 32),
                                        _rand(rng, 32), 65)
    out["convin"] = pc.build_conv2d_blocks(_rand(rng, 3, 3, 2, 4),
                                           _rand(rng, 4), 540)
    out["sconv"] = pc.build_sconv_blocks(_rand(rng, 4, 1, 16, 32),
                                         _rand(rng, 32), 133)
    out["tconv"] = pc.build_tconv_blocks(_rand(rng, 4, 1, 8, 4), _rand(rng, 4),
                                         269, output_padding=1)
    out["dense-lat"] = pc.build_dense_blocks(_rand(rng, 128, 1984, scale=0.03),
                                             _rand(rng, 128))
    out["dense-exp"] = pc.build_dense_blocks(_rand(rng, 1984, 128, scale=0.1),
                                             _rand(rng, 1984))
    for cb in out.values():
        cb.blocks, cb.bias = cb.blocks.to(device), cb.bias.to(device)
    return out


def _train_specs(device="cpu"):
    """The 8 training level specs (with adjoints) of a small net (F=60,
    latent 16, complexity 1): encoder levels with convin fused into the
    first, decoder levels with convout fused into the last."""
    net = init_weights(TimbreTrapNet(60, 16, 1),
                       torch.Generator().manual_seed(4)).to(device)
    with torch.no_grad():
        especs, dspecs = level_specs(hwio_params(net), net, True)
    return especs + dspecs


def _k3_counts():
    return (banded_conv_dx.launches, banded_conv_dw.launches,
            elu_backward.launches)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device for the hand-written kernels")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# --------------------------------------------------------------------- #
# Contracts that hold on any device                                      #
# --------------------------------------------------------------------- #

def test_wrappers_take_the_twin_on_cpu_and_count_nothing():
    rng = np.random.default_rng(0)
    cb = _conv_cases()["3x3-d2"]
    x = _rand(rng, 2, cb.r_in, 9)
    res = _rand(rng, 2, cb.r_out, 9)
    before = banded_conv.launches, peak_mask.launches
    assert torch.equal(banded_conv(x, cb, True, res),
                       banded_conv_reference(x, cb, True, res))
    a = torch.rand((2, 20, 9))
    assert torch.equal(peak_mask(a, 0.3), peak_mask_reference(a, 0.3))
    assert (banded_conv.launches, peak_mask.launches) == before
    spec = _train_specs()[0]
    x = _rand(rng, 1, spec.r_in, 9)
    dy = _rand(rng, 1, spec.r_out, 9)
    k3_before = _k3_counts()
    dx, grads = level_backward(x, spec, dy)
    dx_ref, grads_ref = level_backward_reference(x, spec, dy)
    assert torch.equal(dx, dx_ref)
    for (dw, db), (dw_ref, db_ref) in zip(grads, grads_ref):
        assert torch.equal(dw, dw_ref) and torch.equal(db, db_ref)
    assert _k3_counts() == k3_before


def test_flagship_chain_geometry():
    """The flagship forward: 36 items, 60 convs, time reach 50 of the 64
    halo, and 81.79 MFLOP of banded products per frame column."""
    net = init_weights(TimbreTrapNet(540, 128, 2),
                       torch.Generator().manual_seed(0))
    spec = forward_spec(net, True)
    assert len(spec.items) == 36
    assert sum(1 for _ in spec.convs()) == 60
    assert spec_time_reach(spec) == 50
    assert (spec.r_in, spec.r_out) == (1080, 1080)
    assert chain_flops(spec, 1) == 81789440


# --------------------------------------------------------------------- #
# Kernels on the card                                                    #
# --------------------------------------------------------------------- #

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_banded_conv_kernel_matches_plain(cuda_device, dtype):
    """Every conv kind, with bias, ELU and residual add; f32 within
    1e-4 * max|ref|, bf16 within 1e-2 * max|ref| of the bf16 twin (sum
    order and the rounding of one output)."""
    dtype = getattr(torch, dtype)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    rng = np.random.default_rng(5)
    for name, cb in _conv_cases(cuda_device).items():
        for t in (1, 70, 300):
            x = _rand(rng, 2, cb.r_in, t).to(cuda_device, dtype)
            res = _rand(rng, 2, cb.r_out, t).to(cuda_device, dtype)
            for act, r in ((False, None), (True, res)):
                before = banded_conv.launches
                got = banded_conv(x, cb, act, r)
                assert banded_conv.launches == before + 1
                want = banded_conv_reference(x, cb, act, r)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                scale = want.float().abs().max().item()
                assert err <= tol * scale, (name, t, act, err, scale)


@pytest.mark.cuda
def test_flagship_chain_kernel_matches_plain(cuda_device):
    net = init_weights(TimbreTrapNet(540, 128, 2),
                       torch.Generator().manual_seed(0)).to(cuda_device)
    spec = forward_spec(net, True)
    x = _rand(np.random.default_rng(6), 2, 1080, 256, scale=0.3).to(cuda_device)
    ref = packed_level_apply(x, spec, torch.float32)
    scale = ref.abs().max().item()
    got = fused_level_apply(x, spec, torch.float32)
    assert (got - ref).abs().max().item() <= 1e-4 * scale
    got16 = fused_level_apply(x, spec, torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    assert (got16.float() - ref).abs().max().item() <= 5e-2 * scale


@pytest.mark.cuda
def test_banded_conv_rejects_what_it_does_not_take(cuda_device):
    cb = _conv_cases(cuda_device)["3x3-d1"]
    x = torch.zeros((1, cb.r_in, 8), device=cuda_device)
    with pytest.raises(ValueError):
        banded_conv(x.half(), cb)
    with pytest.raises(ValueError):
        banded_conv(x[:, :-1], cb)
    with pytest.raises(ValueError):
        banded_conv(x, cb, residual=torch.zeros((1, cb.r_out, 7),
                                                device=cuda_device))
    with pytest.raises(ValueError):
        peak_mask(torch.zeros((3, 4), dtype=torch.float64, device=cuda_device))


@pytest.mark.cuda
def test_peak_mask_kernel_matches_plain(cuda_device):
    a = torch.rand((2, 540, 1000), device=cuda_device)
    a[0, 10:13, :5] = 0.7
    for t in (0.5, 0.0, -0.25):
        before = peak_mask.launches
        got = peak_mask(a, t)
        assert peak_mask.launches == before + 1
        assert torch.equal(got, peak_mask_reference(a, t))


@pytest.mark.cuda
def test_transcribe_on_card_matches_cpu(cuda_device):
    hp = dict(sample_rate=8000, n_octaves=5, bins_per_octave=12,
              secs_per_block=0.5, latent_size=16, model_complexity=1,
              fused="f32", seed=3)
    card, cpu = TimbreTrap(**hp), TimbreTrap(**hp, device="cpu")
    audio = (0.3 * np.random.default_rng(7).standard_normal((1, 1, 58400))
             ).astype(np.float32)
    card.piece_blocks = cpu.piece_blocks = 3     # stream 15 blocks in pieces
    got = card.transcribe(audio)
    assert got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(), cpu.transcribe(audio).numpy(),
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_level_backward_kernels_match_plain(cuda_device, dtype):
    """K3 (elu_backward, banded_conv_dx, banded_conv_dw, after a K1
    recompute) against the plain twin on the same card tensors, for every
    training level kind: dX and each conv's dW and dBias within
    1e-4 * max|ref| in float32 and 1e-2 * max|ref| in bfloat16 (sum order,
    and bf16 outputs of the recompute that round the other way)."""
    dtype = getattr(torch, dtype)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    rng = np.random.default_rng(8)
    for idx, spec in enumerate(_train_specs(cuda_device)):
        x = _rand(rng, 2, spec.r_in, 70).to(cuda_device, dtype)
        dy = _rand(rng, 2, spec.r_out, 70).to(cuda_device, dtype)
        before = _k3_counts()
        with torch.no_grad():
            dx, grads = level_backward(x, spec, dy, dtype)
            dx_ref, grads_ref = level_backward_reference(x, spec, dy, dtype)
        torch.cuda.synchronize()
        n_conv = len(grads)
        assert _k3_counts()[1] == before[1] + n_conv
        assert _k3_counts()[2] == before[2] + 1
        assert dx.dtype == dtype
        pairs = [(dx, dx_ref)] + [p for g, r in zip(grads, grads_ref)
                                  for p in zip(g, r)]
        for i, (got, want) in enumerate(pairs):
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            assert err <= tol * scale, (idx, i, err, scale)


@pytest.mark.cuda
def test_level_backward_dw_is_bitwise_stable(cuda_device):
    """dW and dBias come from per-slice partials added in a fixed order:
    two runs give the same bits."""
    spec = _train_specs(cuda_device)[0]
    rng = np.random.default_rng(9)
    x = _rand(rng, 3, spec.r_in, 300).to(cuda_device, torch.bfloat16)
    dy = _rand(rng, 3, spec.r_out, 300).to(cuda_device, torch.bfloat16)
    with torch.no_grad():
        runs = [level_backward(x, spec, dy, torch.bfloat16) for _ in range(2)]
    for (dw1, db1), (dw2, db2) in zip(runs[0][1], runs[1][1]):
        assert torch.equal(dw1, dw2) and torch.equal(db1, db2)
    assert torch.equal(runs[0][0], runs[1][0])
