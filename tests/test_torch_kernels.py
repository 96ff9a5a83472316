"""The port's hand-written CUDA kernels against their plain PyTorch twins:
the conv stage (K1: the band-tiled TMA-fed wgmma kernels of
``csrc/band_wgmma.cu``, bf16 products for bfloat16, split-TF32 products
for float32), the peak mask (K2) and the
level backward (K3: dX and dW on the band tiles of ``csrc/band_mma.cu``
in both dtypes, the ELU' seed of ``csrc/banded_conv_bwd.cu``).

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed. The tests marked ``cuda`` need a card and skip
without one; on the card run them with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py

(``--noconftest`` because ``tests/conftest.py`` imports JAX).
"""

import ctypes
import os

import numpy as np
import pytest
import torch

from timbre_trap_tpu_torch.data import DataLoader, MPEDataset, device_prefetch
from timbre_trap_tpu_torch.data.io import save_wav
from timbre_trap_tpu_torch.interop import hwio_params
from timbre_trap_tpu_torch.models import (TimbreTrap, TimbreTrapFiLM,
                                          TimbreTrapMag, TimbreTrapMagDB,
                                          TimbreTrapNet, forward_spec,
                                          fused_forward, load_model)
from timbre_trap_tpu_torch.models.fused import level_specs
from timbre_trap_tpu_torch.models.modules import init_weights
from timbre_trap_tpu_torch.ops import fused_level as fl
from timbre_trap_tpu_torch.ops import packed_conv as pc
from timbre_trap_tpu_torch.ops.fused_level import (
    HALO, band_tma_plan, band_tma_plan_f32, banded_conv, banded_conv_dw,
    banded_conv_dw_reference, banded_conv_dx, banded_conv_dx_reference,
    banded_conv_reference, chain_flops, elu_backward, fused_level_apply,
    level_backward, level_backward_reference, packed_level_apply,
    spec_time_reach)
from timbre_trap_tpu_torch.ops.peaks import peak_mask, peak_mask_reference
from timbre_trap_tpu_torch.train import (TrainConfig, Trainer, TrainerConfig,
                                         init_train_state, make_train_step,
                                         step_gradients_reference,
                                         synthetic_batch)
from timbre_trap_tpu_torch.train.synthetic import chord_tracks
from timbre_trap_tpu_torch.utils.profiling import (kernel_counts,
                                                   kernel_instance)

torch.set_num_threads(2)


def _rand(rng, *shape, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape)
                             ).astype(np.float32))


def _conv_cases(device="cpu"):
    """One ConvBlocks of every kind the flagship chain holds, and the two
    period-2 stages of complexity 4 (a 256-channel output frequency spans
    two 128-row blocks, so the band pattern repeats every two): encoder
    level 4's strided conv (65 -> 31 frequencies, 128 -> 256 channels) and
    decoder level 1's transposed conv (31 -> 65, 256 -> 128), each the
    other's adjoint geometry."""
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
    out["sconv-P2"] = pc.build_sconv_blocks(
        _rand(rng, 4, 1, 128, 256, scale=(4 * 128) ** -0.5),
        _rand(rng, 256, scale=0.1), 65)
    out["tconv-P2"] = pc.build_tconv_blocks(
        _rand(rng, 4, 1, 256, 128, scale=(4 * 256) ** -0.5),
        _rand(rng, 128, scale=0.1), 31, output_padding=1)
    for cb in out.values():
        cb.blocks, cb.bias = cb.blocks.to(device), cb.bias.to(device)
    return out


def _flagship_net(variant="base", skips=False, device="cpu"):
    return init_weights(TimbreTrapNet(540, 128, 2, variant, skips),
                        torch.Generator().manual_seed(0)).to(device)


def _variant_stages(device="cpu"):
    """The stages the skip route and the one-channel families add at the
    flagship widths: the standalone convin (2 -> 4) and convout (4 -> 2),
    and Mag's (1 -> 4, 4 -> 1)."""
    out = {}
    for variant, tag in (("base", ""), ("mag", "-mag")):
        route = forward_spec(_flagship_net(variant, True, device), True)
        out[f"convin{tag}"] = route.especs[0].items[0][1]
        out[f"convout{tag}"] = route.dspecs[-1].items[0][1]
    return out


def _variant_train_stages(device="cpu"):
    """The same stages as ``_variant_stages``, built with their adjoints
    (the skip route's first encoder and last decoder training specs)."""
    out = {}
    for variant, tag in (("base", ""), ("mag", "-mag")):
        net = _flagship_net(variant, True, device)
        with torch.no_grad():
            especs, dspecs = level_specs(hwio_params(net), net, True)
        out[f"convin{tag}"] = especs[0].items[0][1]
        out[f"convout{tag}"] = dspecs[-1].items[0][1]
    return out


def _route_convs(route):
    specs = route.especs + route.dspecs if hasattr(route, "especs") else [route]
    return sum(1 for s in specs for _ in s.convs())


def _train_specs(device="cpu"):
    """The 8 training level specs (with adjoints) of a small net (F=60,
    latent 16, complexity 1): encoder levels with convin fused into the
    first, decoder levels with convout fused into the last."""
    net = init_weights(TimbreTrapNet(60, 16, 1),
                       torch.Generator().manual_seed(4)).to(device)
    with torch.no_grad():
        especs, dspecs = level_specs(hwio_params(net), net, True)
    return especs + dspecs


# Each band wrapper's (bfloat16, float32) kernel by the name the profiler
# records it under (``kernel_counts``): K1, K3 dX, and dW's partial sums
# (its reduction, ``band_dw_reduce_kernel``, serves both); the ELU' seed
# and K2 have one kernel each.
K1 = ("band_wgmma_kernel", "band_wgmma_f32_kernel")
DX = ("band_product_kernel", "band_tf32_kernel")
DW = ("band_dw_partial_kernel", "band_dw_tf32_kernel")
SEED, K2 = "elu_backward_kernel", "peak_mask_kernel"


def _on_route(counts, kernels, dtype, n):
    """Whether ``counts`` hold ``n`` launches of the ``dtype`` kernel of
    ``kernels`` (bfloat16, float32) and none of the other."""
    bf16 = dtype == torch.bfloat16
    return (counts[kernels[not bf16]], counts[kernels[bf16]]) == (n, 0)


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

def test_wrappers_take_the_twin_on_cpu_and_count_nothing(monkeypatch):
    """On the CPU every wrapper hands its arguments to its plain twin and
    returns the twin's result; the level backward on the CPU reaches every
    K3 twin the same way. Spies stand in for the twins, so the claim is
    the routing itself, not the bits of two separate evaluations."""
    from timbre_trap_tpu_torch.ops import fused_level, peaks

    rng = np.random.default_rng(0)
    cb = _conv_cases()["3x3-d2"]
    spec = _train_specs()[0]
    adj = next(spec.convs()).adjoint
    x = _rand(rng, 2, cb.r_in, 9)
    res = _rand(rng, 2, cb.r_out, 9)
    c = _rand(rng, 2, adj.r_in, 9)
    cases = [
        (fused_level, banded_conv, (x, cb, True, res)),
        (peaks, peak_mask, (torch.rand((2, 20, 9)), 0.3)),
        (fused_level, banded_conv_dx, (c, adj, torch.float32, None, None,
                                       True, torch.float32)),
        (fused_level, banded_conv_dw, (_rand(rng, 2, cb.r_out, 9), x, cb)),
        (fused_level, elu_backward, (res, (res, None), True)),
    ]
    for module, wrapper, args in cases:
        name = wrapper.__name__ + "_reference"
        calls, sentinel = [], object()

        def spy(*a):
            calls.append(a)
            return sentinel

        with monkeypatch.context() as m:
            m.setattr(module, name, spy)
            assert wrapper(*args) is sentinel, name
        assert len(calls) == 1, name
        assert len(calls[0]) == len(args), name
        assert all(got is want for got, want in zip(calls[0], args)), name

    reached = set()

    def through(name, twin):
        def spy(*a):
            reached.add(name)
            return twin(*a)
        return spy

    for name in ("banded_conv_reference", "banded_conv_dx_reference",
                 "banded_conv_dw_reference", "elu_backward_reference"):
        monkeypatch.setattr(fused_level, name,
                            through(name, getattr(fused_level, name)))
    xs = _rand(rng, 1, spec.r_in, 9)
    dx, grads = level_backward(xs, spec, _rand(rng, 1, spec.r_out, 9))
    assert reached == {"banded_conv_reference", "banded_conv_dx_reference",
                       "banded_conv_dw_reference", "elu_backward_reference"}
    assert dx.shape == xs.shape and len(grads) == len(list(spec.convs()))


def test_peak_mask_reads_frame_slices_in_place():
    """K2's wrapper hands the kernel (B, F, T) planes at their own strides
    when the frames are contiguous (a frame slice such as transcribe's
    trimmed output), and copies only other layouts."""
    from timbre_trap_tpu_torch.ops.peaks import _planes_of_rows

    a = torch.zeros((2, 3, 5, 12))
    assert _planes_of_rows(a)
    assert _planes_of_rows(a[..., 2:9])
    assert _planes_of_rows(a[:, 1])
    assert not _planes_of_rows(a[..., ::2])
    assert not _planes_of_rows(a.transpose(-1, -2))
    assert not _planes_of_rows(a[:, :2, 1:4])


def test_f32_accuracy_tool_items_on_cpu():
    """The float64 yardstick of ``tools/f32_accuracy.py``: on the CPU both
    routes are the IEEE plain version, each item within a few float32
    roundings of float64."""
    from timbre_trap_tpu_torch.tools import f32_accuracy

    model = TimbreTrap(8000, 5, 12, 0.5, latent_size=16, model_complexity=1,
                       seed=0, device="cpu")
    spec = model._spec(True)
    x = _rand(np.random.default_rng(15), 2, spec.r_in, 37, scale=0.3)
    items = f32_accuracy._items(spec, x)
    assert len(items) == len(spec.items)
    for e in items:
        assert e["kernel"] == e["ieee"] <= 1e-6, e


def test_f32_accuracy_tool_stages_on_cpu():
    """The stage part of ``tools/f32_accuracy.py``: every conv stage of the
    chain alone, on the input the plain chain gives it; on the CPU both
    routes are the IEEE plain version, within a few float32 roundings of
    float64."""
    from timbre_trap_tpu_torch.tools import f32_accuracy

    model = TimbreTrap(8000, 5, 12, 0.5, latent_size=16, model_complexity=1,
                       seed=0, device="cpu")
    spec = model._spec(True)
    x = _rand(np.random.default_rng(18), 2, spec.r_in, 37, scale=0.3)
    stages = f32_accuracy._stages(spec, x)
    assert [e["stage"] for e in stages] == list(range(len(list(
        spec.convs()))))
    for e in stages:
        assert e["kernel"] == e["ieee"] <= 1e-6, e


def test_c_signatures_match_the_sources():
    """Every entry point's ctypes argument types (``ops/_build.py``
    ``_SIGNATURES``) follow its ``extern "C"`` declaration in ``csrc/``,
    argument by argument: a pointer as ``c_void_p``, an int as ``c_int``,
    a long long as ``c_longlong``, a float as ``c_float`` (ctypes would
    pass a missing argument's value as a C int, cutting a stream
    pointer)."""
    import re

    from timbre_trap_tpu_torch.ops import _build

    kinds = {"*": ctypes.c_void_p, "long long": ctypes.c_longlong,
             "int": ctypes.c_int, "float": ctypes.c_float}
    for lib, entries in _build._SIGNATURES.items():
        src = (_build._CSRC / f"{lib}.cu").read_text()
        for name, argtypes in entries.items():
            decl = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)", src)
            assert decl is not None, name
            want = [next(t for k, t in kinds.items() if k in arg)
                    for arg in decl.group(1).split(",")]
            assert argtypes == want, name


@pytest.mark.parametrize("tool", ["k1_f32_ablation", "k1_bf16_ablation"])
def test_k1_f32_ablation_variants_match_the_source(tool):
    """Every variant of ``tools/k1_f32_ablation.py`` and of its bf16 twin
    ``tools/k1_bf16_ablation.py`` changes text that ``csrc/band_wgmma.cu``
    holds exactly once, so each builds the kernel it names; the base
    variant changes nothing."""
    import importlib

    from timbre_trap_tpu_torch.ops import _build

    variants = importlib.import_module(
        f"timbre_trap_tpu_torch.tools.{tool}").VARIANTS
    src = (_build._CSRC / "band_wgmma.cu").read_text()
    assert variants["base"] == []
    for name, subs in variants.items():
        for old, new in subs:
            assert src.count(old) == 1 and old != new, (name, old)


def test_f32_accuracy_tool_backward_on_cpu():
    """The backward part of ``tools/f32_accuracy.py``: on the CPU both
    routes are the IEEE plain version, and every conv's dX, dW and dBias
    lie within a few float32 roundings of float64."""
    from timbre_trap_tpu_torch.tools import f32_accuracy

    specs = _train_specs()
    convs = f32_accuracy._backward_convs(specs, 37,
                                         torch.Generator().manual_seed(16))
    assert len(convs) == sum(1 for s in specs for _ in s.convs())
    for e in convs:
        for what in ("dx", "dw", "dbias"):
            assert e[what]["kernel"] == e[what]["ieee"] <= 1e-6, e


def test_f32_accuracy_tool_variant_stages_on_cpu():
    """The families' stages in ``tools/f32_accuracy.py``: the skip route's
    standalone convin 2 -> 4 and convout 4 -> 2 and the one-channel convin
    1 -> 4 and convout 4 -> 1 at the flagship widths, each a one-conv
    training spec; on the CPU both routes are the IEEE plain version,
    within a few float32 roundings of float64."""
    from timbre_trap_tpu_torch.tools import f32_accuracy

    specs = f32_accuracy.variant_stage_specs(device="cpu")
    assert {n: (s.r_in, s.r_out) for n, s in specs.items()} == {
        "convin": (1080, 2160), "convout": (2160, 1080),
        "convin-mag": (540, 2160), "convout-mag": (2160, 540)}
    convs = f32_accuracy._backward_convs(list(specs.values()), 37,
                                         torch.Generator().manual_seed(17))
    assert len(convs) == 4
    for e in convs:
        for what in ("dx", "dw", "dbias"):
            assert e[what]["kernel"] == e[what]["ieee"] <= 1e-6, e


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


def test_skip_route_geometry():
    """The flagship skip route: 58 convs (convin, 4 encoder levels; 4
    decoder levels, convout), every level inside the halo; the one-channel
    stages keep their geometry (a 7-row margin shift rounded to 8, a
    272-column band in a 288-column operand, 540 output rows in a partial
    last block)."""
    for variant in ("base", "mag"):
        route = forward_spec(_flagship_net(variant, True), True)
        assert len(route.especs) == len(route.dspecs) == 5
        assert _route_convs(route) == 58
        assert all(spec_time_reach(s) <= HALO
                   for s in route.especs + route.dspecs)
    stages = _variant_stages()
    assert [(cb.c_in, cb.c_out) for cb in stages.values()] == [
        (2, 4), (4, 2), (1, 4), (4, 1)]
    cin, cout = stages["convin-mag"], stages["convout-mag"]
    assert (cin.margin, cin.k, cin.band_width) == (8, 41, 32)
    assert cout.bands == ((0, 272), (256, 272)) and cout.band_width == 288
    assert (cout.r_out, cout.n_out_blocks) == (540, 5)


# --------------------------------------------------------------------- #
# Kernels on the card                                                    #
# --------------------------------------------------------------------- #

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_banded_conv_kernel_matches_plain(cuda_device, dtype):
    """Every conv kind, with bias, ELU and residual add; f32 within
    1e-4 * max|ref|, bf16 within 1e-2 * max|ref| of the bf16 twin (sum
    order and the rounding of one output); each call one launch of the
    dtype's K1 kernel."""
    dtype = getattr(torch, dtype)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    rng = np.random.default_rng(5)
    cases = _conv_cases(cuda_device)
    with kernel_counts() as counts:
        for name, cb in cases.items():
            for t in (1, 70, 300):
                x = _rand(rng, 2, cb.r_in, t).to(cuda_device, dtype)
                res = _rand(rng, 2, cb.r_out, t).to(cuda_device, dtype)
                for act, r in ((False, None), (True, res)):
                    got = banded_conv(x, cb, act, r)
                    want = banded_conv_reference(x, cb, act, r)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    scale = want.float().abs().max().item()
                    assert err <= tol * scale, (name, t, act, err, scale)
    assert _on_route(counts, K1, dtype, len(cases) * 3 * 2), counts


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
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("t_len", [34816, 1001, 3])
@pytest.mark.parametrize("f", [540, 61, 1])
def test_peak_mask_kernel_matches_plain(cuda_device, f, t_len, batch):
    """K2 equals its plain version bit for bit: row runs with a ragged
    last run, T unaligned and not a multiple of 4 (element loads at the
    tail), several planes, thresholds above, at and below zero, ties
    (equal neighbours are no peak), a frame slice of a longer tensor (read
    in place at its row stride, as transcribe's output lies) and a strided
    view (the wrapper's contiguous copy)."""
    g = torch.Generator(device=cuda_device).manual_seed(f * t_len + batch)
    a = torch.rand((batch, f, t_len), generator=g, device=cuda_device)
    a[0, f // 3:f // 3 + 3, :5] = 0.7
    longer = torch.rand((batch, f, t_len + 4), generator=g, device=cuda_device)
    wide = torch.rand((batch, f, 2 * t_len + 1), generator=g,
                      device=cuda_device)
    with kernel_counts() as counts:
        for x in (a, longer[..., :t_len], longer[..., 1:t_len + 1],
                  wide[..., 1::2]):
            for t in (0.5, 0.0, -0.25):
                got = peak_mask(x, t)
                assert torch.equal(got, peak_mask_reference(x, t)), (
                    t, x.stride())
    assert counts[K2] == 4 * 3


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
    and bf16 outputs of the recompute that round the other way). A level
    runs one ELU' seed, and a dX and a dW (partial sums and reduction) a
    conv, on its dtype's kernels."""
    dtype = getattr(torch, dtype)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    rng = np.random.default_rng(8)
    for idx, spec in enumerate(_train_specs(cuda_device)):
        x = _rand(rng, 2, spec.r_in, 70).to(cuda_device, dtype)
        dy = _rand(rng, 2, spec.r_out, 70).to(cuda_device, dtype)
        with torch.no_grad():
            with kernel_counts() as counts:
                dx, grads = level_backward(x, spec, dy, dtype)
            dx_ref, grads_ref = level_backward_reference(x, spec, dy, dtype)
        torch.cuda.synchronize()
        n_conv = len(grads)
        assert counts[SEED] == 1, counts
        assert _on_route(counts, DX, dtype, n_conv), counts
        assert _on_route(counts, DW, dtype, n_conv), counts
        assert counts["band_dw_reduce_kernel"] == n_conv, counts
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


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,t", [("bfloat16", 3072), ("bfloat16", 1001),
                                     ("float32", 3072), ("float32", 1001),
                                     ("float32", 70), ("float32", 1)])
def test_band_kernels_match_plain_at_long_and_ragged_t(cuda_device, dtype, t):
    """The tensor-core kernels (csrc/band_mma.cu) on every conv kind (the
    residual items' 3x3 and 1x1, the per-block dense bridge maps, the
    period-2 strided and transposed convs of complexity 4), at the
    recipe's T and at ragged T, against their twins on the same tensors:
    in bf16 within 1e-2 * max|ref| (sum order and output rounding), in
    float32 (split-TF32 products) within 1e-4 * max|ref| of the IEEE twin.
    The stage (bias, ELU, residual); on every map but the dense ones also
    dX (float32 cotangent, residual, raw, ELU' from stored tensors at the
    storage dtype) and dW/dBias (band entries, zeros elsewhere). Each call
    runs its dtype's kernel."""
    rng = np.random.default_rng(12)
    bf16 = torch.bfloat16
    dtype = getattr(torch, dtype)
    tol = 1e-2 if dtype == bf16 else 1e-4

    def close(got, want, what):
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol * want.float().abs().max().item(), (what, t, err)

    for name, cb in _conv_cases(cuda_device).items():
        x = _rand(rng, 2, cb.r_in, t).to(cuda_device, dtype)
        res = _rand(rng, 2, cb.r_out, t).to(cuda_device, dtype)
        with kernel_counts() as counts:
            got = banded_conv(x, cb, True, res)
        assert _on_route(counts, K1, dtype, 1), (name, counts)
        close(got, banded_conv_reference(x, cb, True, res), name)
        if cb.col_adv == 0:
            continue
        dz = _rand(rng, 2, cb.r_out, t).to(cuda_device)
        with kernel_counts() as counts:
            dw, db = banded_conv_dw(dz, x, cb)
        assert _on_route(counts, DW, dtype, 1), (name, counts)
        dw_ref, db_ref = banded_conv_dw_reference(dz, x, cb)
        assert not dw[~cb.band_mask()].any(), name
        close(dw, dw_ref, f"{name} dW")
        close(db, db_ref, f"{name} dBias")
        cb.bias = torch.zeros_like(cb.bias)     # an adjoint map has no bias
        c = _rand(rng, 2, cb.r_in, t).to(cuda_device)
        r32 = _rand(rng, 2, cb.r_out, t).to(cuda_device)
        s2 = _rand(rng, 2, cb.r_out, t).to(cuda_device, dtype)
        kw = dict(residual=r32, elu=(res, s2), keep_raw=True)
        with kernel_counts() as counts:
            out, raw = banded_conv_dx(c, cb, dtype, **kw)
        assert _on_route(counts, DX, dtype, 1), (name, counts)
        out_ref, raw_ref = banded_conv_dx_reference(c, cb, dtype, **kw)
        close(out, out_ref, f"{name} dX")
        close(raw, raw_ref, f"{name} dX raw")


# The bf16 K1 kernel's two instances (``kernel_instance``): the TMA
# epilogue, where T % 8 == 0, and the staged one.
K1_TMA, K1_STAGED = "band_wgmma_kernel<true>", "band_wgmma_kernel<false>"


def _staged(monkeypatch, fn):
    """``fn()`` with every bf16 K1 stage on the staged epilogue: the plan's
    last integer, the kernel's pick, set to 0 whatever T is."""
    real = fl._wgmma_plan

    def staged_plan(cb, t, width):
        t_pad, ints = real(cb, t, width)
        return t_pad, (ctypes.c_int * len(ints))(*ints[:-1], 0)

    with monkeypatch.context() as m:
        m.setattr(fl, "_wgmma_plan", staged_plan)
        return fn()


def _flagship_stages(device):
    """Two stages of the flagship chain: a residual item's 3x3 at dilation
    3 with 32 channels, and a 1x1 with 4 (r_out 2160, not a multiple of
    64)."""
    picks = {}
    for cb in forward_spec(_flagship_net(device=device), True).convs():
        if cb.col_adv and cb.f_out == cb.f_in:
            kind = "1x1" if len(cb.dts) == 1 else f"3x3-d{max(cb.dts)}"
            picks.setdefault(f"{kind}-c{cb.c_out}", cb)
    return {k: picks[k] for k in ("3x3-d3-c32", "1x1-c4")}


@pytest.mark.cuda
@pytest.mark.parametrize("t", [3072, 1024, 1001, 37])
def test_wgmma_stage_matches_twin(cuda_device, monkeypatch, t):
    """The bf16 stage's TMA-fed wgmma kernel (``tt_band_conv_wgmma``, the
    route of every CUDA bfloat16 ``banded_conv``) on every conv kind (the
    1984 -> 128 bridge, r_out not a multiple of 64; the period-2 convs of
    complexity 4, whose sub-tile g takes weight sub-tile g % 4 and input
    rows from (g // 4) * col_adv), the variants' stages
    and two flagship stages (3x3 at dilation 3 with 32 channels, 1x1 with
    4), with ELU and residual and without either, at the recipe's T and
    the chunks' T (the TMA epilogue, ``band_wgmma_kernel<true>``) and at
    ragged T (x padded to a multiple of 8 frames, the staged epilogue,
    ``band_wgmma_kernel<false>``): within 1e-2 * max|ref| of the twin on
    the same tensors (sum order and the output rounding), the same bits
    in two runs; each call one launch of the plan's instance. Where the
    plan takes the TMA epilogue, the staged one gives the same bits, and
    so does a residual view off 16-byte alignment (copied first)."""
    rng = np.random.default_rng(31)
    bf16 = torch.bfloat16
    tma = t % 8 == 0
    convs = dict(_conv_cases(cuda_device))
    convs.update(_variant_stages(cuda_device))
    convs.update(_flagship_stages(cuda_device))
    for name, cb in convs.items():
        assert band_tma_plan(cb, t).tma_epilogue == tma
        x = _rand(rng, 2, cb.r_in, t).to(cuda_device, bf16)
        res = None if cb.col_adv == 0 else _rand(rng, 2, cb.r_out, t).to(
            cuda_device, bf16)
        for act, r in ((True, res), (False, None)):
            with kernel_counts(kernel_instance) as counts:
                got = banded_conv(x, cb, act, r)
                again = banded_conv(x, cb, act, r)
            assert (counts[K1_TMA], counts[K1_STAGED]) == (
                (2, 0) if tma else (0, 2)), (name, counts)
            ref = banded_conv_reference(x, cb, act, r)
            torch.cuda.synchronize()
            assert torch.equal(got, again), (name, act)
            err = (got.float() - ref.float()).abs().max().item()
            assert err <= 1e-2 * ref.float().abs().max().item(), (name, act,
                                                                  err)
            if not tma:
                continue
            with kernel_counts(kernel_instance) as counts:
                staged = _staged(monkeypatch,
                                 lambda: banded_conv(x, cb, act, r))
            assert (counts[K1_TMA], counts[K1_STAGED]) == (0, 1), (name,
                                                                counts)
            torch.cuda.synchronize()
            assert torch.equal(got, staged), (name, act)
            if r is None:
                continue
            view = torch.empty(r.numel() + 1, dtype=bf16,
                               device=cuda_device)[1:].view(r.shape)
            view.copy_(r)
            assert view.data_ptr() % 16 != 0
            got_view = banded_conv(x, cb, act, view)
            torch.cuda.synchronize()
            assert torch.equal(got, got_view), name


@pytest.mark.cuda
def test_wgmma_flagship_chain_is_bitwise_stable(cuda_device, monkeypatch):
    """The flagship 60-stage bf16 chain at the chunks' (4, 1080, 1024):
    every stage on the TMA epilogue, the same bits in two runs and on the
    staged epilogue."""
    spec = forward_spec(_flagship_net(device=cuda_device), True)
    rng = np.random.default_rng(43)
    x = _rand(rng, 4, spec.r_in, 1024, scale=0.3).to(cuda_device,
                                                     torch.bfloat16)
    n = sum(1 for _ in spec.convs())
    with torch.no_grad():
        with kernel_counts(kernel_instance) as counts:
            runs = [fused_level_apply(x, spec, torch.bfloat16)
                    for _ in range(2)]
        staged = _staged(monkeypatch, lambda: fused_level_apply(
            x, spec, torch.bfloat16))
    torch.cuda.synchronize()
    assert (counts[K1_TMA], counts[K1_STAGED]) == (2 * n, 0), counts
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(runs[0], staged)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [3072, 1024, 1001, 37])
def test_wgmma_f32_stage_matches_twin(cuda_device, t):
    """The float32 stage's TMA-fed TF32 wgmma kernel
    (``tt_band_conv_wgmma_f32``, the route of every CUDA float32
    ``banded_conv``) on every conv kind and the variants' stages (3x3 at
    each dilation, 1x1, the per-block bridge maps, r_out not a multiple of
    64, the period-2 convs of complexity 4), with and without ELU and
    residual, at the recipe's T and the
    chunks' T (the TMA epilogue) and at ragged T (x padded to a multiple
    of 4 frames, the epilogue from the registers): within 1e-4 * max|ref|
    of the IEEE twin on the same tensors, the same bits in two runs; each
    call one launch of ``band_wgmma_f32_kernel``."""
    rng = np.random.default_rng(37)
    convs = dict(_conv_cases(cuda_device))
    convs.update(_variant_stages(cuda_device))
    for name, cb in convs.items():
        x = _rand(rng, 2, cb.r_in, t).to(cuda_device)
        res = None if cb.col_adv == 0 else _rand(rng, 2, cb.r_out, t).to(
            cuda_device)
        for act, r in ((False, None), (True, res)):
            with kernel_counts() as counts:
                got = banded_conv(x, cb, act, r)
                again = banded_conv(x, cb, act, r)
            assert _on_route(counts, K1, torch.float32, 2), (name, counts)
            ref = banded_conv_reference(x, cb, act, r)
            torch.cuda.synchronize()
            assert got.dtype == torch.float32
            assert torch.equal(got, again), (name, act)
            err = (got - ref).abs().max().item()
            assert err <= 1e-4 * ref.abs().max().item(), (name, act, err)


@pytest.mark.cuda
def test_wgmma_f32_stage_refuses_what_it_does_not_take(cuda_device):
    """The float32 route raises before any launch on what it does not
    take: a dilation-9 tap (more than 8 frames), the wrong number of input
    rows, a residual of another shape or dtype, weights on another device.
    No K1 kernel runs."""
    rng = np.random.default_rng(15)
    wide = pc.build_conv2d_blocks(_rand(rng, 3, 3, 4, 4), _rand(rng, 4), 64,
                                  9)
    wide.blocks, wide.bias = wide.blocks.cuda(), wide.bias.cuda()
    cb = _conv_cases(cuda_device)["3x3-d1"]
    cpu_cb = _conv_cases()["3x3-d1"]
    x = torch.zeros((1, cb.r_in, 16), device=cuda_device)
    wide_x = torch.zeros((1, wide.r_in, 16), device=cuda_device)
    short = torch.zeros((1, cb.r_out, 15), device=cuda_device)
    half = torch.zeros((1, cb.r_out, 16), dtype=torch.bfloat16,
                       device=cuda_device)
    with kernel_counts() as counts:
        with pytest.raises(ValueError, match="at most 8 frames"):
            banded_conv(wide_x, wide)
        with pytest.raises(ValueError, match="rows"):
            banded_conv(x[:, :-1], cb)
        with pytest.raises(ValueError, match="residual"):
            banded_conv(x, cb, residual=short)
        with pytest.raises(ValueError, match="residual"):
            banded_conv(x, cb, residual=half)
        with pytest.raises(ValueError, match="different devices"):
            banded_conv(x, cpu_cb)
    assert counts[K1[0]] == counts[K1[1]] == 0, counts


@pytest.mark.cuda
def test_wgmma_f32_tma_epilogue_takes_unaligned_residual_views(cuda_device):
    """Where T % 4 == 0 the float32 stage reads the residual by a tensor
    map, whose base must be 16-byte aligned: a residual view that starts
    off that alignment is copied first, and the stage gives the same bits
    as on an aligned residual, with the TMA epilogue both times (the
    plan's choice at T = 1024)."""
    rng = np.random.default_rng(41)
    cb = _conv_cases(cuda_device)["3x3-d2"]
    x = _rand(rng, 2, cb.r_in, 1024).to(cuda_device)
    res = _rand(rng, 2, cb.r_out, 1024).to(cuda_device)
    view = torch.empty(res.numel() + 1, device=cuda_device)[1:].view(
        res.shape)
    view.copy_(res)
    assert view.data_ptr() % 16 != 0
    assert band_tma_plan_f32(cb, 1024).tma_epilogue == 1
    got = banded_conv(x, cb, True, view)
    want = banded_conv(x, cb, True, res)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_band_dw_matches_masked_twin_and_is_bitwise_stable(cuda_device,
                                                           dtype):
    """dW on the bands (zeros elsewhere) and dBias against the twin masked
    with the same bands, on every kind but the dense maps (the period-2
    convs of complexity 4 among them: a (n_dt, 256, K) pattern), within
    1e-4 * max|ref| in float32 (split-TF32 products) and 1e-2 * max|ref|
    in bf16; two runs give the same bits."""
    dtype = getattr(torch, dtype)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    rng = np.random.default_rng(13)
    for name, cb in _conv_cases(cuda_device).items():
        if cb.col_adv == 0:
            continue
        x = _rand(rng, 2, cb.r_in, 1001).to(cuda_device, dtype)
        dz = _rand(rng, 2, cb.r_out, 1001).to(cuda_device)
        runs = [banded_conv_dw(dz, x, cb) for _ in range(2)]
        want = banded_conv_dw_reference(dz, x, cb)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(*runs)), name
        assert not runs[0][0][~cb.band_mask()].any(), name
        for got, ref in zip(runs[0], want):
            err = (got - ref).abs().max().item()
            assert err <= tol * ref.abs().max().item(), (name, err)


@pytest.mark.cuda
def test_band_kernels_reject_what_they_do_not_take(cuda_device):
    """Every route is band-tiled and stages at most 8 frames per side, so
    a dilation-9 tap raises in the stage, dX and dW in both dtypes; dX/dW
    take no dense per-block map."""
    rng = np.random.default_rng(14)
    wide = pc.build_conv2d_blocks(_rand(rng, 3, 3, 4, 4), _rand(rng, 4), 64,
                                  9)
    wide.blocks, wide.bias = wide.blocks.cuda(), wide.bias.cuda()
    x = torch.zeros((1, wide.r_in, 16), device=cuda_device)
    dz = torch.zeros((1, wide.r_out, 16), device=cuda_device)
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="at most 8 frames"):
            banded_conv(x.to(dtype), wide)
        with pytest.raises(ValueError, match="at most 8 frames"):
            banded_conv_dx(x, wide, dtype)
        with pytest.raises(ValueError, match="at most 8 frames"):
            banded_conv_dw(dz, x.to(dtype), wide)
    dense = _conv_cases(cuda_device)["dense-exp"]
    c = torch.zeros((1, dense.r_in, 16), device=cuda_device)
    for dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError):
            banded_conv_dx(c, dense, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_banded_conv_kernel_on_variant_geometries(cuda_device, dtype):
    """K1 on the stages the variants add (standalone convin and convout,
    one input or output channel) at T = 3072, 1001, 70 and 1, plain and
    with ELU and residual: float32 within 1e-4 * max|ref|, bf16 within
    1e-2 * max|ref| of the bf16 twin."""
    dtype = getattr(torch, dtype)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    rng = np.random.default_rng(17)
    for name, cb in _variant_stages(cuda_device).items():
        for t in (3072, 1001, 70, 1):
            x = _rand(rng, 2, cb.r_in, t).to(cuda_device, dtype)
            res = _rand(rng, 2, cb.r_out, t).to(cuda_device, dtype)
            for act, r in ((False, None), (True, res)):
                with kernel_counts() as counts:
                    got = banded_conv(x, cb, act, r)
                assert _on_route(counts, K1, dtype, 1), (name, t, counts)
                want = banded_conv_reference(x, cb, act, r)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                scale = want.float().abs().max().item()
                assert err <= tol * scale, (name, t, act, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k3_on_variant_geometries(cuda_device, dtype):
    """K3 on the stages the variants add (standalone convin 2 -> 4 and
    convout 4 -> 2, one-channel convin 1 -> 4 and convout 4 -> 1) at
    T = 3072, 1001 and 70 against the twins on the same tensors: dX
    (residual, raw, ELU' from stored tensors; 540 or 2160 output rows, a
    partial last block) and dW/dBias (band entries; the 288-column operand
    of convout 4 -> 1) within 1e-4 * max|ref| in float32 and 1e-2 *
    max|ref| in bf16; dW and dBias the same bits in two runs."""
    dtype = getattr(torch, dtype)
    tol = 1e-4 if dtype == torch.float32 else 1e-2
    rng = np.random.default_rng(21)

    def close(got, want, what):
        err = (got.float() - want.float()).abs().max().item()
        assert err <= tol * want.float().abs().max().item(), (what, err)

    for name, cb in _variant_train_stages(cuda_device).items():
        adj = cb.adjoint
        for t in (3072, 1001, 70):
            c = _rand(rng, 2, adj.r_in, t).to(cuda_device)
            kw = dict(residual=_rand(rng, 2, adj.r_out, t).to(cuda_device),
                      elu=(_rand(rng, 2, adj.r_out, t).to(cuda_device, dtype),
                           _rand(rng, 2, adj.r_out, t).to(cuda_device, dtype)),
                      keep_raw=True)
            with kernel_counts() as counts:
                got = banded_conv_dx(c, adj, dtype, **kw)
            assert _on_route(counts, DX, dtype, 1), (name, t, counts)
            want = banded_conv_dx_reference(c, adj, dtype, **kw)
            torch.cuda.synchronize()
            for g, w, what in zip(got, want, ("dX", "raw")):
                close(g, w, f"{name} T={t} {what}")
            x = _rand(rng, 2, cb.r_in, t).to(cuda_device, dtype)
            dz = _rand(rng, 2, cb.r_out, t).to(cuda_device)
            runs = [banded_conv_dw(dz, x, cb) for _ in range(2)]
            want = banded_conv_dw_reference(dz, x, cb)
            torch.cuda.synchronize()
            assert all(torch.equal(a, b) for a, b in zip(*runs)), name
            assert not runs[0][0][~cb.band_mask()].any(), name
            for g, w, what in zip(runs[0], want, ("dW", "dBias")):
                close(g, w, f"{name} T={t} {what}")


@pytest.mark.cuda
@pytest.mark.parametrize("cls", [TimbreTrap, TimbreTrapFiLM, TimbreTrapMag,
                                 TimbreTrapMagDB])
@pytest.mark.parametrize("skips", [False, True])
def test_family_step_kernels_match_twin(cuda_device, cls, skips):
    """A small model of every family x skips: one float32 ``"pallas"``
    step (K1 and K3) against one ``"packed"`` step (autograd through the
    plain twin) from the same weights on the card: every loss within 1e-5
    relative, every parameter's gradient within 1e-4 x its max|g|; a
    ``"pallas_bf16"`` step launches K1 and K3's dX, dW and ELU' seed on
    the bf16 route only and moves ``skip_weights`` and ``film_layer.*``."""
    hp = dict(sample_rate=8000, n_octaves=5, bins_per_octave=12,
              secs_per_block=0.5, latent_size=16, model_complexity=1,
              skip_connections=skips, seed=5)
    model = cls(**hp)
    audio, gt = synthetic_batch(model, 2, 1.0, seed=6)
    w0 = {k: v.clone() for k, v in model.net.state_dict().items()}
    cfg = TrainConfig()
    runs = {}
    for backend in ("pallas", "packed", "pallas_bf16"):
        model.load_state_dict(w0)
        step = make_train_step(model, cfg, 2, conv_backend=backend,
                               compact_audio_grid=True)
        with kernel_counts() as counts:
            metrics = step(init_train_state(model, cfg), audio, gt, 1e-3)
        runs[backend] = ({k: float(v) for k, v in metrics.items()},
                         {n: p.grad.clone()
                          for n, p in model.net.named_parameters()}, counts)
    (m32, g32, _), (mref, gref, _) = runs["pallas"], runs["packed"]
    for key, want in mref.items():
        if key.startswith("loss/"):
            assert abs(m32[key] - want) <= 1e-5 * abs(want), key
    over = [n for n, want in gref.items()
            if (g32[n] - want).abs().max().item()
            > 1e-4 * want.abs().max().item()]
    if over:
        # Leaves whose float32 gradients part by more: the kernel's largest
        # distance from float64 over them within 3x the twin's.
        model.load_state_dict(w0)
        g64 = step_gradients_reference(model, cfg, 2, audio, gt,
                                       compact_audio_grid=True)

        def dist(g):
            return max((g[n].double() - g64[n]).abs().max().item()
                       / g64[n].abs().max().item() for n in over)
        assert dist(g32) <= 3 * dist(gref), (over, dist(g32), dist(gref))
    counts = runs["pallas_bf16"][2]
    assert all(counts[bf16] > 0 and counts[f32] == 0
               for bf16, f32 in (K1, DX, DW)), counts
    assert counts[SEED] > 0, counts
    assert all(np.isfinite(v) for v in runs["pallas_bf16"][0].values())
    moved = [n for n in w0 if n == "skip_weights" or n.startswith("film")]
    assert len(moved) == int(skips) + 4 * (cls is TimbreTrapFiLM)
    state = model.net.state_dict()
    assert all(not torch.equal(state[n], w0[n]) for n in moved)


@pytest.mark.cuda
@pytest.mark.parametrize("variant,skips", [("base", True), ("film", False),
                                           ("mag", False), ("magdb", False),
                                           ("film", True)])
def test_variant_forward_kernels_match_plain(cuda_device, variant, skips):
    """One flagship forward of each route through the kernels against the
    same route through the plain twins on the card: one K1 launch per conv
    stage; float32 within 1e-4 * max|ref|, bf16 within 5e-2 * max|ref| of
    the float32 plain run."""
    net = _flagship_net(variant, skips, cuda_device)
    x = _rand(np.random.default_rng(18), 2, 540, 256, net.in_channels,
              scale=0.3).to(cuda_device)
    for transcribe in (True, False):
        spec = forward_spec(net, transcribe)
        ref = fused_forward(net, x, transcribe, spec=spec, plain=True)
        scale = ref.abs().max().item()
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 5e-2)):
            with kernel_counts() as counts:
                got = fused_forward(net, x, transcribe, dtype, spec)
            assert _on_route(counts, K1, dtype, _route_convs(spec)), counts
            err = (got - ref).abs().max().item()
            assert err <= tol * scale, (transcribe, dtype, err, scale)


@pytest.mark.cuda
def test_variants_on_card_match_cpu_and_reload(cuda_device, tmp_path):
    """Small FiLM and MagDB models with skips: the card's transcribe
    against the CPU's within 1e-4 (MagDB's CPU model reads the card's
    features: their dB form turns the FFTs' rounding near the 80-dB floor
    into ~1e-4); a save -> load_model round trip on the card gives the
    same activations bit for bit."""
    hp = dict(sample_rate=8000, n_octaves=5, bins_per_octave=12,
              secs_per_block=0.5, latent_size=16, model_complexity=1,
              fused="f32", seed=3, skip_connections=True)
    audio = (0.3 * np.random.default_rng(19).standard_normal((1, 1, 18400))
             ).astype(np.float32)
    for cls in (TimbreTrapFiLM, TimbreTrapMagDB):
        card, cpu = cls(**hp), cls(**hp, device="cpu")
        if cls is TimbreTrapMagDB:
            cpu.features_from_audio = lambda a: card.features_from_audio(
                a.to(cuda_device)).cpu()
        got = card.transcribe(audio)
        np.testing.assert_allclose(got.cpu().numpy(),
                                   cpu.transcribe(audio).numpy(), atol=1e-4)
        path = card.save(str(tmp_path / cls.variant))
        loaded = load_model(path, overrides={"fused": "f32"})
        assert type(loaded) is cls and loaded.hparams == card.hparams
        assert torch.equal(loaded.transcribe(audio), got)


# --------------------------------------------------------------------- #
# The Trainer and its data on the card                                   #
# --------------------------------------------------------------------- #

class _ChordMPE(MPEDataset):
    """Chord tracks with their partials annotated (a .wav and a .f0.npy
    each, the layout of ``tests/test_loop.py``'s toy corpus)."""

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
        d = np.load(self.get_ground_truth_path(track), allow_pickle=True).item()
        return d["times"], [np.asarray(p) for p in d["pitches"]]


def _chord_corpus(root, n_tracks, secs, sr=8000, seed=0):
    audio, freqs = chord_tracks(n_tracks, secs, sr, seed)
    times = np.arange(0, secs, 0.01)
    for i in range(n_tracks):
        save_wav(str(root / f"tr{i}.wav"), audio[i], sr)
        np.save(str(root / f"tr{i}.f0.npy"),
                {"times": times, "pitches": [freqs[i]] * len(times)})
    return str(root)


@pytest.mark.cuda
def test_trainer_on_card_counts_its_kernels(cuda_device, tmp_path):
    """A small model's ``"pallas_bf16"`` Trainer run on the card: 2 steps
    launch K1 and K3 on the bf16 route, the validation sweep after them
    launches K2 once a track, every logged metric is finite, and the
    checkpoint loads back bit for bit."""
    hp = dict(sample_rate=8000, n_octaves=5, bins_per_octave=12,
              secs_per_block=0.5, latent_size=16, model_complexity=1, seed=2)
    model = TimbreTrap(**hp)
    (tmp_path / "train").mkdir()
    (tmp_path / "val").mkdir()
    train = _chord_corpus(tmp_path / "train", 4, 1.5, seed=1)
    val = _chord_corpus(tmp_path / "val", 3, 2.0, seed=2)
    kw = dict(splits=["all"], sample_rate=8000, cqt=model.sliCQ)
    loader = DataLoader(_ChordMPE(base_dir=train, n_secs=1.0, **kw),
                        batch_size=2, shuffle=True, drop_last=True)
    config = TrainerConfig(max_epochs=1, checkpoint_interval=2, batch_size=2,
                           n_secs=1.0, n_epochs_warmup=1,
                           validation_criteria_set="_ChordMPE",
                           conv_backend="pallas_bf16",
                           root_dir=str(tmp_path / "run"))

    class Recorder:
        def __init__(self):
            self.scalars = []

        def add_scalar(self, key, value, i):
            self.scalars.append((key, float(value)))

        def add_image(self, *args):
            pass

    trainer = Trainer(model, loader, None,
                      [_ChordMPE(base_dir=val, n_secs=None, **kw)], config,
                      writer=Recorder())
    with kernel_counts() as counts:
        trainer.run()
    assert trainer.batch_count == 2
    assert all(counts[bf16] > 0 and counts[f32] == 0
               for bf16, f32 in (K1, DX, DW)), counts
    assert counts[SEED] > 0 and counts[K2] == 3, counts
    assert all(np.isfinite(v) for _, v in trainer.writer.scalars)
    loaded = load_model(str(tmp_path / "run" / "models" / "model-2"))
    for name, p in model.net.state_dict().items():
        assert torch.equal(loaded.net.state_dict()[name], p), name


@pytest.mark.cuda
def test_flax_step_card_matches_cpu(cuda_device):
    """One ``"flax"`` step (autograd through the NCHW network, cuDNN on the
    card) from the same weights on the card and the CPU, with cuDNN's TF32
    default on: the step turns it off for itself and leaves the flag as it
    was; every loss within 1e-5 relative, every gradient within 1e-4 x its
    leaf's max|g| (or, where a leaf parts by more, the card within 3x the
    CPU's distance from a float64 run)."""
    hp = dict(sample_rate=8000, n_octaves=5, bins_per_octave=12,
              secs_per_block=0.5, latent_size=16, model_complexity=1, seed=4)
    card, cpu = TimbreTrap(**hp), TimbreTrap(**hp, device="cpu")
    audio, gt = synthetic_batch(card, 2, 1.0, seed=6)
    cfg = TrainConfig()
    runs = []
    torch.backends.cudnn.allow_tf32 = True
    try:
        for model in (card, cpu):
            metrics = make_train_step(model, cfg, 2, conv_backend="flax",
                                      compact_audio_grid=True)(
                init_train_state(model, cfg), audio, gt, 1e-3)
            runs.append(({k: float(v) for k, v in metrics.items()},
                         {n: p.grad.cpu()
                          for n, p in model.net.named_parameters()}))
        assert torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32 = False
    (m_card, g_card), (m_cpu, g_cpu) = runs
    for key, want in m_cpu.items():
        if key.startswith("loss/"):
            assert abs(m_card[key] - want) <= 1e-5 * abs(want), key
    over = [n for n, want in g_cpu.items()
            if (g_card[n] - want).abs().max().item()
            > 1e-4 * want.abs().max().item()]
    if over:
        g64 = step_gradients_reference(TimbreTrap(**hp, device="cpu"), cfg,
                                       2, audio, gt, compact_audio_grid=True)

        def dist(g):
            return max((g[n].double() - g64[n]).abs().max().item()
                       / g64[n].abs().max().item() for n in over)
        assert dist(g_card) <= 3 * dist(g_cpu), (over, dist(g_card),
                                                 dist(g_cpu))


@pytest.mark.cuda
def test_device_prefetch_pins_for_the_card(cuda_device):
    """``pin_memory=True`` stages each batch's arrays as page-locked host
    tensors (made on the prefetch thread), values unchanged."""
    batches = [(np.full((2, 3), i, np.int16), np.ones(4, np.uint8))
               for i in range(3)]
    staged = list(device_prefetch(iter(batches), pin_memory=True))
    assert len(staged) == 3
    for i, (audio, gt) in enumerate(staged):
        assert audio.is_pinned() and gt.is_pinned()
        assert torch.equal(audio, torch.full((2, 3), i, dtype=torch.int16))
        assert torch.equal(gt, torch.ones(4, dtype=torch.uint8))
