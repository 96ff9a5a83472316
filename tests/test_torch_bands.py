"""The band geometry of the port's banded convs and the plain functions
that the bf16 tensor-core kernels (``csrc/band_mma.cu``) compute.

Each 64-row half of a block (a sub-tile) carries the band of columns it
reads, from the builder's static tap map. These tests hold, on the CPU:
that the bands cover every structurally nonzero column (forward and
adjoint blocks, small and flagship geometry), that a conv computed from the
bands alone equals ``packed_conv_reference``, and that keeping dW on the
bands leaves every parameter gradient unchanged. This file imports no JAX.
"""

import numpy as np
import pytest
import torch

from timbre_trap_tpu_torch.interop import hwio_params
from timbre_trap_tpu_torch.models import TimbreTrapNet, forward_spec
from timbre_trap_tpu_torch.models.fused import level_specs
from timbre_trap_tpu_torch.models.modules import init_weights
from timbre_trap_tpu_torch.ops import packed_conv as pc
from timbre_trap_tpu_torch.ops.fused_level import (band_flops, chain_flops,
                                                   banded_conv_dw_reference)

torch.set_num_threads(2)


def _rand(rng, *shape, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape)
                             ).astype(np.float32))


def _net_specs(geometry):
    """Every ConvBlocks of a net's inference chain and of its training
    levels, adjoints included, built from the blocks alone (no forward)."""
    f, latent, complexity = {"small": (60, 16, 1),
                             "flagship": (540, 128, 2)}[geometry]
    net = init_weights(TimbreTrapNet(f, latent, complexity),
                       torch.Generator().manual_seed(0))
    with torch.no_grad():
        specs = [forward_spec(net, True)]
        especs, dspecs = level_specs(hwio_params(net), net, True)
    convs = [cb for s in specs + especs + dspecs for cb in s.convs()]
    return convs + [cb.adjoint for cb in convs if cb.adjoint is not None]


@pytest.mark.parametrize("geometry", ["small", "flagship"])
def test_bands_cover_every_structural_nonzero(geometry):
    """The weights are random, so a block entry is zero only where the
    tap map puts none: every nonzero entry of a sub-tile's rows lies in its
    band, and each band is 16-aligned and starts inside the block."""
    convs = _net_specs(geometry)
    assert len(convs) > 60
    for cb in convs:
        nz = (cb.blocks != 0).any(dim=0)
        for g in range(nz.shape[0] // pc.SUB_ROWS):
            start, length = cb.bands[g % 2]
            assert start % 16 == 0 and length % 16 == 0 and length > 0
            assert 0 <= start < cb.k
            cols = torch.nonzero(
                nz[g * pc.SUB_ROWS:(g + 1) * pc.SUB_ROWS].any(dim=0)).flatten()
            if cols.numel():          # none in a dense map's padding rows
                assert int(cols.min()) >= start
                assert int(cols.max()) < start + length


def _conv_cases():
    """One ConvBlocks of each kind: SAME 3x3 at dilations 1-3 (time taps
    up to 3), 1x1, convin/convout widths, VALID sconv, tconv with output
    padding, and the two dense bridge maps."""
    rng = np.random.default_rng(11)
    cases = {}
    for d in (1, 2, 3):
        cases[f"3x3-c4-d{d}"] = pc.build_conv2d_blocks(
            _rand(rng, 3, 3, 4, 4), _rand(rng, 4), 540, d)
        cases[f"3x3-c32-d{d}"] = pc.build_conv2d_blocks(
            _rand(rng, 3, 3, 32, 32), _rand(rng, 32), 65, d)
    cases["1x1-c16"] = pc.build_conv2d_blocks(_rand(rng, 1, 1, 16, 16),
                                              _rand(rng, 16), 133)
    cases["convin"] = pc.build_conv2d_blocks(_rand(rng, 3, 3, 2, 4),
                                             _rand(rng, 4), 540)
    cases["convout"] = pc.build_conv2d_blocks(_rand(rng, 3, 3, 4, 2),
                                              _rand(rng, 2), 540)
    cases["sconv"] = pc.build_sconv_blocks(_rand(rng, 4, 1, 8, 16),
                                           _rand(rng, 16), 269)
    cases["tconv"] = pc.build_tconv_blocks(_rand(rng, 4, 1, 16, 8),
                                           _rand(rng, 8), 133,
                                           output_padding=1)
    cases["dense-lat"] = pc.build_dense_blocks(
        _rand(rng, 128, 1984, scale=0.03), _rand(rng, 128))
    cases["dense-exp"] = pc.build_dense_blocks(
        _rand(rng, 270, 129, scale=0.1), _rand(rng, 270))
    return cases


_CASES = _conv_cases()


@pytest.mark.parametrize("name", sorted(_CASES))
def test_band_conv_reference_equals_packed(name):
    cb = _CASES[name]
    x = _rand(np.random.default_rng(1), 2, cb.r_in, 23)
    want = pc.packed_conv_reference(x, cb)
    got = pc.band_conv_reference(x, cb)
    assert got.shape == want.shape
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-6 * scale


@pytest.mark.parametrize("name", sorted(n for n in _CASES
                                        if not n.startswith("dense")))
def test_band_masked_dw_keeps_parameter_gradients(name):
    """dW kept on the bands (the bf16 kernel's output) gives, through the
    one-hot builder's backward, the same kernel and bias gradients as the
    full dW; the bf16 twin of dW is zero off the bands."""
    cb0 = _CASES[name]
    rng = np.random.default_rng(2)
    kh = {"sconv": 4, "tconv": 4, "1x1-c16": 1}.get(name, 3)
    kw = 1 if name in ("sconv", "tconv") or name.startswith("1x1") else 3
    kernel = _rand(rng, kh, kw, cb0.c_in, cb0.c_out).requires_grad_(True)
    bias = _rand(rng, cb0.c_out).requires_grad_(True)
    if name == "sconv":
        cb = pc.build_sconv_blocks(kernel, bias, cb0.f_in)
    elif name == "tconv":
        cb = pc.build_tconv_blocks(kernel, bias, cb0.f_in, output_padding=1)
    else:
        cb = pc.build_conv2d_blocks(kernel, bias, cb0.f_in,
                                    max(cb0.dts) or 1)
    assert cb.bands == cb0.bands
    x = _rand(rng, 2, cb.r_in, 19)
    dz = _rand(rng, 2, cb.r_out, 19)
    dw, db = banded_conv_dw_reference(dz, x, cb)
    mask = cb.band_mask()
    full = torch.autograd.grad((cb.blocks, cb.bias), (kernel, bias),
                               (dw, db), retain_graph=True)
    kept = torch.autograd.grad((cb.blocks, cb.bias), (kernel, bias),
                               (dw * mask, db))
    for g_full, g_kept in zip(full, kept):
        assert torch.equal(g_full, g_kept)
    dw16, _ = banded_conv_dw_reference(dz, x.to(torch.bfloat16), cb)
    assert not dw16[~mask].any() and dw16[mask].any()


def test_flagship_band_flops():
    """The bf16 forward at (4, ., 1024) computes 210.18 GFLOP of banded
    products on the bands, 62.7 % of the full blocks' 335.01."""
    net = init_weights(TimbreTrapNet(540, 128, 2),
                       torch.Generator().manual_seed(0))
    with torch.no_grad():
        spec = forward_spec(net, True)
    assert band_flops(spec.convs(), 1) == 51312640
    assert band_flops(spec.convs(), 4 * 1024) <= 212.6e9
    assert chain_flops(spec, 4 * 1024) == 335009546240
