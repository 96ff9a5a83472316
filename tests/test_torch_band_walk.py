"""The column ranges of a band, which the bf16 K1 stage walks, on the CPU.

A residual block's conv1 is a 3x3 conv dilated by d on both axes: a
64-row sub-tile reads input frequencies f - d, f and f + d, and its band
(``ops/packed_conv.py``) spans the 2(d - 1) frequencies between them,
whose weights are zero by construction. So each band comes as up to three
column ranges taken from the static tap map of the blocks
(``ConvBlocks.ranges``), and ``tt_band_conv_wgmma`` walks only those
(``band_tma_plan``). These tests hold the ranges against the counts they
were designed from, show that they cover every structural nonzero of the
blocks, hold a plain twin that sums the ranges alone against
``band_conv_reference`` bit for bit (on data whose float32 sums are exact,
so no order of sums can hide a missed column), and pin ``band_walk_share``
for the flagship chains. The walk's arithmetic is emulated in
``tests/test_torch_band_tma.py`` and the kernel held against the twin on
the card in ``tests/test_torch_kernels.py``. This file imports no JAX.
"""

import numpy as np
import pytest
import torch

from timbre_trap_tpu_torch.interop import hwio_params
from timbre_trap_tpu_torch.models import TimbreTrapNet, forward_spec
from timbre_trap_tpu_torch.models.fused import level_specs
from timbre_trap_tpu_torch.models.modules import init_weights
from timbre_trap_tpu_torch.ops import fused_level as fl
from timbre_trap_tpu_torch.ops import packed_conv as pc

torch.set_num_threads(2)

# The frequencies of complexity 4's levels by channel width.
_C4_FREQS = {16: 540, 32: 269, 64: 133, 128: 65}

# A 3x3 conv's ranges by (channels, dilation): (even sub-tiles, odd).
# Where the taps' frequencies touch the band is one range.
_RANGES = {
    (16, 1): (((0, 96),), ((64, 96),)),
    (16, 2): (((0, 128),), ((64, 128),)),
    (16, 3): (((0, 160),), ((64, 160),)),
    (32, 1): (((0, 128),), ((64, 128),)),
    (32, 2): (((0, 192),), ((64, 192),)),
    (32, 3): (((0, 64), (96, 64), (192, 64)),
              ((64, 64), (160, 64), (256, 64))),
    (64, 1): (((0, 192),), ((64, 192),)),
    (64, 2): (((0, 64), (128, 64), (256, 64)),
              ((64, 64), (192, 64), (320, 64))),
    (64, 3): (((0, 64), (192, 64), (384, 64)),
              ((64, 64), (256, 64), (448, 64))),
    (128, 1): (((0, 384),), ((0, 384),)),
    (128, 2): (((0, 128), (256, 128), (512, 128)),) * 2,
    (128, 3): (((0, 128), (384, 128), (768, 128)),) * 2,
}

# Pipeline stages a tap of a gapped 3x3, walking each band whole and
# walking its ranges (chunks of 64 columns).
_CHUNKS = {(128, 2): (10, 6), (128, 3): (14, 6), (64, 2): (5, 3),
           (64, 3): (7, 3), (32, 3): (4, 3)}


def _rand(rng, *shape, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape)
                             ).astype(np.float32))


def _ints(rng, *shape, high=3):
    """Small whole numbers: their products and sums are exact in float32,
    so every order of sums gives the same bits."""
    return torch.from_numpy(rng.integers(-high, high + 1, shape).astype(
        np.float32))


def _conv3x3(c, d, f=None, values=_rand):
    rng = np.random.default_rng(c + d)
    return pc.build_conv2d_blocks(values(rng, 3, 3, c, c), values(rng, c),
                                  f or _C4_FREQS[c], d)


@pytest.mark.parametrize("c,d", sorted(_RANGES))
def test_3x3_ranges(c, d):
    """A 3x3 conv's ranges at complexity 4's frequency for its width: each
    a run of the frequencies its taps read (d apart, c columns each), the
    runs that touch merged; their hull is the band, which the float32
    kernel, K3 and the band weights read as before; the chunks a tap,
    whole band against ranges, as designed."""
    cb = _conv3x3(c, d)
    assert cb.ranges == _RANGES[c, d]
    assert cb.bands == tuple(pc._hull(r) for r in _RANGES[c, d])
    plan = fl.band_tma_plan(cb, 1024)
    for (start, ranges), band in zip(plan.bands, cb.bands):
        walked = sum(chunks for _, _, chunks in ranges)
        whole = -(-band[1] // fl.WGMMA_KC)
        assert (whole, walked) == _CHUNKS.get((c, d), (whole, whole))


def _one_range_cases():
    """Maps whose bands have no gaps: complexity 4's period-2 sconv 128 ->
    256 and tconv 256 -> 128, the dense bridge maps, a 1x1 and convin."""
    rng = np.random.default_rng(7)
    return {
        "sconv-P2": pc.build_sconv_blocks(_rand(rng, 4, 1, 128, 256),
                                          _rand(rng, 256), 65),
        "tconv-P2": pc.build_tconv_blocks(_rand(rng, 4, 1, 256, 128),
                                          _rand(rng, 128), 31,
                                          output_padding=1),
        "dense-lat": pc.build_dense_blocks(_rand(rng, 128, 1984),
                                           _rand(rng, 128)),
        "dense-exp": pc.build_dense_blocks(_rand(rng, 1984, 128),
                                           _rand(rng, 1984)),
        "1x1-c128": pc.build_conv2d_blocks(_rand(rng, 1, 1, 128, 128),
                                           _rand(rng, 128), 65),
        "convin": pc.build_conv2d_blocks(_rand(rng, 3, 3, 2, 16),
                                         _rand(rng, 16), 540),
    }


@pytest.mark.parametrize("kind", sorted(_one_range_cases()))
def test_gapless_maps_are_one_range(kind):
    """A map whose taps' columns touch is one range, its band, walked as
    before: one (start 0, length, chunks) a parity in the plan."""
    cb = _one_range_cases()[kind]
    assert cb.ranges == tuple((band,) for band in cb.bands)
    for (start, ranges), band in zip(fl.band_tma_plan(cb, 1001).bands,
                                     cb.bands):
        assert (start, ranges) == (band[0], (
            (0, band[1], -(-band[1] // fl.WGMMA_KC)),))


def test_ranges_must_span_the_bands():
    """A ConvBlocks takes ranges only with the bands as their hulls; left
    out, each band is its one range."""
    cb = _conv3x3(32, 3, f=9)
    args = (cb.blocks, cb.dts, cb.bias, cb.col_adv, cb.margin, cb.f_in,
            cb.f_out, cb.c_in, cb.c_out)
    assert pc.ConvBlocks(*args, cb.bands).ranges == tuple(
        (band,) for band in cb.bands)
    assert pc.ConvBlocks(*args, cb.bands, cb.ranges).ranges == cb.ranges
    with pytest.raises(ValueError, match="do not span"):
        pc.ConvBlocks(*args, cb.bands, (cb.ranges[0][:2], cb.ranges[1]))


def _net_convs(complexity):
    """Every ConvBlocks of a flagship-geometry net's inference chain and
    training levels at ``complexity``, adjoints included."""
    net = init_weights(TimbreTrapNet(540, 128, complexity),
                       torch.Generator().manual_seed(0))
    with torch.no_grad():
        especs, dspecs = level_specs(hwio_params(net), net, True)
        specs = [forward_spec(net, True)] + especs + dspecs
    convs = [cb for s in specs for cb in s.convs()]
    return convs + [cb.adjoint for cb in convs if cb.adjoint is not None]


@pytest.mark.parametrize("complexity", [2, 4])
def test_ranges_cover_every_structural_nonzero(complexity):
    """The weights are random, so a block entry is zero only where the
    tap map puts none: every nonzero entry of a sub-tile's rows lies in
    one of its parity's ranges; the ranges are 16-aligned, in order and
    apart, at most three, their hull the band."""
    convs = _net_convs(complexity)
    assert any(len(r) > 1 for cb in convs for r in cb.ranges)
    for cb in convs:
        nz = (cb.blocks != 0).any(dim=0)
        for half, band in zip(cb.ranges, cb.bands):
            assert 1 <= len(half) <= pc.MAX_RANGES
            assert pc._hull(half) == band
            for (s, n), nxt in zip(half, half[1:]):
                assert s + n < nxt[0]
            assert all(s % 16 == 0 and n % 16 == 0 for s, n in half)
        for g in range(nz.shape[0] // pc.SUB_ROWS):
            cols = torch.zeros(cb.k, dtype=torch.bool)
            for s, n in cb.ranges[g % 2]:
                cols[s:s + n] = True
            rows = nz[g * pc.SUB_ROWS:(g + 1) * pc.SUB_ROWS].any(dim=0)
            assert not (rows & ~cols).any(), (cb.c_in, cb.dts, g)


def range_conv_reference(x, cb):
    """A ConvBlocks conv summed over its ranges alone: output sub-tile g is
    ``sum_dt sum_ranges W_g,dt[:, s:s + n] @ x[s_g + s : s_g + s + n, t +
    dt]`` (band-relative s), plus the bias; rows and frames outside the
    input read as zero."""
    b, r_in, t = x.shape
    wb = cb.band_weights().to(x.dtype)
    max_dt = max(abs(d) for d in cb.dts)
    top = max(0, -min(cb.sub_start(g) for g in range(cb.n_sub)))
    xp = torch.nn.functional.pad(x, (max_dt, max_dt, top,
                                     top + cb.band_width))
    y = torch.zeros((b, cb.n_sub * pc.SUB_ROWS, t), dtype=x.dtype)
    for g in range(cb.n_sub):
        start = cb.bands[g % 2][0]
        w = wb[cb.sub_weights(g)]
        for di, dt in enumerate(cb.dts):
            for s, n in cb.ranges[g % 2]:
                k0 = cb.sub_start(g) + s - start + top
                xs = xp[:, k0:k0 + n, max_dt + dt:max_dt + dt + t]
                y[:, g * pc.SUB_ROWS:(g + 1) * pc.SUB_ROWS] += torch.einsum(
                    "rk,bkt->brt", w[di, :, s - start:s - start + n], xs)
    bias = cb.bias.to(x.dtype)
    bias = bias.repeat(-(-cb.r_out // bias.numel()))[:cb.r_out]
    return y[:, :cb.r_out] + bias[None, :, None]


def _twin_cases():
    out = {f"3x3-d{d}-c{c}": _conv3x3(c, d, f, _ints)
           for c, d, f in ((128, 2, 5), (128, 3, 7), (64, 2, 9), (64, 3, 11),
                           (32, 3, 19), (32, 2, 19), (16, 3, 40))}
    rng = np.random.default_rng(3)
    out["sconv-P2"] = pc.build_sconv_blocks(_ints(rng, 4, 1, 128, 256),
                                            _ints(rng, 256), 13)
    out["dense-lat"] = pc.build_dense_blocks(_ints(rng, 128, 496),
                                             _ints(rng, 128))
    return out


@pytest.mark.parametrize("kind", sorted(_twin_cases()))
def test_range_twin_equals_band_twin_bit_for_bit(kind):
    """The conv summed over the ranges alone equals ``band_conv_reference``
    (the whole band) and ``packed_conv_reference`` bit for bit in float32,
    on whole-number weights and input whose sums are exact: a nonzero
    column outside the ranges would change the result."""
    cb = _twin_cases()[kind]
    x = _ints(np.random.default_rng(len(kind)), 2, cb.r_in, 21)
    got = range_conv_reference(x, cb)
    assert torch.equal(got, pc.band_conv_reference(x, cb))
    assert torch.equal(got, pc.packed_conv_reference(x, cb))


# The flagship chains' bf16 pipeline stages at one frame tile: walked,
# whole bands.
_WALK = {2: (7183, 7381), 4: (42870, 57828)}


@pytest.mark.parametrize("complexity", sorted(_WALK))
def test_walk_share_of_the_flagship_chains(complexity):
    """``band_walk_share`` of the inference chain, the bf16 stage's walked
    pipeline stages over its whole bands' at one frame tile (a sub-tile,
    tap and 64-column chunk each), counted from the plans: at complexity 2
    only the two 32-channel dilation-3 conv1s walk ranges (4 chunks a tap
    -> 3), ~0.973; at complexity 4 every 3x3 at 64 and 128 channels and
    dilation 2 or 3 too, ~0.741."""
    net = init_weights(TimbreTrapNet(540, 128, complexity),
                       torch.Generator().manual_seed(0))
    with torch.no_grad():
        convs = list(forward_spec(net, True).convs())
    walked = whole = 0
    for cb in convs:
        plan = fl.band_tma_plan(cb, 1024)
        for g in range(cb.n_sub):
            start, ranges = plan.bands[g % 2]
            walked += len(cb.dts) * sum(c for _, _, c in ranges)
            whole += len(cb.dts) * -(-cb.bands[g % 2][1] // fl.WGMMA_KC)
    assert (walked, whole) == _WALK[complexity]
    assert fl.band_walk_share(convs) == walked / whole
