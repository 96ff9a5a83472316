"""The band geometry of the port's banded convs and the plain functions
that the tensor-core kernels (``csrc/band_mma.cu``) compute.

Each 64-row half of a block (a sub-tile) carries the band of columns it
reads, from the builder's static tap map. These tests hold, on the CPU:
that the bands cover every structurally nonzero column (forward and
adjoint blocks, small and flagship geometry), that a conv computed from the
bands alone equals ``packed_conv_reference``, that keeping dW on the
bands leaves every parameter gradient unchanged, and that the float32
route's split-TF32 products (emulated here on the plain band function)
stay within the card's float32 check. This file imports no JAX.
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
    """Every ConvBlocks of a net's inference route and of its training
    levels, adjoints included, built from the blocks alone (no forward).
    ``geometry`` is the size, then optionally the family with skip
    connections (``flagship-mag-skips``)."""
    size, *family = geometry.split("-")
    f, latent, complexity = {"small": (60, 16, 1),
                             "flagship": (540, 128, 2)}[size]
    variant, skips = (family[0], True) if family else ("base", False)
    net = init_weights(TimbreTrapNet(f, latent, complexity, variant, skips),
                       torch.Generator().manual_seed(0))
    with torch.no_grad():
        route = forward_spec(net, True)
        specs = route.especs + route.dspecs if skips else [route]
        especs, dspecs = level_specs(hwio_params(net), net, True)
    convs = [cb for s in specs + especs + dspecs for cb in s.convs()]
    return convs + [cb.adjoint for cb in convs if cb.adjoint is not None]


@pytest.mark.parametrize("geometry", ["small", "flagship",
                                      "flagship-base-skips",
                                      "flagship-mag-skips"])
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
    # The one-channel families' convin and convout (Mag, MagDB).
    cases["convin-c1"] = pc.build_conv2d_blocks(_rand(rng, 3, 3, 1, 4),
                                                _rand(rng, 4), 540)
    cases["convout-c1"] = pc.build_conv2d_blocks(_rand(rng, 3, 3, 4, 1),
                                                 _rand(rng, 1), 540)
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
    """dW kept on the bands (the kernels' output) gives, through the
    one-hot builder's backward, the same kernel and bias gradients as the
    full dW (autograd of the plain conv); the twin of dW, float32 and
    bf16, is zero off the bands and equals the full dW on them."""
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
    dw_full, db_full = torch.autograd.grad(
        pc.packed_conv_reference(x, cb), (cb.blocks, cb.bias), dz,
        retain_graph=True)
    mask = cb.band_mask()
    # The block construction's backward is linear in dW: the entries off
    # the bands reach no parameter gradient exactly when their own image
    # is zero.
    dropped = torch.autograd.grad((cb.blocks, cb.bias), (kernel, bias),
                                  (dw_full * ~mask, torch.zeros_like(db_full)),
                                  retain_graph=True)
    for g in dropped:
        assert not g.any()
    dw, db = banded_conv_dw_reference(dz, x, cb)
    assert not dw[~mask].any() and dw[mask].any()
    scale = float(dw_full.abs().max())
    assert float((dw - dw_full * mask).abs().max()) <= 1e-5 * scale
    assert float((db - db_full).abs().max()) <= 1e-5 * float(db_full.abs().max())
    dw16, _ = banded_conv_dw_reference(dz, x.to(torch.bfloat16), cb)
    assert not dw16[~mask].any() and dw16[mask].any()


def _tf32_rna(x):
    """float32 rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32``: on the int32 view, add half of
    the 13 dropped bits to the magnitude and clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_tf32(v):
    """(hi, lo) of the split-TF32 routes: hi a TF32 rounding of v, lo =
    v - hi, of which the tensor cores keep the TF32 bits (the low 13
    cleared)."""
    hi = _tf32_rna(v)
    lo = (v - hi).contiguous().view(torch.int32) & ~0x1FFF
    return hi, lo.view(torch.float32)


def _split_tf32_conv(x, cb):
    """The float32 stage of ``csrc/band_mma.cu`` (``tt_band_conv_f32``;
    dX, ``tt_band_conv_dx_f32``, on adjoint blocks) emulated on the plain
    band function: x and the blocks split into hi + lo; the three products
    hi*hi, hi*lo and lo*hi summed in float32 with round-to-nearest adds
    (the kernel adds each 16-column chunk's products into its running sum
    so, not in the truncating MMA accumulators), then the bias."""
    (xh, xl), (wh, wl) = _split_tf32(x), _split_tf32(cb.blocks)
    cb0 = _like(cb, cb.blocks, torch.zeros_like(cb.bias))
    small = (pc.band_conv_reference(xl, cb0, wh)
             + pc.band_conv_reference(xh, cb0, wl))
    return small + pc.band_conv_reference(xh, cb, wh)


def _like(cb, blocks, bias):
    """A ConvBlocks of ``cb``'s geometry with other blocks and bias."""
    return pc.ConvBlocks(blocks, cb.dts, bias, cb.col_adv, cb.margin,
                         cb.f_in, cb.f_out, cb.c_in, cb.c_out, cb.per_block,
                         cb.bands)


def test_tf32_rna_rounds_to_nearest_away():
    one = 1.0 + 2.0 ** -10                      # the TF32 step above 1
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12,
                      -(1.0 + 2.0 ** -11), 3.0 + 2.0 ** -20],
                     dtype=torch.float32)
    want = torch.tensor([1.0, one, 1.0, -one, 3.0], dtype=torch.float32)
    assert torch.equal(_tf32_rna(x), want)
    v = _rand(np.random.default_rng(3), 1000)
    hi = _tf32_rna(v)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert float(((v - hi) / v).abs().max()) <= 2.0 ** -11


def _split_cases():
    cases = dict(_CASES)
    # One flagship-width encoder stage: a residual 3x3 conv of encoder
    # level 1 (540 bins x 4 channels).
    rng = np.random.default_rng(21)
    cases["flagship-enc1-3x3"] = pc.build_conv2d_blocks(
        _rand(rng, 3, 3, 4, 4, scale=0.3), _rand(rng, 4, scale=0.1), 540, 1)
    return cases


_SPLIT_CASES = _split_cases()


@pytest.mark.parametrize("name", sorted(_SPLIT_CASES))
def test_split_tf32_error_within_the_float32_check(name):
    """The float32 route's 3xTF32 products, emulated on the CPU, against
    the same band function in float64: the error stays inside the card's
    float32 check (1e-4 * max|ref|), next to the IEEE float32 error."""
    cb = _SPLIT_CASES[name]
    x = _rand(np.random.default_rng(4), 2, cb.r_in, 37)
    ref = pc.band_conv_reference(
        x.double(), _like(cb, cb.blocks.double(), cb.bias.double()))
    ieee = pc.band_conv_reference(x, cb)
    split = _split_tf32_conv(x, cb)
    scale = float(ref.abs().max())
    e_split = float((split.double() - ref).abs().max())
    e_ieee = float((ieee.double() - ref).abs().max())
    print(f"{name}: split {e_split / scale:.2e}, IEEE {e_ieee / scale:.2e} "
          f"of max|ref|, ratio {e_split / max(e_ieee, 1e-300):.2f}")
    assert e_split <= 1e-4 * scale
    # Far inside it: a few float32 roundings of the sum, not a TF32 one.
    assert e_split <= 1e-5 * scale


def _train_convs():
    """One conv of each kind and channel width in the small net's training
    levels (3x3 at dilations 1-3, 1x1, convin, convout, sconv, tconv),
    each with its adjoint."""
    net = init_weights(TimbreTrapNet(60, 16, 1),
                       torch.Generator().manual_seed(0))
    with torch.no_grad():
        especs, dspecs = level_specs(hwio_params(net), net, True)
    out = {}
    for cb in (c for s in especs + dspecs for c in s.convs()):
        if cb.f_out != cb.f_in:
            kind = "sconv" if cb.f_out < cb.f_in else "tconv"
        else:
            kind = "1x1" if len(cb.dts) == 1 else f"3x3-d{max(cb.dts)}"
        out.setdefault(f"{kind}-c{cb.c_in}-{cb.c_out}", cb)
    return out


_TRAIN_CONVS = _train_convs()

# The split-TF32 error may exceed the IEEE float32 one by at most this
# factor: both are a few float32 roundings of the sum; the split adds the
# dropped lo*lo and lo's cleared bits, ~2^-21 of each product.
_SPLIT_IEEE_FACTOR = 3.0


def _chunked_dw(dz, x, cb, product):
    """dW as the band-tiled dW kernels of ``csrc/band_mma.cu`` order it:
    for every (batch, block, 64-frame) chunk and tap, ``product(z, xc)`` of
    the chunk's 128 dZ rows read at frame - dt (128 x 64) and its K input
    rows (K x 64), zero outside the tensors, added into the tap's running
    sum (one round-to-nearest add per chunk and tap), kept on the bands."""
    b, r_in, t = x.shape
    nb, md = cb.n_out_blocks, max(abs(d) for d in cb.dts)
    tp = -(-t // 64) * 64
    zp = torch.nn.functional.pad(dz, (md, tp - t + md, 0,
                                      nb * pc.BLOCK_ROWS - cb.r_out))
    rows = (nb - 1) * cb.col_adv + cb.k
    xp = torch.nn.functional.pad(
        x, (0, tp - t, cb.margin, max(0, rows - cb.margin - r_in)))
    dw = torch.zeros((len(cb.dts), pc.BLOCK_ROWS, cb.k), dtype=x.dtype)
    for bi in range(b):
        for j in range(nb):
            zr = zp[bi, j * pc.BLOCK_ROWS:(j + 1) * pc.BLOCK_ROWS]
            xr = xp[bi, j * cb.col_adv:j * cb.col_adv + cb.k]
            for t0 in range(0, tp, 64):
                for di, dt in enumerate(cb.dts):
                    z = zr[:, md + t0 - dt:md + t0 - dt + 64]
                    dw[di] += product(z, xr[:, t0:t0 + 64])
    return dw * cb.band_mask()


def _split_tf32_product(z, xc):
    """A chunk's product as ``tt_band_conv_dw_f32`` computes it: both
    operands split into hi + lo, lo*hi + hi*lo + hi*hi in float32."""
    (zh, zl), (xh, xl) = _split_tf32(z), _split_tf32(xc)
    return (zl @ xh.T + zh @ xl.T) + zh @ xh.T


def _errors(got, ieee, ref):
    scale = float(ref.abs().max())
    e_got = float((got.double() - ref).abs().max())
    e_ieee = float((ieee.double() - ref).abs().max())
    return e_got, e_ieee, scale


@pytest.mark.parametrize("name", sorted(_TRAIN_CONVS))
def test_split_tf32_dw_error_within_the_float32_check(name):
    """The float32 dW route (split-TF32 products of each 64-frame chunk,
    one IEEE add per chunk and tap into the running sum), emulated on the
    CPU, against dW in float64: within 1e-5 * max|ref| and within
    ``_SPLIT_IEEE_FACTOR`` of the IEEE float32 twin's error."""
    cb = _TRAIN_CONVS[name]
    rng = np.random.default_rng(16)
    x = _rand(rng, 2, cb.r_in, 150)
    dz = _rand(rng, 2, cb.r_out, 150)
    ref = _chunked_dw(dz.double(), x.double(), cb, lambda z, v: z @ v.T)
    ieee, _ = banded_conv_dw_reference(dz, x, cb)
    split = _chunked_dw(dz, x, cb, _split_tf32_product)
    assert not split[~cb.band_mask()].any()
    e_split, e_ieee, scale = _errors(split, ieee, ref)
    print(f"{name}: dW split {e_split / scale:.2e}, IEEE "
          f"{e_ieee / scale:.2e} of max|ref|")
    assert e_split <= 1e-5 * scale
    assert e_split <= _SPLIT_IEEE_FACTOR * e_ieee


@pytest.mark.parametrize("name", sorted(_TRAIN_CONVS))
def test_split_tf32_dx_error_within_the_float32_check(name):
    """The float32 dX route (the stage's split-TF32 products on the
    adjoint's bands), emulated on the CPU, against dX in float64: within
    1e-5 * max|ref| and within ``_SPLIT_IEEE_FACTOR`` of the IEEE float32
    twin's error."""
    adj = _TRAIN_CONVS[name].adjoint
    c = _rand(np.random.default_rng(17), 2, adj.r_in, 37)
    ref = pc.band_conv_reference(
        c.double(), _like(adj, adj.blocks.double(), adj.bias.double()))
    ieee = pc.band_conv_reference(c, adj)
    split = _split_tf32_conv(c, adj)
    e_split, e_ieee, scale = _errors(split, ieee, ref)
    print(f"{name}: dX split {e_split / scale:.2e}, IEEE "
          f"{e_ieee / scale:.2e} of max|ref|")
    assert e_split <= 1e-5 * scale
    assert e_split <= _SPLIT_IEEE_FACTOR * e_ieee


def _pairwise(parts):
    """The fixed pairwise tree of ``band_dw_reduce_kernel``: a binary
    counter merges two partial sums of equal size as soon as both exist,
    then the leftovers from the smallest up."""
    stack = []
    for v in parts:
        size = 1
        while stack and stack[-1][1] == size:
            v = stack.pop()[0] + v
            size *= 2
        stack.append((v, size))
    v = stack.pop()[0]
    while stack:
        v = stack.pop()[0] + v
    return v


def _kernel_dbias(dz, cb):
    """dBias in float32 as ``tt_band_conv_dw_f32`` orders it: the
    (batch, block, 64-frame) chunks cut into the wrapper's slices; in each
    chunk a thread sums 16 frames of one row in order and adds that into
    its running sum over the slice's chunks; a row's four quarters add as
    ((q0 + q1) + q2) + q3; the slices' partials meet in the pairwise
    tree."""
    b, r_out, t = dz.shape
    nb, n_tc = cb.n_out_blocks, -(-t // 64)
    z = np.zeros((b, nb * pc.BLOCK_ROWS, n_tc * 64), np.float32)
    z[:, :r_out, :t] = dz.numpy()
    z = z.reshape(b, nb, pc.BLOCK_ROWS, n_tc, 4, 16)
    quarter = z[..., 0]
    for f in range(1, 16):
        quarter = quarter + z[..., f]
    chunks = quarter.transpose(0, 1, 3, 2, 4).reshape(-1, pc.BLOCK_ROWS, 4)
    n = chunks.shape[0]
    tiles = 2 * -(-max(length for _, length in cb.bands) // 64)
    n_slices = max(1, min(n, -(-132 * 4 // tiles)))
    parts = []
    for sl in range(n_slices):
        acc = np.zeros((pc.BLOCK_ROWS, 4), np.float32)
        for q in range(n * sl // n_slices, n * (sl + 1) // n_slices):
            acc = acc + chunks[q]
        parts.append(((acc[:, 0] + acc[:, 1]) + acc[:, 2]) + acc[:, 3])
    return torch.from_numpy(_pairwise(parts)), n_slices


def _dbias_cases():
    cases = dict(_TRAIN_CONVS)
    cases["flagship-enc1-3x3"] = _SPLIT_CASES["flagship-enc1-3x3"]
    return cases


_DBIAS_CASES = _dbias_cases()


@pytest.mark.parametrize("name", sorted(_DBIAS_CASES))
def test_kernel_dbias_error_within_the_float32_check(name):
    """The float32 dBias of the dW kernels (per-slice partials, a pairwise
    tree over the slices), emulated on the CPU, against dBias in float64:
    within ``_SPLIT_IEEE_FACTOR`` of the IEEE float32 twin's error, as dX
    and dW are held, at the recipe's length (4 of its 8 crops), which
    cuts it into many slices: there a sum in slice order is 5.3x the IEEE
    error."""
    cb = _DBIAS_CASES[name]
    b, t = 4, 3072
    dz = _rand(np.random.default_rng(18), b, cb.r_out, t)
    ref = torch.nn.functional.pad(
        dz.double(), (0, 0, 0, cb.n_out_blocks * pc.BLOCK_ROWS - cb.r_out)
    ).reshape(b, cb.n_out_blocks, pc.BLOCK_ROWS, t).sum(dim=(0, 1, 3))
    _, ieee = banded_conv_dw_reference(dz, _rand(np.random.default_rng(19),
                                                 b, cb.r_in, t), cb)
    got, n_slices = _kernel_dbias(dz, cb)
    e_got, e_ieee, scale = _errors(got, ieee, ref)
    print(f"{name}: dBias over {n_slices} slices {e_got / scale:.2e}, IEEE "
          f"{e_ieee / scale:.2e} of max|ref|, ratio "
          f"{e_got / max(e_ieee, 1e-300):.2f}")
    assert n_slices > 8
    assert e_got <= _SPLIT_IEEE_FACTOR * e_ieee


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
