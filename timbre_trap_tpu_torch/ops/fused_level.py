"""Level specs, the fused conv chain (kernel K1) and its backward (K3).

Counterpart of ``timbre_trap_tpu/ops/fused_level.py``: the spec layer
(``LevelSpec``, ``encoder_level_spec``, ``decoder_level_spec``,
``fuse_level_specs``, ``spec_time_reach``) and the forward of a chain of
items on packed ``(B, R, T)`` input. An item is ``("conv", cb, act)`` or a
residual block ``("rb", cb3x3, cb1x1)``: conv3x3 + ELU -> conv1x1 + ELU ->
plus the item input.

``fused_level_apply`` runs the chain through hand-written CUDA kernels
(which replace the Pallas ``_level_kernel``), one launch per conv stage:
the band-tiled TMA-fed wgmma kernels of ``csrc/band_wgmma.cu``, bf16
products for bfloat16, split-TF32 (3xTF32) products for float32;
``packed_level_apply`` is their plain PyTorch twin. Both keep the JAX
precision policy: every stage input, weight and output is stored at
``dtype`` (float32 or bfloat16), accumulation and biases are float32.

Training: a spec built ``with_adjoints`` carries each conv's adjoint (its
dX map, another banded conv). ``fused_level_train`` is the differentiable
level (the port of ``make_fused_level_train``): its forward is K1, and its
backward ``level_backward`` runs hand-written kernels (which replace the
Pallas ``_level_bwd_kernel``) stage by stage: the band-tiled dX and dW
products of ``csrc/band_mma.cu`` (bf16 products for bfloat16, split-TF32
for float32; dW on the bands only) and the ELU' seed of
``csrc/banded_conv_bwd.cu``; ``level_backward_reference`` is the same
algorithm in plain PyTorch.
"""

import ctypes
from typing import NamedTuple

import torch

from ..utils.profiling import span
from . import _build
from .packed_conv import (BLOCK_ROWS, SUB_ROWS, ConvBlocks,
                          build_conv2d_blocks, build_sconv_blocks,
                          build_tconv_blocks, packed_conv_reference)

__all__ = ["HALO", "LevelSpec", "conv2d_level_spec", "encoder_level_spec",
           "decoder_level_spec",
           "fuse_level_specs", "spec_time_reach", "banded_conv",
           "banded_conv_reference", "BandTmaPlan",
           "band_tma_plan", "BandTmaPlanF32", "band_tma_plan_f32",
           "tma_frames", "packed_level_apply",
           "fused_level_apply",
           "chain_flops", "band_flops", "band_walk_share", "banded_conv_dx",
           "banded_conv_dx_reference",
           "banded_conv_dw", "banded_conv_dw_reference", "elu_backward",
           "elu_backward_reference", "level_backward",
           "level_backward_reference", "fused_level_train"]

# Time halo per side of the JAX kernel's tiles; a fused chain's cumulative
# time reach must fit it there, and the same limit holds here.
HALO = 64
# Largest time-tap magnitude the tensor-core kernels take (csrc/band_mma.cu
# kHalo; every route holds to it).
BAND_MAX_DT = 8

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class LevelSpec:
    """Static description of a chain of conv items (one level or several).

    A level of a network's kept specs also carries its ``BandStore``
    (``store``), the latest refresh's gradient route (``grad_route``: the
    level's dense blocks and biases, one differentiable vector) and where
    each conv's dW and dBias lie in that vector (``grad_offsets``,
    ``grad_size``)."""

    def __init__(self, items, r_in):
        self.items = items
        self.r_in = int(r_in)
        self.store = self.grad_route = self.grad_offsets = None
        self.grad_size = 0
        r = self.r_in
        for it in items:
            cb = it[1]
            if cb.r_in != r:
                raise ValueError(f"item reads {cb.r_in} rows, chain has {r}")
            r = cb.r_out if it[0] == "conv" else r
        self.r_out = r

    def convs(self):
        for it in self.items:
            for cb in it[1:]:
                if isinstance(cb, ConvBlocks):
                    yield cb


def _adjoint_kernel(kernel):
    """The forward kernel, detached, with its channels swapped: adjoint
    blocks carry no gradient (the forward blocks carry it, as in JAX)."""
    return torch.as_tensor(kernel).detach().to(torch.float32).permute(
        0, 1, 3, 2)


def _zero_bias(kernel):
    k = torch.as_tensor(kernel)
    return torch.zeros(k.shape[2], dtype=torch.float32, device=k.device)


def _attach_conv2d_adjoint(cb, kernel, f_in, dilation):
    """dX of a SAME 2D conv = SAME conv with flipped taps, channels swapped."""
    adj_k = torch.flip(_adjoint_kernel(kernel), (0, 1))
    cb.adjoint = build_conv2d_blocks(adj_k, _zero_bias(kernel), f_in,
                                     dilation)
    return cb


def _attach_sconv_adjoint(cb, kernel, f_in, stride=2):
    """dX of the strided VALID conv = transposed conv with the same kernel,
    channels swapped, output_padding chosen so f_out == the forward f_in."""
    kh = torch.as_tensor(kernel).shape[0]
    pad = f_in - ((cb.f_out - 1) * stride + kh)
    cb.adjoint = build_tconv_blocks(_adjoint_kernel(kernel),
                                    _zero_bias(kernel), cb.f_out,
                                    stride=stride, output_padding=pad)
    if cb.adjoint.r_out != cb.r_in:
        raise ValueError("sconv adjoint does not map back to the input rows")
    return cb


def _attach_tconv_adjoint(cb, kernel, stride=2):
    """dX of the transposed conv = strided VALID conv, channels swapped."""
    cb.adjoint = build_sconv_blocks(_adjoint_kernel(kernel),
                                    _zero_bias(kernel), cb.f_out,
                                    stride=stride)
    if cb.adjoint.r_out != cb.r_in:
        raise ValueError("tconv adjoint does not map back to the input rows")
    return cb


def _conv2d(params, f, dilation, with_adjoints):
    cb = build_conv2d_blocks(params["kernel"], params["bias"], f, dilation)
    if with_adjoints:
        _attach_conv2d_adjoint(cb, params["kernel"], f, dilation)
    return cb


def _residual_items(block_params, f, with_adjoints):
    return [("rb", _conv2d(block_params[f"block{i + 1}"]["conv1"], f, d,
                           with_adjoints),
             _conv2d(block_params[f"block{i + 1}"]["conv2"], f, 1,
                     with_adjoints))
            for i, d in enumerate((1, 2, 3))]


def conv2d_level_spec(conv_params, f_in, act, with_adjoints=False):
    """A one-conv LevelSpec: a SAME 3x3 conv (+ ELU with ``act``), the
    standalone convin or convout of a network with skip connections."""
    cb = _conv2d(conv_params, f_in, 1, with_adjoints)
    return LevelSpec([("conv", cb, bool(act))], cb.r_in)


def encoder_level_spec(block_params, f_in, convin_params=None,
                       with_adjoints=False):
    """LevelSpec for an EncoderBlock (+ optionally the preceding convin);
    ``block_params`` holds block1..block3 (conv1, conv2) and sconv, HWIO.
    ``with_adjoints`` attaches each conv's adjoint blocks (training)."""
    items = []
    if convin_params is not None:
        items.append(("conv", _conv2d(convin_params, f_in, 1, with_adjoints),
                      True))
    items.extend(_residual_items(block_params, f_in, with_adjoints))
    sc = block_params["sconv"]
    cbs = build_sconv_blocks(sc["kernel"], sc["bias"], f_in, stride=2)
    if with_adjoints:
        _attach_sconv_adjoint(cbs, sc["kernel"], f_in, stride=2)
    items.append(("conv", cbs, True))
    return LevelSpec(items, items[0][1].r_in)


def decoder_level_spec(block_params, f_in, output_padding=0,
                       convout_params=None, with_adjoints=False):
    """LevelSpec for a DecoderBlock (+ optionally the trailing convout)."""
    tc = block_params["tconv"]
    cb_t = build_tconv_blocks(tc["kernel"], tc["bias"], f_in, stride=2,
                              output_padding=output_padding)
    if with_adjoints:
        _attach_tconv_adjoint(cb_t, tc["kernel"], stride=2)
    f_mid = cb_t.f_out
    items = [("conv", cb_t, True)]
    items.extend(_residual_items(block_params, f_mid, with_adjoints))
    if convout_params is not None:
        items.append(("conv", _conv2d(convout_params, f_mid, 1,
                                      with_adjoints), False))
    return LevelSpec(items, cb_t.r_in)


def spec_time_reach(spec):
    """Columns per side that the chained stages read beyond a column: the
    sum over convs of their largest time-tap magnitude."""
    return sum(max(abs(d) for d in cb.dts) for cb in spec.convs())


def fuse_level_specs(specs):
    """Concatenate adjacent LevelSpecs into one chain.

    Raises ValueError when the chain's cumulative time reach exceeds
    ``HALO`` (the flagship whole forward reaches 50).
    """
    items = []
    for s in specs:
        items.extend(s.items)
    fused = LevelSpec(items, specs[0].r_in)
    reach = spec_time_reach(fused)
    if reach > HALO:
        raise ValueError(f"fused spec time reach {reach} exceeds the "
                         f"{HALO}-column halo; fuse fewer levels")
    return fused


def _elu(v):
    # As the JAX package writes it: exp(min(v, 0)) - 1 below zero.
    return torch.where(v > 0, v, torch.exp(torch.clamp(v, max=0.0)) - 1.0)


def banded_conv_reference(x, cb, act=False, residual=None):
    """Plain PyTorch twin of ``banded_conv``: one conv stage at the storage
    dtype of ``x`` (weights rounded to it), accumulated in float32."""
    blocks = cb.blocks.to(x.dtype).to(torch.float32)
    y = packed_conv_reference(x.to(torch.float32), cb, blocks=blocks)
    if act:
        y = _elu(y)
    if residual is not None:
        y = y + residual.to(torch.float32)
    return y.to(x.dtype)


def banded_conv(x, cb, act=False, residual=None):
    """One conv stage with fused bias, optional ELU and residual add.

    For a CUDA tensor it launches a band-tiled TMA-fed wgmma kernel of
    ``csrc/band_wgmma.cu``: bfloat16 ``tt_band_conv_wgmma`` (bf16
    products, walking ``band_tma_plan``), float32
    ``tt_band_conv_wgmma_f32`` (TF32 wgmma on the transposed tile, walking
    ``band_tma_plan_f32``; 3xTF32 products: each operand split into TF32
    hi + lo, hi*hi + hi*lo + lo*hi accumulated in float32, as close to the
    exact product as the IEEE float32 one within a small factor). A CPU
    tensor takes the plain twin. Either way the stage is one ``tt.k1``
    span. ``x`` is (B, r_in, T) float32 or bfloat16; ``residual``
    (B, r_out, T).
    """
    with span("tt.k1"):
        if x.device.type == "cpu":
            return banded_conv_reference(x, cb, act, residual)
        x, residual, w, bias, y = _stage_operands(x, cb, residual)
        if y.numel():
            launch = (_launch_wgmma if x.dtype == torch.bfloat16
                      else _launch_wgmma_f32)
            launch(x, cb, act, residual, w, bias, y)
        return y


def _stage_operands(x, cb, residual):
    """Check a CUDA stage's inputs; returns (x, residual) contiguous, the
    band weights (bfloat16, or for float32 their TF32 hi and lo planes)
    and bias, and the empty output."""
    if x.device.type != "cuda":
        raise ValueError(f"banded_conv runs on cuda or cpu, not {x.device}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"banded_conv takes float32 or bfloat16, not "
                         f"{x.dtype}")
    b, r_in, t = x.shape
    if r_in != cb.r_in:
        raise ValueError(f"input has {r_in} rows, conv expects {cb.r_in}")
    _check_taps(cb, "banded_conv", x.dtype)
    x = x.contiguous()
    if residual is not None:
        if residual.shape != (b, cb.r_out, t) or residual.dtype != x.dtype:
            raise ValueError("residual must match the stage output")
        residual = residual.contiguous()
    w, bias = (cb.band_operands(x.dtype) if x.dtype == torch.bfloat16
               else cb.band_tf32_operands())
    if w.device != x.device:
        raise ValueError("conv weights and input lie on different devices")
    y = torch.empty((b, cb.r_out, t), dtype=x.dtype, device=x.device)
    return x, residual, w, bias, y


def _call_on(device, fn, *args):
    """``fn(*args)`` with ``device`` current: the CUDA runtime launches on
    the thread's current device, whichever device the stream belongs to."""
    if device.index == torch.cuda.current_device():
        return fn(*args)
    with torch.cuda.device(device):
        return fn(*args)


# tt_band_conv_wgmma's tiles (csrc/band_wgmma.cu): an output tile is one
# 64-row sub-tile x WGMMA_TILE_T frames; a pipeline stage is one chunk of
# WGMMA_KC band rows of one tap, TMA boxes over the tile's frames and, for
# a tap whose shift is not a whole 8 frames, WGMMA_EDGE_T more.
WGMMA_TILE_T = 128
WGMMA_EDGE_T = 8
WGMMA_KC = 64
# TMA takes global strides, and a box's innermost coordinate, in multiples
# of 16 bytes: 8 bf16 frames.
TMA_FRAME_ALIGN = 8


class BandTmaPlan(NamedTuple):
    """What ``tt_band_conv_wgmma`` walks for one stage at T frames.

    t_pad:  frames a row of x has in the tensor map (T rounded up to
            ``TMA_FRAME_ALIGN``; the wrapper pads x with zero frames).
    tiles:  ``WGMMA_TILE_T``-frame tiles; an output tile is one of them x
            one of ``n_sub`` 64-row sub-tiles x one item, and the
            kernel's persistent CTAs walk every output tile.
    n_sub:  64-row output sub-tiles.
    bands:  (start, ranges) of the band of even and of odd sub-tiles:
            sub-tile g's band column 0 is input row ``cb.sub_start(g)``
            (``(g // n_w) * col_adv - margin + start``); ``ranges`` its
            column ranges (``cb.ranges``), each (start, length, chunks)
            relative to the band: for each tap the kernel walks range by
            range, chunk by chunk, the x box of chunk c of a range at
            band row ``start + WGMMA_KC * c`` and the weight box at that
            band column; the last chunk of a range takes ``length``'s
            k16 steps only. A band without gaps is one range, all of it.
    taps:   (box offset, shift) of each tap, dt = box offset + shift: the
            boxes of tile t0 start at frame ``t0 + box offset`` (a multiple
            of ``TMA_FRAME_ALIGN``) and span ``WGMMA_TILE_T`` frames, plus
            ``WGMMA_EDGE_T`` where shift > 0; the tap's sums at column n
            belong to output frame ``t0 + n - shift``.
    n_w:    weight sub-tiles: the band pattern's 2·P (sub-tile g takes
            weight sub-tile ``g % n_w`` and its bias; a dense map's pattern
            is all its blocks).
    tma_epilogue: 1 where T is a multiple of ``TMA_FRAME_ALIGN`` (the
            residual and y then have 16-byte rows): a tile's residual
            comes into shared memory by TMA during the products before
            its own, and the result leaves by a TMA store
            (``band_wgmma_kernel<true>``); 0 elsewhere: the sums are
            staged in shared memory and the consumers read the residual
            and write y (``band_wgmma_kernel<false>``).
    """
    t_pad: int
    tiles: int
    n_sub: int
    bands: tuple
    taps: tuple
    n_w: int
    tma_epilogue: int


def band_tma_plan(cb, t):
    """The box and tile plan of ``tt_band_conv_wgmma`` for conv ``cb`` on
    T = ``t`` frames (see ``BandTmaPlan``)."""
    a = TMA_FRAME_ALIGN
    return BandTmaPlan(
        t_pad=-(-t // a) * a, tiles=-(-t // WGMMA_TILE_T), n_sub=cb.n_sub,
        bands=tuple((start, tuple((s - start, n, -(-n // WGMMA_KC))
                                  for s, n in ranges))
                    for (start, _), ranges in zip(cb.bands, cb.ranges)),
        taps=tuple((dt // a * a, dt % a) for dt in cb.dts),
        n_w=cb.n_w,
        tma_epilogue=int(t % a == 0))


def tma_frames(x, t_pad):
    """x as the tensor map reads it: itself when its rows are ``t_pad``
    frames and its base 16-byte aligned, else a copy padded with zero
    frames to ``t_pad`` (zeros past T are what the map's edge fill gives,
    so the stage is unchanged)."""
    t = x.shape[-1]
    if t == t_pad and x.data_ptr() % 16 == 0:
        return x
    return torch.nn.functional.pad(x, (0, t_pad - t)).contiguous()


def _wgmma_plan(cb, t, width):
    """(t_pad, the plan's integers as ``tt_band_conv_wgmma`` reads them: a
    C int array), built once per conv and T."""
    key = ("wgmma", t)
    if key not in cb._cache:
        with span("tt.prepare"):
            plan = band_tma_plan(cb, t)
            taps = list(plan.taps) + [(0, 0)] * (3 - len(plan.taps))
            ints = [t, plan.t_pad, len(plan.taps),
                    *[v for tap in taps for v in tap], cb.col_adv, cb.margin,
                    width, plan.n_w]
            for start, ranges in plan.bands:
                ranges = list(ranges) + [(0, 0, 0)] * (3 - len(ranges))
                ints += [start, *[v for r in ranges for v in r]]
            ints.append(plan.tma_epilogue)
            cb._cache[key] = (plan.t_pad, (ctypes.c_int * len(ints))(*ints))
    return cb._cache[key]


def _stream(device):
    """The raw handle of ``device``'s current CUDA stream (what
    ``torch.cuda.current_stream(device).cuda_stream`` gives, without
    building a Stream object on every launch)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _launch_wgmma(x, cb, act, residual, w, bias, y):
    """One launch of ``csrc/band_wgmma.cu:tt_band_conv_wgmma``. Where the
    epilogue runs by TMA (the plan's last integer) its tensor maps want
    16-byte aligned bases: ``y`` is a fresh allocation, a residual view
    that is not aligned is copied."""
    b, r_in, t = x.shape
    t_pad, plan = _wgmma_plan(cb, t, w.shape[-1])
    xp = tma_frames(x, t_pad)
    if plan[-1] and residual is not None and residual.data_ptr() % 16:
        residual = residual.clone()
    res = None if residual is None else residual.data_ptr()
    rc = _call_on(x.device, _build.load("band_wgmma", "tt_band_conv_wgmma"),
                  xp.data_ptr(), w.data_ptr(), bias.data_ptr(), res,
                  y.data_ptr(), b, r_in, cb.r_out, int(act), plan,
                  _stream(x.device))
    _build.check(rc, "banded_conv (tt_band_conv_wgmma)")


# tt_band_conv_wgmma_f32's tiles (csrc/band_wgmma.cu): an output tile is one
# 64-row sub-tile x F32_TILE_T frames; a pipeline stage is one chunk of
# F32_KC band rows: an x box of F32_BOX_T frames from t0 - BAND_MAX_DT (every
# tap reads it at its own offset) and each tap's TF32 hi and lo weight
# boxes. Each (chunk, tap) product is one fresh sum. Where T is a multiple
# of F32_FRAME_ALIGN the epilogue moves the residual and y by TMA.
F32_TILE_T = 128
F32_KC = 16
F32_BOX_T = F32_TILE_T + 3 * BAND_MAX_DT
# TMA takes global strides in multiples of 16 bytes: 4 float32 frames.
F32_FRAME_ALIGN = 4


class BandTmaPlanF32(NamedTuple):
    """What ``tt_band_conv_wgmma_f32`` walks for one stage at T frames.

    t_pad:  frames a row of x has in the tensor map (T rounded up to
            ``F32_FRAME_ALIGN``; the wrapper pads x with zero frames).
    tiles:  ``F32_TILE_T``-frame tiles; an output tile is one of them x
            one of ``n_sub`` 64-row sub-tiles x one item, and the
            kernel's persistent CTAs walk every output tile.
    n_sub:  64-row output sub-tiles.
    bands:  (start, length, chunks) of the band of even and of odd
            sub-tiles: sub-tile g's x boxes start at input row
            ``cb.sub_start(g)``, chunk c at ``+ F32_KC * c``.
    taps:   each tap's dt: the box of tile t0 spans frames
            ``t0 - BAND_MAX_DT`` .. ``+ F32_BOX_T``, and the tap reads
            frame ``t0 + n + dt`` of it for output frame ``t0 + n``.
    n_w:    weight sub-tiles, as ``BandTmaPlan``'s; their hi and lo
            planes are ``cb.band_tf32_operands()``.
    tma_epilogue: 1 where T is a multiple of ``F32_FRAME_ALIGN`` (the
            residual and y then have 16-byte rows): a tile's residual
            comes into shared memory by TMA during its products, and the
            result leaves by a TMA store; 0 elsewhere: the epilogue reads
            the residual and writes y from the registers.
    """
    t_pad: int
    tiles: int
    n_sub: int
    bands: tuple
    taps: tuple
    n_w: int
    tma_epilogue: int


def band_tma_plan_f32(cb, t):
    """The box and tile plan of ``tt_band_conv_wgmma_f32`` for conv ``cb``
    on T = ``t`` frames (see ``BandTmaPlanF32``)."""
    a = F32_FRAME_ALIGN
    return BandTmaPlanF32(
        t_pad=-(-t // a) * a, tiles=-(-t // F32_TILE_T), n_sub=cb.n_sub,
        bands=tuple((s, n, -(-n // F32_KC)) for s, n in cb.bands),
        taps=tuple(cb.dts),
        n_w=cb.n_w,
        tma_epilogue=int(t % a == 0))


def _wgmma_plan_f32(cb, t, width):
    """(t_pad, the plan's integers as ``tt_band_conv_wgmma_f32`` reads
    them: a C int array), built once per conv and T."""
    key = ("wgmma_f32", t)
    if key not in cb._cache:
        with span("tt.prepare"):
            plan = band_tma_plan_f32(cb, t)
            taps = list(plan.taps) + [0] * (3 - len(plan.taps))
            ints = (t, plan.t_pad, len(plan.taps), *taps, cb.col_adv,
                    cb.margin, width, plan.n_w,
                    *[v for band in plan.bands for v in band[:2]],
                    plan.tma_epilogue)
            cb._cache[key] = (plan.t_pad, (ctypes.c_int * len(ints))(*ints))
    return cb._cache[key]


def _launch_wgmma_f32(x, cb, act, residual, w, bias, y):
    """One launch of ``csrc/band_wgmma.cu:tt_band_conv_wgmma_f32``; ``w``
    holds the band weights' TF32 planes. Where the epilogue runs by TMA
    (the plan's last integer) its tensor maps want 16-byte aligned bases:
    ``y`` is a fresh allocation, a residual view that is not aligned is
    copied."""
    b, r_in, t = x.shape
    t_pad, plan = _wgmma_plan_f32(cb, t, w.shape[-1])
    xp = tma_frames(x, t_pad)
    if plan[-1] and residual is not None and residual.data_ptr() % 16:
        residual = residual.clone()
    res = None if residual is None else residual.data_ptr()
    rc = _call_on(x.device,
                  _build.load("band_wgmma", "tt_band_conv_wgmma_f32"),
                  xp.data_ptr(), w.data_ptr(), bias.data_ptr(), res,
                  y.data_ptr(), b, r_in, cb.r_out, int(act), plan,
                  _stream(x.device))
    _build.check(rc, "banded_conv (tt_band_conv_wgmma_f32)")


def _check_taps(cb, what, dtype):
    """The band-tiled tensor-core kernels (K1, dX and dW, in either
    ``dtype``) take at most 3 time taps of at most ``BAND_MAX_DT`` frames
    each."""
    if len(cb.dts) > 3:
        raise ValueError(f"{what} takes at most 3 time taps")
    if max(abs(d) for d in cb.dts) > BAND_MAX_DT:
        name = str(dtype).replace("torch.", "")
        raise ValueError(f"{what} in {name} takes time taps of at most "
                         f"{BAND_MAX_DT} frames")


def _band_ints(cb):
    """(start, length) of both sub-tile bands, as the kernels take them."""
    return [v for band in cb.bands for v in band]


def _aligned(t, *tensors):
    """1 when every row of every tensor starts 16-byte aligned (T times
    the element size a multiple of 16, and aligned bases): the kernels then
    load 16 bytes of a row at a time, else element by element."""
    return int(all(t * v.element_size() % 16 == 0 and v.data_ptr() % 16 == 0
                   for v in tensors))


def _apply_chain(x, spec, dtype, stage):
    cur = x.to(dtype)
    for it in spec.items:
        if it[0] == "conv":
            cur = stage(cur, it[1], act=it[2])
        else:
            h = stage(cur, it[1], act=True)
            cur = stage(h, it[2], act=True, residual=cur)
    return cur


def packed_level_apply(x, spec, dtype=torch.float32):
    """Plain PyTorch execution of a chain on packed (B, R_in, T) input ->
    (B, R_out, T) at ``dtype`` (the twin of ``fused_level_apply``)."""
    return _apply_chain(x, spec, dtype, banded_conv_reference)


def fused_level_apply(x, spec, dtype=torch.float32):
    """Run a chain on packed (B, R_in, T) input -> (B, R_out, T) at
    ``dtype``: one ``banded_conv`` kernel launch per conv stage on the card,
    the plain twin on the CPU; one ``tt.chain`` span."""
    with span("tt.chain"):
        return _apply_chain(x, spec, dtype, banded_conv)


def chain_flops(spec, columns):
    """Flops of the chain's banded products over ``columns`` frame columns,
    structural zeros included: 2·n_dt·n_blocks·128·K per conv and column."""
    per_col = sum(2 * len(cb.dts) * cb.n_out_blocks * BLOCK_ROWS * cb.k
                  for cb in spec.convs())
    return per_col * columns


def band_walk_share(convs):
    """How far the bf16 stage's walk of the column ranges engages on
    ``convs`` (e.g. ``spec.convs()``): its pipeline stages at one frame
    tile, one a sub-tile, tap and ``WGMMA_KC``-column chunk of each range
    (``band_tma_plan``), over the stages a walk of each whole band would
    take. 1.0 where no band has a gap."""
    walked = hull = 0
    for cb in convs:
        for g in range(cb.n_sub):
            taps = len(cb.dts)
            walked += taps * sum(-(-n // WGMMA_KC)
                                 for _, n in cb.ranges[g % 2])
            hull += taps * -(-cb.bands[g % 2][1] // WGMMA_KC)
    return walked / hull


def band_flops(convs, columns):
    """Flops the band-tiled kernels compute for ``convs`` (e.g.
    ``spec.convs()``) over ``columns`` frame columns: 2·n_dt·64·L per
    sub-tile and column, L its band."""
    per_col = sum(2 * len(cb.dts) * SUB_ROWS * cb.bands[g % 2][1]
                  for cb in convs for g in range(cb.n_sub))
    return per_col * columns


# --------------------------------------------------------------------- #
# Training: the level backward (kernel K3) and its plain twin            #
# --------------------------------------------------------------------- #

def _elu_grad_from_out(y):
    """ELU'(z) from y = ELU(z): 1 where y > 0, else e^z = y + 1 (float32)."""
    return torch.where(y > 0, 1.0, y + 1.0)


def _elu_factor(elu):
    """ELU' from stored tensors ``(s1, s2)``: of y = s1 - s2 (s2 may be None)."""
    y = elu[0].to(torch.float32)
    if elu[1] is not None:
        y = y - elu[1].to(torch.float32)
    return _elu_grad_from_out(y)


def elu_backward_reference(dy, elu=None, keep_raw=False):
    """Plain twin of ``elu_backward``."""
    v = dy.to(torch.float32)
    out = v if elu is None else v * _elu_factor(elu)
    return out, (v if keep_raw else None)


def elu_backward(dy, elu=None, keep_raw=False):
    """The cotangent of a level's last item from the level's output
    cotangent ``dy`` (at the storage dtype): ``f32(dy) * ELU'(s1 - s2)`` for
    ``elu = (s1, s2)`` (s2 may be None), ``f32(dy)`` for ``elu=None``.
    Returns ``(out, raw)``, raw being ``f32(dy)`` when ``keep_raw``.

    Launches ``csrc/banded_conv_bwd.cu:tt_elu_backward`` for a CUDA tensor
    and takes the plain twin for a CPU tensor; either way one
    ``tt.k3.seed`` span.
    """
    with span("tt.k3.seed"):
        if dy.device.type == "cpu":
            return elu_backward_reference(dy, elu, keep_raw)
        _check_cuda(dy, "elu_backward")
        dy = dy.contiguous()
        s1, s2 = _stored(elu, dy.shape, dy.dtype, "elu_backward")
        out = torch.empty(dy.shape, dtype=torch.float32, device=dy.device)
        raw = torch.empty_like(out) if keep_raw else None
        if out.numel():
            fn = _build.load("banded_conv_bwd", "tt_elu_backward")
            with torch.cuda.device(dy.device):
                rc = fn(dy.data_ptr(), _ptr(s1), _ptr(s2), _ptr(raw),
                        out.data_ptr(), _DTYPES[dy.dtype], out.numel(),
                        torch.cuda.current_stream(dy.device).cuda_stream)
            _build.check(rc, "elu_backward")
        return out, raw


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_cuda(t, what):
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {t.device}")
    if t.dtype not in _DTYPES:
        raise ValueError(f"{what} takes float32 or bfloat16, not {t.dtype}")


def _stored(elu, shape, dtype, what):
    """The contiguous (s1, s2) of an ELU' factor, checked against the
    shape and storage dtype of the output they scale."""
    if elu is None:
        return None, None
    out = []
    for s in elu:
        if s is not None:
            if tuple(s.shape) != tuple(shape) or s.dtype != dtype:
                raise ValueError(f"{what}: stored tensors must be {tuple(shape)} "
                                 f"{dtype}, not {tuple(s.shape)} {s.dtype}")
            s = s.contiguous()
        out.append(s)
    return out[0], out[1]


def banded_conv_dx_reference(c, adj, dtype, residual=None, elu=None,
                             keep_raw=False, out_dtype=torch.float32):
    """Plain twin of ``banded_conv_dx``."""
    blocks = adj.blocks.to(dtype).to(torch.float32)
    v = packed_conv_reference(c.to(dtype).to(torch.float32), adj,
                              blocks=blocks)
    if residual is not None:
        v = v + residual
    out = v if elu is None else v * _elu_factor(elu)
    return out.to(out_dtype), (v if keep_raw else None)


def banded_conv_dx(c, adj, dtype, residual=None, elu=None, keep_raw=False,
                   out_dtype=torch.float32):
    """dX of one conv stage: the adjoint banded product of the float32
    cotangent ``c`` (B, adj.r_in, T) with the adjoint blocks ``adj`` at the
    storage ``dtype`` (``c`` rounded to it, float32 accumulation), plus the
    float32 ``residual`` cotangent, times ``ELU'(s1 - s2)`` for
    ``elu = (s1, s2)`` (stored tensors at ``dtype``; s2 may be None).
    Returns ``(out, raw)``: out at ``out_dtype`` (float32 or ``dtype``),
    raw the float32 value before the ELU' factor when ``keep_raw``.

    For a CUDA tensor it launches a band-tiled tensor-core kernel of
    ``csrc/band_mma.cu`` over the adjoint's bands: bfloat16
    ``tt_band_conv_dx`` (bf16 products; ``c`` rounded to bfloat16 while it
    is staged), float32 ``tt_band_conv_dx_f32`` (split-TF32 products, as
    ``banded_conv``'s float32 stage). A CPU tensor takes the plain twin;
    either way the call is one ``tt.k3.dx`` span.
    """
    with span("tt.k3.dx"):
        if c.device.type == "cpu":
            return banded_conv_dx_reference(c, adj, dtype, residual, elu,
                                            keep_raw, out_dtype)
        _check_cuda(c, "banded_conv_dx")
        if c.dtype != torch.float32 or dtype not in _DTYPES:
            raise ValueError("banded_conv_dx takes a float32 cotangent and a "
                             "float32 or bfloat16 storage dtype")
        if out_dtype not in (torch.float32, dtype):
            raise ValueError(f"banded_conv_dx writes float32 or {dtype}")
        b, r_in, t = c.shape
        if r_in != adj.r_in or adj.col_adv == 0:
            raise ValueError("cotangent rows or adjoint geometry not "
                             "supported")
        _check_taps(adj, "banded_conv_dx", dtype)
        shape = (b, adj.r_out, t)
        c = c.contiguous()
        if residual is not None:
            if (tuple(residual.shape) != shape
                    or residual.dtype != torch.float32):
                raise ValueError("residual must be the float32 output shape")
            residual = residual.contiguous()
        s1, s2 = _stored(elu, shape, dtype, "banded_conv_dx")
        w, _ = adj.band_operands(dtype)
        if w.device != c.device:
            raise ValueError("adjoint blocks and cotangent lie on different "
                             "devices")
        out = torch.empty(shape, dtype=out_dtype, device=c.device)
        raw = torch.empty(shape, dtype=torch.float32, device=c.device) \
            if keep_raw else None
        if out.numel():
            bf16 = dtype == torch.bfloat16
            dts = list(adj.dts) + [0] * (3 - len(adj.dts))
            args = (c.data_ptr(), w.data_ptr(), _ptr(residual), _ptr(s1),
                    _ptr(s2), _ptr(raw), out.data_ptr())
            geometry = (b, r_in, adj.r_out, t, len(adj.dts), *dts,
                        adj.col_adv, adj.margin, w.shape[-1], adj.n_w,
                        *_band_ints(adj), _aligned(t, c),
                        torch.cuda.current_stream(c.device).cuda_stream)
            if bf16:
                fn = _build.load("band_mma", "tt_band_conv_dx")
                args += (int(out_dtype == torch.float32),)
            else:
                fn = _build.load("band_mma", "tt_band_conv_dx_f32")
            with torch.cuda.device(c.device):
                rc = fn(*args, *geometry)
            _build.check(rc, "banded_conv_dx")
        return out, raw


def banded_conv_dw_reference(dz, x, cb, out=None, offset=0):
    """Plain twin of ``banded_conv_dw`` (``out`` and ``offset`` as there):
    one einsum per time tap over the
    chunked view of the zero-margined input (as ``packed_conv_reference``),
    float32 accumulation (float64 for float64 inputs); dW is kept on the
    bands only (``cb.band_mask()``), zero elsewhere, as the kernels write
    it (every parameter gradient is the same either way: the block
    builder's backward reads no entry outside a band)."""
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    b, r_in, t = x.shape
    rows = cb.pattern_rows
    nb = -(-cb.r_out // rows)
    dzp = torch.nn.functional.pad(dz.to(acc), (0, 0, 0, nb * rows - cb.r_out))
    dzp = dzp.reshape(b, nb, rows, t)
    db = dzp.sum(dim=(0, 1, 3))
    ops = dzp.to(x.dtype).to(acc)
    A = cb.col_adv
    nw = -(-cb.k // A)
    n_ch = nb - 1 + nw
    max_dt = max(abs(d) for d in cb.dts)
    xp = torch.nn.functional.pad(
        x.to(acc), (max_dt, max_dt, cb.margin, n_ch * A - cb.margin - r_in))
    xch = xp.reshape(b, n_ch, A, xp.shape[-1])
    dws = []
    for dt in cb.dts:
        xs = xch[..., max_dt + dt:max_dt + dt + t]
        xw = torch.stack([xs[:, o:o + nb] for o in range(nw)], dim=1)
        dw = torch.einsum("bjrt,bojkt->rok", ops, xw)
        dws.append(dw.reshape(rows, nw * A)[:, :cb.k])
    dw = torch.stack(dws) * cb.band_mask().to(x.device)
    if out is None:
        return dw, db
    n_w = dw.numel()
    out[offset:offset + n_w].copy_(dw.flatten())
    out[offset + n_w:offset + n_w + rows].copy_(db)
    return None, None


def banded_conv_dw(dz, x, cb, out=None, offset=0):
    """Weight and bias gradients of one conv stage: ``dW`` (n_dt, 128·P,
    K) and ``dBias`` (128·P,), float32 (P the conv's period), from the
    float32 cotangent ``dz``
    (B, r_out, T) of the stage's pre-activation and its input ``x``
    (B, r_in, T) at the storage dtype (``dz`` rounded to it for dW, dBias
    from the float32 ``dz``). Rows past ``r_out`` of the last block, and
    input rows and columns outside the input, count as zero.

    For a CUDA tensor it launches the band-tiled tensor-core kernels of
    ``csrc/band_mma.cu``, which compute dW on the bands only and write
    zeros elsewhere (the block builder's backward reads no entry outside a
    band, so every parameter gradient is the same): per-slice partial sums
    of the (batch, pattern, 64 frames) chunks, bfloat16 ``tt_band_conv_dw``
    (bf16 products) or float32 ``tt_band_conv_dw_f32`` (split-TF32
    products), then a fixed-order reduction; the same bits every run. A
    CPU tensor takes the plain twin; either way the call is one
    ``tt.k3.dw`` span.

    With ``out`` (a contiguous float32 vector), dW's n_dt·128·P·K entries
    and then dBias's 128·P are written into it from ``offset`` on, and
    ``(None, None)`` is returned.
    """
    with span("tt.k3.dw"):
        rows = cb.pattern_rows
        n_w = len(cb.dts) * rows * cb.k
        if out is not None and (out.dtype != torch.float32
                                or not out.is_contiguous()
                                or offset + n_w + rows > out.numel()):
            raise ValueError("banded_conv_dw: out must be a contiguous "
                             "float32 vector with room at offset")
        if dz.device.type == "cpu":
            if out is None:
                return banded_conv_dw_reference(dz, x, cb)
            return banded_conv_dw_reference(dz, x, cb, out, offset)
        _check_cuda(x, "banded_conv_dw")
        b, r_in, t = x.shape
        if (dz.dtype != torch.float32 or tuple(dz.shape) != (b, cb.r_out, t)
                or r_in != cb.r_in or cb.col_adv == 0):
            raise ValueError("banded_conv_dw: cotangent, input or geometry "
                             "not supported")
        _check_taps(cb, "banded_conv_dw", x.dtype)
        dz, x = dz.contiguous(), x.contiguous()
        n_dt = len(cb.dts)
        if out is None:
            dw = torch.empty((n_dt, rows, cb.k), dtype=torch.float32,
                             device=x.device)
            db = torch.empty((rows,), dtype=torch.float32, device=x.device)
            dw_ptr, db_ptr = dw.data_ptr(), db.data_ptr()
        else:
            dw = db = None
            dw_ptr = out.data_ptr() + out.element_size() * offset
            db_ptr = dw_ptr + out.element_size() * n_w
        n_chunks = b * -(-cb.r_out // rows) * -(-t // 64)
        if n_chunks == 0:
            if out is not None:
                out[offset:offset + n_w + rows].zero_()
                return None, None
            return dw.zero_(), db.zero_()
        # CTAs per slice: the pattern's 2·P sub-tiles x the longer band's
        # 64-column tiles. Both kernels hold 2 CTAs an SM: slices for two
        # waves over the H100's 132 SMs, fixed by the shapes alone, so the
        # summation order is too.
        tiles = cb.n_w * -(-max(n for _, n in cb.bands) // 64)
        n_slices = max(1, min(n_chunks, -(-132 * 4 // tiles)))
        part = torch.empty((n_slices, n_dt, rows, cb.k),
                           dtype=torch.float32, device=x.device)
        part_bias = torch.empty((n_slices, rows), dtype=torch.float32,
                                device=x.device)
        dts = list(cb.dts) + [0] * (3 - n_dt)
        bf16 = x.dtype == torch.bfloat16
        fn = _build.load("band_mma",
                         "tt_band_conv_dw" if bf16 else "tt_band_conv_dw_f32")
        with torch.cuda.device(x.device):
            rc = fn(dz.data_ptr(), x.data_ptr(), part.data_ptr(),
                    part_bias.data_ptr(), dw_ptr, db_ptr, b,
                    r_in, cb.r_out, t, n_dt, *dts, cb.k, cb.col_adv, cb.margin,
                    cb.period, *_band_ints(cb), n_slices, _aligned(t, dz, x),
                    torch.cuda.current_stream(x.device).cuda_stream)
        _build.check(rc, "banded_conv_dw")
        return dw, db


def _level_backward(x, spec, dy, dtype, input_grad, dx_dtype, ops):
    """The VJP of a chain, stage by stage (the algorithm of
    ``_level_bwd_kernel``). ``x`` is the chain's input at ``dtype``, ``dy``
    its output cotangent. Returns ``(dx or None, [(dW, dBias) per conv])``.

    1. Recompute the forward, keeping each item's input and each residual
       block's conv1 activation (the JAX kernel replays conv1 and the
       terminal item instead, a VMEM trade-off with no counterpart here).
    2. Walk the items in reverse. ELU' comes from stored outputs: an item's
       output is the next item's input, and a residual block's inner ELU
       output is ``y - x``; a linear head takes dZ = dY. Each dX product
       fuses the residual add and the previous item's ELU', and each conv
       gets its dW and dBias. Stored tensors are dropped once used.
    """
    stage, dx_fn, dw_fn, seed_fn = ops
    items = spec.items
    n = len(items)
    ins, a1s = [], []
    cur = x
    for it in items:
        ins.append(cur)
        if it[0] == "conv":
            a1s.append(None)
            cur = stage(cur, it[1], act=it[2])
        else:
            h = stage(cur, it[1], act=True)
            a1s.append(h)
            cur = stage(h, it[2], act=True, residual=cur)
    ins.append(cur)                       # ins[i + 1] is item i's output

    def seed_of(i):
        """The (s1, s2) of item i's ELU' (None for a linear head) and
        whether its raw cotangent is needed (a residual add)."""
        it = items[i]
        if it[0] == "rb":
            return (ins[i + 1], ins[i]), True
        return ((ins[i + 1], None) if it[2] else None), False

    conv_idx, ci = [], 0
    for it in items:
        conv_idx.append(ci)
        ci += 1 if it[0] == "conv" else 2
    grads = [None] * ci

    elu, raw = seed_of(n - 1)
    dz, dy_raw = seed_fn(dy, elu, raw)
    dx = None
    for i in reversed(range(n)):
        it, ci = items[i], conv_idx[i]
        if i > 0:
            elu, raw = seed_of(i - 1)
            kw = dict(elu=elu, keep_raw=raw)
        elif input_grad:
            kw = dict(out_dtype=dx_dtype)
        else:
            kw = None
        if it[0] == "conv":
            grads[ci] = dw_fn(dz, ins[i], it[1])
            if kw is not None:
                dz, dy_raw = dx_fn(dz, it[1].adjoint, dtype, **kw)
        else:
            cb1, cb2 = it[1], it[2]
            grads[ci + 1] = dw_fn(dz, a1s[i], cb2)
            dh1, _ = dx_fn(dz, cb2.adjoint, dtype, elu=(a1s[i], None))
            grads[ci] = dw_fn(dh1, ins[i], cb1)
            if kw is not None:
                dz, dy_raw = dx_fn(dh1, cb1.adjoint, dtype, residual=dy_raw,
                                   **kw)
        if i == 0 and kw is not None:
            dx = dz
        ins[i + 1] = a1s[i] = None
    return dx, grads


_KERNEL_OPS = (banded_conv, banded_conv_dx, banded_conv_dw, elu_backward)
_PLAIN_OPS = (banded_conv_reference, banded_conv_dx_reference,
              banded_conv_dw_reference, elu_backward_reference)


def level_backward(x, spec, dy, dtype=torch.float32, input_grad=True,
                   dx_dtype=None):
    """The VJP of a chain built ``with_adjoints`` on the card: the forward
    recomputed through K1, then the K3 launches (``elu_backward``,
    ``banded_conv_dx``, ``banded_conv_dw``). ``x`` (B, r_in, T) at
    ``dtype``, ``dy`` (B, r_out, T). Returns ``(dx, [(dW, dBias), ...])``,
    dx at ``dx_dtype`` (default ``x.dtype``; None without ``input_grad``),
    dW and dBias float32 in ``spec.convs()`` order."""
    return _level_backward(x, spec, dy, dtype, input_grad,
                           dx_dtype or x.dtype, _KERNEL_OPS)


def level_backward_reference(x, spec, dy, dtype=torch.float32,
                             input_grad=True, dx_dtype=None):
    """Plain PyTorch twin of ``level_backward``: the same algorithm with
    each kernel's twin."""
    return _level_backward(x, spec, dy, dtype, input_grad,
                           dx_dtype or x.dtype, _PLAIN_OPS)


class _FusedLevelTrain(torch.autograd.Function):
    """Forward: the chain through K1 at the storage dtype; saved: the level
    input; backward: ``level_backward`` (K3) on the card, its plain twin on
    the CPU. Gradients: dX at the input's dtype, float32 for every blocks
    and bias tensor, or, for a level of the kept specs, one float32 vector
    of every conv's dW and dBias (K3 writes them into it in place) for its
    gradient route."""

    @staticmethod
    def forward(ctx, x, spec, dtype, *arrays):
        xs = x.to(dtype)
        ctx.save_for_backward(xs)
        ctx.spec, ctx.dtype, ctx.x_dtype = spec, dtype, x.dtype
        ctx.gen = None if spec.store is None else spec.store.gen
        return fused_level_apply(xs, spec, dtype)

    @staticmethod
    def backward(ctx, dy):
        (xs,) = ctx.saved_tensors
        spec = ctx.spec
        ops = _KERNEL_OPS if xs.device.type == "cuda" else _PLAIN_OPS
        flat = None
        if spec.store is not None:
            if spec.store.gen != ctx.gen:
                raise RuntimeError("the level's band operands were refreshed "
                                   "after its forward; run the backward "
                                   "before the next refresh")
            flat = torch.empty(spec.grad_size, dtype=torch.float32,
                               device=xs.device)
            dw_fn, at = ops[2], spec.grad_offsets
            ops = ops[:2] + (lambda dz, x, cb: dw_fn(
                dz, x, cb, out=flat, offset=at[cb]),) + ops[3:]
        dx, grads = _level_backward(xs, spec, dy.contiguous(), ctx.dtype,
                                    ctx.needs_input_grad[0], ctx.x_dtype, ops)
        if flat is not None:
            return dx, None, None, flat
        return (dx, None, None) + tuple(g for pair in grads for g in pair)


def fused_level_train(x, spec, dtype=torch.float32):
    """Differentiable chain (the port of ``make_fused_level_train``):
    packed (B, r_in, T) input -> (B, r_out, T) at ``dtype`` (float32, or
    bfloat16 storage with float32 accumulation). Gradients flow to ``x``
    and to every conv's ``blocks`` and ``bias`` (and through them to the
    parameters they were built from), or, for a level of the kept specs, to
    its ``grad_route`` (and through the refresh to the parameters). The
    spec must be built ``with_adjoints``."""
    convs = list(spec.convs())
    if any(cb.adjoint is None for cb in convs):
        raise ValueError("fused_level_train needs a spec built with_adjoints")
    if spec.grad_route is not None:
        arrays = [spec.grad_route]
    else:
        arrays = [a for cb in convs for a in (cb.blocks, cb.bias)]
    return _FusedLevelTrain.apply(x, spec, dtype, *arrays)
