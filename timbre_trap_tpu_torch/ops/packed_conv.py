"""Packed f-major banded-matmul formulation of the model's convolutions.

Counterpart of ``timbre_trap_tpu/ops/packed_conv.py`` (inference form).
Every conv of the model is re-expressed on the packed layout ``(B, R, T)``
with ``R = F·C`` (row ``r = f*C + c``): a frequency-axis convolution with
channel mixing is a block-banded matrix product whose 128-row band block is
the same for every block, so one ``(128, K)`` weight block per time tap
drives the whole conv:

    y[j*128:(j+1)*128, t] = sum_dt B_dt @ x[j*col_adv - margin : ... + K, t + dt]

Rows and columns outside the input read as zero (SAME/VALID semantics).
The block tensors built here are equal to the JAX package's, including the
8-row margin shift and the zero leading columns it adds to ``K``.
``packed_conv_reference`` is the plain PyTorch execution of one conv.

Bands: an output row reads only ``n_df * c_in`` of a block's ``K`` columns,
so each 64-row half of a block (a sub-tile) carries its band, the first
column it reads and how many, rounded out to multiples of 16, taken from
the builder's static tap map (never from weight values).
``band_conv_reference`` computes a conv from the bands alone; the
tensor-core kernels (the stage, dX and dW, in both dtypes) iterate over
the band only.
"""

import math

import numpy as np
import torch

__all__ = ["BLOCK_ROWS", "pack_nhwc", "unpack_to_nhwc", "pack_nchw",
           "unpack_to_nchw", "ConvBlocks", "build_conv2d_blocks",
           "build_sconv_blocks", "build_tconv_blocks", "build_dense_blocks",
           "packed_conv_reference", "SUB_ROWS", "band_conv_reference",
           "tf32_round"]

BLOCK_ROWS = 128
# Rows of a sub-tile (one warpgroup-sized M tile of the tensor-core kernels).
SUB_ROWS = 64
# Band granularity in columns (the k16 step of a bf16 tensor-core product).
BAND_ALIGN = 16


def pack_nhwc(x):
    """(B, F, T, C) -> (B, F*C, T) f-major packed."""
    b, f, t, c = x.shape
    return x.permute(0, 1, 3, 2).reshape(b, f * c, t)


def unpack_to_nhwc(x, channels):
    """(B, F*C, T) -> (B, F, T, C)."""
    b, r, t = x.shape
    return x.reshape(b, r // channels, channels, t).permute(0, 1, 3, 2)


def pack_nchw(x):
    """(B, C, F, T) -> (B, F*C, T) f-major packed."""
    b, c, f, t = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, f * c, t)


def unpack_to_nchw(x, channels):
    """(B, F*C, T) -> (B, C, F, T)."""
    b, r, t = x.shape
    return x.reshape(b, r // channels, channels, t).permute(0, 2, 1, 3)


class ConvBlocks:
    """A conv expressed as repeating banded blocks on the packed layout.

    Attributes:
      blocks:   (n_dt, 128, K) float32 banded weight block per time tap, or
                (1, n_out_blocks*128, K) with ``per_block`` (a dense map with
                its own weight slice per output block).
      dts:      time-frame shift of each tap (correlation: reads x[t + dt]).
      bias:     (128,) per-row pattern repeating every 128 rows, or the full
                (n_out_blocks*128,) vector with ``per_block``.
      col_adv:  input-row advance per 128 output rows.
      margin:   zero rows above the input (block j starts reading at input
                row ``j*col_adv - margin``).
      k:        input rows read per output block.
      bands:    ((start, length), (start, length)): the block columns that
                rows [0, 64) and rows [64, 128) of a block read, each a
                multiple of 16 (the end may pass ``k``; those columns hold
                no weight). A ``per_block`` map has one band, all of ``k``.
      adjoint:  the transpose of the conv as another repeating banded conv
                (its dX map), attached by a training spec, else None.
    """

    def __init__(self, blocks, dts, bias, col_adv, margin, f_in, f_out,
                 c_in, c_out, per_block=False, bands=None):
        self.blocks = blocks
        self.dts = tuple(int(d) for d in dts)
        self.bias = bias
        self.col_adv = int(col_adv)
        self.margin = int(margin)
        self.k = int(blocks.shape[-1])
        self.f_in, self.f_out = int(f_in), int(f_out)
        self.c_in, self.c_out = int(c_in), int(c_out)
        self.per_block = bool(per_block)
        if bands is None:
            full = (0, -(-self.k // BAND_ALIGN) * BAND_ALIGN)
            bands = (full, full)
        self.bands = tuple((int(s), int(n)) for s, n in bands)
        self.adjoint = None
        self._cache = {}

    @property
    def r_in(self):
        return self.f_in * self.c_in

    @property
    def r_out(self):
        return self.f_out * self.c_out

    @property
    def n_out_blocks(self):
        return math.ceil(self.r_out / BLOCK_ROWS)

    @property
    def n_sub(self):
        """Output sub-tiles of 64 rows."""
        return math.ceil(self.r_out / SUB_ROWS)

    @property
    def band_width(self):
        """Columns of each sub-tile's band weights: the longest band,
        rounded up to 32 (two k16 steps) so whole steps stay in bounds."""
        return -(-max(n for _, n in self.bands) // 32) * 32

    def sub_weights(self, g):
        """The weight sub-tile that output sub-tile ``g`` uses: its own
        with ``per_block``, else the block pattern's half ``g % 2``."""
        return g if self.per_block else g % 2

    def sub_start(self, g):
        """The input row of band column 0 of output sub-tile ``g`` (may be
        negative: rows outside the input read as zero)."""
        return ((g // 2) * self.col_adv - self.margin
                + self.bands[g % 2][0])

    def band_weights(self, blocks=None):
        """(n_weight_subtiles, n_dt, 64, band_width): each sub-tile's band of
        ``blocks`` (default ``self.blocks``), zero past its band and past
        ``k``; K-major rows, the layout of a tensor-core A operand."""
        blocks = self.blocks if blocks is None else blocks
        n_w = 2 * self.n_out_blocks if self.per_block else 2
        out = blocks.new_zeros((n_w, len(self.dts), SUB_ROWS, self.band_width))
        for g in range(n_w):
            start, length = self.bands[g % 2]
            n = min(length, self.k - start)
            rows = blocks[:, g * SUB_ROWS:(g + 1) * SUB_ROWS, start:start + n]
            out[g, :, :rows.shape[1], :n] = rows
        return out

    def band_operands(self, dtype):
        """(band weights, bias) as the band-tiled tensor-core kernels read
        them: the band weights at the storage ``dtype`` (bfloat16, or
        float32 for the ``mma.sync`` split-TF32 kernels, which split them
        in the kernel), the bias in float32. Built once per dtype."""
        key = ("band", dtype)
        if key not in self._cache:
            w = self.band_weights(self.blocks.detach())
            self._cache[key] = (w.to(dtype).contiguous(),
                                self.bias.to(torch.float32).contiguous())
        return self._cache[key]

    def band_tf32_operands(self):
        """(planes, bias) as the float32 TMA-fed wgmma kernel reads them:
        the float32 band weights split into TF32 planes, (n_w, n_dt, 2, 64,
        band_width), plane 0 ``hi`` (rounded to TF32, to nearest with ties
        away from zero, as ``cvt.rna.tf32.f32``) and plane 1 ``lo = w -
        hi`` (exact in float32), and the float32 bias. Built once, on the
        weights' device."""
        key = ("tf32",)
        if key not in self._cache:
            w, bias = self.band_operands(torch.float32)
            hi = tf32_round(w)
            self._cache[key] = (torch.stack((hi, w - hi), dim=2).contiguous(),
                                bias)
        return self._cache[key]

    def band_mask(self):
        """(n_dt, 128, k) bool: True at the block entries inside the band
        of their row's sub-tile."""
        cols = torch.arange(self.k, device=self.blocks.device)
        halves = [(cols >= s) & (cols < s + n) for s, n in self.bands]
        rows = torch.stack(halves).repeat_interleave(SUB_ROWS, dim=0)
        return rows[None].expand(len(self.dts), -1, -1)


def tf32_round(x):
    """float32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32``: on the int32 view, add
    half of the 13 dropped bits to the magnitude and clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _build_blocks(kernel_fc, bias, f_in, f_out, c_in, c_out, f_taps, dts):
    """Contract the (n_df, n_dt, c_in, c_out) kernel into banded blocks.

    ``f_taps(f_loc, df)`` maps a block-local output frequency and frequency
    tap to the input frequency it reads (relative to block 0's window), or
    None where the tap does not apply.

    The blocks are the JAX package's one-hot form (its ``vjp_einsum``
    builder): a static map ``m[df, fl, g] = 1`` where output frequency fl
    reads window offset g through tap df (at most one tap per (fl, g)),
    contracted with the kernel. Every block entry is one weight times 1 plus
    zeros, so the values equal the gather form's exactly; the contraction is
    a broadcast multiply and sum (no matmul, so no TF32 rounding), and its
    backward is another such sum where a gather's is an index scatter-add
    (81 ms per recipe train step on the H100, ``PERF.md``).
    """
    n_f_per_block = BLOCK_ROWS // c_out
    if BLOCK_ROWS % c_out:
        raise ValueError(f"channel width {c_out} does not divide {BLOCK_ROWS}")
    n_df = kernel_fc.shape[0]

    def window(block):
        offs = [f_taps(block * n_f_per_block + fl, df)
                for fl in range(n_f_per_block) for df in range(n_df)]
        return [o for o in offs if o is not None]

    w0, w1 = window(0), window(1)
    lo, hi = min(w0), max(w0)
    margin_rows = -lo * c_in
    col_adv = (min(w1) - lo) * c_in
    if max(w1) - min(w1) != hi - lo:
        raise ValueError("band pattern must repeat")
    # Margin rounded up to 8 rows (the JAX package's sublane tile), which
    # adds as many zero leading columns to every block.
    shift = (-margin_rows) % 8
    margin_rows += shift
    n_g = hi - lo + 1

    m = np.zeros((n_df, n_f_per_block, n_g), np.float32)
    for fl in range(n_f_per_block):
        for df in range(n_df):
            off = f_taps(fl, df)
            if off is not None:
                m[df, fl, off - lo] = 1.0
    bands = _sub_tile_bands(m, c_in, c_out, shift)
    m = torch.as_tensor(m, device=kernel_fc.device)
    # (df, dt, fl, co, g, ci) summed over df -> blocks[dt, fl*c_out + co,
    # shift + g*c_in + ci].
    kern = kernel_fc.permute(0, 1, 3, 2)
    core = (m[:, None, :, None, :, None]
            * kern[:, :, None, :, None, :]).sum(dim=0)
    blocks = torch.nn.functional.pad(
        core.reshape(len(dts), BLOCK_ROWS, n_g * c_in), (shift, 0))
    bias_pat = bias.repeat(n_f_per_block)
    return ConvBlocks(blocks, dts, bias_pat, col_adv, margin_rows, f_in,
                      f_out, c_in, c_out, bands=bands)


def _sub_tile_bands(m, c_in, c_out, shift):
    """The band of each 64-row half of a block from the static tap map
    ``m[df, fl, g]``: the block columns ``shift + g*c_in + ci`` that any of
    its output frequencies reads through any tap, rounded out to 16."""
    bands = []
    for s in range(BLOCK_ROWS // SUB_ROWS):
        f_lo = s * SUB_ROWS // c_out
        f_hi = -(-(s + 1) * SUB_ROWS // c_out)
        g = np.flatnonzero(m[:, f_lo:f_hi].any(axis=(0, 1)))
        if g.size == 0:
            bands.append((0, BAND_ALIGN))
            continue
        lo = (shift + int(g[0]) * c_in) // BAND_ALIGN * BAND_ALIGN
        hi = -(-(shift + (int(g[-1]) + 1) * c_in) // BAND_ALIGN) * BAND_ALIGN
        bands.append((lo, hi - lo))
    return tuple(bands)


def _f32(a):
    return torch.as_tensor(a).to(torch.float32)


def build_conv2d_blocks(kernel, bias, f_in, dilation=1):
    """SAME 2D conv, kernel (kh, kw, C_in, C_out) HWIO, dilation on both axes
    (the residual-block 3x3/1x1 convs, convin and convout); f_out == f_in."""
    kh, kw, c_in, c_out = kernel.shape
    d = int(dilation)
    half_h = (kh - 1) // 2
    dts = tuple((i - (kw - 1) // 2) * d for i in range(kw))

    def f_taps(f_loc, df):
        return f_loc + (df - half_h) * d

    return _build_blocks(_f32(kernel), _f32(bias), f_in, f_in, c_in, c_out,
                         f_taps, dts)


def build_sconv_blocks(kernel, bias, f_in, stride=2):
    """Frequency-strided VALID down-sampling conv, kernel (2s, 1, C_in, C_out):
    ``f_out = (f_in - 2s) // s + 1``."""
    kh, kw, c_in, c_out = kernel.shape
    if kw != 1:
        raise ValueError("sconv kernel must be (kh, 1)")
    s = int(stride)
    f_out = (f_in - kh) // s + 1

    def f_taps(f_loc, df):
        return f_loc * s + df

    return _build_blocks(_f32(kernel), _f32(bias), f_in, f_out, c_in, c_out,
                         f_taps, (0,))


def build_tconv_blocks(kernel, bias, f_in, stride=2, output_padding=0):
    """Torch-semantics transposed conv along frequency, kernel (kh, 1, Ci, Co):
    ``y[fo] += x[fi] W[k]`` wherever ``fo = fi*stride + k``, and
    ``f_out = (f_in - 1)*stride + kh + output_padding``."""
    kh, kw, c_in, c_out = kernel.shape
    if kw != 1:
        raise ValueError("tconv kernel must be (kh, 1)")
    s = int(stride)
    f_out = (f_in - 1) * s + kh + int(output_padding)

    def f_taps(f_loc, df):
        if (f_loc - df) % s != 0:
            return None
        return (f_loc - df) // s

    return _build_blocks(_f32(kernel), _f32(bias), f_in, f_out, c_in, c_out,
                         f_taps, (0,))


def build_dense_blocks(w, bias):
    """A dense row map ``y = W @ x + b`` (W: (R_out, R_in)) as a one-tap
    per-block ConvBlocks: R_in zero-padded up to a multiple of 16, R_out up
    to whole 128-row blocks (the latent-bridge items)."""
    w = _f32(w)
    r_out, r_in = int(w.shape[0]), int(w.shape[1])
    k = r_in + (-r_in % 16)
    nb = math.ceil(r_out / BLOCK_ROWS)
    blocks = torch.nn.functional.pad(
        w, (0, k - r_in, 0, nb * BLOCK_ROWS - r_out))[None].contiguous()
    bias_full = torch.nn.functional.pad(_f32(bias), (0, nb * BLOCK_ROWS - r_out))
    return ConvBlocks(blocks, (0,), bias_full, 0, 0, r_in, r_out, 1, 1,
                      per_block=True)


def packed_conv_reference(x, cb: ConvBlocks, blocks=None):
    """Plain execution of a ConvBlocks conv on packed (B, R_in, T) input ->
    (B, R_out, T) in the dtype of ``x``; ``blocks`` overrides ``cb.blocks``
    (the same shape, e.g. rounded to a storage dtype).

    One einsum per time tap: block j's window ``[j*col_adv, j*col_adv + k)``
    of the zero-margined input splits into ``nw = ceil(k / col_adv)``
    chunks of ``col_adv`` rows, chunk o of every window being the (j+o)-th
    chunk of one chunked view of x.
    """
    b, r_in, t = x.shape
    if r_in != cb.r_in:
        raise ValueError(f"input has {r_in} rows, conv expects {cb.r_in}")
    blocks = (cb.blocks if blocks is None else blocks).to(x.dtype)
    if cb.per_block:
        y = torch.einsum("rk,bkt->brt", blocks[0][:, :r_in], x)
        return (y + cb.bias.to(x.dtype)[None, :, None])[:, :cb.r_out]
    n_blocks = cb.n_out_blocks
    A = cb.col_adv
    nw = -(-cb.k // A)
    n_ch = n_blocks - 1 + nw
    top = cb.margin
    bottom = n_ch * A - top - r_in
    max_dt = max(abs(d) for d in cb.dts)
    xp = torch.nn.functional.pad(x, (max_dt, max_dt, top, bottom))
    xch = xp.reshape(b, n_ch, A, xp.shape[-1])
    blocks = torch.nn.functional.pad(blocks, (0, nw * A - cb.k))
    blocks = blocks.reshape(len(cb.dts), BLOCK_ROWS, nw, A)

    acc = None
    for di, dt in enumerate(cb.dts):
        xs = xch[..., max_dt + dt:max_dt + dt + t]
        xw = torch.stack([xs[:, o:o + n_blocks] for o in range(nw)], dim=1)
        term = torch.einsum("rok,bojkt->bjrt", blocks[di], xw)
        acc = term if acc is None else acc + term
    y = acc.reshape(b, n_blocks * BLOCK_ROWS, t)[:, :cb.r_out]
    bias_full = cb.bias.to(x.dtype).repeat(n_blocks)[:cb.r_out]
    return y + bias_full[None, :, None]


def band_conv_reference(x, cb: ConvBlocks, blocks=None):
    """A ConvBlocks conv computed from its bands alone: output sub-tile g
    (rows [64g, 64g + 64)) is ``sum_dt W_g,dt @ x[s_g : s_g + L, t + dt]``
    with ``W_g`` its band weights (``cb.band_weights``) and ``s_g =
    cb.sub_start(g)``, plus the bias; rows and columns outside the input
    read as zero. Equal to ``packed_conv_reference`` (the columns outside a
    band hold no weight); it is the arithmetic of the tensor-core kernels.
    """
    b, r_in, t = x.shape
    if r_in != cb.r_in:
        raise ValueError(f"input has {r_in} rows, conv expects {cb.r_in}")
    wb = cb.band_weights(blocks).to(x.dtype)
    n_sub, width = cb.n_sub, wb.shape[-1]
    starts = [cb.sub_start(g) for g in range(n_sub)]
    top = max(0, -min(starts))
    bottom = max(0, max(starts) + width - r_in)
    max_dt = max(abs(d) for d in cb.dts)
    xp = torch.nn.functional.pad(x, (max_dt, max_dt, top, bottom))
    idx = (torch.tensor(starts, device=x.device)[:, None] + top
           + torch.arange(width, device=x.device)[None])
    xw = xp[:, idx]                                  # (B, n_sub, L, T + 2md)
    w = wb[[cb.sub_weights(g) for g in range(n_sub)]]  # (n_sub, n_dt, 64, L)
    y = None
    for di, dt in enumerate(cb.dts):
        term = torch.einsum("grk,bgkt->bgrt", w[:, di],
                            xw[..., max_dt + dt:max_dt + dt + t])
        y = term if y is None else y + term
    y = y.reshape(b, n_sub * SUB_ROWS, t)[:, :cb.r_out]
    bias = cb.bias.to(x.dtype)
    if not cb.per_block:
        bias = bias.repeat(cb.n_out_blocks)
    return y + bias[:cb.r_out][None, :, None]
