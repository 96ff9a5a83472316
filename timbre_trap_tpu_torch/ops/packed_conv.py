"""Packed f-major banded-matmul formulation of the model's convolutions.

Counterpart of ``timbre_trap_tpu/ops/packed_conv.py`` (inference form).
Every conv of the model is re-expressed on the packed layout ``(B, R, T)``
with ``R = F·C`` (row ``r = f*C + c``): a frequency-axis convolution with
channel mixing is a block-banded matrix product whose band pattern repeats
every ``P`` 128-row blocks (the period: one block for a conv whose
outputs of a frequency fit in a block and whose taps repeat block by
block, more where an output frequency spans several blocks, ``c_out`` >
128, or a transposed conv's stride spans them), so one ``(128·P, K)``
weight block per time tap drives the whole conv (a dense map, the
latent bridge's, is one pattern of all its blocks with ``col_adv`` 0):
with ``j = J*P + p``,

    y[j*128:(j+1)*128, t] = sum_dt B_dt[p*128:(p+1)*128]
                            @ x[J*col_adv - margin : ... + K, t + dt]

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

from ..utils.profiling import span

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
      blocks:   (n_dt, 128*P, K) float32 banded weight pattern per time tap
                (P the period, ``period``; a dense map is one pattern of
                all its ``n_out_blocks`` blocks, (1, n_out_blocks*128, K)).
      dts:      time-frame shift of each tap (correlation: reads x[t + dt]).
      bias:     (128*P,) per-row pattern repeating every 128*P rows.
      col_adv:  input-row advance per 128*P output rows (0 for a dense
                map).
      margin:   zero rows above the input (block j = J*P + p starts reading
                at input row ``J*col_adv - margin``).
      k:        input rows read per output block.
      bands:    ((start, length), (start, length)): the block columns that
                rows [0, 64) and rows [64, 128) of every block of the
                pattern read, each a multiple of 16 (the end may pass
                ``k``; those columns hold no weight). A dense map has one
                band, all of ``k``.
      adjoint:  the transpose of the conv as another repeating banded conv
                (its dX map), attached by a training spec, else None.

    A conv of a network's kept specs (``ops/band_store.py``) is backed by
    its ``BandStore``: its band operands are views of the store's buffers,
    refreshed from the weights in place, and ``blocks`` and ``bias`` views
    of the store's dense blocks, built when first read after a refresh.
    """

    _store = None

    def __init__(self, blocks, dts, bias, col_adv, margin, f_in, f_out,
                 c_in, c_out, bands=None):
        self.blocks = blocks
        self.dts = tuple(int(d) for d in dts)
        self.bias = bias
        self.col_adv = int(col_adv)
        self.margin = int(margin)
        self.k = int(blocks.shape[-1])
        self.f_in, self.f_out = int(f_in), int(f_out)
        self.c_in, self.c_out = int(c_in), int(c_out)
        # P: the 128-row blocks a band pattern spans.
        self.period = int(blocks.shape[1]) // BLOCK_ROWS
        if bands is None:
            full = (0, -(-self.k // BAND_ALIGN) * BAND_ALIGN)
            bands = (full, full)
        self.bands = tuple((int(s), int(n)) for s, n in bands)
        self.adjoint = None
        self._cache = {}

    @property
    def blocks(self):
        if self._store is not None:
            self._store.dense_views()
        return self._blocks

    @blocks.setter
    def blocks(self, value):
        self._blocks = value

    @property
    def bias(self):
        if self._store is not None:
            self._store.dense_views()
        return self._bias

    @bias.setter
    def bias(self, value):
        self._bias = value

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
    def pattern_rows(self):
        """Output rows of one band pattern: 128·P."""
        return BLOCK_ROWS * self.period

    @property
    def n_w(self):
        """Weight sub-tiles: the pattern's 2·P."""
        return 2 * self.period

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
        """The weight sub-tile that output sub-tile ``g`` uses."""
        return g % self.n_w

    def sub_start(self, g):
        """The input row of band column 0 of output sub-tile ``g`` (may be
        negative: rows outside the input read as zero)."""
        return ((g // self.n_w) * self.col_adv - self.margin
                + self.bands[g % 2][0])

    def band_weights(self, blocks=None):
        """(n_weight_subtiles, n_dt, 64, band_width): each sub-tile's band of
        ``blocks`` (default ``self.blocks``), zero past its band and past
        ``k``; K-major rows, the layout of a tensor-core A operand."""
        blocks = self.blocks if blocks is None else blocks
        out = blocks.new_zeros((self.n_w, len(self.dts), SUB_ROWS,
                                self.band_width))
        for g in range(self.n_w):
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
        if self._store is not None:
            return self._store.band_operands(self, dtype)
        key = ("band", dtype)
        if key not in self._cache:
            with span("tt.prepare"):
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
        if self._store is not None:
            return self._store.tf32_operands(self)
        key = ("tf32",)
        if key not in self._cache:
            w, bias = self.band_operands(torch.float32)
            with span("tt.prepare"):
                hi = tf32_round(w)
                self._cache[key] = (
                    torch.stack((hi, w - hi), dim=2).contiguous(), bias)
        return self._cache[key]

    def band_mask(self):
        """(n_dt, 128·P, k) bool: True at the pattern's entries inside the
        band of their row's sub-tile."""
        cols = torch.arange(self.k, device=self.blocks.device)
        halves = [(cols >= s) & (cols < s + n) for s, n in self.bands]
        rows = torch.stack(halves * self.period).repeat_interleave(SUB_ROWS,
                                                                   dim=0)
        return rows[None].expand(len(self.dts), -1, -1)


def tf32_round(x):
    """float32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32``: on the int32 view, add
    half of the 13 dropped bits to the magnitude and clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _build_blocks(kernel_fc, bias, f_in, f_out, c_in, c_out, f_taps, dts):
    """Contract the (n_df, n_dt, c_in, c_out) kernel into banded blocks.

    ``f_taps(f_loc, df)`` maps a pattern-local output frequency and
    frequency tap to the input frequency it reads (relative to pattern 0's
    window), or None where the tap does not apply.

    The blocks are the JAX package's one-hot form (its ``vjp_einsum``
    builder): a static map ``m[df, fl, g] = 1`` where output frequency fl
    reads window offset g through tap df (at most one tap per (fl, g)),
    contracted with the kernel. Every block entry is one weight times 1 plus
    zeros, so the values equal the gather form's exactly; the contraction is
    a broadcast multiply and sum (no matmul, so no TF32 rounding), and its
    backward is another such sum where a gather's is an index scatter-add
    (81 ms per recipe train step on the H100, ``PERF.md``).
    """
    n_df = kernel_fc.shape[0]
    n_f = _pattern_freqs(f_taps, n_df, c_out)

    def window(pattern):
        offs = [f_taps(pattern * n_f + fl, df)
                for fl in range(n_f) for df in range(n_df)]
        return [o for o in offs if o is not None]

    w0, w1 = window(0), window(1)
    lo, hi = min(w0), max(w0)
    margin_rows = -lo * c_in
    col_adv = (min(w1) - lo) * c_in
    # Margin rounded up to 8 rows (the JAX package's sublane tile), which
    # adds as many zero leading columns to every block.
    shift = (-margin_rows) % 8
    margin_rows += shift
    n_g = hi - lo + 1

    m = np.zeros((n_df, n_f, n_g), np.float32)
    for fl in range(n_f):
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
        core.reshape(len(dts), n_f * c_out, n_g * c_in), (shift, 0))
    bias_pat = bias.repeat(n_f)
    return ConvBlocks(blocks, dts, bias_pat, col_adv, margin_rows, f_in,
                      f_out, c_in, c_out, bands=bands)


def _pattern_freqs(f_taps, n_df, c_out):
    """Output frequencies of one band pattern: the fewest whose rows fill
    whole 128-row blocks and whose taps repeat pattern after pattern, each
    pattern reading the previous one's input frequencies shifted by one
    fixed offset (a transposed conv of stride s needs a multiple of s)."""
    if c_out % BLOCK_ROWS and BLOCK_ROWS % c_out:
        raise ValueError(f"channel width {c_out} neither divides nor is a "
                         f"multiple of {BLOCK_ROWS}")
    n_f = max(1, BLOCK_ROWS // c_out)
    for _ in range(8):
        # Per tap of patterns 1 and 2: the shift from pattern 0 per
        # pattern, None where only one of the two reads.
        shifts = set()
        for j in (1, 2):
            for fl in range(n_f):
                for df in range(n_df):
                    a, b = f_taps(fl, df), f_taps(j * n_f + fl, df)
                    if (a is None) != (b is None):
                        shifts.add(None)
                    elif a is not None:
                        shifts.add((b - a) / j)
        if len(shifts) == 1 and None not in shifts:
            return n_f
        n_f *= 2
    raise ValueError("band pattern must repeat")


def _sub_tile_bands(m, c_in, c_out, shift):
    """The band of the even and of the odd 64-row sub-tiles of a pattern
    from the static tap map ``m[df, fl, g]``: the block columns ``shift +
    g*c_in + ci`` that any of their output frequencies reads through any
    tap, rounded out to 16 (over a pattern of several blocks, the union
    of its even, and of its odd, sub-tiles' bands)."""
    spans = [[], []]
    for s in range(m.shape[1] * c_out // SUB_ROWS):
        f_lo = s * SUB_ROWS // c_out
        f_hi = -(-(s + 1) * SUB_ROWS // c_out)
        g = np.flatnonzero(m[:, f_lo:f_hi].any(axis=(0, 1)))
        if g.size:
            lo = (shift + int(g[0]) * c_in) // BAND_ALIGN * BAND_ALIGN
            hi = -(-(shift + (int(g[-1]) + 1) * c_in) // BAND_ALIGN) * BAND_ALIGN
            spans[s % 2].append((lo, hi))
    bands = []
    for half in spans:
        if not half:
            bands.append((0, BAND_ALIGN))
            continue
        lo, hi = min(a for a, _ in half), max(b for _, b in half)
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
    ConvBlocks of one pattern, ``col_adv`` 0: R_in zero-padded up to a
    multiple of 16, R_out up to whole 128-row blocks, all of them the
    pattern (the latent-bridge items)."""
    w = _f32(w)
    r_out, r_in = int(w.shape[0]), int(w.shape[1])
    k = r_in + (-r_in % 16)
    nb = math.ceil(r_out / BLOCK_ROWS)
    blocks = torch.nn.functional.pad(
        w, (0, k - r_in, 0, nb * BLOCK_ROWS - r_out))[None].contiguous()
    bias_full = torch.nn.functional.pad(_f32(bias), (0, nb * BLOCK_ROWS - r_out))
    return ConvBlocks(blocks, (0,), bias_full, 0, 0, r_in, r_out, 1, 1)


def packed_conv_reference(x, cb: ConvBlocks, blocks=None):
    """Plain execution of a ConvBlocks conv on packed (B, R_in, T) input ->
    (B, R_out, T) in the dtype of ``x``; ``blocks`` overrides ``cb.blocks``
    (the same shape, e.g. rounded to a storage dtype).

    One einsum per time tap: pattern J's window ``[J*col_adv, J*col_adv +
    k)`` of the zero-margined input splits into ``nw = ceil(k / col_adv)``
    chunks of ``col_adv`` rows, chunk o of every window being the (J+o)-th
    chunk of one chunked view of x. A dense map (``col_adv`` 0) is one
    pattern whose window is one chunk of ``k`` rows.
    """
    b, r_in, t = x.shape
    if r_in != cb.r_in:
        raise ValueError(f"input has {r_in} rows, conv expects {cb.r_in}")
    blocks = (cb.blocks if blocks is None else blocks).to(x.dtype)
    rows = cb.pattern_rows
    n_blocks = -(-cb.r_out // rows)
    A = cb.col_adv or cb.k
    nw = -(-cb.k // A)
    n_ch = n_blocks - 1 + nw
    top = cb.margin
    bottom = n_ch * A - top - r_in
    max_dt = max(abs(d) for d in cb.dts)
    xp = torch.nn.functional.pad(x, (max_dt, max_dt, top, bottom))
    xch = xp.reshape(b, n_ch, A, xp.shape[-1])
    blocks = torch.nn.functional.pad(blocks, (0, nw * A - cb.k))
    blocks = blocks.reshape(len(cb.dts), rows, nw, A)

    acc = None
    for di, dt in enumerate(cb.dts):
        xs = xch[..., max_dt + dt:max_dt + dt + t]
        xw = torch.stack([xs[:, o:o + n_blocks] for o in range(nw)], dim=1)
        term = torch.einsum("rok,bojkt->bjrt", blocks[di], xw)
        acc = term if acc is None else acc + term
    y = acc.reshape(b, n_blocks * rows, t)[:, :cb.r_out]
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
    bias = bias.repeat(-(-cb.r_out // bias.numel()))
    return y + bias[:cb.r_out][None, :, None]
