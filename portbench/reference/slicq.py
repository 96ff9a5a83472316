"""The sliCQ analysis and synthesis of the plain reference.

A frozen copy of the port's native-frame design (``design_slicq``) and of
its PyTorch execution (``encode``, ``decode``), kept here so that the
yardstick does not move when the program does. Per block of L samples:

    encode: rfft(L) -> band slices [band_lo_k, band_lo_k + M) -> window
            multiply -> ifft(M) per bin -> phase ramp
    decode: fft(M) per bin / scale -> for each spectrum bin, the sum over
            its (at most two) window slots of a gathered coefficient times
            its dual window value -> irfft(L)

The frame is tight (the windows' squares sum to one), so the dual window
is the analysis window and encode -> decode is exact up to rounding.
"""

import math
from types import SimpleNamespace

import numpy as np
import torch

__all__ = ["design", "window_length", "Slicq"]


def _next_power_of_2(x):
    return 1 << max(0, int(math.ceil(math.log2(max(1, x)))))


def _supports(sample_rate, n_octaves, bins_per_octave, block_length):
    """The window nodes, and each bin's integer support [lo, hi]."""
    n_bins = n_octaves * bins_per_octave
    half = block_length // 2
    fmin = sample_rate / 2.0 / (2.0 ** n_octaves)
    center_freqs = fmin * 2.0 ** (np.arange(n_bins, dtype=np.float64)
                                  / bins_per_octave)
    pos = center_freqs * block_length / sample_rate
    nodes = np.concatenate(([0.0], pos, [float(half)]))
    lo = np.ceil(nodes[:-2]).astype(np.int64)
    hi = np.floor(nodes[2:]).astype(np.int64)
    lo[0] = 0
    hi[-1] = half
    return nodes, lo, hi


def window_length(sample_rate, n_octaves, bins_per_octave, block_length):
    """M, the frames a block gives: the widest support, to a power of 2."""
    _, lo, hi = _supports(sample_rate, n_octaves, bins_per_octave,
                          block_length)
    return _next_power_of_2(int(np.maximum(hi - lo + 1, 0).max()))


def design(sample_rate, n_octaves, bins_per_octave, block_length):
    """The plan of one configuration: windows, bands, phase ramps and the
    synthesis gather tables, as host arrays."""
    if block_length % 2 != 0:
        raise ValueError("block_length must be even")
    n_bins = n_octaves * bins_per_octave
    n_rfft = block_length // 2 + 1
    nodes, lo, hi = _supports(sample_rate, n_octaves, bins_per_octave,
                              block_length)
    support = np.maximum(hi - lo + 1, 0)
    max_support = int(support.max())
    M = _next_power_of_2(max_support)

    def window_value(k, f):
        f = np.asarray(f, dtype=np.float64)
        left, center, right = nodes[k], nodes[k + 1], nodes[k + 2]
        w = np.zeros_like(f)
        if k == 0:
            w[f <= center] = 1.0
        else:
            rise = (f >= left) & (f <= center)
            denom = max(center - left, np.finfo(np.float64).tiny)
            w[rise] = np.sin(0.5 * np.pi * (f[rise] - left) / denom)
        if k == n_bins - 1:
            w[f > center] = 1.0
        else:
            fall = (f > center) & (f <= right)
            denom = max(right - center, np.finfo(np.float64).tiny)
            w[fall] = np.cos(0.5 * np.pi * (f[fall] - center) / denom)
        return w

    alignment = 128 if (max_support + 127 <= M and M % 128 == 0) else 1
    band_lo = np.maximum((lo // alignment) * alignment, 0)
    band_win = np.zeros((n_bins, M), dtype=np.float64)
    contrib_idx = [[] for _ in range(n_rfft)]
    contrib_dual = [[] for _ in range(n_rfft)]
    for k in range(n_bins):
        if support[k] <= 0:
            continue
        f = np.arange(lo[k], hi[k] + 1)
        w = window_value(k, f)
        band_win[k, f - band_lo[k]] = w
        nz = w > 0.0
        for fi, mi, wi in zip(f[nz], np.mod(f, M)[nz], w[nz]):
            contrib_idx[fi].append(k * M + mi)
            contrib_dual[fi].append(wi)
    frame = np.array([float(np.sum(np.square(c))) for c in contrib_dual])
    if not np.allclose(frame, 1.0, atol=1e-10):
        raise AssertionError("the frame operator is not the identity")
    scatter_idx = np.zeros((2, n_rfft), dtype=np.int64)
    scatter_dual = np.zeros((2, n_rfft), dtype=np.float64)
    for fi in range(n_rfft):
        for s, (ci, cd) in enumerate(zip(contrib_idx[fi], contrib_dual[fi])):
            scatter_idx[s, fi] = ci
            scatter_dual[s, fi] = cd
    scale = 2.0 * M / block_length
    ang = 2.0 * np.pi * np.outer(np.mod(band_lo, M), np.arange(M)) / M
    return SimpleNamespace(
        block_length=int(block_length), n_bins=int(n_bins),
        max_window_length=int(M), n_rfft=int(n_rfft),
        band_lo=band_lo, band_win=band_win.astype(np.float32),
        band_phase=(scale * np.exp(1j * ang)).astype(np.complex64),
        scatter_idx=scatter_idx, scatter_dual=scatter_dual.astype(np.float32),
        scale=float(scale))


class Slicq:
    """``encode`` and ``decode`` of one plan, its tables on ``device``."""

    def __init__(self, sample_rate, n_octaves, bins_per_octave,
                 secs_per_block, device):
        plan = design(sample_rate, n_octaves, bins_per_octave,
                      int(secs_per_block * sample_rate))
        self.plan = plan
        self.L = plan.block_length
        self.M = plan.max_window_length
        self.F = plan.n_bins
        self._S = int(plan.band_lo.max()) + self.M
        self._win = torch.as_tensor(plan.band_win, device=device)
        self._phase = torch.as_tensor(plan.band_phase, device=device)
        self._idx = torch.as_tensor(
            (plan.band_lo[:, None] + np.arange(self.M)[None, :]).reshape(-1),
            device=device)
        self._sidx = torch.as_tensor(plan.scatter_idx, device=device)
        self._dual = torch.as_tensor(plan.scatter_dual, device=device)
        self._inv_scale = float(np.float32(1.0 / plan.scale))

    def encode(self, audio):
        """Real float32 (B, C, N), N a multiple of L -> complex64
        (B, C, F, N / L * M)."""
        B, C, N = audio.shape
        nb = N // self.L
        X = torch.fft.rfft(audio.reshape(B, C, nb, self.L), dim=-1)
        X = torch.nn.functional.pad(X, (0, self._S - X.shape[-1]))
        Z = X.index_select(-1, self._idx).reshape(B, C, nb, self.F, self.M)
        coeffs = torch.fft.ifft(Z * self._win, dim=-1) * self._phase
        return coeffs.movedim(-3, -2).reshape(B, C, self.F, nb * self.M)

    def decode(self, coefficients):
        """Complex (B, C, F, T), T a multiple of M -> float32 audio
        (B, C, T / M * L), not normalised."""
        B, C, F, T = coefficients.shape
        nb = T // self.M
        c = coefficients.reshape(B, C, F, nb, self.M).movedim(-2, -3)
        Z = (torch.fft.fft(c, dim=-1) * self._inv_scale).reshape(
            B, C, nb, F * self.M)
        X = sum(Z.index_select(-1, self._sidx[s]) * self._dual[s]
                for s in range(self._sidx.shape[0]))
        x = torch.fft.irfft(X, n=self.L, dim=-1)
        return x.reshape(B, C, nb * self.L).to(torch.float32)
