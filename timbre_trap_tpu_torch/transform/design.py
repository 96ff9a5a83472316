"""Host-side construction of the invertible sliCQ (NSGT) transform plan.

The port's own numpy copy of the native-frame design of
``timbre_trap_tpu/transform/design.py`` (``SlicqPlan``, ``design_slicq``,
``hz_to_midi``, ``midi_to_hz``) and of the ``cqt_pytorch`` compat frame
(``design_cqt_pytorch``); the tables they return are equal to the JAX
package's.

Window design: center frequencies are geometrically spaced over
``n_octaves`` octaves below Nyquist. Bin ``k`` rises as ``sin(pi/2 t)``
between its lower neighbour's center and its own, and falls as
``cos(pi/2 t)`` up to its upper neighbour's center; the lowest window
plateaus down to DC and the highest up to Nyquist, so
``sum_k w_k(f)^2 == 1`` on the whole spectrum: the frame is tight, the dual
window is the analysis window, and encode->decode is exact up to rounding.
All bins share one coefficient length ``max_window_length`` (the sliCQ
matrix form), so coefficients are a dense (F, T) array.
"""

from dataclasses import dataclass, field
import math

import numpy as np

__all__ = ["SlicqPlan", "design_slicq", "design_cqt_pytorch",
           "hz_to_midi", "midi_to_hz"]


def hz_to_midi(frequencies):
    """Convert frequency in Hz to (fractional) MIDI note number."""
    return 12.0 * (np.log2(np.asarray(frequencies, dtype=np.float64))
                   - np.log2(440.0)) + 69.0


def midi_to_hz(notes):
    """Convert (fractional) MIDI note number to frequency in Hz."""
    return 440.0 * (2.0 ** ((np.asarray(notes, dtype=np.float64) - 69.0) / 12.0))


def _next_power_of_2(x: int) -> int:
    return 1 << max(0, int(math.ceil(math.log2(max(1, x)))))


@dataclass(frozen=True)
class SlicqPlan:
    """Static host arrays and scalars describing one sliCQ configuration.

    Shapes: F = n_bins, M = max_window_length, R = block_length // 2 + 1.
    Analysis reads, for every bin, the contiguous spectrum band
    ``[band_lo_k, band_lo_k + M)`` and folds the mod-M alias roll into a
    post-IFFT phase ramp: ``c_k = IFFT_M(X[lo_k : lo_k+M] * band_win_k) *
    band_phase_k``. Synthesis reads ``scatter_idx`` / ``scatter_dual``:
    spectrum bin f is the sum over slots s of ``FFT_M(c)[scatter_idx[s, f]]
    * scatter_dual[s, f]`` (slots past a bin's windows hold a zero dual).
    """

    sample_rate: float
    n_octaves: int
    bins_per_octave: int
    block_length: int
    n_bins: int
    max_window_length: int
    n_rfft: int
    band_lo: np.ndarray = field(repr=False)      # (F,) int32
    band_win: np.ndarray = field(repr=False)     # (F, M) float32
    band_phase: np.ndarray = field(repr=False)   # (F, M) complex64 (x scale)
    alignment: int
    scatter_idx: np.ndarray = field(repr=False)  # (S, R) int32 into (F*M)
    scatter_dual: np.ndarray = field(repr=False)  # (S, R) float32
    band_dual: np.ndarray = field(repr=False)    # (F, M) float32
    center_freqs_hz: np.ndarray = field(repr=False)  # (F,) float64
    midi_freqs: np.ndarray = field(repr=False)  # (F,) float64
    scale: float = 1.0
    variant: str = "native"

    @property
    def hop_length(self) -> float:
        return self.block_length / self.max_window_length


def design_slicq(sample_rate, n_octaves, bins_per_octave, block_length,
                 power_of_2_length=True):
    """Construct the static gather/window/dual arrays for one configuration
    (``block_length = int(secs_per_block * sample_rate)``)."""
    n_bins = n_octaves * bins_per_octave
    nyquist = sample_rate / 2.0
    half = block_length // 2
    if block_length % 2 != 0:
        raise ValueError("block_length must be even")
    n_rfft = half + 1

    fmin = nyquist / (2.0 ** n_octaves)
    center_freqs = fmin * 2.0 ** (np.arange(n_bins, dtype=np.float64)
                                  / bins_per_octave)
    midi_freqs = hz_to_midi(fmin) + np.arange(n_bins, dtype=np.float64) / (
        bins_per_octave / 12.0)

    # Center positions in fractional DFT bins; DC and Nyquist close the chain.
    pos = center_freqs * block_length / sample_rate
    nodes = np.concatenate(([0.0], pos, [float(half)]))

    # Integer support of each window: [lo_k, hi_k] inclusive.
    lo = np.ceil(nodes[:-2]).astype(np.int64)
    hi = np.floor(nodes[2:]).astype(np.int64)
    lo[0] = 0
    hi[-1] = half
    support = np.maximum(hi - lo + 1, 0)

    max_support = int(support.max())
    M = _next_power_of_2(max_support) if power_of_2_length else max_support

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

    # Band starts aligned down to 128 when the window-length slack allows.
    alignment = 128 if (max_support + 127 <= M and M % 128 == 0) else 1
    band_lo = np.maximum((lo // alignment) * alignment, 0)
    if np.any(hi - band_lo + 1 > M):
        raise AssertionError("aligned band exceeds window length")

    band_win = np.zeros((n_bins, M), dtype=np.float64)
    contrib_idx = [[] for _ in range(n_rfft)]
    contrib_dual = [[] for _ in range(n_rfft)]
    for k in range(n_bins):
        if support[k] <= 0:
            continue
        f = np.arange(lo[k], hi[k] + 1)
        w = window_value(k, f)
        m = np.mod(f, M)
        band_win[k, f - band_lo[k]] = w
        nz = w > 0.0
        for fi, mi, wi in zip(f[nz], m[nz], w[nz]):
            contrib_idx[fi].append(k * M + mi)
            contrib_dual[fi].append(wi)

    S = np.array([float(np.sum(np.square(c))) for c in contrib_dual])
    if not np.allclose(S, 1.0, atol=1e-10):
        raise AssertionError(
            f"frame operator not identity: S in [{S.min()}, {S.max()}]")
    max_contrib = max(len(c) for c in contrib_idx)
    if max_contrib > 2:
        raise AssertionError(
            f"more than two windows overlap one spectrum bin ({max_contrib})")

    scatter_idx = np.zeros((2, n_rfft), dtype=np.int64)
    scatter_dual = np.zeros((2, n_rfft), dtype=np.float64)
    for fi in range(n_rfft):
        for s, (ci, cd) in enumerate(zip(contrib_idx[fi], contrib_dual[fi])):
            scatter_idx[s, fi] = ci
            scatter_dual[s, fi] = cd

    # A full-scale sinusoid at a bin center gives coefficients of ~1.
    scale = 2.0 * M / block_length
    ang = 2.0 * np.pi * np.outer(np.mod(band_lo, M), np.arange(M)) / M
    band_phase = (scale * np.exp(1j * ang)).astype(np.complex64)

    return SlicqPlan(
        sample_rate=float(sample_rate),
        n_octaves=int(n_octaves),
        bins_per_octave=int(bins_per_octave),
        block_length=int(block_length),
        n_bins=int(n_bins),
        max_window_length=int(M),
        n_rfft=int(n_rfft),
        band_lo=band_lo.astype(np.int32),
        band_win=band_win.astype(np.float32),
        band_phase=band_phase,
        alignment=int(alignment),
        scatter_idx=scatter_idx.astype(np.int32),
        scatter_dual=scatter_dual.astype(np.float32),
        band_dual=band_win.astype(np.float32),
        center_freqs_hz=center_freqs,
        midi_freqs=midi_freqs,
        scale=float(scale),
        variant="native",
    )


def design_cqt_pytorch(sample_rate, n_octaves, bins_per_octave, block_length,
                       power_of_2_length=True, tables=None):
    """Construct a ``cqt_pytorch``-compatible sliCQ plan (compat frame).

    The released reference checkpoint (``tt-orig.pt``) was trained on
    coefficients produced by the external ``cqt_pytorch`` package
    (``timbre_trap/framework/cqtwrapper.py:31-35``), whose source is not
    part of this repository. This designer rebuilds that transform's
    *frame* from the construction it documents — the painless NSGT of the
    sliCQ paper (arXiv 1210.0084) with constant-Q Hann windows in the
    frequency domain — pinned to the wrapper-visible behaviors:

    * geometric centers over ``n_octaves`` below Nyquist
      (``cqtwrapper.py:45-48``),
    * constant-Q bandwidths ``Omega_k = xi_k * (2^(1/B) - 2^(-1/B))``
      (Q ~ 43.3 at B = 60),
    * per-bin frequency crops IFFT'd at the common, power-of-2-rounded
      ``max_window_length`` (``power_of_2_length=True``, ``cqtwrapper.py:35``;
      ``hop = block_length / max_window_length``, :40),
    * plain ``ifft`` (1/M) coefficient scaling, baseband demodulation at each
      crop's start bin (coefficients = ``ifft(window * spectrum_crop)``).

    Synthesis uses the canonical dual frame (``w_k / S`` with
    ``S(f) = sum_k w_k(f)^2``) — exact wherever the windows cover the
    spectrum; content below the lowest window (and in sub-bin gaps between
    the narrowest low-frequency windows) is not reconstructable, matching the
    reference transform's documented approximate invertibility.

    ``tables`` — optional measured tables ``{"starts": (F,) int,
    "windows": list/object array of per-bin float window values, "M": int}``
    produced by :mod:`.calibrate` from a live
    ``cqt_pytorch`` install; when given they override the analytic window
    construction entirely, making the compat mode bit-faithful to whatever
    the installed package actually computes.
    """
    if tables is not None:
        unknown = set(tables) - {"starts", "windows", "M"}
        if unknown:
            raise ValueError(f"unknown tables keys {sorted(unknown)}; "
                             "expected starts, windows and M")

    n_bins = n_octaves * bins_per_octave
    nyquist = sample_rate / 2.0
    if block_length % 2 != 0:
        raise ValueError("block_length must be even")
    half = block_length // 2
    n_rfft = half + 1

    fmin = nyquist / (2.0 ** n_octaves)
    center_freqs = fmin * 2.0 ** (np.arange(n_bins, dtype=np.float64) / bins_per_octave)
    midi_freqs = hz_to_midi(fmin) + np.arange(n_bins, dtype=np.float64) / (bins_per_octave / 12.0)

    if tables is None:
        # Constant-Q bandwidth (Hz): Omega_k = xi_k * (2^(1/B) - 2^(-1/B)) ==
        # xi_{k+1} - xi_{k-1} for geometric spacing — Hann windows at ~2x
        # overlap (the classic 50%-overlap partition).
        q_factor = 1.0 / (2.0 ** (1.0 / bins_per_octave)
                          - 2.0 ** (-1.0 / bins_per_octave))
        pos = center_freqs * block_length / sample_rate      # fractional bins
        width = pos / q_factor                               # support in bins
        lengths = np.maximum(np.ceil(width).astype(np.int64), 2)
        starts = np.round(pos - lengths / 2.0).astype(np.int64)
        # Keep every window inside the one-sided spectrum [0, half].
        starts = np.clip(starts, 0, np.maximum(half + 1 - lengths, 0))
        # Periodic Hann (torch.hann_window default): w[i] = 0.5 - 0.5 cos(2 pi i / n).
        windows = [0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)
                   for n in lengths]
        max_support = int(lengths.max())
        M = _next_power_of_2(max_support) if power_of_2_length else max_support
    else:
        starts = np.asarray(tables["starts"], dtype=np.int64)
        windows = [np.asarray(w) for w in tables["windows"]]
        if len(windows) != n_bins or starts.shape != (n_bins,):
            raise ValueError("measured tables do not match the configuration")
        lengths = np.array([len(w) for w in windows], dtype=np.int64)
        max_support = int(lengths.max())
        M = int(tables.get("M", 0)) or (
            _next_power_of_2(max_support) if power_of_2_length else max_support)
        if max_support > M:
            raise ValueError("measured window longer than max_window_length")

    # Measured tables may carry complex window values (a package convention
    # beyond pure magnitude is still identified exactly by calibrate.py).
    is_complex = any(np.iscomplexobj(w) for w in windows)
    tdtype = np.complex128 if is_complex else np.float64
    out_dtype = np.complex64 if is_complex else np.float32
    windows = [np.asarray(w, dtype=tdtype) for w in windows]

    # Coverage S(f) = sum_k |w_k(f)|^2 on the integer grid; canonical dual.
    S = np.zeros(n_rfft, dtype=np.float64)
    for k in range(n_bins):
        f = np.arange(starts[k], starts[k] + lengths[k])
        S[f] += np.square(np.abs(windows[k]))
    covered = S > 1e-6 * max(float(S.max()), 1e-300)
    S_safe = np.where(covered, S, 1.0)

    # Analysis band tables — same aligned contiguous-slice machinery as the
    # exact design; the crop-start demodulation goes into the phase ramp.
    alignment = 128 if (max_support + 127 <= M and M % 128 == 0) else 1
    band_lo = (starts // alignment) * alignment
    band_lo = np.maximum(band_lo, 0)
    if np.any(starts + lengths - band_lo > M):
        raise AssertionError("aligned band exceeds window length")

    band_win = np.zeros((n_bins, M), dtype=tdtype)
    band_dual = np.zeros((n_bins, M), dtype=tdtype)
    n_slots = int(np.max(np.bincount(
        np.concatenate([np.arange(starts[k], starts[k] + lengths[k])
                        for k in range(n_bins)]),
        minlength=n_rfft)))
    contrib_count = np.zeros(n_rfft, dtype=np.int64)
    scatter_idx = np.zeros((n_slots, n_rfft), dtype=np.int64)
    scatter_dual = np.zeros((n_slots, n_rfft), dtype=tdtype)
    for k in range(n_bins):
        f = np.arange(starts[k], starts[k] + lengths[k])
        off = f - band_lo[k]
        w = windows[k]
        # Canonical dual; spectrum bins no window covers reconstruct as 0.
        d = np.where(covered[f], np.conj(w) / S_safe[f], 0.0)
        band_win[k, off] = w
        band_dual[k, off] = d
        nz = w != 0.0
        slot = contrib_count[f[nz]]
        scatter_idx[slot, f[nz]] = k * M + (f[nz] - starts[k])
        scatter_dual[slot, f[nz]] = d[nz]
        contrib_count[f[nz]] += 1

    # Demodulate each band at its crop start (cqt_pytorch convention:
    # coefficients = ifft of the zero-padded crop). scale = 1: plain 1/M ifft
    # normalization — the released weights expect this coefficient scale.
    n_idx = np.arange(M)
    ang = -2.0 * np.pi * np.outer(starts - band_lo, n_idx) / M
    band_phase = np.exp(1j * ang).astype(np.complex64)

    return SlicqPlan(
        sample_rate=float(sample_rate),
        n_octaves=int(n_octaves),
        bins_per_octave=int(bins_per_octave),
        block_length=int(block_length),
        n_bins=int(n_bins),
        max_window_length=int(M),
        n_rfft=int(n_rfft),
        band_lo=band_lo.astype(np.int32),
        band_win=band_win.astype(out_dtype),
        band_phase=band_phase,
        alignment=int(alignment),
        scatter_idx=scatter_idx.astype(np.int32),
        scatter_dual=scatter_dual.astype(out_dtype),
        band_dual=band_dual.astype(out_dtype),
        center_freqs_hz=center_freqs,
        midi_freqs=midi_freqs,
        scale=1.0,
        variant="cqt_pytorch",
    )
