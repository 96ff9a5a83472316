"""PyTorch execution of the sliCQ plan: analysis (encode) and synthesis
(decode).

Counterpart of ``timbre_trap_tpu/transform/nsgt.py:build_slicq_fns``. Per
block of L samples:

    encode: rfft(L) -> band slices [band_lo_k, band_lo_k + M) -> window
            multiply -> ifft(M) per bin -> phase ramp (undoes the mod-M
            alias roll)
    decode: fft(M) per bin / scale -> for each spectrum bin, the sum over
            its S window slots of a gathered coefficient times its dual
            window value -> irfft(L)

``torch.fft`` takes any length (cuFFT factors 66150 = 2·3³·5²·7²), so the
matmul FFT the JAX package needs on the TPU has no counterpart here. The
band slices are one ``index_select`` of ``band_lo[:, None] + arange(M)``,
which is exact for both the 128-aligned tables and the unaligned fallback.

Synthesis takes the gather form of the JAX package's unaligned fallback for
every plan: the scatter tables do not depend on the band alignment (the
phase ramp puts spectrum bin f of window k at FFT index ``f mod M``, or
``f - start_k`` on the compat frame, whatever ``band_lo_k``), so it serves
the 128-aligned plans too, where the JAX package takes a one-hot matmul
that suits the TPU. A gather has a fixed order on the card and needs
neither a matmul (whose float32 product could round through TF32) nor an
``index_add_`` (atomics, in no fixed order).
"""

import numpy as np
import torch

__all__ = ["build_encode", "build_decode"]


def build_encode(plan, device):
    """Return ``encode(audio)``: real (B, C, T) -> complex64 (B, C, F, T')
    with ``T' = ceil(T / L * M)``; the tables live on ``device``."""
    L = plan.block_length
    M = plan.max_window_length
    F = plan.n_bins
    R = plan.n_rfft
    S = int(plan.band_lo.max()) + M
    band_win = torch.as_tensor(plan.band_win, device=device)
    band_phase = torch.as_tensor(plan.band_phase, device=device)
    idx = (plan.band_lo[:, None].astype(np.int64)
           + np.arange(M)[None, :]).reshape(-1)
    idx = torch.as_tensor(idx, device=device)

    def encode(audio):
        audio = audio.to(torch.float32)
        B, C, T = audio.shape
        pad = -T % L
        if pad:
            # Zero-pad to whole blocks; frames are truncated to ceil(T·M/L).
            audio = torch.nn.functional.pad(audio, (0, pad))
        nb = (T + pad) // L
        X = torch.fft.rfft(audio.reshape(B, C, nb, L), dim=-1)   # (B,C,nb,R)
        X = torch.nn.functional.pad(X, (0, S - R))
        Z = X.index_select(-1, idx).reshape(B, C, nb, F, M) * band_win
        coeffs = torch.fft.ifft(Z, dim=-1) * band_phase           # (B,C,nb,F,M)
        coeffs = coeffs.movedim(-3, -2).reshape(B, C, F, nb * M)
        n_frames = -(-T * M // L)
        return coeffs[..., :n_frames]

    return encode


def build_decode(plan, device):
    """Return ``decode(coefficients)``: complex (B, C, F, T) with T a
    multiple of M -> real float32 (B, C, T / M * L), unnormalised; the
    tables live on ``device``."""
    L = plan.block_length
    M = plan.max_window_length
    F = plan.n_bins
    idx = torch.as_tensor(plan.scatter_idx.astype(np.int64), device=device)
    dual = torch.as_tensor(plan.scatter_dual, device=device)
    inv_scale = float(np.float32(1.0 / plan.scale))

    def decode(coefficients):
        if not coefficients.is_complex():
            raise ValueError("decode expects complex coefficients")
        B, C, Fc, Tf = coefficients.shape
        if Fc != F:
            raise ValueError(f"expected {F} bins, got {Fc}")
        if Tf % M != 0:
            raise ValueError(f"{Tf} frames not a multiple of window length {M}")
        nb = Tf // M
        c = coefficients.to(torch.complex64).reshape(B, C, F, nb, M)
        Z = torch.fft.fft(c.movedim(-2, -3), dim=-1) * inv_scale
        Z = Z.reshape(B, C, nb, F * M)
        X = sum(Z.index_select(-1, idx[s]) * dual[s]
                for s in range(idx.shape[0]))                 # (B,C,nb,R)
        x = torch.fft.irfft(X, n=L, dim=-1)                     # (B,C,nb,L)
        return x.reshape(B, C, nb * L).to(torch.float32)

    return decode
