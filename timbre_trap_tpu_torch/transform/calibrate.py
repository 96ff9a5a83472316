"""Black-box identification of a ``cqt_pytorch``-style transform.

The port's own numpy copy of ``timbre_trap_tpu/transform/calibrate.py``
(``identify_transform``, ``save_tables``, ``load_tables``). Any linear
analysis of the form

    c_k = ifft_M( window_k * spectrum_crop_k )        (one crop per bin k)

responds to a probe ``cos(2*pi*f*n/L)`` at integer DFT bin ``f`` with, per
CQT bin ``k``,

    c_k[n] = (amp_f / M) * g_k(f) * exp(2i*pi*r*n/M),   r = f - start_k,

a single complex exponential whose rate reveals the crop offset and whose
amplitude reveals the (possibly complex) window value ``g_k(f)``. Probing
every integer bin identifies the per-bin crop starts and window tables,
which :func:`.design.design_cqt_pytorch` takes verbatim (``tables=``).
Measuring a live ``cqt_pytorch`` install (the JAX package's
``tables_from_cqt_pytorch``) needs that package, which the port does not
depend on; tables measured there load here with :func:`load_tables`.
"""

import numpy as np

__all__ = ["identify_transform", "save_tables", "load_tables"]


def identify_transform(encode_fn, block_length, n_bins, batch=64, rtol=1e-5):
    """Measure per-bin (start, window) tables of a block transform.

    Parameters
    ----------
    encode_fn : callable
      ``(B, 1, block_length) float32 -> (B, 1, n_bins, M) complex`` analysis
      of exactly one block (the ``cqt_pytorch.CQT.encode`` contract for a
      single ``block_length`` input).
    block_length : int
    n_bins : int
    batch : int
      Number of probe frequencies evaluated per call.
    rtol : float
      Window values below ``rtol * max_response`` count as zero.

    Returns
    ----------
    tables : dict
      ``{"starts": (F,) int64, "windows": list of per-bin arrays (complex128,
      cast to real when imaginary parts vanish), "M": int}`` — the ``tables``
      argument of ``design_cqt_pytorch``.
    """
    L = int(block_length)
    half = L // 2
    n_rfft = half + 1
    n = np.arange(L, dtype=np.float64)

    M = None
    # responses[k] : dict f -> (g, r)
    responses = [dict() for _ in range(n_bins)]
    peak = 0.0

    for lo in range(0, n_rfft, batch):
        freqs = np.arange(lo, min(lo + batch, n_rfft))
        probes = np.cos(2.0 * np.pi * freqs[:, None] * n[None, :] / L)
        probes = probes[:, None, :].astype(np.float32)      # (B, 1, L)
        coeffs = np.asarray(encode_fn(probes))              # (B, 1, F, M)
        if coeffs.ndim != 4 or coeffs.shape[2] != n_bins:
            raise ValueError(f"unexpected coefficient shape {coeffs.shape}")
        if M is None:
            M = coeffs.shape[-1]
        c = coeffs[:, 0]                                    # (B, F, M)
        # Rate r of each (probe, bin) exponential via one full correlation
        # against all M rates (robust to zero samples, unlike c[1]/c[0]).
        spec = np.fft.fft(c, axis=-1)                        # rate r -> peak at r
        r_hat = np.argmax(np.abs(spec), axis=-1)             # (B, F)
        mag = np.max(np.abs(spec), axis=-1) / M              # |g|*amp/M
        for bi, f in enumerate(freqs):
            amp = float(L if f in (0, half) else L / 2)
            for k in range(n_bins):
                a = mag[bi, k] * M / amp
                if a == 0.0:
                    continue
                # Complex window value: the rate-r Fourier coefficient of c.
                g = spec[bi, k, r_hat[bi, k]] / M * (M / amp)
                responses[k][int(f)] = (complex(g), int(r_hat[bi, k]))
                peak = max(peak, abs(g))

    starts = np.zeros(n_bins, dtype=np.int64)
    windows = []
    for k in range(n_bins):
        resp = {f: (g, r) for f, (g, r) in responses[k].items()
                if abs(g) > rtol * peak}
        if not resp:
            raise ValueError(f"bin {k} produced no measurable response")
        implied = {f - r for f, (_, r) in resp.items()}
        if len(implied) != 1:
            raise ValueError(
                f"bin {k}: inconsistent crop starts {sorted(implied)} — "
                "transform is not of the ifft-of-crop form")
        start = implied.pop()
        if start < 0:
            raise ValueError(
                f"bin {k}: measured demodulation implies a negative crop "
                f"start ({start}) — wrap-around crops are not expressible "
                "in the tables form")
        fs = sorted(resp)
        length = fs[-1] - start + 1
        win = np.zeros(length, dtype=np.complex128)
        for f, (g, _) in resp.items():
            win[f - start] = g
        if np.allclose(win.imag, 0.0, atol=rtol * max(peak, 1e-30)):
            win = win.real.copy()
        starts[k] = start
        windows.append(win)

    return {"starts": starts, "windows": windows, "M": int(M)}


def save_tables(path, tables):
    """Persist measured tables as an ``.npz`` (object array for the windows)."""
    wins = np.empty(len(tables["windows"]), dtype=object)
    for i, w in enumerate(tables["windows"]):
        wins[i] = np.asarray(w)
    np.savez(path,
             starts=np.asarray(tables["starts"], dtype=np.int64),
             M=np.int64(tables["M"]),
             windows=wins)


def load_tables(path):
    """Tables written by :func:`save_tables` (the windows are an object
    array, so only load files this code wrote)."""
    data = np.load(path, allow_pickle=True)
    return {"starts": data["starts"],
            "windows": list(data["windows"]),
            "M": int(data["M"])}
