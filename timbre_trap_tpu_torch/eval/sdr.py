"""Signal-to-distortion ratio with a short projection filter.

The port's own numpy/scipy copy of ``timbre_trap_tpu/eval/sdr.py``.

Equivalent to ``torchmetrics.audio.SignalDistortionRatio`` as used by the
reference evaluation (``experiments/evaluate.py:50-51,120-127``): the
reference signal is projected onto the estimate through an optimal
``filter_length``-tap FIR filter (solved as a Toeplitz system), and

    SDR = 10 log10( ||s_target||^2 / ||estimate - s_target||^2 ).

Pure numpy/scipy; correlations are computed via FFT.
"""

import numpy as np
import scipy.linalg

__all__ = ["signal_distortion_ratio"]


def _fft_correlations(target, estimate, filter_length):
    n = target.shape[-1]
    n_fft = 1 << int(np.ceil(np.log2(n + filter_length)))
    T = np.fft.rfft(target, n_fft)
    E = np.fft.rfft(estimate, n_fft)
    # autocorrelation of target (lags 0..filter_length-1)
    acf = np.fft.irfft(T * np.conj(T), n_fft)[..., :filter_length]
    # cross-correlation <target(t-tau), estimate(t)> for tau = 0..L-1
    xcorr = np.fft.irfft(np.conj(T) * E, n_fft)[..., :filter_length]
    return acf, xcorr


def signal_distortion_ratio(estimate, target, filter_length=512,
                            zero_mean=False, load_diag=None):
    """SDR (dB) of ``estimate`` against ``target`` over the last axis.

    Leading axes are averaged (matching torchmetrics' mean reduction).
    """
    estimate = np.asarray(estimate, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    if estimate.shape != target.shape:
        raise ValueError("estimate and target must have the same shape")
    flat_e = estimate.reshape(-1, estimate.shape[-1])
    flat_t = target.reshape(-1, target.shape[-1])

    sdrs = []
    for e, t in zip(flat_e, flat_t):
        if zero_mean:
            e = e - e.mean()
            t = t - t.mean()
        acf, xcorr = _fft_correlations(t, e, filter_length)
        if load_diag is not None:
            acf = acf.copy()
            acf[0] += load_diag
        if acf[0] <= 0:
            sdrs.append(-np.inf)
            continue
        h = scipy.linalg.solve_toeplitz(acf, xcorr)
        # ||P_t e||^2 = h . xcorr ; ||e||^2 - that = distortion energy
        coherent = float(np.dot(h, xcorr))
        total = float(np.dot(e, e))
        distortion = max(total - coherent, np.finfo(np.float64).tiny)
        coherent = max(coherent, np.finfo(np.float64).tiny)
        sdrs.append(10.0 * (np.log10(coherent) - np.log10(distortion)))
    return float(np.mean(sdrs))
