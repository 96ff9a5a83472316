"""ctypes bindings for the native (C++) audio loader (the port's copy of
``timbre_trap_tpu/data/io/native.py``).

Builds ``native/build/libtt_audio.so`` at the repository root (shared with
the JAX package) with g++ on first use (cached) and
exposes :func:`load_audio_native`. Callers should fall back to the numpy
path when :func:`available` is False (no toolchain, unsupported platform).
"""

import ctypes
import os
import subprocess
import threading

import numpy as np

__all__ = ["available", "mp3_available", "load_audio_native",
           "load_mp3_native"]

_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", ".."))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_SO_PATH = os.path.join(_NATIVE_DIR, "build", "libtt_audio.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build():
    subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                   capture_output=True)


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            if not os.path.exists(_SO_PATH):
                _build()
            lib = ctypes.CDLL(_SO_PATH)
            lib.tt_load_wav.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int),
            ]
            lib.tt_load_wav.restype = ctypes.c_int
            lib.tt_load_mp3.argtypes = lib.tt_load_wav.argtypes
            lib.tt_load_mp3.restype = ctypes.c_int
            lib.tt_mp3_available.argtypes = []
            lib.tt_mp3_available.restype = ctypes.c_int
            lib.tt_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
            lib.tt_free.restype = None
            _lib = lib
        except Exception:
            _lib = None
        return _lib


def available():
    """Whether the native loader is usable on this machine."""
    return _load() is not None


def mp3_available():
    """Whether MP3 decode is usable (native lib built AND libmpg123 found)."""
    lib = _load()
    return lib is not None and bool(lib.tt_mp3_available())


def _decode(fn_name, kind, path, sample_rate, normalize):
    lib = _load()
    if lib is None:
        raise RuntimeError("native audio library unavailable")
    out = ctypes.POINTER(ctypes.c_float)()
    out_len = ctypes.c_int64()
    out_sr = ctypes.c_int()
    rc = getattr(lib, fn_name)(
        os.fsencode(path), int(sample_rate or 0), int(bool(normalize)),
        ctypes.byref(out), ctypes.byref(out_len), ctypes.byref(out_sr))
    if rc != 0:
        raise RuntimeError(f"native {kind} decode failed (code {rc}) for {path}")
    try:
        n = out_len.value
        audio = np.ctypeslib.as_array(out, shape=(n,)).copy()
    finally:
        lib.tt_free(out)
    return audio[None, :].astype(np.float32), int(out_sr.value)


def load_audio_native(path, sample_rate=None, normalize=True):
    """Decode a WAV file natively -> (float32 (1, N) array, sample_rate).

    Raises RuntimeError on decode failure (caller may fall back).
    """
    return _decode("tt_load_wav", "WAV", path, sample_rate, normalize)


def load_mp3_native(path, sample_rate=None, normalize=True):
    """Decode an MP3 via the system libmpg123 (dlopen'd by the native lib).

    Same contract as :func:`load_audio_native`; reference parity with the
    torchaudio decode path (``datasets/AudioDataset.py:49-86``) for the FMA
    corpus (``datasets/AudioMixtures/FMA.py``).
    """
    return _decode("tt_load_mp3", "MP3", path, sample_rate, normalize)
