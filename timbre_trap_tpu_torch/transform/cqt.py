"""Public CQT wrapper with the reference API surface, on PyTorch.

Counterpart of ``timbre_trap_tpu/transform/cqt.py:CQT``: ``encode``,
``decode`` and ``decode_raw``, ``to_real``, ``to_complex``,
``to_magnitude``, ``to_decibels``, ``pad_to_block_length``,
``get_expected_samples``, ``get_expected_frames``, ``get_times`` and
``get_midi_freqs``, on the native (exact) frame or the ``cqt_pytorch``
compat frame.
"""

import math

import numpy as np
import torch

from ..device import resolve_device
from .design import design_cqt_pytorch, design_slicq
from .nsgt import build_decode, build_encode

__all__ = ["CQT"]


class CQT:
    """Invertible sliCQ transform with bookkeeping helpers.

    ``compat`` selects the frame: ``"native"`` (default), the exact
    partition-of-unity frame of :func:`.design.design_slicq`, or
    ``"cqt_pytorch"``, the compat frame the released ``tt-orig.pt`` was
    trained on (:func:`.design.design_cqt_pytorch`; approximately
    invertible, like the reference). ``compat_tables`` (from
    :mod:`.calibrate`) pin the compat windows to a measured install.

    ``device`` is where the plan tables live and where ``encode`` and
    ``decode`` run: the card unless the caller asks for the CPU
    (``device="cpu"``).
    """

    def __init__(self, n_octaves, bins_per_octave, sample_rate,
                 secs_per_block, compat="native", compat_tables=None,
                 device=None):
        block_length = int(secs_per_block * sample_rate)
        if compat in (None, "native"):
            if compat_tables is not None:
                raise ValueError("compat_tables requires compat='cqt_pytorch'")
            self.plan = design_slicq(sample_rate=sample_rate,
                                     n_octaves=n_octaves,
                                     bins_per_octave=bins_per_octave,
                                     block_length=block_length,
                                     power_of_2_length=True)
        elif compat == "cqt_pytorch":
            self.plan = design_cqt_pytorch(sample_rate=sample_rate,
                                           n_octaves=n_octaves,
                                           bins_per_octave=bins_per_octave,
                                           block_length=block_length,
                                           power_of_2_length=True,
                                           tables=compat_tables)
        else:
            raise ValueError(f"unknown compat mode: {compat!r}")
        self.compat = self.plan.variant
        self.device = resolve_device(device)
        self.sample_rate = sample_rate
        self.n_octaves = n_octaves
        self.bins_per_octave = bins_per_octave
        self.block_length = self.plan.block_length
        self.max_window_length = self.plan.max_window_length
        self.hop_length = self.block_length / self.max_window_length
        self.n_bins = self.plan.n_bins
        self.midi_freqs = np.asarray(self.plan.midi_freqs)
        self._encode = build_encode(self.plan, self.device)
        self._decode = build_decode(self.plan, self.device)

    def encode(self, audio):
        """Real audio (B x 1 x T) -> complex coefficients (B x 1 x F x T')."""
        return self._encode(torch.as_tensor(audio, device=self.device))

    def decode_raw(self, coefficients):
        """Complex (B x C x F x T) -> audio (B x C x T / M * L), not
        normalised."""
        return self._decode(torch.as_tensor(coefficients, device=self.device))

    @staticmethod
    def _normalize(audio):
        """Divide by the infinity norm over the whole batch
        (``cqtwrapper.py:209-211``); silence stays silence."""
        peak = audio.abs().max()
        return torch.where(peak > 0, audio / peak, audio)

    def _decode_normalized(self, coefficients):
        """Complex (B x 1 x F x T) -> audio normalised by its infinity norm."""
        return self._normalize(self.decode_raw(coefficients))

    def _decode_real(self, coefficients):
        """Real/imag (B x 2 x F x T) -> normalised audio (B x 1 x T)."""
        return self._decode_normalized(self.to_complex(coefficients)[:, None])

    @torch.no_grad()
    def decode(self, coefficients):
        """Coefficients (B x 2 [real] OR B x 1 [complex] x F x T) -> audio
        (B x 1 x T), normalised by the infinity norm of the whole batch
        (``cqtwrapper.py:209-211``)."""
        coefficients = torch.as_tensor(coefficients, device=self.device)
        if coefficients.is_complex():
            return self._decode_normalized(coefficients)
        return self._decode_real(coefficients)

    @staticmethod
    def to_real(coefficients):
        """Complex (B x 1 x F x T) -> stacked [real, imag] (B x 2 x F x T)."""
        coefficients = coefficients.squeeze(-3)
        return torch.stack([coefficients.real, coefficients.imag], dim=-3)

    @staticmethod
    def to_complex(coefficients):
        """Real/imag (B x 2 x F x T) -> complex (B x F x T)."""
        return torch.complex(coefficients.select(-3, 0),
                             coefficients.select(-3, 1))

    @staticmethod
    def to_magnitude(coefficients):
        """L2 magnitude over the real/imag channel dim."""
        return torch.linalg.vector_norm(coefficients, dim=-3)

    @staticmethod
    def to_decibels(magnitude, rescale=True):
        """Amplitude -> dB with an 80 dB floor per track; optionally in [0, 1]."""
        db = 20.0 * torch.log10(torch.clamp(magnitude, min=1e-10))
        db_max = db.flatten(1).amax(dim=1).reshape((-1,) + (1,) * (db.ndim - 1))
        db = torch.maximum(db, db_max - 80.0)
        if rescale:
            db = 1.0 + (db - db_max) / 80.0
        return db

    def pad_to_block_length(self, audio):
        """Zero-pad audio (... x T) up to the next block multiple."""
        pad = -audio.shape[-1] % self.block_length
        if pad == 0:
            return audio
        return torch.nn.functional.pad(audio, (0, pad))

    def get_expected_samples(self, t):
        """Seconds -> samples, rounded down."""
        return int(max(0, t) * self.sample_rate)

    def get_expected_frames(self, num_samples):
        """Samples -> coefficient frames."""
        return math.ceil((num_samples / self.block_length)
                         * self.max_window_length)

    def get_times(self, n_frames):
        """Time (s) of each coefficient frame."""
        return np.arange(n_frames) * self.hop_length / self.sample_rate

    def get_midi_freqs(self):
        """Center frequency (MIDI) of each bin."""
        return self.midi_freqs
