"""Public Timbre-Trap model (base variant): transform + network + transcribe.

Counterpart of ``timbre_trap_tpu/models/timbre_trap.py:TimbreTrap`` for the
inference main path: ``features_from_audio``, ``inference``,
``chunked_inference``, ``to_activations`` and the streaming ``transcribe``.
Public layouts match the JAX package (coefficients ``(B, C, F, T)``,
activations ``(B, F, T)``).

Precision policy, as in the JAX package: ``transcribe`` runs the conv chain
with bfloat16 weights and activations, float32 accumulation and float32
biases, unless ``fused="f32"``; every other path is float32.

The model runs on the card unless the caller asks for the CPU
(``device="cpu"``, where the kernels' plain twins run). With no CUDA device
present, ``device=None`` raises instead of falling back to the CPU.
"""

import numpy as np
import torch

from ..device import resolve_device
from ..interop import state_dict_from_jax
from ..transform import CQT
from .fused import forward_spec, fused_forward
from .modules import TimbreTrapNet, init_weights

__all__ = ["TimbreTrap"]

_FUSED_MODES = ("auto", "f32")


class TimbreTrap:
    """Base (real/imaginary coefficient) model with indicator-channel switch."""

    variant = "base"
    # Chunks of the 50%-overlap stream run per forward.
    chunk_group = 4
    # Streaming-transcribe piece size, in sliCQ blocks.
    piece_blocks = 16
    # Route host clips shorter than two pieces through a zero-padded piece
    # too. Off by default: the port has no per-shape compile to amortise, so
    # padding a short clip would only add work.
    pad_short_to_piece = False

    def __init__(self, sample_rate, n_octaves, bins_per_octave,
                 secs_per_block=3, latent_size=None, model_complexity=1,
                 skip_connections=False, seed=0, fused="auto", device=None):
        if skip_connections:
            raise NotImplementedError(
                "skip connections are not ported yet")
        self.device = resolve_device(device)
        self.fused = fused
        self.sliCQ = CQT(n_octaves=n_octaves, bins_per_octave=bins_per_octave,
                         sample_rate=sample_rate,
                         secs_per_block=secs_per_block, device=self.device)
        net = TimbreTrapNet(self.sliCQ.n_bins, latent_size, model_complexity)
        init_weights(net, torch.Generator().manual_seed(int(seed)))
        self.net = net.to(self.device).eval()
        self._specs = {}

    @property
    def fused(self):
        return self._fused

    @fused.setter
    def fused(self, value):
        if value not in _FUSED_MODES:
            raise ValueError(f"fused must be one of {_FUSED_MODES}, "
                             f"not {value!r}")
        self._fused = value

    def load_state_dict(self, state_dict):
        """Load reference-named weights (strict) and drop the cached chains."""
        self.net.load_state_dict(state_dict, strict=True)
        self.invalidate_specs()

    def invalidate_specs(self):
        """Drop the cached inference chains (and the kernel operands they
        hold): call after changing ``self.net``'s weights in place, as the
        train step does."""
        self._specs.clear()

    def load_jax_params(self, params):
        """Load a flax parameter tree of the JAX package's TimbreTrapNet."""
        self.load_state_dict(state_dict_from_jax(params))

    def _spec(self, transcribe):
        if transcribe not in self._specs:
            self._specs[transcribe] = forward_spec(self.net, transcribe)
        return self._specs[transcribe]

    # ------------------------------------------------------------------ #
    # Features and forward                                               #
    # ------------------------------------------------------------------ #

    def _to_f32(self, audio):
        """Audio of any ingestion dtype -> float32 on the model's device:
        int16 (PCM16) dequantizes by 1/32768, float16 casts."""
        audio = torch.as_tensor(audio).to(self.device)
        if audio.dtype == torch.int16:
            return audio.to(torch.float32) * (1.0 / 32768.0)
        return audio.to(torch.float32)

    @torch.no_grad()
    def features_from_audio(self, audio):
        """Audio (B, 1, N) -> network input features (B, F, T, 2), NHWC."""
        coefficients = self.sliCQ.encode(self._to_f32(audio))
        return CQT.to_real(coefficients).movedim(-3, -1)

    def _dtype(self, transcribe):
        if transcribe and self.fused != "f32":
            return torch.bfloat16
        return torch.float32

    def _infer(self, audio, transcribe):
        """Block-multiple audio (B, 1, N) -> coefficients (B, C, F, T)."""
        features = self.features_from_audio(audio)
        return fused_forward(self.net, features, transcribe,
                             dtype=self._dtype(transcribe),
                             spec=self._spec(transcribe))

    @torch.no_grad()
    def inference(self, audio, transcribe=False):
        """Full-length single pass -> coefficients (B, C, F, T)."""
        audio = self.sliCQ.pad_to_block_length(self._to_f32(audio))
        return self._infer(audio, bool(transcribe))

    @torch.no_grad()
    def _chunked(self, audio, transcribe):
        """50%-overlap Hann overlap-add over chunks of one block.

        ``audio`` is padded to a block multiple and extended by half a block
        on each side. Chunks run ``chunk_group`` at a time; chunk k (scaled
        by a symmetric ``np.hanning(M)`` window) adds into frames
        ``[k*M/2, k*M/2 + M)``, i.e. even chunks tile the frames
        contiguously and odd chunks at a half-window offset, as in the JAX
        package. The centering margins are trimmed at the end.
        """
        L = self.sliCQ.block_length
        M = self.sliCQ.max_window_length
        F = self.sliCQ.n_bins
        B = audio.shape[0]
        C = self.net.in_channels
        hop = L // 2
        n_chunks = (audio.shape[-1] - hop) // hop
        n_frames = self.sliCQ.get_expected_frames(audio.shape[-1])
        window = torch.as_tensor(np.hanning(M), dtype=torch.float32,
                                 device=self.device)
        acc = torch.zeros((B, C, F, n_frames + 2 * M), dtype=torch.float32,
                          device=self.device)
        G = max(1, min(self.chunk_group, n_chunks))
        for g0 in range(0, n_chunks, G):
            n = min(G, n_chunks - g0)
            chunks = torch.stack([audio[..., (g0 + i) * hop:(g0 + i) * hop + L]
                                  for i in range(n)])        # (n, B, 1, L)
            out = self._infer(chunks.reshape(n * B, 1, L), transcribe)
            out = out.reshape(n, B, C, F, M) * window
            for i in range(n):
                start = (g0 + i) * (M // 2)
                acc[..., start:start + M] += out[i]
        return acc[..., M // 2: n_frames - M // 2]

    def _pad_for_chunks(self, audio):
        """Block-multiple + half-block centering pads."""
        audio = self.sliCQ.pad_to_block_length(audio)
        hop = self.sliCQ.block_length // 2
        return torch.nn.functional.pad(audio, (hop, hop))

    @torch.no_grad()
    def chunked_inference(self, audio, transcribe=False):
        """Arbitrary-length streaming inference -> coefficients (B, C, F, T)."""
        return self._chunked(self._pad_for_chunks(self._to_f32(audio)),
                             bool(transcribe))

    @staticmethod
    def to_activations(coefficients):
        """Transcription coefficients (B, C, F, T) -> activations (B, F, T)."""
        return torch.tanh(CQT.to_magnitude(coefficients))

    # ------------------------------------------------------------------ #
    # Streaming transcribe                                               #
    # ------------------------------------------------------------------ #

    def _piece(self, segment):
        """Activations of one pre-extended piece (``piece_blocks*L + L``
        samples: the piece plus a half-block halo on each side)."""
        return self.to_activations(self._chunked(self._to_f32(segment), True))

    def _stream_pieces(self, audio_np, out_per_block):
        """Piece-by-piece execution over a host array.

        Each ``piece_blocks*L + L`` window (zero halo at the signal edges)
        is staged in a pinned host buffer and copied to the card on a side
        stream while the previous piece computes; outputs are concatenated
        on the card and trimmed to ``n_blocks * out_per_block`` columns.
        """
        L = self.sliCQ.block_length
        hop = L // 2
        P = self.piece_blocks
        n_blocks = -(-audio_np.shape[-1] // L)
        n_pieces = -(-n_blocks // P)
        seg_len = P * L + L
        lead = [(0, 0)] * (audio_np.ndim - 1)

        def piece(i):
            a = i * P * L - hop
            b = a + seg_len
            lo, hi = max(a, 0), min(b, audio_np.shape[-1])
            seg = audio_np[..., lo:hi]
            if lo > a or hi < b:
                seg = np.pad(seg, lead + [(lo - a, b - hi)])
            return seg

        if self.device.type != "cuda":
            outs = [self._piece(torch.from_numpy(np.ascontiguousarray(piece(i))))
                    for i in range(n_pieces)]
        else:
            outs = self._stream_cuda(piece, n_pieces)
        out = torch.cat(outs, dim=-1)
        return out[..., :n_blocks * out_per_block]

    def _stream_cuda(self, piece, n_pieces):
        """Upload piece i+1 (pinned buffer, side stream, non_blocking) while
        piece i computes on the current stream."""
        main = torch.cuda.current_stream(self.device)
        copy = torch.cuda.Stream(self.device)
        first = np.ascontiguousarray(piece(0))
        pinned = [torch.empty(first.shape, dtype=torch.from_numpy(first).dtype,
                              pin_memory=True) for _ in range(2)]
        copied = [None, None]

        def upload(i, seg):
            slot = i % 2
            if copied[slot] is not None:
                copied[slot].synchronize()   # the slot's last copy is done
            pinned[slot].numpy()[...] = seg
            dev = torch.empty(pinned[slot].shape, dtype=pinned[slot].dtype,
                              device=self.device)
            # The new block may have been freed by work still queued on the
            # main stream: order the copy after it.
            copy.wait_stream(main)
            with torch.cuda.stream(copy):
                dev.copy_(pinned[slot], non_blocking=True)
                done = torch.cuda.Event()
                done.record(copy)
            copied[slot] = done
            return dev, done

        outs = []
        nxt = upload(0, first)
        for i in range(n_pieces):
            dev, done = nxt
            main.wait_event(done)
            if i + 1 < n_pieces:
                nxt = upload(i + 1, piece(i + 1))
            outs.append(self._piece(dev))
        return outs

    def _piece_route(self, audio_np):
        """Whether a host input streams piece by piece."""
        n_blocks = -(-audio_np.shape[-1] // self.sliCQ.block_length)
        if n_blocks >= 2 * self.piece_blocks:
            return True
        return self.pad_short_to_piece

    @torch.no_grad()
    def transcribe(self, audio):
        """Audio (B, 1, N) -> multi-pitch activations (B, F, T) in [0, 1].

        Host (numpy) inputs in float32, int16 or float16 of two pieces or
        more stream piece by piece; tensors and shorter clips take one
        pass over the whole padded signal.
        """
        if not isinstance(audio, torch.Tensor):
            audio_np = np.asarray(audio)
            if audio_np.dtype not in (np.int16, np.float16):
                audio_np = audio_np.astype(np.float32, copy=False)
            if self._piece_route(audio_np):
                return self._stream_pieces(audio_np,
                                           self.sliCQ.max_window_length)
            audio = torch.from_numpy(np.ascontiguousarray(audio_np))
        audio = self._pad_for_chunks(self._to_f32(audio))
        return self.to_activations(self._chunked(audio, True))
