"""Public Timbre-Trap model families: transform + network + transcribe and
reconstruct, and their persistence.

Counterpart of ``timbre_trap_tpu/models/timbre_trap.py`` (``TimbreTrap``,
``TimbreTrapFiLM``, ``TimbreTrapMag``, ``TimbreTrapMagDB``, with or without
skip connections): ``features_from_audio``, ``inference``,
``chunked_inference``, ``to_activations``, the streaming ``transcribe``
and ``reconstruct``, the differentiable ``encode``,
``apply_skip_connections``, ``decode`` and ``forward``, and ``save``,
``load`` and ``load_model``. Public layouts match the JAX package
(coefficients ``(B, C, F, T)``, activations ``(B, F, T)``, latents
``(B, D, T)``, audio ``(B, 1, N)``), except the encoder embeddings, which
are NCHW ``(B, C, F, T)`` here and NHWC in the JAX package.

Precision policy, as in the JAX package: ``transcribe`` runs the conv chain
with bfloat16 weights and activations, float32 accumulation and float32
biases, unless ``fused="f32"``; every other path, ``reconstruct`` included,
is float32.

The model runs on the card unless the caller asks for the CPU
(``device="cpu"``, where the kernels' plain twins run). With no CUDA device
present, ``device=None`` raises instead of falling back to the CPU.

On the card every chunk group of the overlap-add stream (``_chunked``: the
sliCQ analysis and the whole forward of up to ``chunk_group`` chunks) is the
replay of one CUDA graph, captured once per key (branch, compute dtype,
chunks in the group, batch) into one memory pool a model, and dropped with
the inference chains (``invalidate_specs``, ``load_state_dict``).
"""

import json
import os
from typing import NamedTuple

import numpy as np
import torch

from ..device import resolve_device
from ..interop import state_dict_from_jax
from ..transform import CQT
from ..utils.profiling import span
from .fused import forward_spec, fused_forward
from .modules import TimbreTrapNet, init_weights

__all__ = ["TimbreTrap", "TimbreTrapFiLM", "TimbreTrapMag", "TimbreTrapMagDB",
           "load_model"]

_FUSED_MODES = ("auto", "f32")
# The weights file of a ``save`` directory (beside ``hparams.json``).
WEIGHTS_FILE = "weights.pt"
# The file of a training checkpoint directory (``train/checkpoint.py``).
CHECKPOINT_FILE = "checkpoint.pt"


def _replays_graphs(device):
    """Whether chunk groups on ``device`` run as CUDA graph replays: on
    the card, always."""
    return device.type == "cuda"


class _GroupGraph(NamedTuple):
    """One chunk group's forward captured as a CUDA graph: the static input
    (n·B, 1, L) that each replay reads, the static output (n·B, C, F, M)
    that it writes, and the spec it was captured on, kept alive with it
    (the graph reads its operands in place)."""
    graph: object
    input: torch.Tensor
    output: torch.Tensor
    spec: object


def _host_array(audio):
    """A host clip as numpy: int16 (PCM16) and float16 stay as they are
    (they upload at half the bytes and dequantize on the device), anything
    else becomes float32."""
    audio_np = np.asarray(audio)
    if audio_np.dtype not in (np.int16, np.float16):
        audio_np = audio_np.astype(np.float32, copy=False)
    return audio_np


class TimbreTrap:
    """Base (real/imaginary coefficient) model with indicator-channel
    switch; the other families subclass it. ``skip_connections`` adds the
    scaled encoder embeddings to the decoder (every family). ``remat``
    recomputes the NCHW network's cells in the backward pass
    (``TimbreTrapNet``; it matters to the ``"flax"`` train backend only, as
    the packed backends checkpoint each level themselves)."""

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
                 skip_connections=False, seed=0, remat=False, fused="auto",
                 transform_compat="native", compat_tables=None, device=None):
        self.hparams = dict(sample_rate=sample_rate, n_octaves=n_octaves,
                            bins_per_octave=bins_per_octave,
                            secs_per_block=secs_per_block,
                            latent_size=latent_size,
                            model_complexity=model_complexity,
                            skip_connections=skip_connections,
                            variant=self.variant,
                            transform_compat=transform_compat)
        self.device = resolve_device(device)
        self.fused = fused
        self.sliCQ = CQT(n_octaves=n_octaves, bins_per_octave=bins_per_octave,
                         sample_rate=sample_rate,
                         secs_per_block=secs_per_block,
                         compat=transform_compat,
                         compat_tables=compat_tables, device=self.device)
        # ``remat`` changes how the NCHW network trains, not what it is:
        # like the JAX package, it stays out of ``hparams`` (and saved files).
        net = TimbreTrapNet(self.sliCQ.n_bins, latent_size, model_complexity,
                            self.variant, skip_connections, remat)
        init_weights(net, torch.Generator().manual_seed(int(seed)))
        self.net = net.to(self.device).eval()
        self._specs = {}
        self._graphs = {}
        self._graph_pool = None
        # The overlap-add's symmetric Hann window, resident on the device.
        self._window = torch.as_tensor(
            np.hanning(self.sliCQ.max_window_length), dtype=torch.float32,
            device=self.device)

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
        hold) and the chunk groups' CUDA graphs captured on them: call after
        changing ``self.net``'s weights in place, as the train step does."""
        self._specs.clear()
        self._graphs = {}
        self._graph_pool = None

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
        """Audio (B, 1, N) -> network input features (B, F, T, C_in), NHWC."""
        with span("tt.analysis"):
            return self._features_from_complex(self.sliCQ.encode(
                self._to_f32(audio)))

    @staticmethod
    def _features_from_complex(coefficients):
        """Complex (B, 1, F, T) -> real/imag features (B, F, T, 2)."""
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

    # ------------------------------------------------------------------ #
    # Public API (reference layouts), differentiable                     #
    # ------------------------------------------------------------------ #

    def encode(self, audio):
        """Audio (B, 1, N) -> (latents (B, D, T), the 5 encoder embeddings,
        losses ``{}``), through the NCHW network with autograd (the
        features carry no gradient, as in the reference). The embeddings
        are NCHW ``(B, C, F, T)``; the JAX package returns them NHWC."""
        features = self.features_from_audio(audio).movedim(-1, 1)
        latents, embeddings = self.net.encode(features)
        return latents, embeddings, {}

    def apply_skip_connections(self, embeddings):
        """The embeddings scaled by ``skip_weights``, or None without skip
        connections."""
        return self.net.apply_skip_connections(embeddings)

    def decode(self, latents, embeddings=None, transcribe=False):
        """Latents (B, D, T) -> coefficients (B, C, F, T), with the scaled
        NCHW embeddings of ``apply_skip_connections`` under skip
        connections."""
        latents = torch.as_tensor(latents).to(self.device)
        return self.net.decode(latents, embeddings, bool(transcribe))

    def forward(self, audio, consistency=False):
        """Training-mode forward (reference ``modules.py:338-393``) through
        the NCHW network with autograd.

        Returns (reconstruction, latents, transcription, transcription_rec,
        transcription_scr, losses): coefficients (B, C, F, T), latents
        (B, D, T); the last two coefficients are None without
        ``consistency``.
        """
        latents, embeddings, losses = self.encode(audio)
        embeddings = self.apply_skip_connections(embeddings)
        reconstruction = self.decode(latents, embeddings)
        transcription = self.decode(latents, embeddings, True)
        trn_rec = trn_scr = None
        if consistency:
            latents_t, embeddings_t = self.net.encode(transcription)
            embeddings_t = self.apply_skip_connections(embeddings_t)
            trn_rec = self.decode(latents_t, embeddings_t)
            trn_scr = self.decode(latents_t, embeddings_t, True)
        return (reconstruction, latents, transcription, trn_rec, trn_scr,
                losses)

    __call__ = forward

    @torch.no_grad()
    def inference(self, audio, transcribe=False):
        """Full-length single pass -> coefficients (B, C, F, T)."""
        audio = self.sliCQ.pad_to_block_length(self._to_f32(audio))
        return self._infer(audio, bool(transcribe))

    @torch.no_grad()
    def _chunked(self, audio, transcribe, share=None, reduce=None):
        """50%-overlap Hann overlap-add over chunks of one block.

        ``audio`` is padded to a block multiple and extended by half a block
        on each side. Chunks run ``chunk_group`` at a time (``_group``);
        chunk k (scaled by a symmetric ``np.hanning(M)`` window) adds into
        frames ``[k*M/2, k*M/2 + M)``, i.e. even chunks tile the frames
        contiguously and odd chunks at a half-window offset, as in the JAX
        package. The centering margins are trimmed at the end.

        ``share(n_chunks) -> (lo, hi)`` runs only chunks ``[lo, hi)`` into
        the zero accumulator of the whole signal, and ``reduce(acc)`` then
        combines the accumulators in place before the trim (sharded
        inference: ``parallel/inference.py``).
        """
        L = self.sliCQ.block_length
        M = self.sliCQ.max_window_length
        F = self.sliCQ.n_bins
        B = audio.shape[0]
        C = self.net.in_channels
        hop = L // 2
        n_chunks = (audio.shape[-1] - hop) // hop
        n_frames = self.sliCQ.get_expected_frames(audio.shape[-1])
        with span("tt.overlap_add"):
            acc = torch.zeros((B, C, F, n_frames + 2 * M),
                              dtype=torch.float32, device=self.device)
        lo, hi = (0, n_chunks) if share is None else share(n_chunks)
        G = max(1, min(self.chunk_group, hi - lo))
        for g0 in range(lo, hi, G):
            n = min(G, hi - g0)
            with span("tt.forward", n):
                out = self._group(audio, g0, n, transcribe)
            with span("tt.overlap_add"):
                out = out.reshape(n, B, C, F, M) * self._window
                for i in range(n):
                    start = (g0 + i) * (M // 2)
                    acc[..., start:start + M] += out[i]
        if reduce is not None:
            reduce(acc)
        return acc[..., M // 2: n_frames - M // 2]

    def _group(self, audio, g0, n, transcribe):
        """Coefficients (n·B, C, F, M) of chunks ``[g0, g0 + n)`` of
        ``audio``: on the card the replay of the group's CUDA graph, whose
        static input takes the chunks in one copy; on the CPU one ``_infer``
        of the stacked chunks."""
        L = self.sliCQ.block_length
        hop = L // 2
        B = audio.shape[0]
        if not _replays_graphs(self.device):
            chunks = torch.stack([
                audio[..., (g0 + i) * hop:(g0 + i) * hop + L]
                for i in range(n)])                          # (n, B, 1, L)
            return self._infer(chunks.reshape(n * B, 1, L), transcribe)
        group = self._graph(transcribe, n, B)
        group.input.view(n, B, 1, L).copy_(
            audio.unfold(-1, L, hop).narrow(-2, g0, n).movedim(-2, 0))
        with span("tt.graph.replay", n):
            group.graph.replay()
        return group.output

    def _graph(self, transcribe, n, B):
        """The CUDA graph of a chunk group of ``n`` chunks of a batch of
        ``B``, captured on a miss. The key holds what the captured work
        depends on, never the clip's length: ``fused`` changes only the
        compute dtype, so graphs of both modes stand side by side."""
        key = (transcribe, self._dtype(transcribe), n, B)
        group = self._graphs.get(key)
        if group is None:
            with span("tt.graph.capture"):
                group = self._graphs[key] = self._capture(transcribe, n * B)
        return group

    def _capture(self, transcribe, rows):
        """``_infer`` of a static (rows, 1, L) input captured as one CUDA
        graph, as PyTorch's recipe has it: the spec built first, one eager
        run on a side stream (plans, operands, FFT plans), then the capture
        into the model's graph pool. A failed capture raises."""
        spec = self._spec(transcribe)
        static_in = torch.zeros((rows, 1, self.sliCQ.block_length),
                                dtype=torch.float32, device=self.device)
        with torch.cuda.device(self.device):
            main = torch.cuda.current_stream()
            side = torch.cuda.Stream()
            side.wait_stream(main)
            with torch.cuda.stream(side):
                self._infer(static_in, transcribe)
            main.wait_stream(side)
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            # Thread-local: another thread (the Trainer's batch prefetch)
            # may issue CUDA work while this one captures.
            with torch.cuda.graph(graph, pool=self._graph_pool,
                                  capture_error_mode="thread_local"):
                static_out = self._infer(static_in, transcribe)
        return _GroupGraph(graph, static_in, static_out, spec)

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
        """Transcription coefficients (B, C, F, T) -> activations (B, F, T)
        in [0, 1]."""
        return torch.tanh(CQT.to_magnitude(coefficients))

    def _reconstruct(self, audio):
        """Pad -> chunked float32 inference -> inverse sliCQ -> normalise."""
        coefficients = self._chunked(self._pad_for_chunks(self._to_f32(audio)),
                                     False)
        with span("tt.synthesis"):
            audio = self.sliCQ.decode_raw(
                CQT.to_complex(coefficients)[:, None])
        with span("tt.normalize"):
            return CQT._normalize(audio)

    # ------------------------------------------------------------------ #
    # Streaming transcribe and reconstruct                               #
    # ------------------------------------------------------------------ #

    def _piece(self, segment):
        """Activations of one pre-extended piece (``piece_blocks*L + L``
        samples: the piece plus a half-block halo on each side)."""
        coefficients = self._chunked(self._to_f32(segment), True)
        with span("tt.activations"):
            return self.to_activations(coefficients)

    def _piece_recon(self, segment):
        """Unnormalised synthesis of one pre-extended piece.

        Synthesis is per block, so decoding pieces and concatenating equals
        decoding the whole coefficient tensor; only the global
        infinity-norm waits for the whole signal (``reconstruct``)."""
        coefficients = self._chunked(self._to_f32(segment), False)
        with span("tt.synthesis"):
            return self.sliCQ.decode_raw(
                CQT.to_complex(coefficients)[:, None])

    def _stream_pieces(self, audio_np, piece_fn, out_per_block):
        """Piece-by-piece execution of ``piece_fn`` over a host array.

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
            outs = [piece_fn(torch.from_numpy(np.ascontiguousarray(piece(i))))
                    for i in range(n_pieces)]
        else:
            outs = self._stream_cuda(piece, n_pieces, piece_fn)
        with span("tt.concat"):
            out = torch.cat(outs, dim=-1)
        return out[..., :n_blocks * out_per_block]

    def _stream_cuda(self, piece, n_pieces, piece_fn):
        """Upload piece i+1 (pinned buffer, side stream, non_blocking) while
        ``piece_fn`` computes piece i on the current stream."""
        main = torch.cuda.current_stream(self.device)
        copy = torch.cuda.Stream(self.device)
        with span("tt.stream.stage"):
            first = np.ascontiguousarray(piece(0))
            pinned = [torch.empty(first.shape,
                                  dtype=torch.from_numpy(first).dtype,
                                  pin_memory=True) for _ in range(2)]
        copied = [None, None]

        def upload(i, seg=None):
            slot = i % 2
            if copied[slot] is not None:
                with span("tt.stream.wait"):
                    copied[slot].synchronize()   # the slot's last copy is done
            with span("tt.stream.stage"):
                pinned[slot].numpy()[...] = piece(i) if seg is None else seg
                dev = torch.empty(pinned[slot].shape,
                                  dtype=pinned[slot].dtype, device=self.device)
                # The new block may have been freed by work still queued on
                # the main stream: order the copy after it.
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
                nxt = upload(i + 1)
            outs.append(piece_fn(dev))
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
        with span("tt.transcribe"):
            if not isinstance(audio, torch.Tensor):
                audio_np = _host_array(audio)
                if self._piece_route(audio_np):
                    return self._stream_pieces(audio_np, self._piece,
                                               self.sliCQ.max_window_length)
                audio = torch.from_numpy(np.ascontiguousarray(audio_np))
            audio = self._pad_for_chunks(self._to_f32(audio))
            coefficients = self._chunked(audio, True)
            with span("tt.activations"):
                return self.to_activations(coefficients)

    @torch.no_grad()
    def reconstruct(self, audio):
        """Audio (B, 1, N) -> resynthesised audio (B, 1, n_blocks * L),
        normalised by its infinity norm over the whole batch.

        Host inputs of two pieces or more stream piece by piece, as in
        ``transcribe``, and are normalised after the concatenation; tensors
        and shorter clips take one pass. int16 and float16 host inputs
        dequantize as in ``transcribe``. The one-channel families (``mag``,
        ``magdb``) have no phase to resynthesise and raise ``ValueError``.
        """
        if self.net.in_channels != 2:
            raise ValueError(
                f"reconstruct needs real and imaginary channels; the "
                f"{self.variant} model has {self.net.in_channels}")
        with span("tt.reconstruct"):
            if not isinstance(audio, torch.Tensor):
                audio_np = _host_array(audio)
                if self._piece_route(audio_np):
                    out = self._stream_pieces(audio_np, self._piece_recon,
                                              self.sliCQ.block_length)
                    with span("tt.normalize"):
                        return CQT._normalize(out)
                audio = torch.from_numpy(np.ascontiguousarray(audio_np))
            return self._reconstruct(audio)

    # ------------------------------------------------------------------ #
    # Persistence                                                        #
    # ------------------------------------------------------------------ #

    def save(self, path):
        """Write ``hparams.json`` (the JAX package's keys) and
        ``weights.pt`` (``torch.save`` of the reference-named state_dict,
        on the CPU) under the directory ``path``."""
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "hparams.json"), "w") as fh:
            json.dump(self.hparams, fh, indent=2)
        state_dict = {k: v.detach().cpu()
                      for k, v in self.net.state_dict().items()}
        torch.save(state_dict, os.path.join(path, WEIGHTS_FILE))
        return path

    @staticmethod
    def load(path, seed=0, device=None):
        """Rebuild a model of any family saved by :meth:`save`."""
        return load_model(path, seed=seed, overrides={"device": device})


class TimbreTrapFiLM(TimbreTrap):
    """FiLM-conditioned decoder switch."""

    variant = "film"


class TimbreTrapMag(TimbreTrap):
    """Magnitude-sliCQ (amplitude) family: one input and output channel."""

    variant = "mag"

    @staticmethod
    def _features_from_complex(coefficients):
        return CQT.to_magnitude(CQT.to_real(coefficients))[..., None]

    @staticmethod
    def to_activations(coefficients):
        return torch.tanh(coefficients.squeeze(-3))


class TimbreTrapMagDB(TimbreTrapMag):
    """Magnitude-sliCQ (rescaled decibels) family. The dB floor and the
    rescale are relative to each item's maximum (each chunk of a chunk
    group, as the JAX package's ``vmap``)."""

    variant = "magdb"

    @staticmethod
    def _features_from_complex(coefficients):
        magnitude = CQT.to_magnitude(CQT.to_real(coefficients))
        return CQT.to_decibels(magnitude)[..., None]

    @staticmethod
    def to_activations(coefficients):
        return coefficients.squeeze(-3)


_FAMILIES = {cls.variant: cls for cls in (TimbreTrap, TimbreTrapFiLM,
                                           TimbreTrapMag, TimbreTrapMagDB)}


def _load_weights(path):
    """The reference-named state_dict a checkpoint path names: a
    ``torch.save`` weights file, ``weights.pt`` in a :meth:`TimbreTrap.save`
    directory, or the parameters of a Trainer step checkpoint
    (``checkpoint.pt``). A directory with neither (the JAX package's orbax
    ``weights/``) raises."""
    def load(f):
        return torch.load(f, map_location="cpu", weights_only=True)

    if os.path.isfile(path):
        return load(path)
    if os.path.isfile(os.path.join(path, WEIGHTS_FILE)):
        return load(os.path.join(path, WEIGHTS_FILE))
    if os.path.isfile(os.path.join(path, CHECKPOINT_FILE)):
        return load(os.path.join(path, CHECKPOINT_FILE))["params"]
    if os.path.isdir(path):
        raise ValueError(
            f"{path} holds no {WEIGHTS_FILE} nor {CHECKPOINT_FILE}: a "
            "checkpoint of the JAX package (orbax) is not read here; convert "
            "its parameter tree with "
            "timbre_trap_tpu_torch.interop.state_dict_from_jax and load it "
            "with TimbreTrap.load_state_dict")
    raise FileNotFoundError(f"no checkpoint at {path}")


def load_model(path, seed=0, overrides=None, defaults=None):
    """Rebuild a model of any family from a checkpoint path.

    ``path`` is a :meth:`TimbreTrap.save` directory (``hparams.json`` +
    ``weights.pt``), a Trainer step checkpoint ``<run>/models/model-N``
    (whose run directory holds the ``hparams.json`` the Trainer writes), or
    a weights file whose hyperparameters sit beside it as
    ``<path>.hparams.json`` or in its directory's ``hparams.json``; a bare
    weights file takes its constructor arguments from ``defaults``.
    ``overrides`` take precedence over the stored hyperparameters (e.g.
    ``device``, ``fused``, ``transform_compat``, ``compat_tables``); a
    None value is ignored. A JAX package checkpoint raises ``ValueError``.
    """
    path = os.path.normpath(path)
    weights = _load_weights(path)
    hparams = None
    for candidate in (os.path.join(path, "hparams.json"),
                      path + ".hparams.json",
                      os.path.join(os.path.dirname(path), "hparams.json")):
        if os.path.isfile(candidate):
            with open(candidate) as fh:
                hparams = json.load(fh)
            break
    merged = dict(defaults or {}) if hparams is None else dict(hparams)
    merged.update({k: v for k, v in (overrides or {}).items()
                   if v is not None})
    if not merged:
        raise ValueError(
            f"{path} carries no hparams.json and no defaults were given")
    cls = _FAMILIES[merged.pop("variant", "base")]
    model = cls(seed=seed, **merged)
    model.load_state_dict(weights)
    return model
