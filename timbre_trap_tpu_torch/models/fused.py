"""Packed-layout forward of the network: inference routes and training.

Counterpart of ``timbre_trap_tpu/models/fused.py`` for every family
(``base``, ``film``, ``mag``, ``magdb``) with and without skip
connections, for inference and for training.

Inference without skips: the whole forward (4 encoder levels with convin
fused into the first, the latent bridge, 4 decoder levels with convout
fused into the last) is ONE item chain ``especs + [bridge] + dspecs``, run
by ``ops/fused_level.fused_level_apply``: on the card one ``banded_conv``
kernel launch per conv stage (60 at the flagship geometry), for both
float32 and bfloat16. The JAX package keeps the single chain to bf16 only
because of TPU compile time, which has no counterpart here. The bridge is
two dense items: convlat (reference kernel ``(E, 1)``) and the decoder's
ConvTranspose expansion with the decoder switch folded in (the indicator
row into the bias; FiLM into column scales and the bias).

Inference with skips (``SkipRoute``): the skip adds land on level
boundaries, so convin and convout run as one-conv levels of their own and
every level is its own chain (58 launches at the flagship geometry); the
latent bridge is two einsums between them, computed in float64 and
rounded once to float32 (float32-accurate whatever TF32 flags are set);
each skip add happens in float32 and goes back to the chain's dtype, as in
the JAX package. The variant's output activation (ReLU for ``mag``,
sigmoid for ``magdb``) follows the chain in float32 on both routes.

Training (``packed_train_forward``): one differentiable call per level,
the latent matmuls and the decoder switch (the indicator row, or FiLM's
gamma and beta as affine maps of the one-hot condition, differentiable)
in plain PyTorch between them, as the JAX package computes them outside
any Pallas kernel; with skips, the 5 encoder level outputs scaled by
``skip_weights`` and added in float32 after the expansion and after each
decoder level. The level backends keep JAX's names: ``"pallas"`` and
``"pallas_bf16"`` mean the hand-written CUDA kernels here (K1 forward, K3
backward; float32, or bfloat16 storage with float32 accumulation);
``"packed"`` is autograd through the plain twin ``packed_level_apply`` in
float32, checkpointed per level as the JAX ``"packed"`` step
rematerializes.

Both routes run the net's kept level specs (``kept_level_specs``): the
convs' geometry, their K1 plans and the band store's tables are built once
per net and shapes, and each step (each inference chain) refreshes the
band operands from the weights in place by one gather, whose backward is a
fixed-order segment sum (``ops/band_store.py``).
"""

import weakref

import torch
from torch.utils.checkpoint import checkpoint

from ..interop import _flax_tree, hwio_params
from ..ops.band_store import BandStore
from ..ops.fused_level import (LevelSpec, conv2d_level_spec,
                               decoder_level_spec, encoder_level_spec,
                               fuse_level_specs, fused_level_apply,
                               fused_level_train, packed_level_apply)
from ..ops.packed_conv import build_dense_blocks, pack_nhwc
from ..utils.profiling import span
from .modules import embedding_sizes

__all__ = ["packed_to_nchw", "forward_spec", "fused_forward", "SkipRoute",
           "TRAIN_BACKENDS", "level_specs", "kept_level_specs",
           "encode_packed", "decode_packed", "packed_train_forward"]

# Level backend -> storage dtype of its level chains.
TRAIN_BACKENDS = {"pallas": torch.float32, "pallas_bf16": torch.bfloat16,
                  "packed": torch.float32}


def packed_to_nchw(y, feature_size, channels):
    """(B, F*C, T) f-major -> (B, C, F, T)."""
    b, r, t = y.shape
    return y.reshape(b, feature_size, channels, t).permute(0, 2, 1, 3)


def _latent_matmuls(params):
    """convlat as a dense map over packed rows, and the decoder's convin
    expansion as a dense map back to them (f-major rows)."""
    clat = params["encoder"]["convlat"]
    kh, kw, c_in, latent = clat["kernel"].shape
    w_lat = clat["kernel"].reshape(kh * c_in, latent)
    b_lat = clat["bias"]

    cin = params["decoder"]["convin"]
    khd, kwd, d_in, c0 = cin["kernel"].shape
    # ConvTranspose (E, 1) on a 1-row input: y[f, co] = sum_i x[i] K[f, 0, i, co]
    w_dec = cin["kernel"][:, 0].permute(0, 2, 1).reshape(khd * c0, d_in)
    b_dec = cin["bias"].repeat(khd)
    return w_lat, b_lat, w_dec, b_dec


def level_specs(params, net, with_adjoints=False):
    """(encoder specs, decoder specs). Without skips, 4 + 4: convin fused
    into encoder level 1, convout into decoder level 4. With skips, 5 + 5:
    convin is the first encoder spec (whose outputs are the 5
    embeddings), convout the last decoder spec. ``with_adjoints``
    attaches the adjoint blocks the training backward needs."""
    sizes, paddings = embedding_sizes(net.feature_size)
    enc, dec = params["encoder"], params["decoder"]
    skip = net.skip_connections
    especs, f = [], net.feature_size
    if skip:
        especs.append(conv2d_level_spec(enc["convin"], f, True,
                                        with_adjoints))
    for i in range(4):
        especs.append(encoder_level_spec(
            enc[f"block{i + 1}"], f,
            convin_params=enc["convin"] if i == 0 and not skip else None,
            with_adjoints=with_adjoints))
        f = sizes[i]
    dspecs, f = [], sizes[-1]
    for i in range(4):
        dspecs.append(decoder_level_spec(
            dec[f"block{i + 1}"], f, output_padding=paddings[i],
            convout_params=dec["convout"] if i == 3 and not skip else None,
            with_adjoints=with_adjoints))
        f = dspecs[-1].items[0][1].f_out
    if skip:
        dspecs.append(conv2d_level_spec(dec["convout"], f, False,
                                        with_adjoints))
    return especs, dspecs


# net -> {geometry key: (encoder specs, decoder specs)}: the kept specs,
# dropped with their net.
_KEPT = weakref.WeakKeyDictionary()


def kept_level_specs(net, with_adjoints=False):
    """``level_specs(hwio_params(net), net, with_adjoints)``, kept: the
    geometry (the specs' convs, their K1 plans, the band store's index
    tables and buffers, ``ops/band_store.py``) is built once per net and
    key, the key being what the geometry depends on (the parameters' names
    and shapes, the feature size, skips, variant, device and dtype); every
    call refreshes the band operands from the net's current weights in
    place (``BandStore.refresh``, differentiable). A miss is one
    ``tt.prepare`` span."""
    named = list(net.named_parameters())
    first = named[0][1]
    key = (bool(with_adjoints), first.device, first.dtype, net.feature_size,
           net.skip_connections, net.variant,
           tuple((n, tuple(p.shape)) for n, p in named))
    kept = _KEPT.setdefault(net, {})
    if key not in kept:
        with span("tt.prepare"):
            kept[key] = _build_kept(net, named, with_adjoints, first.device)
    especs, dspecs = kept[key]
    especs[0].store.refresh([p for _, p in named])
    return especs, dspecs


def _build_kept(net, named, with_adjoints, device):
    """The level specs of ``net`` built once on the CPU from
    position-valued parameters (``1 + i`` for element i of the
    parameters in order), taken over by a ``BandStore`` on ``device``."""
    positions, start = [], 1
    for name, p in named:
        positions.append((name, torch.arange(
            start, start + p.numel(), dtype=torch.float32).view(p.shape)))
        start += p.numel()
    especs, dspecs = level_specs(_flax_tree(positions), net, with_adjoints)
    BandStore(especs + dspecs, [p.shape for _, p in named], device)
    return especs, dspecs


def _film(params, transcribe):
    """FiLM's (gamma, beta) for one branch: affine maps of the one-hot
    condition ``[transcribe, not transcribe]``, i.e. the kernel row of the
    hot entry plus the bias (differentiable; exact, no matmul)."""
    film = params["film_layer"]
    k = 1 - int(bool(transcribe))       # the condition's hot entry
    return (film["gamma"]["kernel"][k] + film["gamma"]["bias"],
            film["beta"]["kernel"][k] + film["beta"]["bias"])


def _switch(params, net, transcribe):
    """The decoder switch of one branch as an affine map of the latents,
    folded into the expansion: ``(w_cond, b_cond)`` with
    ``W @ switch(x) + b == w_cond @ x + b_cond``. The indicator row
    v = float(not transcribe) contributes ``v * W[:, -1]`` to the bias;
    FiLM, ``gamma * x + beta`` (``_film``), gives column scales
    ``W * gamma`` and bias ``b + W @ beta`` (exact in real math; the
    product is taken in float64 and rounded once)."""
    _, _, w_dec, b_dec = _latent_matmuls(params)
    if net.variant != "film":
        v = float(not transcribe)
        return w_dec[:, :-1], b_dec + v * w_dec[:, -1]
    gamma, beta = _film(params, transcribe)
    w_beta = (w_dec.double() @ beta.double()).float()
    return w_dec * gamma[None, :], b_dec + w_beta


def _latent_bridge_spec(params, net, transcribe):
    """convlat + the switch-conditioned decoder expansion as two dense
    items."""
    w_lat, b_lat, _, _ = _latent_matmuls(params)
    cb_lat = build_dense_blocks(w_lat.T, b_lat)
    cb_exp = build_dense_blocks(*_switch(params, net, transcribe))
    return LevelSpec([("conv", cb_lat, False), ("conv", cb_exp, True)],
                     cb_lat.r_in)


def _scale_skips(skip_weights, embeddings):
    """The learnable per-level skip weights times the embeddings, float32
    (reference ``modules.py:61-66``)."""
    return [skip_weights[i] * e.to(torch.float32)
            for i, e in enumerate(embeddings)]


def _add_skip(y, skip):
    """A skip add in float32, back to the chain's dtype."""
    return (y.to(torch.float32) + skip).to(y.dtype)


class SkipRoute:
    """The inference forward of a network with skip connections: 5
    encoder specs, the two bridge maps in float64 (convlat, and the
    switch-conditioned expansion), 5 decoder specs, and the 5 skip
    weights."""

    def __init__(self, params, net, transcribe):
        self.especs, self.dspecs = kept_level_specs(net)
        w_lat, b_lat, _, _ = _latent_matmuls(params)
        w_cond, b_cond = _switch(params, net, transcribe)
        self.w_lat, self.b_lat = w_lat.double(), b_lat.double()
        self.w_cond, self.b_cond = w_cond.double(), b_cond.double()
        self.skip_weights = params["skip_weights"].float()

    def apply(self, x, dtype, level_apply):
        """Packed (B, F*C_in, T) at ``dtype`` -> (B, F*C_out, T) float32,
        each level through ``level_apply``."""
        embeddings = []
        for spec in self.especs:
            x = level_apply(x, spec, dtype)
            embeddings.append(x)
        with span("tt.skip.bridge"):
            latents = (torch.einsum("rl,brt->blt", self.w_lat, x.double())
                       + self.b_lat[None, :, None])
            y = (torch.einsum("ri,bit->brt", self.w_cond, latents)
                 + self.b_cond[None, :, None]).float()
            y = torch.nn.functional.elu(y).to(dtype)
        with span("tt.skip.add"):
            skips = _scale_skips(self.skip_weights, embeddings)
            y = _add_skip(y, skips[4])
        for i, spec in enumerate(self.dspecs[:4]):
            y = level_apply(y, spec, dtype)
            with span("tt.skip.add"):
                y = _add_skip(y, skips[3 - i])
        return level_apply(y, self.dspecs[4], dtype).float()


@torch.no_grad()
def forward_spec(net, transcribe):
    """The whole inference forward of ``net`` for one decoder branch
    (blocks on the net's device): one chain (a ``LevelSpec``) without skip
    connections, a ``SkipRoute`` with them; its levels are the net's kept
    specs (``kept_level_specs``), refreshed from the current weights."""
    with span("tt.spec_build"):
        params = hwio_params(net)
        if net.skip_connections:
            return SkipRoute(params, net, transcribe)
        especs, dspecs = kept_level_specs(net)
        bridge = _latent_bridge_spec(params, net, transcribe)
        return fuse_level_specs(especs + [bridge] + dspecs)


def _output_activation(net, y):
    if net.variant == "mag":
        return torch.relu(y)
    if net.variant == "magdb":
        return torch.sigmoid(y)
    return y


@torch.no_grad()
def fused_forward(net, features, transcribe, dtype=torch.float32, spec=None,
                  plain=False):
    """Features (B, F, T, C_in) NHWC -> coefficients (B, C_out, F, T) NCHW,
    float32. ``dtype`` is the chain's storage type; ``spec`` a prebuilt
    ``forward_spec(net, transcribe)``; ``plain`` runs every level through
    the kernels' plain twin (``packed_level_apply``) on any device."""
    if spec is None:
        spec = forward_spec(net, transcribe)
    level_apply = packed_level_apply if plain else fused_level_apply
    with span("tt.pack"):
        x = pack_nhwc(features).to(dtype)
    if isinstance(spec, SkipRoute):
        y = spec.apply(x, dtype, level_apply)
    else:
        y = level_apply(x, spec, dtype)
    with span("tt.unpack"):
        y = _output_activation(net, y.to(torch.float32))
        return packed_to_nchw(y, net.feature_size, net.in_channels)


# --------------------------------------------------------------------- #
# Training                                                               #
# --------------------------------------------------------------------- #

def _apply_level(x, spec, backend):
    if backend == "packed":
        return checkpoint(packed_level_apply, x, spec, torch.float32,
                          use_reentrant=False)
    return fused_level_train(x, spec, TRAIN_BACKENDS[backend])


def _condition_latents(params, net, latents, transcribe):
    """The decoder switch (reference ``modules.py:119-147`` / ``:780-839``):
    FiLM's ``gamma * x + beta``, or an indicator row
    ``float(not transcribe)`` below the latents."""
    if net.variant == "film":
        gamma, beta = _film(params, transcribe)
        return latents * gamma[None, :, None] + beta[None, :, None]
    indicator = torch.full_like(latents[:, :1], float(not transcribe))
    return torch.cat([latents, indicator], dim=1)


def encode_packed(params, x, specs, backend="pallas_bf16",
                  with_embeddings=False):
    """Packed features (B, F*C_in, T) -> latents (B, D, T), float32, through
    the encoder level ``specs`` (``level_specs(params, ...)[0]``). With
    ``with_embeddings`` (skip connections: 5 specs, convin on its own)
    returns ``(latents, embeddings)``, the embeddings being the 5 level
    outputs at the chain's dtype."""
    embeddings = []
    for spec in specs:
        x = _apply_level(x, spec, backend)
        embeddings.append(x)
    w_lat, b_lat, _, _ = _latent_matmuls(params)
    latents = (torch.einsum("rl,brt->blt", w_lat, x.to(torch.float32))
               + b_lat[None, :, None])
    return (latents, embeddings) if with_embeddings else latents


def decode_packed(params, net, latents, transcribe, specs,
                  backend="pallas_bf16", skips=None):
    """Latents (B, D, T) -> packed coefficients (B, F*C_out, T), float32,
    through the decoder switch, the dense expansion, the decoder level
    ``specs`` (``level_specs(params, ...)[1]``) and the variant's output
    activation. ``skips``: the 5 scaled encoder embeddings
    (``_scale_skips``), added in float32 after the expansion and after
    each of the 4 decoder levels, before the standalone convout."""
    _, _, w_dec, b_dec = _latent_matmuls(params)
    latents = _condition_latents(params, net, latents, transcribe)
    y = torch.einsum("ri,bit->brt", w_dec, latents) + b_dec[None, :, None]
    y = torch.nn.functional.elu(y).to(TRAIN_BACKENDS[backend])
    if skips is not None:
        y = _add_skip(y, skips[4])
    for i, spec in enumerate(specs):
        y = _apply_level(y, spec, backend)
        if skips is not None and i < 4:
            y = _add_skip(y, skips[3 - i])
    return _output_activation(net, y.to(torch.float32))


def packed_train_forward(params, net, features, consistency,
                         backend="pallas_bf16"):
    """Training-mode forward on packed tensors, every family, with or
    without skip connections.

    Returns (reconstruction, latents, transcription, transcription_rec,
    transcription_scr), coefficients PACKED (B, F*C, T) float32 — the
    quantities of the reference's training forward in the padding-free
    layout (the JAX ``packed_train_forward`` with ``batch_pairs=False``).
    ``params`` is ``hwio_params(net)``. The level specs are the net's kept
    specs (``kept_level_specs``), refreshed once a call from its weights,
    with autograd, before they serve both encodes and all four decodes:
    the kernel backends' operands at the storage dtype, or the dense
    blocks that ``"packed"`` reads.
    """
    if backend not in TRAIN_BACKENDS:
        raise ValueError(f"backend must be one of {tuple(TRAIN_BACKENDS)}, "
                         f"not {backend!r}")
    skip = net.skip_connections
    with span("tt.spec_build"):
        especs, dspecs = kept_level_specs(net, backend != "packed")
        if backend == "packed":
            especs[0].store.dense_views()
        else:
            especs[0].store.prepare(TRAIN_BACKENDS[backend])

    def encode(x):
        if not skip:
            return encode_packed(params, x, especs, backend), None
        latents, embeddings = encode_packed(params, x, especs, backend, True)
        return latents, _scale_skips(params["skip_weights"], embeddings)

    def decode_pair(latents, skips):
        return tuple(decode_packed(params, net, latents, transcribe, dspecs,
                                   backend, skips)
                     for transcribe in (False, True))

    latents, skips = encode(pack_nhwc(features))
    reconstruction, transcription = decode_pair(latents, skips)
    if consistency:
        trn_rec, trn_scr = decode_pair(*encode(transcription))
    else:
        trn_rec, trn_scr = None, None
    return reconstruction, latents, transcription, trn_rec, trn_scr
