"""Packed-layout forward of the network: inference chain and training.

Counterpart of ``timbre_trap_tpu/models/fused.py`` for the base model
without skip connections (FiLM and skips are not ported; ``TimbreTrap``
raises ``NotImplementedError`` for skips).

Inference: the whole forward (4 encoder levels with convin fused into the
first, the latent bridge, 4 decoder levels with convout fused into the
last) is ONE item chain ``especs + [bridge] + dspecs``, run by
``ops/fused_level.fused_level_apply``: on the card one ``banded_conv``
kernel launch per conv stage (60 at the flagship geometry), for both
float32 and bfloat16. The JAX package keeps the single chain to bf16 only
because of TPU compile time, which has no counterpart here. The bridge is
two dense items: convlat (reference kernel ``(E, 1)``) and the decoder's
ConvTranspose expansion, with the decoder switch (a constant indicator row
``float(not transcribe)``) folded into the expansion's bias.

Training (``packed_train_forward``): one differentiable call per level,
the latent matmuls in plain ``torch.einsum`` between them, as the JAX
package computes them outside any Pallas kernel. The level backends keep
JAX's names: ``"pallas"`` and ``"pallas_bf16"`` mean the hand-written CUDA
kernels here (K1 forward, K3 backward; float32, or bfloat16 storage with
float32 accumulation); ``"packed"`` is autograd through the plain twin
``packed_level_apply`` in float32, checkpointed per level as the JAX
``"packed"`` step rematerializes.
"""

import torch
from torch.utils.checkpoint import checkpoint

from ..interop import hwio_params
from ..ops.fused_level import (LevelSpec, decoder_level_spec,
                               encoder_level_spec, fuse_level_specs,
                               fused_level_apply, fused_level_train,
                               packed_level_apply)
from ..ops.packed_conv import build_dense_blocks, pack_nhwc
from .modules import embedding_sizes

__all__ = ["packed_to_nchw", "forward_spec", "fused_forward",
           "TRAIN_BACKENDS", "level_specs", "encode_packed", "decode_packed",
           "packed_train_forward"]

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
    """(encoder specs, decoder specs) of the no-skip path: convin fused into
    encoder level 1, convout into decoder level 4. ``with_adjoints``
    attaches the adjoint blocks the training backward needs."""
    sizes, paddings = embedding_sizes(net.feature_size)
    enc, dec = params["encoder"], params["decoder"]
    especs, f = [], net.feature_size
    for i in range(4):
        especs.append(encoder_level_spec(
            enc[f"block{i + 1}"], f,
            convin_params=enc["convin"] if i == 0 else None,
            with_adjoints=with_adjoints))
        f = sizes[i]
    dspecs, f = [], sizes[-1]
    for i in range(4):
        dspecs.append(decoder_level_spec(
            dec[f"block{i + 1}"], f, output_padding=paddings[i],
            convout_params=dec["convout"] if i == 3 else None,
            with_adjoints=with_adjoints))
        f = dspecs[-1].items[0][1].f_out
    return especs, dspecs


def _latent_bridge_spec(params, transcribe):
    """convlat + the switch-conditioned decoder expansion as two dense items.

    The indicator row v = float(not transcribe) is constant per branch, so
    it contributes ``v * W[:, -1]`` to the expansion's bias.
    """
    w_lat, b_lat, w_dec, b_dec = _latent_matmuls(params)
    cb_lat = build_dense_blocks(w_lat.T, b_lat)
    v = float(not transcribe)
    cb_exp = build_dense_blocks(w_dec[:, :-1], b_dec + v * w_dec[:, -1])
    return LevelSpec([("conv", cb_lat, False), ("conv", cb_exp, True)],
                     cb_lat.r_in)


@torch.no_grad()
def forward_spec(net, transcribe):
    """The whole forward of ``net`` as one chain (blocks on the net's device)."""
    params = hwio_params(net)
    especs, dspecs = level_specs(params, net)
    bridge = _latent_bridge_spec(params, transcribe)
    return fuse_level_specs(especs + [bridge] + dspecs)


@torch.no_grad()
def fused_forward(net, features, transcribe, dtype=torch.float32, spec=None):
    """Features (B, F, T, C_in) NHWC -> coefficients (B, C_out, F, T) NCHW,
    float32. ``dtype`` is the chain's storage type; ``spec`` a prebuilt
    ``forward_spec(net, transcribe)``."""
    if spec is None:
        spec = forward_spec(net, transcribe)
    x = pack_nhwc(features).to(dtype)
    y = fused_level_apply(x, spec, dtype=dtype).to(torch.float32)
    return packed_to_nchw(y, net.feature_size, net.in_channels)


# --------------------------------------------------------------------- #
# Training                                                               #
# --------------------------------------------------------------------- #

def _apply_level(x, spec, backend):
    if backend == "packed":
        return checkpoint(packed_level_apply, x, spec, torch.float32,
                          use_reentrant=False)
    return fused_level_train(x, spec, TRAIN_BACKENDS[backend])


def _condition_latents(latents, transcribe):
    """The decoder switch: an indicator row ``float(not transcribe)``."""
    indicator = torch.full_like(latents[:, :1], float(not transcribe))
    return torch.cat([latents, indicator], dim=1)


def encode_packed(params, x, specs, backend="pallas_bf16"):
    """Packed features (B, F*C_in, T) -> latents (B, D, T), float32, through
    the encoder level ``specs`` (``level_specs(params, ...)[0]``)."""
    for spec in specs:
        x = _apply_level(x, spec, backend)
    w_lat, b_lat, _, _ = _latent_matmuls(params)
    return (torch.einsum("rl,brt->blt", w_lat, x.to(torch.float32))
            + b_lat[None, :, None])


def decode_packed(params, latents, transcribe, specs, backend="pallas_bf16"):
    """Latents (B, D, T) -> packed coefficients (B, F*C_out, T), float32,
    through the decoder switch, the dense expansion and the decoder level
    ``specs`` (``level_specs(params, ...)[1]``)."""
    _, _, w_dec, b_dec = _latent_matmuls(params)
    latents = _condition_latents(latents, transcribe)
    y = torch.einsum("ri,bit->brt", w_dec, latents) + b_dec[None, :, None]
    y = torch.nn.functional.elu(y).to(TRAIN_BACKENDS[backend])
    for spec in specs:
        y = _apply_level(y, spec, backend)
    return y.to(torch.float32)


def packed_train_forward(params, net, features, consistency,
                         backend="pallas_bf16"):
    """Training-mode forward on packed tensors.

    Returns (reconstruction, latents, transcription, transcription_rec,
    transcription_scr), coefficients PACKED (B, F*C, T) float32 — the
    quantities of the reference's training forward in the padding-free
    layout (the JAX ``packed_train_forward`` with ``batch_pairs=False``).
    ``params`` is ``hwio_params(net)``: the level specs are built once from
    it, with autograd, and serve both encodes and all four decodes.
    """
    if backend not in TRAIN_BACKENDS:
        raise ValueError(f"backend must be one of {tuple(TRAIN_BACKENDS)}, "
                         f"not {backend!r}")
    especs, dspecs = level_specs(params, net, backend != "packed")

    def decode_pair(latents):
        return (decode_packed(params, latents, False, dspecs, backend),
                decode_packed(params, latents, True, dspecs, backend))

    latents = encode_packed(params, pack_nhwc(features), especs, backend)
    reconstruction, transcription = decode_pair(latents)
    if consistency:
        latents_t = encode_packed(params, transcription, especs, backend)
        trn_rec, trn_scr = decode_pair(latents_t)
    else:
        trn_rec, trn_scr = None, None
    return reconstruction, latents, transcription, trn_rec, trn_scr
