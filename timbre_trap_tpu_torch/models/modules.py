"""PyTorch (NCHW) network modules of the Timbre-Trap autoencoder.

Counterpart of ``timbre_trap_tpu/models/modules.py`` for every family
(``base``, ``film``, ``mag``, ``magdb``), with or without skip
connections. The modules hold their weights under the reference names
(``encoder.convin.0.weight``, ``encoder.block1.sconv.0.bias``,
``decoder.convin.0.weight``, ``film_layer.gamma.weight``,
``skip_weights``, ...), convs with an activation being wrapped in
``nn.Sequential(conv, ELU)``, so a reference state_dict, or the output of
``export_torch_state_dict(params, like=net.state_dict().keys())``, loads
verbatim. ``forward`` is a plain CPU check of the same function: inference
runs through the packed banded chain (``models/fused.py``).

``remat`` (the JAX package's ``nn.remat`` cells) recomputes in the
backward pass what the forward would keep: the encoder's convin + ELU,
each of the four encoder and four decoder levels, and the decoder's
convout each run under ``torch.utils.checkpoint``; the decoder's skip
adds stay outside those cells. It changes no result and no state_dict
name.
"""

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

__all__ = ["embedding_sizes", "default_latent_size", "ResidualConv2dBlock",
           "EncoderBlock", "DecoderBlock", "Encoder", "Decoder", "FiLM",
           "TimbreTrapNet", "VARIANTS", "init_weights"]

# The model families: input/output channels, decoder switch, output.
VARIANTS = ("base", "film", "mag", "magdb")


def _channel_widths(model_complexity):
    """Filter counts per level."""
    scale = 2 ** (model_complexity - 1)
    return tuple(round(c * scale) for c in (2, 4, 8, 16, 32))


def default_latent_size(model_complexity):
    return 32 * 2 ** (model_complexity - 1)


def embedding_sizes(feature_size):
    """Frequency sizes after each of the 4 stride-2 stages, plus the
    reversed padding-parity chain the decoder needs."""
    sizes, paddings = [], []
    size = feature_size
    for _ in range(4):
        paddings.append(size % 2)
        size = size // 2 - 1
        sizes.append(size)
    paddings.reverse()
    return sizes, paddings


def _conv_elu(conv):
    return nn.Sequential(conv, nn.ELU())


def _cell(remat, module, x):
    """``module(x)``, recomputed in the backward pass under ``remat`` (and
    only where autograd records)."""
    if remat and torch.is_grad_enabled():
        return checkpoint(module, x, use_reentrant=False)
    return module(x)


class ResidualConv2dBlock(nn.Module):
    """3x3 dilated conv + ELU -> 1x1 conv + ELU -> residual add."""

    def __init__(self, channels, dilation=1):
        super().__init__()
        self.conv1 = _conv_elu(nn.Conv2d(channels, channels, 3, padding="same",
                                         dilation=dilation))
        self.conv2 = _conv_elu(nn.Conv2d(channels, channels, 1))

    def forward(self, x):
        return self.conv2(self.conv1(x)) + x


class EncoderBlock(nn.Module):
    """Three residual blocks (dilation 1, 2, 3), then a frequency-strided
    VALID conv, kernel (2s, 1), stride (s, 1)."""

    def __init__(self, in_channels, out_channels, stride=2):
        super().__init__()
        self.block1 = ResidualConv2dBlock(in_channels, 1)
        self.block2 = ResidualConv2dBlock(in_channels, 2)
        self.block3 = ResidualConv2dBlock(in_channels, 3)
        self.sconv = _conv_elu(nn.Conv2d(in_channels, out_channels,
                                         (2 * stride, 1), stride=(stride, 1)))

    def forward(self, x):
        return self.sconv(self.block3(self.block2(self.block1(x))))


class DecoderBlock(nn.Module):
    """Frequency-transposed conv, then three residual blocks."""

    def __init__(self, in_channels, out_channels, stride=2, padding=0):
        super().__init__()
        self.tconv = _conv_elu(nn.ConvTranspose2d(
            in_channels, out_channels, (2 * stride, 1), stride=(stride, 1),
            output_padding=(padding, 0)))
        self.block1 = ResidualConv2dBlock(out_channels, 1)
        self.block2 = ResidualConv2dBlock(out_channels, 2)
        self.block3 = ResidualConv2dBlock(out_channels, 3)

    def forward(self, x):
        return self.block3(self.block2(self.block1(self.tconv(x))))


class Encoder(nn.Module):
    """Coefficients (B, C_in, F, T) -> latents (B, D, T) and the 5
    embeddings (after convin + ELU, then after each level)."""

    def __init__(self, feature_size, latent_size, model_complexity,
                 in_channels=2, remat=False):
        super().__init__()
        self.remat = bool(remat)
        channels = _channel_widths(model_complexity)
        sizes, _ = embedding_sizes(feature_size)
        self.convin = _conv_elu(nn.Conv2d(in_channels, channels[0], 3,
                                          padding="same"))
        for i in range(4):
            setattr(self, f"block{i + 1}",
                    EncoderBlock(channels[i], channels[i + 1]))
        self.convlat = nn.Conv2d(channels[4], latent_size, (sizes[-1], 1))

    def forward(self, x):
        x = _cell(self.remat, self.convin, x)
        embeddings = [x]
        for i in range(4):
            x = _cell(self.remat, getattr(self, f"block{i + 1}"), x)
            embeddings.append(x)
        return self.convlat(x).squeeze(-2), embeddings


class Decoder(nn.Module):
    """Conditioned latents (B, D_in, T) -> coefficients (B, C, F, T):
    ``D_in`` is the latent size plus the switch row, or the latent size
    alone under FiLM (``switch_row=False``)."""

    def __init__(self, feature_size, latent_size, model_complexity,
                 out_channels=2, switch_row=True, remat=False):
        super().__init__()
        self.remat = bool(remat)
        channels = _channel_widths(model_complexity)[::-1]
        sizes, paddings = embedding_sizes(feature_size)
        self.convin = _conv_elu(nn.ConvTranspose2d(latent_size
                                                   + int(switch_row),
                                                   channels[0],
                                                   (sizes[-1], 1)))
        for i in range(4):
            setattr(self, f"block{i + 1}",
                    DecoderBlock(channels[i], channels[i + 1],
                                 padding=paddings[i]))
        self.convout = nn.Conv2d(channels[4], out_channels, 3, padding="same")

    def forward(self, latents, embeddings=None):
        """``embeddings``: the 5 scaled encoder embeddings (skip
        connections), added after convin and after each level."""
        y = self.convin(latents.unsqueeze(-2))
        if embeddings is not None:
            y = y + embeddings[-1]
        for i in range(4):
            y = _cell(self.remat, getattr(self, f"block{i + 1}"), y)
            if embeddings is not None:
                y = y + embeddings[-(i + 2)]
        return _cell(self.remat, self.convout, y)


class FiLM(nn.Module):
    """Feature-wise linear modulation of latents (B, D, T) by a one-hot
    condition (n_conditions,)."""

    def __init__(self, embedding_size, n_conditions=2):
        super().__init__()
        self.gamma = nn.Linear(n_conditions, embedding_size)
        self.beta = nn.Linear(n_conditions, embedding_size)

    def forward(self, x, condition):
        return (x * self.gamma(condition)[:, None]
                + self.beta(condition)[:, None])


class TimbreTrapNet(nn.Module):
    """The autoencoder of one family (``VARIANTS``):

    * ``base``  -- real/imag in and out, indicator-row decoder switch;
    * ``film``  -- real/imag in and out, FiLM decoder switch;
    * ``mag``   -- one magnitude channel in and out, ReLU output;
    * ``magdb`` -- one rescaled-dB channel in and out, sigmoid output.

    ``skip_connections`` adds each encoder embedding, scaled by the
    learnable ``skip_weights`` (ones at init), to the decoder at the same
    resolution. ``remat`` recomputes the encoder's and decoder's cells in
    the backward pass (see the module docstring).
    """

    def __init__(self, feature_size, latent_size=None, model_complexity=1,
                 variant="base", skip_connections=False, remat=False):
        super().__init__()
        if variant not in VARIANTS:
            raise ValueError(f"unknown variant {variant!r}")
        self.variant = variant
        self.skip_connections = bool(skip_connections)
        self.feature_size = int(feature_size)
        self.model_complexity = int(model_complexity)
        self.latent_size = int(latent_size
                               or default_latent_size(model_complexity))
        self.encoder = Encoder(feature_size, self.latent_size,
                               model_complexity, self.in_channels, remat)
        self.decoder = Decoder(feature_size, self.latent_size,
                               model_complexity, self.in_channels,
                               switch_row=variant != "film", remat=remat)
        if self.skip_connections:
            self.skip_weights = nn.Parameter(torch.ones(5))
        if variant == "film":
            self.film_layer = FiLM(self.latent_size)

    @property
    def in_channels(self):
        return 1 if self.variant in ("mag", "magdb") else 2

    def encode(self, coefficients):
        """(B, C_in, F, T) -> latents (B, D, T) and the 5 embeddings."""
        return self.encoder(coefficients)

    def apply_skip_connections(self, embeddings):
        """The embeddings scaled by ``skip_weights``, or None without skip
        connections."""
        if not self.skip_connections:
            return None
        return [self.skip_weights[i] * e for i, e in enumerate(embeddings)]

    def decode(self, latents, embeddings=None, transcribe=False):
        """Latents (B, D, T) -> coefficients (B, C, F, T). The switch is
        the one-hot FiLM condition ``[transcribe, not transcribe]``, or an
        indicator row ``float(not transcribe)``."""
        if self.variant == "film":
            condition = torch.tensor([float(transcribe), float(not transcribe)],
                                     dtype=latents.dtype, device=latents.device)
            latents = self.film_layer(latents, condition)
        else:
            indicator = torch.full_like(latents[:, :1], float(not transcribe))
            latents = torch.cat([latents, indicator], dim=1)
        coefficients = self.decoder(latents, embeddings)
        if self.variant == "mag":
            coefficients = torch.relu(coefficients)
        elif self.variant == "magdb":
            coefficients = torch.sigmoid(coefficients)
        return coefficients

    def forward(self, coefficients, transcribe=False):
        latents, embeddings = self.encode(coefficients)
        return self.decode(latents, self.apply_skip_connections(embeddings),
                           transcribe)


@torch.no_grad()
def init_weights(module, generator):
    """Seeded random init: every conv and FiLM weight ~ N(0, 1/fan_in)
    (fan_in counts the input channels times the kernel's taps), biases
    zero; ``skip_weights`` keep their ones."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = m.weight
            c_in = w.shape[0] if isinstance(m, nn.ConvTranspose2d) else w.shape[1]
            fan_in = c_in * math.prod(w.shape[2:])
            w.copy_(torch.randn(w.shape, generator=generator)
                    / math.sqrt(fan_in))
            m.bias.zero_()
    return module
