"""The Timbre-Trap autoencoder of the plain reference: an NCHW network of
``nn.Conv2d`` and ``nn.ConvTranspose2d`` under the published module names
(sony/timbre-trap ``timbre_trap/framework/modules.py``), the base family
(real and imaginary channels, indicator-row decoder switch), with or
without skip connections.

Each conv can round its input and its weight (and, on the way back, the
gradient it receives) through ``quant``: that is how the controls compute
the same network in a lower precision. With ``quant`` None the network is
plain float32 (the callers turn TF32 off).
"""

import torch
from torch import nn
from torch.nn import functional as fn

__all__ = ["channel_widths", "embedding_sizes", "TimbreTrapNet"]


def channel_widths(model_complexity):
    """Filter counts per level."""
    scale = 2 ** (model_complexity - 1)
    return tuple(round(c * scale) for c in (2, 4, 8, 16, 32))


def embedding_sizes(feature_size):
    """Frequency sizes after each of the 4 stride-2 stages, and the
    reversed padding parities the decoder restores."""
    sizes, paddings = [], []
    size = feature_size
    for _ in range(4):
        paddings.append(size % 2)
        size = size // 2 - 1
        sizes.append(size)
    paddings.reverse()
    return sizes, paddings


class _Conv(nn.Conv2d):
    quant = None

    def forward(self, x):
        if self.quant is None:
            return super().forward(x)
        q = self.quant
        return q(self._conv_forward(q(x), q(self.weight), self.bias))


class _ConvT(nn.ConvTranspose2d):
    quant = None

    def forward(self, x):
        if self.quant is None:
            return super().forward(x)
        q = self.quant
        return q(fn.conv_transpose2d(q(x), q(self.weight), self.bias,
                                     self.stride, self.padding,
                                     self.output_padding))


def _conv_elu(conv):
    return nn.Sequential(conv, nn.ELU())


class ResidualConv2dBlock(nn.Module):
    def __init__(self, channels, dilation):
        super().__init__()
        self.conv1 = _conv_elu(_Conv(channels, channels, 3, padding="same",
                                     dilation=dilation))
        self.conv2 = _conv_elu(_Conv(channels, channels, 1))

    def forward(self, x):
        return self.conv2(self.conv1(x)) + x


class EncoderBlock(nn.Module):
    def __init__(self, c_in, c_out):
        super().__init__()
        self.block1 = ResidualConv2dBlock(c_in, 1)
        self.block2 = ResidualConv2dBlock(c_in, 2)
        self.block3 = ResidualConv2dBlock(c_in, 3)
        self.sconv = _conv_elu(_Conv(c_in, c_out, (4, 1), stride=(2, 1)))

    def forward(self, x):
        return self.sconv(self.block3(self.block2(self.block1(x))))


class DecoderBlock(nn.Module):
    def __init__(self, c_in, c_out, padding):
        super().__init__()
        self.tconv = _conv_elu(_ConvT(c_in, c_out, (4, 1), stride=(2, 1),
                                      output_padding=(padding, 0)))
        self.block1 = ResidualConv2dBlock(c_out, 1)
        self.block2 = ResidualConv2dBlock(c_out, 2)
        self.block3 = ResidualConv2dBlock(c_out, 3)

    def forward(self, x):
        return self.block3(self.block2(self.block1(self.tconv(x))))


class Encoder(nn.Module):
    def __init__(self, feature_size, latent_size, model_complexity):
        super().__init__()
        w = channel_widths(model_complexity)
        sizes, _ = embedding_sizes(feature_size)
        self.convin = _conv_elu(_Conv(2, w[0], 3, padding="same"))
        for i in range(4):
            setattr(self, f"block{i + 1}", EncoderBlock(w[i], w[i + 1]))
        self.convlat = _Conv(w[4], latent_size, (sizes[-1], 1))

    def forward(self, x):
        x = self.convin(x)
        embeddings = [x]
        for i in range(4):
            x = getattr(self, f"block{i + 1}")(x)
            embeddings.append(x)
        return self.convlat(x).squeeze(-2), embeddings


class Decoder(nn.Module):
    def __init__(self, feature_size, latent_size, model_complexity):
        super().__init__()
        w = channel_widths(model_complexity)[::-1]
        sizes, paddings = embedding_sizes(feature_size)
        self.convin = _conv_elu(_ConvT(latent_size + 1, w[0],
                                       (sizes[-1], 1)))
        for i in range(4):
            setattr(self, f"block{i + 1}",
                    DecoderBlock(w[i], w[i + 1], paddings[i]))
        self.convout = _Conv(w[4], 2, 3, padding="same")

    def forward(self, latents, embeddings=None):
        y = self.convin(latents.unsqueeze(-2))
        if embeddings is not None:
            y = y + embeddings[-1]
        for i in range(4):
            y = getattr(self, f"block{i + 1}")(y)
            if embeddings is not None:
                y = y + embeddings[-(i + 2)]
        return self.convout(y)


class TimbreTrapNet(nn.Module):
    """Coefficients (B, 2, F, T) -> latents (B, D, T) -> coefficients."""

    def __init__(self, feature_size, latent_size, model_complexity,
                 skip_connections):
        super().__init__()
        self.skip_connections = bool(skip_connections)
        self.encoder = Encoder(feature_size, latent_size, model_complexity)
        self.decoder = Decoder(feature_size, latent_size, model_complexity)
        if self.skip_connections:
            self.skip_weights = nn.Parameter(torch.ones(5))

    def set_quant(self, quant):
        """Round every conv's operands through ``quant`` (None: float32)."""
        for m in self.modules():
            if isinstance(m, (_Conv, _ConvT)):
                m.quant = quant

    def encode(self, x):
        latents, embeddings = self.encoder(x)
        if self.skip_connections:
            embeddings = [self.skip_weights[i] * e
                          for i, e in enumerate(embeddings)]
        else:
            embeddings = None
        return latents, embeddings

    def decode(self, latents, embeddings, transcribe):
        indicator = torch.full_like(latents[:, :1], float(not transcribe))
        return self.decoder(torch.cat([latents, indicator], dim=1),
                            embeddings)
