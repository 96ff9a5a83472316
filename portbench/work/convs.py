"""The work of the published architecture, counted from its shapes.

Every conv of the reference network (``reference/net.py``) at a given
number of frames: its operations (2 per multiply-add) and the bytes it
needs, each input, weight, bias and residual byte read once and each
output byte written once, whatever a kernel reads again. The counts do
not depend on how the program lays out or packs its work, so a change of
the program's layout leaves the yardstick where it was.

* A ``Conv2d`` counts ``2 * Cin * Cout * kh * kw * F_out * T`` operations
  (padding taps included, as the published formula has them). A
  ``ConvTranspose2d`` counts per input position,
  ``2 * Cin * Cout * kh * kw * F_in * T``: that is the multiply-adds it
  has; counting per output row would double them for a stride of 2.
* Bytes: the input, the weight (at the chain's element size) and the bias
  (float32); the residual added after the second conv of a residual block;
  the output.
* The backward of a conv (training): the gradient of its input (dX),
  skipped where the input needs none (the first conv of an encode whose
  input is the data), and of its weight (dW), each as many operations as
  the forward. Bytes: the output's gradient, the output again where an
  ELU follows (its derivative), the input (for dW), the weight, the
  residual's gradient at the first conv of a residual block, and the
  written input gradient, weight gradient and bias gradient (float32).

The bridge is ``encoder.convlat`` and ``decoder.convin``, the two dense
maps over the whole frequency axis.
"""

from dataclasses import dataclass

__all__ = ["Conv", "network_convs", "forward_work", "backward_work",
           "BRIDGE"]

BRIDGE = ("encoder.convlat", "decoder.convin")


@dataclass(frozen=True)
class Conv:
    name: str
    c_in: int
    c_out: int
    kh: int
    kw: int
    f_in: int
    f_out: int
    transposed: bool = False
    elu: bool = True
    residual: bool = False      # the block's input is added to the output
    block_input: bool = False   # first conv of a residual block


def _widths(model_complexity):
    scale = 2 ** (model_complexity - 1)
    return tuple(round(c * scale) for c in (2, 4, 8, 16, 32))


def _sizes(feature_size):
    sizes, paddings, size = [], [], feature_size
    for _ in range(4):
        paddings.append(size % 2)
        size = size // 2 - 1
        sizes.append(size)
    return sizes, paddings[::-1]


def _residual_blocks(prefix, c, f):
    convs = []
    for j in (1, 2, 3):
        convs.append(Conv(f"{prefix}.block{j}.conv1", c, c, 3, 3, f, f,
                          block_input=True))
        convs.append(Conv(f"{prefix}.block{j}.conv2", c, c, 1, 1, f, f,
                          residual=True))
    return convs


def network_convs(model):
    """The convs of one encode and one decode, in the order they run."""
    f = model["n_octaves"] * model["bins_per_octave"]
    w = _widths(model["model_complexity"])
    latent = model["latent_size"]
    sizes, paddings = _sizes(f)
    convs = [Conv("encoder.convin", 2, w[0], 3, 3, f, f)]
    f_in = f
    for i in range(4):
        convs += _residual_blocks(f"encoder.block{i + 1}", w[i], f_in)
        convs.append(Conv(f"encoder.block{i + 1}.sconv", w[i], w[i + 1],
                          4, 1, f_in, sizes[i]))
        f_in = sizes[i]
    convs.append(Conv("encoder.convlat", w[4], latent, sizes[-1], 1,
                      sizes[-1], 1, elu=False))
    wd = w[::-1]
    convs.append(Conv("decoder.convin", latent + 1, wd[0], sizes[-1], 1, 1,
                      sizes[-1], transposed=True))
    f_in = sizes[-1]
    for i in range(4):
        f_out = (f_in - 1) * 2 + 4 + paddings[i]
        convs.append(Conv(f"decoder.block{i + 1}.tconv", wd[i], wd[i + 1],
                          4, 1, f_in, f_out, transposed=True))
        convs += _residual_blocks(f"decoder.block{i + 1}", wd[i + 1], f_out)
        f_in = f_out
    convs.append(Conv("decoder.convout", wd[4], 2, 3, 3, f_in, f_in,
                      elu=False))
    return convs


def _ops(c, frames):
    rows = c.f_in if c.transposed else c.f_out
    return 2 * c.c_in * c.c_out * c.kh * c.kw * rows * frames


def forward_work(convs, frames, size):
    """(operations, bytes) of ``convs`` on ``frames`` frames, activations
    and weights of ``size`` bytes an element."""
    ops = bytes_ = 0
    for c in convs:
        x = c.c_in * c.f_in * frames
        y = c.c_out * c.f_out * frames
        ops += _ops(c, frames)
        bytes_ += (x + y + (y if c.residual else 0)) * size
        bytes_ += c.c_in * c.c_out * c.kh * c.kw * size + c.c_out * 4
    return ops, bytes_


def backward_work(convs, frames, size, first_input_grad=True):
    """(operations, bytes) of the backward of ``convs``; the first conv's
    input gradient is left out unless ``first_input_grad``."""
    ops = bytes_ = 0
    for i, c in enumerate(convs):
        x = c.c_in * c.f_in * frames
        y = c.c_out * c.f_out * frames
        weights = c.c_in * c.c_out * c.kh * c.kw
        dx = first_input_grad or i > 0
        ops += _ops(c, frames) * (2 if dx else 1)
        bytes_ += (y + (y if c.elu else 0) + x) * size + weights * size
        bytes_ += (x + (x if c.block_input else 0)) * size if dx else 0
        bytes_ += (weights + c.c_out) * 4
    return ops, bytes_
