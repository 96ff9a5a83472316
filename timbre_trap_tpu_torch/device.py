"""Where the port's entry points run.

``None`` means the card. The CPU runs only when the caller asks for it
(``device="cpu"``), and then the kernels' plain twins run; a missing CUDA
device raises instead of falling back to the CPU.

``ieee_convs`` scopes float32 cuDNN convolutions to IEEE arithmetic: the
port's float32 paths are float32-accurate, and cuDNN's default rounds
float32 operands to TF32.
"""

import contextlib

import torch

__all__ = ["resolve_device", "ieee_convs"]


def resolve_device(device):
    """``None`` means the card; a CUDA device that is not there raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


@contextlib.contextmanager
def ieee_convs(device):
    """Inside the block, float32 cuDNN convolutions on a CUDA ``device`` run
    without TF32; torch's flags are as they were after it. Nothing changes
    on the CPU."""
    if torch.device(device).type != "cuda":
        yield
        return
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        yield
