"""Weights between the JAX package's flax parameter tree and the port.

The port's own copy of the layout rules of
``timbre_trap_tpu/interop/torch_import.py:export_torch_state_dict``:

* Conv2d weight           (kh, kw, in, out) -> (out, in, kh, kw)
* ConvTranspose2d weight  (kh, kw, in, out) -> (in, out, kh, kw)
* Linear (FiLM) weight    (in, out)         -> (out, in)
* ``skip_weights``        (5,), flat at the top of the tree

with the reference module names (convs followed by an ELU sit at index 0
of an ``nn.Sequential``: ``encoder.convin.0.weight``; the FiLM layer's
``film_layer.gamma.weight``), so ``state_dict_from_jax(params)`` loads into
``TimbreTrapNet`` of any family verbatim.
``hwio_params`` goes the other way, viewing the port's parameters in the
flax layout that the packed block builders take; the views keep autograd,
so a training spec built from them passes its gradients back to the
parameters (the inference path builds its specs under ``no_grad``).
"""

import numpy as np
import torch

__all__ = ["state_dict_from_jax", "hwio_params"]

# Parameter paths that are transposed convolutions in the reference.
_TRANSPOSE_CONV_PATHS = ("decoder.convin",)
# Dense layers (flax kernel (in, out), torch weight (out, in)).
_LINEAR_PATHS = ("film_layer.gamma", "film_layer.beta")
# Convs wrapped as nn.Sequential(conv, ELU) in the reference modules.
_SEQUENTIAL_PATHS = ("encoder.convin", "decoder.convin")
_SEQUENTIAL_LEAVES = ("conv1", "conv2", "sconv", "tconv")


def _flatten(tree, prefix=()):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict) or hasattr(value, "items"):
            out.update(_flatten(value, prefix + (key,)))
        else:
            out[prefix + (key,)] = value
    return out


def _is_tconv(clean):
    return clean in _TRANSPOSE_CONV_PATHS or clean.endswith(".tconv")


def _module_key(clean):
    if clean in _SEQUENTIAL_PATHS or clean.split(".")[-1] in _SEQUENTIAL_LEAVES:
        return clean + ".0"
    return clean


def state_dict_from_jax(params):
    """Flax param tree (numpy or array-like leaves) -> the port's state_dict
    of float32 CPU tensors."""
    state_dict = {}
    for path, value in sorted(_flatten(params).items()):
        value = np.asarray(value, dtype=np.float32)
        clean = ".".join(path[:-1])
        if path == ("skip_weights",):
            state_dict["skip_weights"] = torch.from_numpy(value.copy())
            continue
        if path[-1] == "kernel":
            if clean in _LINEAR_PATHS:
                value = value.T
            elif _is_tconv(clean):
                value = value.transpose(2, 3, 0, 1)
            elif value.ndim == 4:
                value = value.transpose(3, 2, 0, 1)
            leaf = "weight"
        elif path[-1] == "bias":
            leaf = "bias"
        else:
            raise ValueError(f"unexpected parameter {'.'.join(path)}")
        state_dict[f"{_module_key(clean)}.{leaf}"] = torch.from_numpy(
            np.array(value, copy=True, order="C"))
    return state_dict


def hwio_params(net):
    """The net's parameters as a nested dict in the flax layout (kernels
    HWIO), as views of the module's parameters (autograd included)."""
    tree = {}
    for name, value in net.named_parameters():
        parts = [p for p in name.split(".") if p != "0"]
        clean = ".".join(parts[:-1])
        if parts[-1] == "weight":
            leaf = "kernel"
            if clean in _LINEAR_PATHS:
                value = value.T
            elif _is_tconv(clean):
                value = value.permute(2, 3, 0, 1)
            else:
                value = value.permute(2, 3, 1, 0)
        else:
            leaf = parts[-1]
        node = tree
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree
