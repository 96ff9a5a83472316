"""Weights between reference-named torch state_dicts, the flax-layout
parameter tree and the port's modules.

The port's copy of ``timbre_trap_tpu/interop/torch_import.py``
(``import_torch_state_dict``, ``export_torch_state_dict``,
``load_torch_checkpoint``), with one table of layout rules (``_axes``):

* Conv2d weight           (out, in, kh, kw) <-> (kh, kw, in, out)
* ConvTranspose2d weight  (in, out, kh, kw) <-> (kh, kw, in, out)
* Linear (FiLM) weight    (out, in)         <-> (in, out)
* ``skip_weights``        (5,), flat at the top of the tree

The reference modules wrap each conv followed by an ELU as index 0 of an
``nn.Sequential`` (``encoder.convin.0.weight``); the importer drops those
``.0`` segments, the exporter restores them from ``like`` and
``state_dict_from_jax`` from the port's own module names (``_module_key``),
so its result loads into ``TimbreTrapNet`` of any family verbatim.
``hwio_params`` views the port's parameters in the flax layout that the
packed block builders take; the views keep autograd, so a training spec
built from them passes its gradients back to the parameters (the inference
path builds its specs under ``no_grad``).
"""

import numpy as np
import torch

__all__ = ["import_torch_state_dict", "export_torch_state_dict",
           "load_torch_checkpoint", "state_dict_from_jax", "hwio_params"]

# Parameter paths that are transposed convolutions in the reference.
_TRANSPOSE_CONV_PATHS = ("decoder.convin",)
# Dense layers (flax kernel (in, out), torch weight (out, in)).
_LINEAR_PATHS = ("film_layer.gamma", "film_layer.beta")
# Convs wrapped as nn.Sequential(conv, ELU) in the reference modules.
_SEQUENTIAL_PATHS = ("encoder.convin", "decoder.convin")
_SEQUENTIAL_LEAVES = ("conv1", "conv2", "sconv", "tconv")


def _axes(clean, ndim):
    """The permutation from the torch layout of the weight at module path
    ``clean`` to its flax layout (None: the same layout)."""
    if clean in _LINEAR_PATHS:
        return (1, 0)
    if clean in _TRANSPOSE_CONV_PATHS or clean.endswith(".tconv"):
        return (2, 3, 0, 1)
    if ndim == 4:
        return (2, 3, 1, 0)
    return None


def _permute(value, axes):
    if axes is None:
        return value
    if isinstance(value, torch.Tensor):
        return value.permute(*axes)
    return value.transpose(axes)


def _to_numpy(value):
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().numpy()
    return np.asarray(value)


def _flatten(tree, prefix=()):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict) or hasattr(value, "items"):
            out.update(_flatten(value, prefix + (key,)))
        else:
            out[prefix + (key,)] = value
    return out


def _flax_tree(named):
    """(reference name, torch-layout value) pairs -> the flax-layout tree:
    ``.0`` segments dropped, ``weight`` -> ``kernel`` in the flax layout,
    ``skip_weights`` at the top; other leaves are skipped."""
    params = {}
    for name, value in named:
        parts = [p for p in name.split(".") if p != "0"]
        if parts == ["skip_weights"]:
            params["skip_weights"] = value
            continue
        if parts[-1] not in ("weight", "bias"):
            continue
        leaf = "bias"
        if parts[-1] == "weight":
            leaf = "kernel"
            value = _permute(value, _axes(".".join(parts[:-1]), value.ndim))
        node = params
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[leaf] = value
    return params


def import_torch_state_dict(state_dict, reference_params=None):
    """Convert a reference torch ``state_dict`` into a flax-layout parameter
    tree of numpy arrays.

    If ``reference_params`` (the port net's ``hwio_params``, as tensors or
    numpy, or a JAX package tree) is given, shapes are validated against it
    and missing or extra keys raise ``ValueError``.
    """
    params = _flax_tree((name, _to_numpy(value))
                        for name, value in state_dict.items())
    if reference_params is not None:
        _validate(params, reference_params)
    return params


def _validate(params, reference_params):
    got = _flatten(params)
    want = _flatten(reference_params)
    missing = set(want) - set(got)
    extra = set(got) - set(want)
    if missing or extra:
        raise ValueError(f"parameter mismatch: missing={sorted(missing)} "
                         f"extra={sorted(extra)}")
    for key in want:
        if tuple(np.shape(got[key])) != tuple(want[key].shape):
            raise ValueError(
                f"shape mismatch at {'.'.join(key)}: "
                f"{np.shape(got[key])} vs {tuple(want[key].shape)}")


def export_torch_state_dict(params, like=None):
    """Inverse of :func:`import_torch_state_dict`: a flax-layout parameter
    tree -> a reference-named torch-layout ``state_dict`` of numpy arrays.
    ``import_torch_state_dict(export_torch_state_dict(p)) == p``.

    ``like`` -- optional iterable of the target torch module's state_dict
    keys (e.g. ``net.state_dict().keys()``): exported keys are renamed to
    the matching original (the ``.0`` segments of ``nn.Sequential``), so the
    dict loads into that module verbatim.
    """
    state_dict = {}
    for path, value in sorted(_flatten(params).items()):
        value = _to_numpy(value)
        if path == ("skip_weights",):
            state_dict["skip_weights"] = value
            continue
        clean = ".".join(path[:-1])
        if path[-1] == "kernel":
            axes = _axes(clean, value.ndim)
            if axes is not None:
                value = value.transpose(np.argsort(axes))
            state_dict[f"{clean}.weight"] = value
        else:
            state_dict[f"{clean}.{path[-1]}"] = value

    if like is not None:
        rename = {".".join(p for p in key.split(".") if p != "0"): key
                  for key in like}
        unknown = set(state_dict) - set(rename)
        if unknown:
            raise ValueError(f"no target key for {sorted(unknown)}")
        state_dict = {rename[k]: v for k, v in state_dict.items()}
    return state_dict


def load_torch_checkpoint(path):
    """Load a ``.pt`` file and return its state_dict (numpy values).

    Takes both ``torch.save(net.state_dict())`` and whole-module saves
    (``torch.save(net)``, as the reference trainer writes them); the latter
    needs the pickled class to be importable. The file is unpickled: load
    only checkpoints from a trusted source.
    """
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()
    return {k: _to_numpy(v) for k, v in obj.items()}


def _module_key(clean):
    if clean in _SEQUENTIAL_PATHS or clean.split(".")[-1] in _SEQUENTIAL_LEAVES:
        return clean + ".0"
    return clean


def state_dict_from_jax(params):
    """Flax-layout parameter tree (numpy or array-like leaves) -> the port's
    state_dict of float32 CPU tensors, under the port's module names."""
    state_dict = {}
    for key, value in export_torch_state_dict(params).items():
        clean, _, leaf = key.rpartition(".")
        if key != "skip_weights":
            if leaf not in ("weight", "bias"):
                raise ValueError(f"unexpected parameter {key}")
            key = f"{_module_key(clean)}.{leaf}"
        state_dict[key] = torch.from_numpy(
            np.array(value, dtype=np.float32, copy=True, order="C"))
    return state_dict


def hwio_params(net):
    """The net's parameters as a nested dict in the flax layout (kernels
    HWIO), as views of the module's parameters (autograd included)."""
    return _flax_tree(net.named_parameters())
