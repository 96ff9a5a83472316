"""Training checkpoints: parameters, optimizer state and step counter.

Counterpart of ``timbre_trap_tpu/train/checkpoint.py`` with ``torch.save``
in place of orbax. A checkpoint is a directory holding one file,
``checkpoint.pt``: the reference-named state_dict of ``model.net``
(``params``), the step, and the optimizer state (``opt_state``: count,
mu, nu, and the gradient accumulator under ``grad_accum_steps > 1``) when
one is given. Tensors are saved on the CPU; resume is exact (the step
after ``save_checkpoint`` -> ``load_checkpoint`` is the step the run
would have taken).
"""

import os

import torch

from ..models.timbre_trap import CHECKPOINT_FILE, WEIGHTS_FILE

__all__ = ["CHECKPOINT_FILE", "save_checkpoint", "load_checkpoint",
           "latest_checkpoint", "load_params"]


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    return tree


def _state_dict(model_or_state_dict):
    """A ``TimbreTrap`` (its ``net``), an ``nn.Module`` or a state_dict."""
    obj = getattr(model_or_state_dict, "net", model_or_state_dict)
    if isinstance(obj, torch.nn.Module):
        return obj.state_dict()
    return dict(obj)


def save_checkpoint(path, model_or_state_dict, opt_state=None, step=0):
    """Save a training state into the directory ``path`` (created, or its
    checkpoint replaced): written under a temporary name, then renamed, so
    a reader finds the old checkpoint or the new one, never half of one.
    Returns the absolute path."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    state = {"params": _to_cpu(_state_dict(model_or_state_dict)),
             "step": int(step)}
    if opt_state is not None:
        state["opt_state"] = _to_cpu(opt_state)
    target = os.path.join(path, CHECKPOINT_FILE)
    tmp = f"{target}.tmp-{os.getpid()}"
    torch.save(state, tmp)
    os.replace(tmp, target)
    return path


def load_checkpoint(path, map_location=None):
    """Restore a training state: ``{"params", "step", "opt_state"?}``,
    tensors on ``map_location`` (default the CPU)."""
    return torch.load(os.path.join(os.path.abspath(path), CHECKPOINT_FILE),
                      map_location=map_location or "cpu", weights_only=True)


def latest_checkpoint(directory, prefix="model-"):
    """Path of the highest-step checkpoint under ``directory`` (or None)."""
    if not os.path.isdir(directory):
        return None
    best, best_step = None, -1
    for name in os.listdir(directory):
        if name.startswith(prefix):
            try:
                step = int(name[len(prefix):])
            except ValueError:
                continue
            if step > best_step:
                best, best_step = os.path.join(directory, name), step
    return best


def load_params(path, map_location=None):
    """The reference-named state_dict of either layout: a trainer
    checkpoint directory (``checkpoint.pt``) or a ``TimbreTrap.save``
    directory (``hparams.json`` + ``weights.pt``)."""
    weights = os.path.join(path, WEIGHTS_FILE)
    if os.path.isfile(weights):
        return torch.load(weights, map_location=map_location or "cpu",
                          weights_only=True)
    return load_checkpoint(path, map_location)["params"]
