"""The device mesh and the rows of a batch each rank holds (the port's
counterpart of ``timbre_trap_tpu/parallel/mesh.py``).

The JAX package builds a 1-D ``data`` mesh over the devices of one
process and lets XLA shard batches and emit the gradient all-reduce. In
the port each device is a rank of a ``torch.distributed`` process group
(one process per device, see ``parallel/distributed.py``): the mesh is
PyTorch's own ``DeviceMesh`` over that group, every rank holds its rows of
the global batch on its own device, and the train step all-reduces the
gradients itself (``train/step.py:shard_train_step``).
"""

from dataclasses import dataclass
from typing import List

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from . import distributed

__all__ = ["make_mesh", "replicated", "batch_sharded", "shard_batch",
           "shard_global_batch", "plan_local_rows", "LocalBatchPlan",
           "DATA_AXIS", "torchrun_hint"]

DATA_AXIS = "data"


def torchrun_hint(n_devices):
    """How to start ``n_devices`` ranks of the train CLI."""
    return (f"torchrun --nproc-per-node {n_devices} -m "
            f"timbre_trap_tpu_torch.experiments.train --n-devices "
            f"{n_devices} --distributed ...")


def make_mesh(n_devices=None, axis_name=DATA_AXIS):
    """A 1-D ``DeviceMesh`` named ``axis_name`` over the process group's
    ``n_devices`` ranks (default: all of them), on this rank's kind of
    device (the card, else the CPU).

    The group must be up (``parallel.initialize``) with a world size of
    exactly ``n_devices``: each rank drives one device, so N devices are N
    processes, started as ``torchrun --nproc-per-node N ...``.
    """
    world = distributed.process_count()
    n = world if n_devices is None else int(n_devices)
    if not dist.is_initialized() or world != n:
        have = (f"a process group of {world} ranks" if dist.is_initialized()
                else "no process group")
        raise ValueError(
            f"a mesh of {n} devices needs {n} processes, one per device, "
            f"joined by parallel.initialize(); this process has {have}. "
            f"Start them as: {torchrun_hint(n)}")
    return init_device_mesh(distributed.local_device().type, (n,),
                            mesh_dim_names=(axis_name,))


def replicated(mesh):
    """Placement of a tensor that every rank of ``mesh`` holds whole."""
    return (Replicate(),)


def batch_sharded(mesh, axis_name=DATA_AXIS):
    """Placement of a tensor whose leading (batch) axis is split over the
    ranks of ``mesh``'s ``axis_name`` dimension (each holds its own
    contiguous rows) and held whole along any other."""
    if axis_name not in mesh.mesh_dim_names:
        raise ValueError(f"mesh has no axis {axis_name!r} (it has "
                         f"{mesh.mesh_dim_names})")
    return tuple(Shard(0) if name == axis_name else Replicate()
                 for name in mesh.mesh_dim_names)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _mesh_device(mesh):
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_batch(mesh, batch, axis_name=DATA_AXIS):
    """This rank's rows of every array of the global ``batch`` (a tensor,
    numpy array, or a tuple, list or dict of them), on its device: rows
    ``[r * B / n, (r + 1) * B / n)`` of rank r of n. Leading dims must
    divide n."""
    n, r = mesh.size(), mesh.get_local_rank(axis_name)
    device = _mesh_device(mesh)

    def one(x):
        x = torch.as_tensor(x)
        if x.shape[0] % n:
            raise ValueError(f"global batch {x.shape[0]} not divisible by "
                             f"{n} ranks")
        per = x.shape[0] // n
        return x[r * per:(r + 1) * per].to(device)

    return _tree_map(one, batch)


def shard_global_batch(mesh, batch, axis_name=DATA_AXIS, local=False):
    """This rank's part of a global batch, on its device.

    ``local=False``: every rank passes the same global batch and keeps its
    rows (:func:`shard_batch`). ``local=True``: each rank passes only its
    own rows (from loaders configured with :func:`plan_local_rows`), which
    move to its device as they are.
    """
    if not local:
        return shard_batch(mesh, batch, axis_name)
    device = _mesh_device(mesh)
    return _tree_map(lambda x: torch.as_tensor(x).to(device), batch)


@dataclass(frozen=True)
class LocalBatchPlan:
    """Which rows of each per-batch loader draw THIS rank materializes.

    The global training batch is ``[mpe rows | audio-only rows]`` (the
    train step's loss composition), with ground truth for the MPE rows.
    A rank of the port computes its losses on its own device, so it must
    hold the audio of every ground-truth row it holds: rank p of n loads
    MPE rows ``[p*m/n, (p+1)*m/n)`` and audio-only rows ``[p*a/n,
    (p+1)*a/n)``, and composes ``[its MPE rows | its audio-only rows]``
    with the MPE rows' ground truth. So ``mpe_audio_pos`` and ``gt_pos``
    select the same items (all of ``mpe_rows``). The JAX package's plan
    cuts the audio rows ``[p*B/n, (p+1)*B/n)`` of the whole batch instead,
    which may put an MPE item's audio on one device and its raster on
    another; XLA's global arrays allow that. With every rank holding m/n
    MPE and a/n audio-only rows, the mean of the ranks' losses is the
    global batch's (every loss is a mean over rows), so the averaged
    gradient is the global batch's gradient as in JAX.
    """

    mpe_rows: List[int]        # MPE-loader batch positions to load
    mpe_audio_pos: List[int]   # positions WITHIN mpe_rows feeding the audio
    gt_pos: List[int]          # positions WITHIN mpe_rows feeding the GT
    audio_rows: List[int]      # audio-only-loader batch positions to load


def plan_local_rows(mpe_batch_size, audio_batch_size=0, n_processes=None,
                    process_index=None):
    """This rank's :class:`LocalBatchPlan` for one global batch.

    ``None`` for one process (no slicing needed). Both the total batch and
    the MPE batch must divide the number of processes, as in the JAX
    package (hence the audio-only batch does too).
    """
    n = distributed.process_count() if n_processes is None \
        else int(n_processes)
    if n == 1:
        return None
    p = distributed.process_index() if process_index is None \
        else int(process_index)
    m, a = int(mpe_batch_size), int(audio_batch_size)
    total = m + a
    if total % n or m % n:
        raise ValueError(
            f"batch sizes (total={total}, mpe={m}) must divide {n} "
            f"processes")
    mpe_rows = list(range(p * m // n, (p + 1) * m // n))
    positions = list(range(len(mpe_rows)))
    return LocalBatchPlan(
        mpe_rows=mpe_rows, mpe_audio_pos=positions, gt_pos=positions,
        audio_rows=list(range(p * a // n, (p + 1) * a // n)))

