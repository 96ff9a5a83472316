"""Process-group initialization for multi-device runs (the port's
counterpart of ``timbre_trap_tpu/parallel/distributed.py``).

The JAX package drives N devices from one process (SPMD) and calls
``jax.distributed.initialize`` only to join hosts. PyTorch's idiom is one
process per device: a ``torch.distributed`` process group of N ranks, each
on ``cuda:{LOCAL_RANK}``, started by ``torchrun`` or by the caller (then
each on card ``process_id`` modulo the machine's cards). Call
:func:`initialize` once at program start in every rank; the group is NCCL
on the card and gloo on the CPU.
"""

import datetime
import logging
import os

import torch
import torch.distributed as dist

__all__ = ["initialize", "is_multi_host", "local_batch_slice",
           "local_device", "process_count", "process_index"]

logger = logging.getLogger(__name__)

# How long a rank waits for the others: to join, and in a collective (the
# Trainer's ranks wait in one while rank 0 runs a validation sweep).
DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)
# What ``torchrun`` sets in every rank's environment.
_TORCHRUN_ENV = ("WORLD_SIZE", "RANK", "MASTER_ADDR")


def local_device(process_id=None):
    """This rank's device where a card is present, else the CPU: the card
    ``LOCAL_RANK`` (which ``torchrun`` sets), or without it card
    ``process_id % torch.cuda.device_count()`` (ranks started by the
    caller on one machine each take their own card), or card 0."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    if "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if process_id is not None:
        return torch.device("cuda",
                            int(process_id) % torch.cuda.device_count())
    return torch.device("cuda", 0)


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               timeout=DEFAULT_TIMEOUT, backend=None):
    """Join this process to the group of ranks; returns True on success.

    ``coordinator_address`` ("host:port" of rank 0), ``num_processes`` (the
    world size) and ``process_id`` (this rank) form the group over
    ``tcp://``; with none of them, ``torchrun``'s environment
    (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``) forms it over ``env://``.
    The backend is NCCL on the card (after ``torch.cuda.set_device`` to
    :func:`local_device` of ``process_id``) and gloo on the CPU, unless
    ``backend`` names one (gloo is the only way to put two ranks on one
    card).

    A group that is already up returns True. An explicitly requested
    group (or one ``torchrun`` announced) that fails to form raises, and
    the error is logged: a misconfigured cluster never quietly degrades to
    one device. Autodetection that finds no cluster logs it and returns
    False.
    """
    if dist.is_initialized():
        return True
    explicit = (coordinator_address is not None or num_processes is not None
                or process_id is not None)
    if explicit:
        if None in (coordinator_address, num_processes, process_id):
            logger.error("initialize needs coordinator_address, "
                         "num_processes and process_id together (got %s, "
                         "%s, %s)", coordinator_address, num_processes,
                         process_id)
            raise ValueError("initialize: give coordinator_address, "
                             "num_processes and process_id together")
        kwargs = dict(init_method=f"tcp://{coordinator_address}",
                      world_size=int(num_processes), rank=int(process_id))
    elif all(k in os.environ for k in _TORCHRUN_ENV):
        kwargs = dict(init_method="env://")
    else:
        logger.info("torch.distributed: no cluster in the environment (%s "
                    "unset); continuing in one process",
                    ", ".join(k for k in _TORCHRUN_ENV
                              if k not in os.environ))
        return False
    device = local_device(process_id)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl":
        kwargs["device_id"] = device   # binds the communicator to the card
    try:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(backend, timeout=timeout, **kwargs)
    except (RuntimeError, ValueError) as exc:
        logger.error("torch.distributed.init_process_group failed: %s "
                     "(backend=%s %s)", exc, backend, kwargs)
        raise
    logger.info("torch.distributed: rank %d of %d on %s (%s)",
                dist.get_rank(), dist.get_world_size(), device, backend)
    return True


def process_count():
    """The world size: 1 without a process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index():
    """This rank: 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_multi_host():
    """Whether more than one rank takes part."""
    return process_count() > 1


def local_batch_slice(global_batch_size):
    """(start, stop) rows of the global batch this rank should load."""
    per_rank = global_batch_size // process_count()
    start = process_index() * per_rank
    return start, start + per_rank
