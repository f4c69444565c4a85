"""Multi-process execution: the port's counterpart of
``ligero_tpu/parallel/multihost.py`` on ``torch.distributed``.

One process a device (a rank), all of them running the same program on the
same inputs; ``initialize`` joins them into one process group and
``global_row_mesh`` gives the 1-D mesh over every rank's device, on which
``make_sharded_prover_core`` and ``ShardedBackend`` (hence ``LigeroCircuit``
``prove`` / ``verify``) run with collectives between the ranks
(``parallel/collectives.py``).  Outputs the protocol reads are replicated,
so every rank makes the same proof bytes, those of one device:

    from ligero_tpu_torch.parallel.multihost import (global_row_mesh,
                                                     initialize)
    initialize()                      # once a process, from the variables
    mesh = global_row_mesh()          # this rank's device: cuda:LOCAL_RANK
    lig = LigeroCircuit(circuit, outputs,
                        backend=ShardedBackend(field, mesh))

The variables are the JAX package's: ``LIGERO_NUM_PROCESSES``,
``LIGERO_PROCESS_ID`` and ``LIGERO_COORDINATOR`` (``host:port``, default
``localhost:9876``), read where the arguments are not given.

The backend is chosen, never fallen back to: NCCL where the ranks' devices
are CUDA devices, gloo on the CPU.  ``backend="gloo"`` with the ranks on
CUDA devices runs only when asked for by name: NCCL refuses two ranks on
one GPU, so that is how two ranks share one card (the collectives then
stage every tensor through host memory, ``Collectives.staged_bytes``).
"""

from __future__ import annotations

import os

import torch

from ..engine.backend import resolve_device
from .collectives import Collectives
from .sharded_backend import ProcessRowMesh, RowMesh

DEFAULT_COORDINATOR = "localhost:9876"


def rank_device(device=None, process_id: int | None = None) -> torch.device:
    """This rank's device: ``device`` where given (``"cpu"``, or a CUDA
    device such as ``"cuda:0"`` for every rank of a one-card host), else
    ``cuda:{LOCAL_RANK mod the visible cards}`` (``LOCAL_RANK``, else the
    process id).  Without a card and without ``device="cpu"`` it raises,
    as the port's other entry points do."""
    if device is not None:
        return resolve_device(device)
    if not torch.cuda.is_available():
        return resolve_device(None)          # raises: no card
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        local = (torch.distributed.get_rank()
                 if torch.distributed.is_initialized()
                 else process_id if process_id is not None
                 else int(os.environ.get("LIGERO_PROCESS_ID", "0")))
    return resolve_device(f"cuda:{int(local) % torch.cuda.device_count()}")


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None, device=None) -> None:
    """Join this process to the process group, from the arguments or the
    variables.  Does nothing for one process (the JAX function's no-op),
    unless ``backend`` is named: then a group of one on that backend (the
    path of a multi-card host, run on one card).

    ``backend`` None takes NCCL where this rank's device (``device``, see
    :func:`rank_device`; without a card, the CPU) is a CUDA device, gloo
    on the CPU.  ``"gloo"`` with a CUDA device stages the collectives
    through host memory; ``"nccl"`` with the CPU raises."""
    num = (num_processes if num_processes is not None
           else int(os.environ.get("LIGERO_NUM_PROCESSES", "1")))
    if num <= 1 and backend is None:
        return
    pid = (process_id if process_id is not None
           else int(os.environ.get("LIGERO_PROCESS_ID", "0")))
    dev = (rank_device(device, pid) if device is not None
           or torch.cuda.is_available() else torch.device("cpu"))
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"initialize: backend {backend!r} is not nccl or "
                         "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"initialize: NCCL needs a CUDA device, not {dev}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    address = (coordinator_address
               or os.environ.get("LIGERO_COORDINATOR", DEFAULT_COORDINATOR))
    torch.distributed.init_process_group(
        backend, init_method=f"tcp://{address}", world_size=num, rank=pid)


def global_row_mesh(device=None) -> RowMesh:
    """The 1-D mesh over every process's device, one a rank, in rank order
    (a :class:`ProcessRowMesh` holding this rank's position); without a
    process group, the mesh of this process's one device.  ``device`` is
    this rank's (:func:`rank_device`)."""
    if not torch.distributed.is_initialized():
        return RowMesh([rank_device(device)])
    dev = rank_device(device)
    backend = torch.distributed.get_backend()
    comm = Collectives(None, torch.distributed.get_rank(),
                       torch.distributed.get_world_size(), backend, dev)
    return ProcessRowMesh(dev, comm)


def shutdown() -> None:
    """Leave the process group (where one was joined)."""
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
