"""Multi-device execution of the port, the counterpart of
``ligero_tpu/parallel/``: the row-sharded backend (``sharded_backend``) and
the prover's compute core on one device or a mesh (``core_step``), over the
devices of one process (``RowMesh``) or one device a process
(``ProcessRowMesh``: ``multihost``, with ``collectives`` between the
ranks)."""

from .core_step import make_prover_core, make_sharded_prover_core
from .sharded_backend import (ProcessRowMesh, RowMesh, ShardedBackend,
                              ShardedRows)

__all__ = ["make_prover_core", "make_sharded_prover_core", "ProcessRowMesh",
           "RowMesh", "ShardedBackend", "ShardedRows"]
