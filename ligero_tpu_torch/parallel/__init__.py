"""Multi-device execution of the port, the counterpart of
``ligero_tpu/parallel/``: the row-sharded backend (``sharded_backend``) and
the prover's compute core on one device or a mesh (``core_step``)."""

from .core_step import make_prover_core, make_sharded_prover_core
from .sharded_backend import RowMesh, ShardedBackend, ShardedRows

__all__ = ["make_prover_core", "make_sharded_prover_core", "RowMesh",
           "ShardedBackend", "ShardedRows"]
