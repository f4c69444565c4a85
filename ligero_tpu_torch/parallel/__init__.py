"""Multi-device execution of the port: the row-sharded backend
(``sharded_backend``), the counterpart of ``ligero_tpu/parallel/``."""

from .sharded_backend import RowMesh, ShardedBackend, ShardedRows

__all__ = ["RowMesh", "ShardedBackend", "ShardedRows"]
