"""Blake2s column hashing: the CUDA kernel ``csrc/blake2s_cols.cu`` and its
wrapper.

Replaces ``ligero_tpu/engine/pallas_hash.py:_blake2s_kernel_factory``
(``blake2s_columns_pallas``), the commit's column leaves, for BN254 Fr
(32-byte elements) and BLS12-377 Fq (48-byte elements).  On this card the
kernel is bound by integer issue (about 1000 dependent 32-bit operations
per 64-byte block), not by memory: one thread per column streams its
column straight from the (rows, n, L) matrix, with no re-layout pass, and
carries the two words that the 8-byte length prefix shifts across each
period of blocks (:func:`hashops.column_block_words` is the kernel's word
map).  It takes any n (the TPU kernel needed n % 1024 == 0), and a batch of
B matrices of one shape in one launch.

A tensor on the CPU takes the plain version
(:func:`hashops.blake2s_columns_ref`); a CUDA tensor launches the kernel
or raises.
"""

from __future__ import annotations

import torch

from ..fields import FieldSpec

from . import cuda_build
from .hashops import blake2s_columns_ref

#: kernel launches by :func:`blake2s_columns`
launches = cuda_build.LaunchCounter()


def blake2s_columns_batch_ref(u_canon: torch.Tensor, batch: int) -> torch.Tensor:
    """Plain version of :func:`blake2s_columns` for a batch: each matrix's
    columns in turn."""
    rows = u_canon.shape[0] // batch
    return torch.cat([blake2s_columns_ref(u_canon[b * rows:(b + 1) * rows])
                      for b in range(batch)])


def blake2s_columns(field: FieldSpec, u_canon: torch.Tensor,
                    batch: int = 1) -> torch.Tensor:
    """(batch * rows, n, L) canonical int32 limbs of ``field``, ``batch``
    matrices of ``rows`` rows stacked -> (batch * n, 8) int32 LE digest
    words: matrix b's column j at row b n + j.  A column's message opens
    with its own matrix's row count."""
    if batch < 1 or u_canon.shape[0] % batch:
        raise ValueError(f"blake2s_columns: {u_canon.shape[0]} rows do not "
                         f"split into {batch} matrices")
    if u_canon.shape[-1] != field.num_limbs:
        raise ValueError(f"blake2s_columns: {field.name} elements are "
                         f"{field.num_limbs} limbs, not {u_canon.shape[-1]}")
    if u_canon.device.type == "cpu":
        return blake2s_columns_batch_ref(u_canon, batch)
    total, n, L = u_canon.shape
    fid = cuda_build.kernel_field_id(field, "blake2s_columns")
    u_canon = u_canon.contiguous()
    out = torch.empty((batch * n, 8), dtype=torch.int32, device=u_canon.device)
    if n == 0:
        return out
    cuda_build.require_cuda_tensors("blake2s_columns", u_canon, out)
    lib = cuda_build.library()
    cuda_build.check(lib.lt_blake2s_cols(
        fid, u_canon.data_ptr(), total // batch, n, batch, out.data_ptr(),
        cuda_build.stream_handle(u_canon.device)), "lt_blake2s_cols")
    launches.add()
    return out
