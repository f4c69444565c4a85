"""Blake2s column hashing: the CUDA kernel ``csrc/blake2s_cols.cu`` and its
wrapper.

Replaces ``ligero_tpu/engine/pallas_hash.py:_blake2s_kernel_factory``
(``blake2s_columns_pallas``), the commit's column leaves, for BN254 Fr
(32-byte elements) and BLS12-377 Fq (48-byte elements).  On this card the
hash is bound by instruction issue (968 adds, xors and rotations a 64-byte
block), not by memory.  One thread hashes a column; each warp stages its
32 columns' next rows in shared memory with cp.async while it hashes the
rows before (``csrc/stage.cuh``), so no load waits in a compression.  The
message is the column's ark serialization: the 8-byte length prefix shifts
two words across each period of blocks (:func:`hashops.column_block_words`
is the kernel's word map).  It takes any n (the TPU kernel needed n % 1024
== 0), and a batch of B matrices of one shape in one launch.

The streamed entry (:class:`ColumnHashStream`, the counterpart of the JAX
package's ``HashKernel.blake2s_stream_*`` in
``ligero_tpu/engine/hashops.py``) hashes the same columns when their rows
arrive chunk by chunk, as the streaming commit re-encodes them: one launch
a chunk, each column's chaining value and two carried words kept on the
device between launches; the last chunk's launch makes the final
compression.  Its digests equal :func:`blake2s_columns`'s for every
chunking.  It reads 16-bit limbs (int16, :func:`fieldops.narrow16`): the
resident and streaming modes hold their codeword chunks so (the JAX
package's ``narrow16``), and a 16-bit element is its own message words.

A tensor on the CPU takes the plain version
(:func:`hashops.blake2s_columns_ref`, :func:`hashops.blake2s_absorb_ref`);
a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..fields import FieldSpec

from . import cuda_build
from .hashops import (blake2s_absorb_ref, blake2s_columns_ref,
                      blake2s_stream_start, period_rows)

#: kernel launches by :func:`blake2s_columns`
launches = cuda_build.LaunchCounter()
#: launches of the streamed entry, by :func:`blake2s_absorb`
stream_launches = cuda_build.LaunchCounter()


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


def blake2s_absorb(field: FieldSpec, chunk: torch.Tensor, rows: int,
                   state: torch.Tensor, block0: int, final: bool,
                   total_rows: int) -> torch.Tensor:
    """Rows [0, ``rows``) of a (>= rows, n, L) canonical chunk of 16-bit
    limbs (int16) absorbed into the (n, 10) int32 column states
    (:func:`hashops.blake2s_stream_start`) after ``block0`` compressed
    blocks; ``final`` for a column's last rows
    (``total_rows`` in all), otherwise ``rows`` is a multiple of
    :func:`hashops.period_rows`.  Returns the new states (on CUDA: the same
    tensor, updated in place)."""
    L = field.num_limbs
    cuda_build.require_limbs16("blake2s_absorb", chunk)
    if (chunk.dim() != 3 or chunk.shape[-1] != L
            or not 0 <= rows <= chunk.shape[0]):
        raise ValueError(f"blake2s_absorb: bad chunk {tuple(chunk.shape)} "
                         f"for {rows} {field.name} rows")
    if state.shape != (chunk.shape[1], 10):
        raise ValueError(f"blake2s_absorb: states {tuple(state.shape)} for "
                         f"{chunk.shape[1]} columns")
    if not final and rows % period_rows(L):
        raise ValueError(f"blake2s_absorb: {rows} rows are not whole periods "
                         f"of {period_rows(L)}")
    if chunk.device.type == "cpu":
        return blake2s_absorb_ref(chunk, rows, state, block0, final,
                                  total_rows)
    fid = cuda_build.kernel_field_id(field, "blake2s_absorb")
    chunk = chunk.contiguous()
    cuda_build.require_cuda_tensors("blake2s_absorb", state, limbs16=(chunk,))
    lib = cuda_build.library()
    cuda_build.check(lib.lt_blake2s_absorb(
        fid, chunk.data_ptr(), rows, chunk.shape[1], state.data_ptr(), block0,
        int(final), 8 + total_rows * L * 2,
        cuda_build.stream_handle(chunk.device)), "lt_blake2s_absorb")
    stream_launches.add()
    return state


class ColumnHashStream:
    """The Blake2s digests of n columns of ``total_rows`` rows, absorbed
    chunk by chunk in row order (:func:`blake2s_absorb`); the chunk that
    brings the count to ``total_rows`` finalises, after which
    :meth:`digests` gives the (n, 8) int32 LE words :func:`blake2s_columns`
    gives for the whole matrix."""

    def __init__(self, field: FieldSpec, n: int, total_rows: int, device):
        self.field, self.total_rows = field, total_rows
        self.done = self.blocks = 0
        self.state = blake2s_stream_start(n, total_rows, device)

    def absorb(self, chunk: torch.Tensor, rows: int) -> None:
        """The next ``rows`` rows: rows [0, rows) of ``chunk``."""
        if self.done + rows > self.total_rows:
            raise ValueError(f"ColumnHashStream: {self.done} + {rows} rows "
                             f"exceed {self.total_rows}")
        final = self.done + rows == self.total_rows
        self.state = blake2s_absorb(self.field, chunk, rows, self.state,
                                    self.blocks, final, self.total_rows)
        self.done += rows
        self.blocks += (2 + rows * self.field.num_limbs // 2) // 16

    def digests(self) -> torch.Tensor:
        if self.done != self.total_rows:
            raise ValueError(f"ColumnHashStream: {self.done} of "
                             f"{self.total_rows} rows absorbed")
        return self.state[:, :8]
