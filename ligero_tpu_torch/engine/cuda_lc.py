"""Row combination: the CUDA kernel ``csrc/row_combine.cu`` and its wrapper.

Replaces ``ligero_tpu/engine/mxu_lc.py:_mxu_lc_kernel_factory`` (``mxu_lc``),
the interleaved phase's lc = sum_i r_i preenc_i.  On this card the pass is
bound by device memory (one 64-byte element per Montgomery product): the
kernel gives each thread one column and a chunk of rows, so the card fills
even at a few thousand columns, and a second launch adds the per-chunk
partials.  Modular adds make the sum exact in any order.  The same kernel
serves the per-element form sum_i r_i[c] M_i[c] (linear phase, verifier
spot sums).

A tensor on the CPU takes the plain version (:func:`row_combine_ref`); a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..fields import FieldSpec

from . import cuda_build, fieldops
from .cuda_mont import require_bn254

#: kernel launches by :func:`row_combine`
launches = cuda_build.LaunchCounter()

ROWS_PER_CHUNK = 64
MAX_CHUNKS = 65535  # the grid's second axis


def row_combine_ref(field: FieldSpec, r: torch.Tensor,
                    mat: torch.Tensor) -> torch.Tensor:
    """Plain version: sum over rows of REDC(r_i M_i) mod p."""
    rr = r[:, None, :] if r.dim() == 2 else r
    return fieldops.sum_mod(field, fieldops.mont_mul(field, rr, mat), 0)


def row_combine(field: FieldSpec, r: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """(rows, k, L) x r (rows, L) or (rows, k, L) -> (k, L) int32 limbs of
    sum_i REDC(r_i M_i) mod p (Montgomery when both are Montgomery,
    canonical when one is canonical)."""
    if r.device.type == "cpu" and mat.device.type == "cpu":
        return row_combine_ref(field, r, mat)
    require_bn254(field, "row_combine")
    rows, k, L = mat.shape
    per_column = r.dim() == 3
    if r.shape != ((rows, k, L) if per_column else (rows, L)):
        raise ValueError(f"row_combine: r {tuple(r.shape)} vs M {tuple(mat.shape)}")
    out = torch.zeros((k, L), dtype=torch.int32, device=mat.device)
    if rows == 0 or k == 0:
        return out
    r, mat = r.contiguous(), mat.contiguous()
    chunks = min(MAX_CHUNKS, -(-rows // ROWS_PER_CHUNK))
    rows_per_chunk = -(-rows // chunks)
    chunks = -(-rows // rows_per_chunk)
    partial = torch.empty((chunks, k, L // 2), dtype=torch.int32,
                          device=mat.device)
    cuda_build.require_cuda_tensors("row_combine", r, mat, partial, out)
    lib = cuda_build.library()
    cuda_build.check(
        lib.lt_row_combine(mat.data_ptr(), r.data_ptr(), partial.data_ptr(),
                           out.data_ptr(), rows, k, chunks, rows_per_chunk,
                           int(per_column), cuda_build.stream_handle(mat.device)),
        "lt_row_combine")
    launches.add()
    return out
