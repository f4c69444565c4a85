"""Row combination: the CUDA kernel ``csrc/row_combine.cu`` and its wrapper.

Replaces ``ligero_tpu/engine/mxu_lc.py:_mxu_lc_kernel_factory`` (``mxu_lc``),
the interleaved phase's lc = sum_i r_i preenc_i, for BN254 Fr and BLS12-377
Fq.  On this card the pass is bound by device memory (one 4 L-byte element
per Montgomery product: 64 bytes for BN254, 96 for BLS12-377): the
kernel gives each thread one column and a chunk of rows, so the card fills
even at a few thousand columns, and a second launch adds the per-chunk
partials.  Modular adds make the sum exact in any order.  The same kernel
serves the per-element form sum_i r_i[c] M_i[c] (linear phase, verifier
spot sums).  :func:`row_combine_batch` runs B combinations of one shape in
the same two launches (the batch on the grid's third axis).

A tensor on the CPU takes the plain version (:func:`row_combine_ref`); a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..fields import FieldSpec

from . import cuda_build, fieldops

#: kernel launches by :func:`row_combine`
launches = cuda_build.LaunchCounter()

ROWS_PER_CHUNK = 64
MAX_CHUNKS = 65535  # the grid's second axis


def row_combine_ref(field: FieldSpec, r: torch.Tensor,
                    mat: torch.Tensor) -> torch.Tensor:
    """Plain version: sum over rows of REDC(r_i M_i) mod p."""
    rr = r[:, None, :] if r.dim() == 2 else r
    return fieldops.sum_mod(field, fieldops.mont_mul(field, rr, mat), 0)


def row_combine_batch_ref(field: FieldSpec, r: torch.Tensor,
                          mats: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`row_combine_batch`: :func:`row_combine_ref`
    of each pair in turn."""
    return torch.stack([row_combine_ref(field, r[b], mats[b])
                        for b in range(mats.shape[0])])


def _launch(field: FieldSpec, name: str, r: torch.Tensor, mats: torch.Tensor,
            per_column: bool) -> torch.Tensor:
    """(B, rows, k, L) x r -> (B, k, L) on the kernel, counted once."""
    fid = cuda_build.kernel_field_id(field, name)
    batch, rows, k, L = mats.shape
    out = torch.zeros((batch, k, L), dtype=torch.int32, device=mats.device)
    if rows == 0 or k == 0 or batch == 0:
        return out
    if batch > MAX_CHUNKS:
        raise ValueError(f"{name}: at most {MAX_CHUNKS} combinations a launch")
    r, mats = r.contiguous(), mats.contiguous()
    chunks = min(MAX_CHUNKS, -(-rows // ROWS_PER_CHUNK))
    rows_per_chunk = -(-rows // chunks)
    chunks = -(-rows // rows_per_chunk)
    partial = torch.empty((batch, chunks, k, L // 2), dtype=torch.int32,
                          device=mats.device)
    cuda_build.require_cuda_tensors(name, r, mats, partial, out)
    lib = cuda_build.library()
    cuda_build.check(
        lib.lt_row_combine(fid, mats.data_ptr(), r.data_ptr(),
                           partial.data_ptr(), out.data_ptr(), batch, rows, k,
                           chunks, rows_per_chunk, int(per_column),
                           cuda_build.stream_handle(mats.device)),
        "lt_row_combine")
    launches.add()
    return out


def row_combine(field: FieldSpec, r: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """(rows, k, L) x r (rows, L) or (rows, k, L) -> (k, L) int32 limbs of
    sum_i REDC(r_i M_i) mod p (Montgomery when both are Montgomery,
    canonical when one is canonical)."""
    if r.device.type == "cpu" and mat.device.type == "cpu":
        return row_combine_ref(field, r, mat)
    rows, k, L = mat.shape
    per_column = r.dim() == 3
    if r.shape != ((rows, k, L) if per_column else (rows, L)):
        raise ValueError(f"row_combine: r {tuple(r.shape)} vs M {tuple(mat.shape)}")
    return _launch(field, "row_combine", r[None], mat[None], per_column)[0]


def row_combine_batch(field: FieldSpec, r: torch.Tensor,
                      mats: torch.Tensor) -> torch.Tensor:
    """B combinations of one shape: (B, rows, k, L) x r (B, rows, L) ->
    (B, k, L), each as :func:`row_combine` gives it."""
    if r.device.type == "cpu" and mats.device.type == "cpu":
        return row_combine_batch_ref(field, r, mats)
    if mats.dim() != 4 or r.shape != mats.shape[:2] + mats.shape[3:]:
        raise ValueError(f"row_combine_batch: r {tuple(r.shape)} vs M "
                         f"{tuple(mats.shape)}")
    return _launch(field, "row_combine_batch", r, mats, False)
