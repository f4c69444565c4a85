"""Poseidon column digests: the CUDA kernel ``csrc/poseidon_cols.cu`` and
its wrapper.

Replaces the sponge rounds of ``ligero_tpu/engine/poseidon_cols.py``, which
the JAX package runs as one ``mont_mul_pallas`` launch
(``ligero_tpu/engine/pallas_kernels.py:_mont_mul_kernel_factory``) per
product per round.  The kernel runs every round of every absorb of a column
in registers, BN254 Fr only.  Each permutation is a chain of dependent
products, so the time is that of one column's chain, not of memory: the
three S-boxes of a full round run side by side (195 products deep a
permutation, not 275), the squarings take a squaring routine, and G = 1,
2, 4 or 8 lanes of a warp share a column, each holding 8 / G words of every
element, its products a CIOS distributed over the lanes by shuffles.
:func:`lanes_for` picks G from the number of columns of the launch: one
lane where the columns fill the card, eight where they leave it idle.  One
launch takes B stacked matrices (a batch's commitments, or a tree level of
B trees).

A tensor on the CPU takes the plain version
(:func:`poseidon_cols.poseidon_columns_plain`); a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import BN254_FR, FieldSpec
from . import cuda_build, poseidon_cols

#: kernel launches by :func:`poseidon_columns`
launches = cuda_build.LaunchCounter()

#: the lane counts the kernel is compiled for
LANES = (1, 2, 4, 8)

_CONSTS: dict = {}


def lanes_for(columns: int) -> int:
    """Lanes a column for a launch over ``columns`` sponges.  Past 4096
    columns one lane a column keeps a warp on every scheduler and more
    lanes only add instructions (G = 1); at 2049-4096, four lanes; at up to
    2048, eight lanes a column fill the schedulers the columns alone leave
    idle and shorten each product's chain (the times behind the rule:
    ``PERF.md``, kernel table)."""
    if columns > 4096:
        return 1
    if columns > 2048:
        return 4
    return 8


def kernel_constants(field: FieldSpec, cfg, device) -> torch.Tensor:
    """(3 x 39 + 1, 8) int32 words on ``device``: ``cfg``'s round
    constants in Montgomery form, then R^2 mod p (the kernel's
    to-Montgomery factor).  Cached by the constants' values."""
    key = (field.name, str(device), tuple(c for row in cfg.ark for c in row))
    out = _CONSTS.get(key)
    if out is None:
        ark = poseidon_cols.round_constants(field, cfg)
        limbs = np.concatenate([ark.reshape(-1, field.num_limbs),
                                field.r2_limbs[None]]).astype(np.uint32)
        words = limbs[:, 0::2] | (limbs[:, 1::2] << 16)
        out = torch.from_numpy(words.view(np.int32).copy()).to(device)
        _CONSTS[key] = out
    return out


def poseidon_columns(field: FieldSpec, cfg, u: torch.Tensor,
                     lanes: int | None = None) -> torch.Tensor:
    """(rows, N, L) -> (N, L), or B matrices (B, rows, N, L) -> (B, N, L):
    int32 canonical limbs on a CUDA device, any strides whose limb axis is
    contiguous, to int32 canonical digests, in one launch at ``lanes``
    lanes a column (default :func:`lanes_for` of B N)."""
    poseidon_cols.check_config(field, cfg)
    if (field.name, field.p) != (BN254_FR.name, BN254_FR.p):
        raise NotImplementedError(
            f"poseidon_columns: the CUDA kernel is built for {BN254_FR.name} "
            f"only, not {field.name}")
    if u.dim() not in (3, 4):
        raise ValueError(f"poseidon_columns: expected (rows, N, L) or "
                         f"(B, rows, N, L), got {tuple(u.shape)}")
    mats = u if u.dim() == 4 else u[None]
    batch, rows, n, L = mats.shape
    if L != field.num_limbs:
        raise ValueError(f"poseidon_columns: {field.name} elements are "
                         f"{field.num_limbs} limbs, not {L}")
    if u.device.type != "cuda" or u.dtype != torch.int32:
        raise ValueError("poseidon_columns: expected int32 limbs on a CUDA "
                         f"device, got {u.dtype} on {u.device}")
    strides = (mats.stride(0) if batch > 1 else 0, mats.stride(1),
               mats.stride(2))
    if mats.stride(3) != 1 or any(s % 4 for s in strides) or (
            u.data_ptr() % 16):
        raise ValueError("poseidon_columns: each element's limbs must be "
                         "contiguous and 16-byte aligned")
    lanes = lanes_for(batch * n) if lanes is None else lanes
    if lanes not in LANES:
        raise ValueError(f"poseidon_columns: {lanes} lanes a column; the "
                         f"kernel is built for {LANES}")
    out = torch.empty((batch, n, L), dtype=torch.int32, device=u.device)
    consts = kernel_constants(field, cfg, u.device)
    lib = cuda_build.library()
    with torch.cuda.device(u.device):
        cuda_build.check(lib.lt_poseidon_cols(
            consts.data_ptr(), u.data_ptr(), rows, n, batch, strides[1],
            strides[2], strides[0], lanes, out.data_ptr(),
            cuda_build.stream_handle(u.device)), "lt_poseidon_cols")
    launches.add()
    return out if u.dim() == 4 else out[0]
