"""Poseidon column digests: the CUDA kernel ``csrc/poseidon_cols.cu`` and
its wrapper.

Replaces the sponge rounds of ``ligero_tpu/engine/poseidon_cols.py``, which
the JAX package runs as one ``mont_mul_pallas`` launch
(``ligero_tpu/engine/pallas_kernels.py:_mont_mul_kernel_factory``) per
product per round.  The kernel runs every round of every absorb of a column
in registers, one thread per column, BN254 Fr only.  On this card it is
bound by the latency of each column's chain of dependent products (h/2
permutations of 275 for h rows), not by memory.

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

_CONSTS: dict = {}


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


def poseidon_columns(field: FieldSpec, cfg, u: torch.Tensor) -> torch.Tensor:
    """(rows, N, L) canonical int32 limbs on a CUDA device, any strides
    whose limb axis is contiguous -> (N, L) int32 canonical digests."""
    poseidon_cols.check_config(field, cfg)
    if (field.name, field.p) != (BN254_FR.name, BN254_FR.p):
        raise NotImplementedError(
            f"poseidon_columns: the CUDA kernel is built for {BN254_FR.name} "
            f"only, not {field.name}")
    rows, n, L = u.shape
    if L != field.num_limbs:
        raise ValueError(f"poseidon_columns: {field.name} elements are "
                         f"{field.num_limbs} limbs, not {L}")
    if u.device.type != "cuda" or u.dtype != torch.int32:
        raise ValueError("poseidon_columns: expected int32 limbs on a CUDA "
                         f"device, got {u.dtype} on {u.device}")
    if u.stride(2) != 1 or u.stride(0) % 4 or u.stride(1) % 4 or (
            u.data_ptr() % 16):
        raise ValueError("poseidon_columns: each element's limbs must be "
                         "contiguous and 16-byte aligned")
    out = torch.empty((n, L), dtype=torch.int32, device=u.device)
    consts = kernel_constants(field, cfg, u.device)
    lib = cuda_build.library()
    with torch.cuda.device(u.device):
        cuda_build.check(lib.lt_poseidon_cols(
            consts.data_ptr(), u.data_ptr(), rows, n, u.stride(0), u.stride(1),
            out.data_ptr(), cuda_build.stream_handle(u.device)),
            "lt_poseidon_cols")
    launches.add()
    return out
