"""Batched NTT: the CUDA kernel ``csrc/ntt.cu`` and its wrapper.

Replaces ``ligero_tpu/engine/mxu_ntt.py:_mxu_kernel_factory`` (every BN254
transform at 2^20 gates on the TPU: iNTT_k, the split NTT_n and the 2k
products) and ``ligero_tpu/engine/pallas_ntt.py:_ntt_kernel_factory`` (the
k <= 512 sizes).  On this card the transform is bound by device memory:
each butterfly stage reads and writes the whole row block.  The kernel
keeps the first ten stages in shared memory (one read, in bit-reversed
order, and one write), runs the remaining stages as global passes over a
packed 32-byte-per-element scratch, and fuses the 1/n scale and the
from-Montgomery epilogue into the last pass.

A tensor on the CPU takes the plain version (:func:`ntt.ntt_ref`); a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..fields import FieldSpec

from . import cuda_build
from .cuda_mont import require_bn254
from .ntt import check_size, epilogue_const, ntt_ref, twiddle_limbs

#: kernel launches by :func:`ntt` (one per call; a call runs 1 + max(0,
#: log2 n - 10) kernels back to back)
launches = cuda_build.LaunchCounter()

_PACKED_TW: dict = {}


def pack_words(limbs: np.ndarray) -> np.ndarray:
    """(..., L) 16-bit limbs -> (..., L/2) 32-bit words as int32 bits."""
    limbs = np.asarray(limbs, dtype=np.uint32)
    return (limbs[..., 0::2] | (limbs[..., 1::2] << np.uint32(16))).view(np.int32)


def _packed_twiddles(field: FieldSpec, n: int, inverse: bool, device):
    key = (field.name, n, inverse, str(device))
    t = _PACKED_TW.get(key)
    if t is None:
        t = torch.from_numpy(np.ascontiguousarray(
            pack_words(twiddle_limbs(field.name, n, inverse)))).to(device)
        _PACKED_TW[key] = t
    return t


def ntt(field: FieldSpec, x: torch.Tensor, n: int, inverse: bool = False,
        canon_out: bool = False) -> torch.Tensor:
    """(..., w, L) Montgomery limbs, w <= n, zero-extended -> (..., n, L);
    ``inverse`` for omega^-1 with 1/n, ``canon_out`` for canonical output."""
    if x.device.type == "cpu":
        return ntt_ref(field, x, n, inverse, canon_out)
    require_bn254(field, "ntt")
    logn = check_size(field, n)
    L = field.num_limbs
    lead, w = x.shape[:-2], x.shape[-2]
    if w > n or x.shape[-1] != L:
        raise ValueError(f"ntt: bad input shape {tuple(x.shape)} for n = {n}")
    x = x.reshape(-1, w, L).contiguous()
    B = x.shape[0]
    out = torch.empty((B, n, L), dtype=torch.int32, device=x.device)
    if B == 0:
        return out.reshape(*lead, n, L)
    # packed words between the stage passes (unused when n fits one tile)
    scratch = torch.empty((B, n, L // 2), dtype=torch.int32, device=x.device)
    tw = _packed_twiddles(field, n, inverse, x.device)
    cuda_build.require_cuda_tensors("ntt", x, out, scratch, tw)
    c = epilogue_const(field, n, inverse, canon_out)
    c_words = (ctypes.c_uint32 * 8)(*[((c or 0) >> (32 * i)) & 0xFFFFFFFF
                                      for i in range(8)])
    lib = cuda_build.library()
    cuda_build.check(
        lib.lt_ntt(x.data_ptr(), w, out.data_ptr(), scratch.data_ptr(),
                   tw.data_ptr(), B, logn, ctypes.addressof(c_words),
                   int(c is not None), cuda_build.stream_handle(x.device)),
        "lt_ntt")
    launches.add()
    return out.reshape(*lead, n, L)
