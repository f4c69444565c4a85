"""Radix-2 NTT twiddle tables and the plain PyTorch transform.

The counterpart of ``ligero_tpu.engine.ntt`` (``NTTPlan``/``DomainOps``):
ark-poly ``Radix2EvaluationDomain`` semantics, domain generator
``omega = TWO_ADIC_ROOT^(2^(s - log2 n))``, natural-order evaluations, and
``1/n`` scaling on the inverse.  :func:`ntt_ref` is the plain version the
CUDA kernel (``cuda_ntt``) is held against: a bit-reversed gather and
``log2 n`` Cooley-Tukey stages over whole row blocks.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import FIELDS, FieldSpec

from . import fieldops


def check_size(field: FieldSpec, n: int) -> int:
    """log2(n) for a power-of-two transform size the field supports."""
    if n < 2 or n & (n - 1):
        raise ValueError(f"NTT size must be a power of two >= 2, got {n}")
    logn = n.bit_length() - 1
    if logn > field.two_adicity:
        raise ValueError(f"field cannot accommodate an NTT of size {n}")
    return logn


def bitrev_permutation(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


@functools.lru_cache(maxsize=None)
def twiddle_limbs(field_name: str, n: int, inverse: bool) -> np.ndarray:
    """omega^j for j < n/2 (omega^-1 for an inverse), as (n/2, L) uint32
    Montgomery limbs."""
    field = FIELDS[field_name]
    omega = field.root_of_unity(n)
    if inverse:
        omega = pow(omega, -1, field.p)
    tw, cur = [], 1
    for _ in range(n // 2):
        tw.append(cur)
        cur = cur * omega % field.p
    return field.ints_to_mont_limbs(tw)


def epilogue_const(field: FieldSpec, n: int, inverse: bool,
                   canon_out: bool) -> int | None:
    """Constant c of the output multiply REDC(v c), or None for none:
    Montgomery n^-1 for an inverse, 1 for canonical output, the plain
    integer n^-1 for both."""
    if not inverse and not canon_out:
        return None
    n_inv = pow(n, -1, field.p)
    if inverse and canon_out:
        return n_inv
    return n_inv * field.R % field.p if inverse else 1


_TW_CACHE: dict = {}


def twiddles(field: FieldSpec, n: int, inverse: bool, device) -> torch.Tensor:
    """(n/2, L) int32 Montgomery twiddles on ``device`` (cached)."""
    key = (field.name, n, inverse, str(device))
    t = _TW_CACHE.get(key)
    if t is None:
        t = torch.from_numpy(
            twiddle_limbs(field.name, n, inverse).astype(np.int32)).to(device)
        _TW_CACHE[key] = t
    return t


def ntt_ref(field: FieldSpec, x: torch.Tensor, n: int, inverse: bool = False,
            canon_out: bool = False) -> torch.Tensor:
    """(..., w, L) Montgomery limbs, w <= n, zero-extended -> (..., n, L).

    ``inverse`` applies omega^-1 and the 1/n scale; ``canon_out`` returns
    canonical (from-Montgomery) limbs.  Plain PyTorch, any device."""
    logn = check_size(field, n)
    L = field.num_limbs
    lead, w = x.shape[:-2], x.shape[-2]
    if w > n:
        raise ValueError(f"ntt_ref: {w} input columns exceed n = {n}")
    rows = x.reshape(-1, w, L)
    B = rows.shape[0]
    if w < n:
        rows = torch.cat([rows, torch.zeros((B, n - w, L), dtype=rows.dtype,
                                            device=rows.device)], dim=1)
    perm = torch.from_numpy(bitrev_permutation(n)).to(rows.device)
    y = rows.index_select(1, perm).to(torch.int32)
    tw = twiddles(field, n, inverse, y.device)
    for s in range(logn):
        half = 1 << s
        v = y.reshape(B, n // (2 * half), 2, half, L)
        lo, hi = v[:, :, 0], v[:, :, 1]
        stage_tw = tw[torch.arange(half, device=y.device) << (logn - 1 - s)]
        t = fieldops.mont_mul(field, hi, stage_tw)
        y = torch.stack([fieldops.add(field, lo, t), fieldops.sub(field, lo, t)],
                        dim=2).reshape(B, n, L)
    c = epilogue_const(field, n, inverse, canon_out)
    if c is not None:
        y = fieldops.mont_mul(field, y, fieldops.const_limbs(field, c, y.device))
    return y.reshape(*lead, n, L)
