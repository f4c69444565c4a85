"""Plain PyTorch prime-field arithmetic on 16-bit limbs.

The counterpart of ``ligero_tpu.engine.fieldops.FieldKernel``: tensors of
shape ``(..., L)`` hold ``L`` little-endian 16-bit limbs (``int32`` at every
public function; ``int64`` inside, where limb products and column sums need
the room).  Montgomery form uses the JAX package's radix ``R = 2^(16 L)``,
so values are the same integers on both sides.

These functions run on any device and are the plain versions the CPU tests
and ``chip_smoke.py`` hold the CUDA kernels against.  Where an operation
needs Montgomery products (``sum_mod``, ``to_mont``, ``from_mont``), the
product function is a parameter, so the CUDA backend can route it through
the mont_mul kernel and the plain path through :func:`mont_mul`.
"""

from __future__ import annotations

import torch

from ..fields import FieldSpec

MASK = 0xFFFF

_CONST_CACHE: dict = {}


def const_limbs(field: FieldSpec, value: int, device) -> torch.Tensor:
    """``value`` (an integer < 2^(16 L)) as an ``(L,)`` int32 limb tensor."""
    key = (field.name, value, str(device))
    t = _CONST_CACHE.get(key)
    if t is None:
        t = torch.tensor([(value >> (16 * i)) & MASK
                          for i in range(field.num_limbs)],
                         dtype=torch.int32, device=device)
        _CONST_CACHE[key] = t
    return t


def _p64(field: FieldSpec) -> list[int]:
    return [(field.p >> (16 * i)) & MASK for i in range(field.num_limbs)]


def _cond_sub_p(field: FieldSpec, x: torch.Tensor,
                top: torch.Tensor | None = None) -> torch.Tensor:
    """x - p where x >= p (or top != 0), else x; x normalized int64 limbs."""
    p = _p64(field)
    d = torch.empty_like(x)
    borrow = torch.zeros(x.shape[:-1], dtype=torch.int64, device=x.device)
    for j in range(field.num_limbs):
        v = x[..., j] - p[j] - borrow
        borrow = (v < 0).to(torch.int64)
        d[..., j] = v + (borrow << 16)
    ge = borrow == 0
    if top is not None:
        ge = ge | (top != 0)
    return torch.where(ge[..., None], d, x)


def _carry_normalize(x: torch.Tensor) -> torch.Tensor:
    """(..., C) non-negative int64 columns -> 16-bit limbs (in place);
    the last column keeps the overflow."""
    for j in range(x.shape[-1] - 1):
        x[..., j + 1] += x[..., j] >> 16
        x[..., j] &= MASK
    return x


def mont_mul(field: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """REDC(a * b) = a b R^-1 mod p, fully reduced, for a < R and b < p.

    Shapes broadcast.  16-bit REDC over int64 product columns; the result
    is the unique reduced representative, so it equals ark's CIOS and the
    CUDA kernel bit for bit."""
    L = field.num_limbs
    a64, b64 = torch.broadcast_tensors(a.to(torch.int64), b.to(torch.int64))
    t = torch.zeros(a64.shape[:-1] + (2 * L + 1,), dtype=torch.int64,
                    device=a64.device)
    for i in range(L):
        t[..., i:i + L] += a64[..., i:i + 1] * b64
    p = torch.tensor(_p64(field), dtype=torch.int64,
                     device=a64.device)
    n16 = field.n16
    for i in range(L):
        m = (t[..., i] * n16) & MASK
        t[..., i:i + L] += m[..., None] * p
        t[..., i + 1] += t[..., i] >> 16
    r = _carry_normalize(t[..., L:].clone())
    return _cond_sub_p(field, r[..., :L], r[..., L]).to(torch.int32)


def add(field: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a + b mod p for reduced a, b (shapes broadcast)."""
    s = a.to(torch.int64) + b.to(torch.int64)
    s = torch.cat([s, torch.zeros_like(s[..., :1])], dim=-1)
    s = _carry_normalize(s)
    return _cond_sub_p(field, s[..., :-1], s[..., -1]).to(torch.int32)


def sub(field: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b mod p for reduced a, b (shapes broadcast)."""
    a64, b64 = torch.broadcast_tensors(a.to(torch.int64), b.to(torch.int64))
    d = torch.empty_like(a64)
    borrow = torch.zeros(a64.shape[:-1], dtype=torch.int64, device=a64.device)
    for j in range(field.num_limbs):
        v = a64[..., j] - b64[..., j] - borrow
        borrow = (v < 0).to(torch.int64)
        d[..., j] = v + (borrow << 16)
    p = _p64(field)
    under = borrow
    carry = torch.zeros_like(borrow)
    for j in range(field.num_limbs):
        v = d[..., j] + under * p[j] + carry
        carry = v >> 16
        d[..., j] = v & MASK
    return d.to(torch.int32)


def fold_wide(field: FieldSpec, s: torch.Tensor, mul=mont_mul) -> torch.Tensor:
    """Reduce int64 limb sums ``s`` (each < 2^48) mod p.

    With s = LO + 2^16 MID + 2^32 HI, where LO, MID, HI are 16-bit limb
    numbers below R: value mod p = REDC(LO (R mod p)) + REDC(MID (2^16 R
    mod p)) + REDC(HI (2^32 R mod p)).  The products take a < R with b < p
    (the bound the mont_mul kernel honours)."""
    rp = field.R % field.p
    out = None
    for shift in (0, 16, 32):
        part = ((s >> shift) & MASK).to(torch.int32)
        term = mul(field, part, const_limbs(field, (rp << shift) % field.p,
                                            s.device))
        out = term if out is None else add(field, out, term)
    return out


def sum_mod(field: FieldSpec, a: torch.Tensor, dim: int,
            mul=mont_mul) -> torch.Tensor:
    """Sum of field elements along ``dim`` (not the limb axis) mod p:
    one exact int64 limb sum, then :func:`fold_wide`."""
    if dim < 0:
        dim += a.dim()
    if a.shape[dim] >= (1 << 32):
        raise ValueError("sum_mod: axis too long for the int64 limb sums")
    return fold_wide(field, a.to(torch.int64).sum(dim=dim), mul)


def to_mont(field: FieldSpec, a: torch.Tensor, mul=mont_mul) -> torch.Tensor:
    """canonical -> Montgomery: REDC(a R^2)."""
    return mul(field, a, const_limbs(field, field.R2, a.device))


def from_mont(field: FieldSpec, a: torch.Tensor, mul=mont_mul) -> torch.Tensor:
    """Montgomery -> canonical: REDC(a * 1)."""
    return mul(field, a, const_limbs(field, 1, a.device))
