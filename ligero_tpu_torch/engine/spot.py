"""Spot-column codeword evaluation: U[:, js] = coeffs x W(js).

The counterpart of ``ligero_tpu/engine/mxu_spot.py``.  The verifier needs
the 4m r_i codewords only at the t ~ 156 opened columns; instead of all
n points of every row this module evaluates

    u[row, j] = sum_c coeffs[row, c] * omega_n^(c * js[j])

as a dense (rows, k) x (k, t) field contraction on the tensor cores: both
operands are split into 37 limbs of 7 bits (int8), one int8 matrix product
per data limb against every weight limb (``torch._int_mm``, exact int32
sums), shifted adds into 2 * 37 - 1 redundant base-2^7 columns, a regroup
of those columns into 16-bit limbs, and a Montgomery fold of the ~540-bit
integer back below p.  The JAX package leaves the product to XLA outside
any Pallas kernel; here it is the library's int8 product, and everything
around it is this module's.

Exactness: a dot entry is at most kc * 127^2 and a column sums 37 of them,
so a chunk of kc <= K_MAX coefficients keeps every column inside int32
(asserted below); a longer row contracts in chunks whose results add
mod p.  Both operands are Montgomery, so a chunk's integer V is
(sum c w) R^2: V R^-1 is the Montgomery-form evaluation, the same
representative the NTT route emits, and V R^-2 the canonical one
(``canon_out``).

:func:`spot_ref` (the full transform, then a gather) is the plain version
the tests and ``chip_smoke.py`` hold :func:`spot_eval` against.

``TorchBackend.ntt_columns`` does not call this module: on an H100 the
~1,200 small launches around the products make it slower than the NTT
kernel and a gather at every shape measured (PERF.md, Findings), at a
quarter of the transients.  It becomes the verifier's route once the limb
split, the regroup and the fold are one kernel each.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import FIELDS, FieldSpec
from . import cuda_mont, fieldops
from .ntt import ntt_ref

#: 7-bit limbs of a 16 x 16-bit element
L7 = 37
MASK7 = 0x7F
#: coefficients contracted per exact int32 accumulation
K_MAX = 2048
# a column sums L7 dot entries of at most K_MAX * 127^2 each
assert L7 * K_MAX * MASK7 ** 2 < 1 << 31
#: 16-bit limbs of a chunk's integer: 2 * L7 - 1 columns of 31 bits, 7 apart
_WIDE = (7 * (2 * L7 - 2) + 31) // 16 + 1
_TABLES: dict = {}


def spot_ok(field: FieldSpec, n: int) -> bool:
    """16 x 16-bit-limb fields only (the 7-bit split is laid out for them);
    n a power of two (exponents reduce with ``& (n - 1)``)."""
    return field.num_limbs == 16 and n > 0 and n & (n - 1) == 0


@functools.lru_cache(maxsize=None)
def omega_powers(field_name: str, n: int) -> np.ndarray:
    """(n, L) int32 Montgomery limbs of omega_n^i, omega_n the root the
    transforms use (``field.root_of_unity``)."""
    field = FIELDS[field_name]
    omega, p = field.root_of_unity(n), field.p
    powers, cur = [], 1
    for _ in range(n):
        powers.append(cur)
        cur = cur * omega % p
    return field.ints_to_mont_limbs(powers).astype(np.int32)


def _power_table(field: FieldSpec, n: int, device) -> torch.Tensor:
    key = (field.name, n, str(device))
    t = _TABLES.get(key)
    if t is None:
        t = torch.from_numpy(omega_powers(field.name, n)).to(device)
        _TABLES[key] = t
    return t


def limbs16_to_7(x_lt: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """(L, ...) int32 16-bit limbs, limb-major -> ``out`` (L7, ...) int8
    7-bit limbs (limb l holds bits [7 l, 7 l + 7) of the element)."""
    L = x_lt.shape[0]
    for l in range(L7):
        q, off = divmod(7 * l, 16)
        v = x_lt[q] >> off
        if off > 9 and q + 1 < L:
            v |= x_lt[q + 1] << (16 - off)
        out[l] = v & MASK7
    return out


def _pad8(x: int) -> int:
    return -(-x // 8) * 8


def spot_weights(field: FieldSpec, js: torch.Tensor, k: int,
                 n: int) -> torch.Tensor:
    """int8 limb planes of W[c, j] = omega_n^(c js[j]) (Montgomery), gathered
    on the device from the (n, L) power table, as the product's second
    operand: the transposed view (k8, L7 * t8) of a contiguous
    (L7 * t8, k8) tensor, because on a CUDA device the int8 product is fast
    only with that operand column-major (measured: 0.16 against 0.86 ms a
    product at the 2^20-gate shape).  k and t are padded to multiples of 8
    by zero weights (the product's shape rule there); column b * t8 + j
    holds weight limb b of opened column j."""
    t, dev = js.numel(), js.device
    exps = (js.to(torch.int64)[:, None]
            * torch.arange(k, dtype=torch.int64, device=dev)[None, :]) & (n - 1)
    w_lt = _power_table(field, n, dev)[exps].permute(2, 0, 1).contiguous()
    w7 = torch.zeros((L7, _pad8(t), _pad8(k)), dtype=torch.int8, device=dev)
    limbs16_to_7(w_lt, w7[:, :t, :k])
    return w7.reshape(L7 * _pad8(t), _pad8(k)).t()


def _regroup(cols: torch.Tensor) -> torch.Tensor:
    """(rows, 2 L7 - 1, t8) int32 base-2^7 columns, each < 2^31 ->
    (rows, _WIDE, t8) int64 normalized 16-bit limbs of sum_s cols[s] 2^(7 s):
    column s lands whole in limb 7 s // 16, shifted by 7 s % 16 (at most
    three columns a limb, so below 2^48), then one carry pass."""
    rows, ncols, t8 = cols.shape
    bits = 7 * torch.arange(ncols, dtype=torch.int64, device=cols.device)
    wide = torch.zeros((rows, _WIDE, t8), dtype=torch.int64,
                       device=cols.device)
    wide.index_add_(1, bits // 16, cols.to(torch.int64) << (bits % 16)[:, None])
    for u in range(_WIDE - 1):
        wide[:, u + 1] += wide[:, u] >> 16
        wide[:, u] &= fieldops.MASK
    return wide


def _fold(field: FieldSpec, wide: torch.Tensor, t: int,
          canon_out: bool) -> torch.Tensor:
    """V = lo + hi R + top R^2 in normalized 16-bit limbs -> (rows, t, L)
    limbs of V R^-1 mod p, or V R^-2 with ``canon_out``: one Montgomery
    product per part with the matching power of R, summed mod p."""
    L, p = field.num_limbs, field.p
    x = wide[:, :, :t].permute(0, 2, 1).to(torch.int32)       # (rows, t, W)
    top = torch.zeros(x.shape[:2] + (L,), dtype=torch.int32, device=x.device)
    top[..., :_WIDE - 2 * L] = x[..., 2 * L:]
    first = -1 if canon_out else 0
    out = None
    for i, part in enumerate((x[..., :L], x[..., L:2 * L], top)):
        const = fieldops.const_limbs(field, pow(field.R, first + i, p),
                                     x.device)
        term = cuda_mont.mont_mul(field, part, const)
        out = term if out is None else fieldops.add(field, out, term)
    return out


def _int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(r, k8) int8 x (k8, c8) int8, column-major -> (r, c8) int32, exact.
    On a CUDA device ``torch._int_mm`` wants more than 16 rows: fewer are
    padded."""
    r = a.shape[0]
    if a.device.type == "cuda" and r <= 16:
        pad = torch.zeros((17, a.shape[1]), dtype=torch.int8, device=a.device)
        pad[:r] = a
        return torch._int_mm(pad, b)[:r]
    return torch._int_mm(a, b)


def _spot_chunk(field: FieldSpec, blk: torch.Tensor, w7: torch.Tensor, t: int,
                canon_out: bool) -> torch.Tensor:
    """One block of rows against one chunk of at most K_MAX coefficients:
    (rows, kc, L) Montgomery x (kc8, L7 t8) int8 weights (a slice of
    :func:`spot_weights`) -> (rows, t, L)."""
    rows, kc, L = blk.shape
    kc8, t8 = w7.shape[0], w7.shape[1] // L7
    assert kc <= K_MAX and kc8 == _pad8(kc)
    a7 = torch.zeros((L7, rows, kc8), dtype=torch.int8, device=blk.device)
    limbs16_to_7(blk.permute(2, 0, 1).contiguous(), a7[:, :, :kc])
    cols = torch.zeros((rows, 2 * L7 - 1, t8), dtype=torch.int32,
                       device=blk.device)
    for a in range(L7):
        cols[:, a:a + L7] += _int_mm(a7[a], w7).view(rows, L7, t8)
    del a7
    return _fold(field, _regroup(cols), t, canon_out)


def chunk_bytes_per_row(k: int, t: int, L: int = 16) -> int:
    """Transient bytes :func:`spot_eval` holds per row of a block: the
    limb-major copy and the int8 planes of min(k, K_MAX) coefficients, the
    int32 columns with one product beside them, their int64 regroup (twice:
    the shifted copy and the limbs) and the fold's parts and sums."""
    kc, t8 = _pad8(min(k, K_MAX)), _pad8(t)
    ncols = 2 * L7 - 1
    return (kc * (4 * L + L7)
            + t8 * (4 * (ncols + L7) + 16 * ncols + 16 * _WIDE + 40 * L))


def rows_per_block(rows: int, k: int, t: int, device) -> int:
    """Rows of one block: all of them where half of the device's free
    memory (the caching allocator's spare blocks included) holds their
    transients, else as many as fit, at least 32."""
    if torch.device(device).type != "cuda":
        return rows
    free, _ = torch.cuda.mem_get_info(device)
    free += (torch.cuda.memory_reserved(device)
             - torch.cuda.memory_allocated(device))
    return max(32, min(rows, free // 2 // chunk_bytes_per_row(k, t)))


def spot_eval(field: FieldSpec, coeffs: torch.Tensor, js, n: int,
              canon_out: bool = False) -> torch.Tensor:
    """(rows, k, L) Montgomery coefficient rows (k <= n, zero-extended) x
    column indices ``js`` (t,) -> (rows, t, L) int32 evaluations
    u[row, j] = sum_c coeffs[row, c] omega_n^(c js[j]): Montgomery form,
    bit-equal to the NTT route's, or canonical with ``canon_out``.  The rows
    go in blocks of :func:`rows_per_block`."""
    if not spot_ok(field, n):
        raise ValueError(f"spot_eval: {field.name}, n = {n} is not a shape "
                         "of the spot route")
    rows, k, L = coeffs.shape
    if L != field.num_limbs or not 1 <= k <= n:
        raise ValueError(f"spot_eval: bad coefficients {tuple(coeffs.shape)} "
                         f"for n = {n}")
    dev = coeffs.device
    if not isinstance(js, torch.Tensor):
        js = torch.from_numpy(np.asarray(js, dtype=np.int64))
    js = js.to(device=dev, dtype=torch.int64).reshape(-1)
    t = js.numel()
    out = torch.empty((rows, t, L), dtype=torch.int32, device=dev)
    if rows == 0 or t == 0:
        return out
    if int(js.min()) < 0 or int(js.max()) >= n:
        raise ValueError("spot_eval: a column index lies outside [0, n)")
    w7 = spot_weights(field, js, k, n)
    step = rows_per_block(rows, k, t, dev)
    for r0 in range(0, rows, step):
        blk = coeffs[r0:r0 + step]
        total = None
        for c0 in range(0, k, K_MAX):
            part = _spot_chunk(field, blk[:, c0:c0 + K_MAX],
                               w7[c0:c0 + K_MAX], t, canon_out)
            total = part if total is None else fieldops.add(field, total, part)
        out[r0:r0 + step] = total
    return out


def spot_ref(field: FieldSpec, coeffs: torch.Tensor, js, n: int,
             canon_out: bool = False) -> torch.Tensor:
    """Plain version: every row's full n-point transform
    (:func:`ntt.ntt_ref`), then the columns ``js``."""
    idx = torch.as_tensor(np.asarray(js, dtype=np.int64), device=coeffs.device)
    return ntt_ref(field, coeffs, n, canon_out=canon_out).index_select(1, idx)
