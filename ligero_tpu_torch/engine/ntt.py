"""Radix-2 NTT twiddle tables, the plain PyTorch transform, and the route
plan of the CUDA kernel with its plain "structure twin".

The counterpart of ``ligero_tpu.engine.ntt`` (``NTTPlan``/``DomainOps``):
ark-poly ``Radix2EvaluationDomain`` semantics, domain generator
``omega = TWO_ADIC_ROOT^(2^(s - log2 n))``, natural-order evaluations, and
``1/n`` scaling on the inverse.  :func:`ntt_ref` is the plain version the
CUDA kernel (``cuda_ntt``) is held against: a bit-reversed gather and
``log2 n`` Cooley-Tukey stages over whole row blocks.

:func:`ntt_plan` decides, from (w, n, tile limit) alone, how the kernel
decomposes a transform (one shared-memory pass, cosets of the zero-extended
input, two passes with one packed intermediate, global stages for what two
passes cannot hold).  :func:`ntt_structured` computes the transform by that
same decomposition in plain PyTorch, index map for index map, so that the
CPU tests reach everything of the kernel but its CUDA.
"""

from __future__ import annotations

import dataclasses
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


def _pad_rows(rows: torch.Tensor, n: int) -> torch.Tensor:
    B, w, L = rows.shape
    if w == n:
        return rows
    return torch.cat([rows, torch.zeros((B, n - w, L), dtype=rows.dtype,
                                        device=rows.device)], dim=1)


def _dit_stages(field: FieldSpec, y: torch.Tensor, tw_of_stage, first: int,
                last: int) -> torch.Tensor:
    """Cooley-Tukey stages ``first`` .. ``last - 1`` over (B, n, L) rows in
    bit-reversed block order; ``tw_of_stage(s)`` gives stage s's (2^s, L)
    twiddles omega_{2^(s+1)}^pos."""
    B, n, L = y.shape
    for s in range(first, last):
        half = 1 << s
        v = y.reshape(B, n // (2 * half), 2, half, L)
        lo, hi = v[:, :, 0], v[:, :, 1]
        t = fieldops.mont_mul(field, hi, tw_of_stage(s))
        y = torch.stack([fieldops.add(field, lo, t), fieldops.sub(field, lo, t)],
                        dim=2).reshape(B, n, L)
    return y


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
    rows = _pad_rows(x.reshape(-1, w, L), n)
    perm = torch.from_numpy(bitrev_permutation(n)).to(rows.device)
    y = rows.index_select(1, perm).to(torch.int32)
    tw = twiddles(field, n, inverse, y.device)
    y = _dit_stages(
        field, y,
        lambda s: tw[torch.arange(1 << s, device=y.device) << (logn - 1 - s)],
        0, logn)
    c = epilogue_const(field, n, inverse, canon_out)
    if c is not None:
        y = fieldops.mont_mul(field, y, fieldops.const_limbs(field, c, y.device))
    return y.reshape(*lead, n, L)


# ---------------------------------------------------------------------------
# the CUDA kernel's decomposition: plan, tables, and the plain twin
# ---------------------------------------------------------------------------

#: log2 of the most elements one block of the kernel holds in shared memory
#: (4096 packed elements, 128 KB of the 227 KB a block may use)
TILE_LOG = 12
#: log2 of the tile the kernel fills when the sub-transforms are shorter
#: (2048 elements, 64 KB: two blocks to an SM)
GROUP_TILE_LOG = 11


@dataclasses.dataclass(frozen=True)
class NttRoute:
    """How the kernel computes an n-point transform of w-wide rows.

    The input is split into c = 2^lc cosets: X[c q + r] = NTT_s(x[i]
    omega_n^(i r))[q] with s = 2^ls = n / c >= w, so the zero extension
    costs nothing.  Each s-point transform is one shared-memory pass
    (``l0 = l1 = 0``), or two passes over s = n1 n2 (``l1``, ``l2``) with one
    packed intermediate, or, where s exceeds the square of the tile limit,
    2^l0 interleaved two-pass transforms joined by ``l0`` global stages."""
    name: str   # "one-pass" | "coset" | "two-pass" | "two-pass+stages"
    logn: int
    lc: int
    l0: int
    l1: int
    l2: int

    @property
    def ls(self) -> int:
        return self.logn - self.lc

    def scratch_elements(self, rows: int) -> int:
        """Packed (32-byte) elements of scratch the route allocates."""
        return 0 if self.l1 == 0 else rows << self.logn

    def group_log(self, sub_log: int, avail_log: int,
                  tile_log: int = TILE_LOG) -> int:
        """log2 of the sub-transforms one block takes side by side: as many
        of the ``2^avail_log`` neighbours as fill the tile."""
        return max(0, min(avail_log, min(tile_log, GROUP_TILE_LOG) - sub_log))


#: a batch whose one-pass tiles number at most this many leaves the card
#: idle (a tile is one block on one SM): it is split further
LONE_TILES = 4


def tile_log_for(rows: int | None, w: int, n: int) -> int:
    """The tile limit the kernel is given: its own, or, for a batch of so
    few rows that one-pass tiles would occupy at most ``LONE_TILES`` SMs
    (the protocol's single-row polynomials), the square root of the
    sub-transform, so that two passes of many small blocks spread the work
    over the card."""
    ls = (w - 1).bit_length()
    if rows is None or ls < 8:
        return TILE_LOG
    if rows * (n >> ls) > LONE_TILES:
        return TILE_LOG
    return min((ls + 1) // 2, TILE_LOG)


def ntt_plan(w: int, n: int, tile_log: int = TILE_LOG) -> NttRoute:
    """The kernel's route for w-wide rows and an n-point transform under a
    tile limit: a pure function of (w, n, tile limit)."""
    if n < 2 or n & (n - 1) or not 1 <= w <= n or tile_log < 1:
        raise ValueError(f"ntt_plan: bad shape w = {w}, n = {n}, "
                         f"tile_log = {tile_log}")
    logn = n.bit_length() - 1
    ls = (w - 1).bit_length()          # s = the least power of two >= w
    lc = logn - ls
    if ls <= tile_log:
        return NttRoute("coset" if lc else "one-pass", logn, lc, 0, 0, ls)
    if ls <= 2 * tile_log:
        l2 = (ls + 1) // 2
        return NttRoute("two-pass", logn, lc, 0, ls - l2, l2)
    return NttRoute("two-pass+stages", logn, lc, ls - 2 * tile_log, tile_log,
                    tile_log)


@functools.lru_cache(maxsize=None)
def stage_twiddle_limbs(field_name: str, size: int, inverse: bool) -> np.ndarray:
    """Stage-major twiddles as (size, L) uint32 Montgomery limbs: entry
    [h + pos] = omega_{2h}^pos for every power of two h < size and pos < h
    (omega^-1 for an inverse); entry 0 is one.  A stage's twiddles are
    contiguous, and the table of a smaller size is a prefix of a larger
    one's."""
    if size <= 1:
        return FIELDS[field_name].ints_to_mont_limbs([1])
    powers = twiddle_limbs(field_name, size, inverse)     # omega_size^j
    idx = np.zeros(size, dtype=np.int64)
    h = 1
    while h < size:
        idx[h:2 * h] = np.arange(h, dtype=np.int64) * (size // (2 * h))
        h *= 2
    return powers[idx]


def twist_const(field: FieldSpec, n: int, inverse: bool,
                canon_out: bool) -> int:
    """K of the twist table omega^e K: the epilogue constant folded into
    the input twist (the transform is linear), R where there is none, so
    that REDC(x omega^e K) is x omega^e times the epilogue's factor."""
    c = epilogue_const(field, n, inverse, canon_out)
    return field.R % field.p if c is None else c


@functools.lru_cache(maxsize=16)
def twist_limbs(field_name: str, n: int, inverse: bool, k: int) -> np.ndarray:
    """omega_n^e k mod p for e < n (omega^-1 for an inverse) as (n, L)
    uint32 limbs of the plain integer."""
    field = FIELDS[field_name]
    omega = field.root_of_unity(n)
    if inverse:
        omega = pow(omega, -1, field.p)
    vals, cur = [], k % field.p
    for _ in range(n):
        vals.append(cur)
        cur = cur * omega % field.p
    return field.ints_to_limbs(vals)


def _dif_tile(field: FieldSpec, y: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The kernel's in-tile transform of (..., s, L): Gentleman-Sande stages
    from the widest down on natural-order input, stage-major twiddles, no
    product in the last stage (its twiddle is one), and the bit reversal on
    the way out.  No 1/s scale."""
    s, L = y.shape[-2], y.shape[-1]
    lead = y.shape[:-2]
    tws = torch.from_numpy(
        stage_twiddle_limbs(field.name, s, inverse).astype(np.int32)).to(y.device)
    h = s // 2
    while h >= 1:
        v = y.reshape(*lead, s // (2 * h), 2, h, L)
        a, b = v[..., 0, :, :], v[..., 1, :, :]
        d = fieldops.sub(field, a, b)
        if h > 1:
            d = fieldops.mont_mul(field, d, tws[h:2 * h])
        y = torch.stack([fieldops.add(field, a, b), d], dim=-3).reshape(
            *lead, s, L)
        h //= 2
    perm = torch.from_numpy(bitrev_permutation(s)).to(y.device)
    return y.index_select(-2, perm)


def ntt_structured(field: FieldSpec, x: torch.Tensor, n: int,
                   inverse: bool = False, canon_out: bool = False,
                   tile_log: int = TILE_LOG) -> torch.Tensor:
    """:func:`ntt_ref`'s function computed the kernel's way (see
    :class:`NttRoute`): coset twist with the epilogue folded in, s-point
    sub-transforms, the two-pass index maps and twiddle, the interleaved
    store.  Plain PyTorch, any device; bit-equal to :func:`ntt_ref`."""
    check_size(field, n)
    L = field.num_limbs
    lead, w = x.shape[:-2], x.shape[-2]
    if w > n:
        raise ValueError(f"ntt_structured: {w} input columns exceed n = {n}")
    rows = x.reshape(-1, w, L).to(torch.int32)
    B, dev = rows.shape[0], rows.device
    rt = ntt_plan(w, n, tile_log)
    c, s = 1 << rt.lc, 1 << rt.ls
    n0, n1, n2 = 1 << rt.l0, 1 << rt.l1, 1 << rt.l2

    def table(k):
        return torch.from_numpy(
            twist_limbs(field.name, n, inverse, k).astype(np.int32)).to(dev)

    k_epi = twist_const(field, n, inverse, canon_out)
    k_one = field.R % field.p
    i = torch.arange(w, device=dev)
    r = torch.arange(c, device=dev)
    two_pass = rt.l1 > 0
    # the coset twist: with one pass it carries the epilogue; with two the
    # second pass's twiddle does, and a lone coset needs no twist at all
    y = rows[:, None].expand(B, c, w, L)
    k_first = k_one if two_pass else k_epi
    if c > 1 or k_first != k_one:
        y = fieldops.mont_mul(field, y,
                              table(k_first)[(r[:, None] * i[None, :]) % n])
    y = _pad_rows(y.reshape(B * c, w, L), s).reshape(B, c, s, L)
    if not two_pass:
        big = _dif_tile(field, y, inverse)                       # (B, c, s)
    else:
        # i = i0 + n0 (i1 + n1 i2): pass 1 transforms over i2
        v = y.reshape(B, c, n2, n1, n0, L).permute(0, 1, 4, 3, 2, 5)
        z = _dif_tile(field, v, inverse)            # (B, c, i0, i1, k2)
        e = (torch.arange(n1, device=dev)[:, None]
             * torch.arange(n2, device=dev)[None, :] << (rt.lc + rt.l0)) % n
        z = fieldops.mont_mul(field, z, table(k_epi)[e])
        # pass 2 transforms over i1; outputs land at k2 + n2 k1
        v = _dif_tile(field, z.transpose(3, 4), inverse)   # (.., i0, k2, k1)
        v = v.transpose(3, 4).reshape(B, c, n0, n1 * n2, L)
        if rt.l0:
            perm = torch.from_numpy(bitrev_permutation(n0)).to(dev)
            v = v.index_select(2, perm).reshape(B * c, s, L)
            tws = torch.from_numpy(stage_twiddle_limbs(
                field.name, s, inverse).astype(np.int32)).to(dev)
            v = _dit_stages(field, v, lambda st: tws[1 << st:2 << st],
                            rt.l1 + rt.l2, rt.ls)
        big = v.reshape(B, c, s, L)
    # X[c q + r] = coset r's output q
    return big.transpose(1, 2).reshape(*lead, n, L)
