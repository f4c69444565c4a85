"""The chip's peaks and the work a kernel has to do, frozen for the benchmark.

Copied from ``chip_smoke.py`` (its rates, ``ntt_products``, ``ntt_work``,
``blake2s_work``, ``mont_mul_ops`` and the Blake2s block count), with the
field given by its number of 16-bit limbs L: later changes to the smoke do
not move the benchmark's rooflines.

NVIDIA H100 SXM data sheet: the device memory rate; the 32-bit integer
rate taken as a quarter of the 67 TFLOP/s float32 figure (two operations
per FMA on 128 lanes an SM; integer has 64 lanes, one each), the rate of
the multiply-adds of the Montgomery products; the issue rate, half the
float32 figure, bounds work of adds, logic and rotations alone (the
hashes).  A Blake2s block is 10 rounds x 8 G x 12 operations (two
three-input adds, two adds, four XORs, four rotations) and 8 that fold the
state.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 16.75e12
INT32_ISSUE_PER_S = 33.5e12
BLAKE2S_BLOCK_OPS = 10 * 8 * 12 + 8


def bound_s(nbytes: float, ops: float,
            ops_per_s: float = INT32_OPS_PER_S) -> float:
    """The least seconds the card could take for work that moves ``nbytes``
    and does ``ops`` 32-bit integer operations at ``ops_per_s``."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)


def elem_bytes(limbs: int) -> int:
    """Bytes of one element at a kernel's boundary: L int32 limbs."""
    return 4 * limbs


def mont_mul_ops(limbs: int) -> int:
    """32-bit operations of one W-word CIOS Montgomery product (W = L/2):
    2 W^2 multiply-adds with their carries and ~4 W more."""
    w = limbs // 2
    return 2 * w * w + 4 * w


def ntt_products(w: int, n: int, epilogue: bool) -> int:
    """Montgomery products a row of a transform needs, w-wide rows
    zero-extended to n: c = n / s transforms of s points (s the least power
    of two >= w), each s/2 log2 s butterflies less the s - 1 whose twiddle
    is one, plus the twist of the w inputs of every coset, which coset 0
    skips where there is no output constant (``epilogue``: n^-1 or
    from-Montgomery) to fold in."""
    s = 1 << (w - 1).bit_length()
    c = n // s
    butterflies = (s // 2) * (s.bit_length() - 1) - (s - 1)
    return c * butterflies + w * (c if epilogue else c - 1)


def ntt_work(limbs: int, rows: int, w: int, n: int,
             epilogue: bool) -> tuple[int, int]:
    """(bytes, operations) of a batched NTT: w-wide rows and the twiddles
    in, n-wide rows out."""
    elem = elem_bytes(limbs)
    return (rows * (w + n) * elem + (n // 2) * elem // 2,
            rows * ntt_products(w, n, epilogue) * mont_mul_ops(limbs))


def blake2s_work(limbs: int, rows: int, cols: int) -> tuple[int, int]:
    """(bytes, operations) of the column hash of a rows x cols matrix: the
    8-byte length and 2 L bytes an element, 64 bytes a block; the matrix
    read once, 32 bytes a digest written."""
    blocks = -(-(8 + 2 * limbs * rows) // 64)
    return (rows * cols * elem_bytes(limbs) + cols * 32,
            cols * blocks * BLAKE2S_BLOCK_OPS)
