"""Plain prime-field arithmetic for the benchmark's reference check.

Canonical Python ints for scalars and small transforms; numpy arrays of
16-bit limbs (little-endian, the canonical integer) for bulk data; exact
integer dot products on a torch device through float64 matrix products of
limbs (every partial sum an integer below 2**53, so the products are
exact).  Imports nothing of the program under test.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Field:
    """A prime field with a radix-2 domain (ark-ff conventions: the
    Montgomery radix R is 2**(64 * u64 limbs), domains are generated by
    powers of the two-adic root of unity)."""

    p: int
    generator: int
    two_adicity: int

    @property
    def bits(self) -> int:
        return self.p.bit_length()

    @property
    def u64_limbs(self) -> int:
        return (self.bits + 63) // 64

    @property
    def limbs(self) -> int:
        """16-bit limbs of an element."""
        return 4 * self.u64_limbs

    @property
    def byte_size(self) -> int:
        """Bytes of a serialized element (ark ``serialize_compressed``)."""
        return (self.bits + 7) // 8

    @property
    def sponge_bytes(self) -> int:
        """Usable bytes an element gives ``squeeze_bytes``."""
        return (self.bits - 1) // 8

    @property
    def r_inv(self) -> int:
        """R^-1 mod p: a Montgomery form times this is the element."""
        return pow(1 << (64 * self.u64_limbs), -1, self.p)

    def root_of_unity(self, n: int) -> int:
        if n & (n - 1) or n.bit_length() - 1 > self.two_adicity:
            raise ValueError(f"no radix-2 domain of size {n}")
        root = pow(self.generator, (self.p - 1) >> self.two_adicity, self.p)
        return pow(root, 1 << (self.two_adicity - (n.bit_length() - 1)),
                   self.p)

    @classmethod
    def from_config(cls, spec: dict) -> "Field":
        return cls(int(spec["p"]), int(spec["generator"]),
                   int(spec["two_adicity"]))


def ntt(field: Field, coeffs: list[int], n: int) -> list[int]:
    """Evaluations at omega_n^j, j = 0..n-1, of the polynomial with these
    coefficients (at most n of them): iterative radix-2."""
    p = field.p
    a = [c % p for c in coeffs] + [0] * (n - len(coeffs))
    bits = n.bit_length() - 1
    for i in range(n):
        j = int(format(i, f"0{bits}b")[::-1], 2) if bits else 0
        if i < j:
            a[i], a[j] = a[j], a[i]
    size = 2
    while size <= n:
        w_step = field.root_of_unity(size)
        half = size // 2
        ws = [1] * half
        for i in range(1, half):
            ws[i] = ws[i - 1] * w_step % p
        for start in range(0, n, size):
            for i in range(half):
                u = a[start + i]
                v = a[start + i + half] * ws[i] % p
                a[start + i] = (u + v) % p
                a[start + i + half] = (u - v) % p
        size *= 2
    return a


def intt(field: Field, evals: list[int], n: int) -> list[int]:
    """Coefficients of the polynomial of degree < n with these evaluations
    at omega_n^j."""
    p = field.p
    a = ntt(field, evals, n)
    n_inv = pow(n, -1, p)
    # evaluating at omega^-j is evaluating at omega^(n-j)
    return [a[0] * n_inv % p] + [a[n - j] * n_inv % p for j in range(1, n)]


def lagrange_at(field: Field, k: int, z: int) -> list[int]:
    """L_c(z) of the k-point domain {omega_k^c}, for z off the domain:
    (z^k - 1) omega^c / (k (z - omega^c))."""
    p = field.p
    w = field.root_of_unity(k)
    scale = (pow(z, k, p) - 1) * pow(k, -1, p) % p
    points = [1] * k
    for c in range(1, k):
        points[c] = points[c - 1] * w % p
    dens = [(z - x) % p for x in points]
    # one inversion for all denominators
    prefix = [1] * (k + 1)
    for i, d in enumerate(dens):
        prefix[i + 1] = prefix[i] * d % p
    inv = pow(prefix[k], -1, p)
    out = [0] * k
    for i in range(k - 1, -1, -1):
        out[i] = inv * prefix[i] % p * points[i] % p * scale % p
        inv = inv * dens[i] % p
    return out


def horner(field: Field, coeffs: list[int], z: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * z + c) % field.p
    return acc


def ints_to_limbs(field: Field, values) -> np.ndarray:
    """Canonical ints -> (N, L) uint16 limbs."""
    size = 2 * field.limbs
    buf = b"".join(int(v).to_bytes(size, "little") for v in values)
    return np.frombuffer(buf, dtype="<u2").reshape(-1, field.limbs)


def bytes_to_limbs(field: Field, data: bytes, count: int) -> np.ndarray:
    """``count`` serialized elements (``byte_size`` bytes each, little
    endian) -> (count, L) uint16 limbs."""
    size = field.byte_size
    raw = np.frombuffer(data, dtype=np.uint8, count=count * size).reshape(
        count, size)
    padded = np.zeros((count, 2 * field.limbs), np.uint8)
    padded[:, :size] = raw
    return padded.view("<u2")


def exact_dot(a16, b16, device) -> list[list[int]]:
    """[[sum_k A[n, k] B[k, m] for m] for n] as exact Python ints (not
    reduced), for limb arrays a16 (N, K, La) and b16 (K, M, Lb) of values
    below 2**16 (numpy or torch).  One float64 matrix product of the limb
    planes: each product term is below 2**32 and K below 2**13, so every
    partial sum is an integer below 2**45 and exact; the limb diagonals
    then add up to at most La terms (< 2**50)."""
    a = torch.as_tensor(np.asarray(a16, dtype=np.float64) if isinstance(
        a16, np.ndarray) else a16.double()).to(device)
    b = torch.as_tensor(np.asarray(b16, dtype=np.float64) if isinstance(
        b16, np.ndarray) else b16.double()).to(device)
    n, k, la = a.shape
    k2, m, lb = b.shape
    if k != k2 or k >= 1 << 13:
        raise ValueError(f"exact_dot: inner sizes {k} and {k2}")
    c = (a.permute(0, 2, 1).reshape(n * la, k) @ b.reshape(k, m * lb)
         ).reshape(n, la, m, lb)
    d = torch.zeros((n, m, la + lb - 1), dtype=torch.float64, device=device)
    for i in range(la):
        d[:, :, i:i + lb] += c[:, i]
    digits = d.to(torch.int64).cpu().numpy().tolist()
    out = []
    for row in digits:
        vals = []
        for ds in row:
            acc = 0
            for digit in reversed(ds):
                acc = (acc << 16) + digit
            vals.append(acc)
        out.append(vals)
    return out


def normalize_limbs(sums: torch.Tensor) -> torch.Tensor:
    """(N, L) int64 limb sums (each below 2**62) -> (N, L + 3) limbs below
    2**16 of the same integers."""
    n, width = sums.shape
    out = torch.zeros((n, width + 3), dtype=torch.int64, device=sums.device)
    out[:, :width] = sums
    for i in range(width + 2):
        carry = out[:, i] >> 16
        out[:, i] &= 0xFFFF
        out[:, i + 1] += carry
    return out
