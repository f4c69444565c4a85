"""The plain reference check of a Ligero proof of a known witness.

Given the circuit and the witness the benchmark handed the program, and
the proof bytes the program returned, this works out what an honest
non-zk prover (NP-Eng/ligero's protocol, as the benchmark's configurations
state it) must have produced, and counts every disagreement:

* the witness: the circuit evaluated gate by gate, laid out as the four
  solution vectors x | y | z | w of length m k (x, y, z the operands and
  result of every multiplication gate, w every node but the constants
  other than node 0), 4m message rows of k;
* the encode and the commitment: every opened column (4m values) must be
  the Reed-Solomon codeword of the message rows at its point omega_n^j,
  checked for all columns at once against a random combination rho of the
  rows (Freivalds: sum_i rho_i U[i, j] = g(omega_n^j) with g the
  interpolant of rho^T M); its Blake2s leaf (of the column as serialized)
  and its SHA-256 path must lead to the proof's root; its index must be
  the transcript's;
* the transcript: the Poseidon sponge absorbs the root, the three
  revealed polynomials, and squeezes the three ChaCha20 seeds and the
  three index sets, as the protocol orders them;
* the interleaved reveal: every coefficient of lc = r^T M (r the 4m
  challenges), compared exactly;
* the linear reveal q = sum_i r_i(X) u_i(X) (r_i the rows of r_lin^T A,
  A the constraint matrix worked out from the gates, u_i the rows'
  interpolants) and the quadratic reveal p0 = sum_i r_i (x_i y_i - z_i):
  each compared with the honest polynomial at a random point z and by its
  length (Schwartz-Zippel: a wrong polynomial of degree < 2k agrees at z
  with probability below 2k / p).

The root over the unopened columns is tied to the opened ones only by the
Merkle paths, as in any Ligero verifier: recomputing the whole codeword
matrix in plain arithmetic would take longer than the measured window.
``rho`` and ``z`` come from the reference's own generator.  Imports nothing
of the program under test.
"""

from __future__ import annotations

import hashlib
import math
import random
import struct
from dataclasses import dataclass

import numpy as np
import torch

from . import transcript
from .field import (Field, bytes_to_limbs, exact_dot, horner, intt,
                    ints_to_limbs, lagrange_at, normalize_limbs, ntt)

CONST, VAR, ADD, MUL = 0, 1, 2, 3
SEED_BYTES = 32


def calculate_t(field: Field, lambda_: int, rate_inv: int, n: int) -> int:
    """Column openings for soundness 2^-lambda (ark-poly-commit's
    ``calculate_t`` with distance (n - k + 1) / n, evaluated in floats in
    its order)."""
    k = n // rate_inv
    arg = 2.0 ** (-lambda_) - n / (2.0 ** field.bits)
    nom = math.log2(arg) - 1.0
    denom = math.log2(1.0 - 0.5 * (n - k + 1) / n)
    t = math.ceil(nom / denom)
    return min(t, n)


@dataclass
class Circuit:
    """A flat DAG: ``kinds`` (CONST, VAR, ADD, MUL), operand node ids of
    the gates, the constants' values and the output nodes.  Node 0 is the
    constant 1."""

    kinds: np.ndarray
    lefts: np.ndarray
    rights: np.ndarray
    consts: dict
    outputs: list
    var_nodes: list


@dataclass
class Instance:
    """What the reference works out from the circuit once."""

    field: Field
    circuit: Circuit
    m: int
    k: int
    n: int
    t: int
    rows: np.ndarray          # node ids of the w entries, in order
    im: np.ndarray            # node id -> its w index (constants: 0)
    base: int                 # w entries; output constraints follow

    @classmethod
    def build(cls, field: Field, circuit: Circuit, lambda_: int,
              rate_inv: int) -> "Instance":
        kinds = circuit.kinds
        if kinds[0] != CONST or circuit.consts.get(0) != 1:
            raise ValueError("node 0 must be the constant 1")
        num_consts = int((kinds == CONST).sum())
        sol = 1 + len(kinds) - num_consts + len(circuit.outputs)
        m = math.ceil(math.sqrt(sol))
        k = 1 if m <= 1 else 1 << (m - 1).bit_length()
        n = rate_inv * k
        is_row = kinds != CONST
        is_row[0] = True
        im = np.cumsum(is_row, dtype=np.int64) - 1
        im[~is_row] = 0
        return cls(field, circuit, m, k, n,
                   calculate_t(field, lambda_, rate_inv, n),
                   np.flatnonzero(is_row), im, int(is_row.sum()))

    @property
    def num_rows(self) -> int:
        return 4 * self.m

    def evaluate(self, assignment: dict) -> list[int]:
        """Every node's value, in node order."""
        c, p = self.circuit, self.field.p
        vals = [0] * len(c.kinds)
        for node, v in c.consts.items():
            vals[node] = v % p
        for node, v in assignment.items():
            if c.kinds[node] != VAR:
                raise ValueError(f"node {node} is not a variable")
            vals[node] = v % p
        kinds, lefts, rights = (c.kinds.tolist(), c.lefts.tolist(),
                                c.rights.tolist())
        for i, kind in enumerate(kinds):
            if kind == ADD:
                vals[i] = (vals[lefts[i]] + vals[rights[i]]) % p
            elif kind == MUL:
                vals[i] = vals[lefts[i]] * vals[rights[i]] % p
        return vals

    def messages(self, vals: list[int]) -> np.ndarray:
        """(4m, k, L) uint16 limbs of x | y | z | w (canonical values)."""
        c, mk, L = self.circuit, self.m * self.k, self.field.limbs
        node16 = ints_to_limbs(self.field, vals)
        out = np.zeros((4, mk, L), np.uint16)
        out[3, :self.base] = node16[self.rows]
        mul = np.flatnonzero(c.kinds == MUL)
        out[0, self.im[mul]] = node16[c.lefts[mul]]
        out[1, self.im[mul]] = node16[c.rights[mul]]
        out[2, self.im[mul]] = node16[mul]
        return out.reshape(4 * self.m, self.k, L)

    def constraint_entries(self):
        """A's nonzeros as (rows, cols, sign) arrays of the entries worth
        +-1 (sign +1 or -1), and a list of (row, col, value) of any other
        value (constant operands), for A = [[I | -(Px; Py; Pz)], [0 |
        P_add]] over (x; y; z; w), the outputs' constraints in the rows
        past the w entries."""
        c, mk, p = self.circuit, self.m * self.k, self.field.p
        kinds, im = c.kinds, self.im
        rows, cols, signs, other = [], [], [], []

        def operand(ids):
            """(columns, constant?, constants' values) of operand nodes: a
            constant operand is its value on the constant-one column."""
            is_c = kinds[ids] == CONST
            vals = [c.consts[int(i)] % p for i in ids[is_c]]
            return np.where(is_c, 0, im[ids]), is_c, vals

        def add(r, sign, ids):
            colv, is_c, vals = operand(ids)
            keep = ~is_c
            rows.append(r[keep])
            cols.append(3 * mk + colv[keep])
            signs.append(np.full(int(keep.sum()), sign, np.int64))
            for rr, v in zip(r[is_c], vals):
                other.append((int(rr), 3 * mk, v if sign > 0 else (-v) % p))

        def plain(r, cl, sign):
            rows.append(np.asarray(r, np.int64))
            cols.append(np.asarray(cl, np.int64))
            signs.append(np.full(len(rows[-1]), sign, np.int64))

        eye = np.arange(3 * mk, dtype=np.int64)
        plain(eye, eye, 1)
        mul = np.flatnonzero(kinds == MUL)
        adds = np.flatnonzero(kinds == ADD)
        add(im[mul], -1, c.lefts[mul])
        add(mk + im[mul], -1, c.rights[mul])
        plain(2 * mk + im[mul], 3 * mk + im[mul], -1)
        add(3 * mk + im[adds], 1, c.lefts[adds])
        add(3 * mk + im[adds], 1, c.rights[adds])
        plain(3 * mk + im[adds], 3 * mk + im[adds], -1)
        for t, out in enumerate(c.outputs):
            row = self.base + t
            one = np.asarray([out])
            if kinds[out] == MUL:
                add(np.asarray([row]), -1, c.lefts[one])
                add(np.asarray([mk + row]), -1, c.rights[one])
                plain([2 * mk + row], [3 * mk], -1)
            elif kinds[out] == ADD:
                add(np.asarray([3 * mk + row]), 1, c.lefts[one])
                add(np.asarray([3 * mk + row]), 1, c.rights[one])
                plain([3 * mk + row], [3 * mk], -1)
            else:
                raise ValueError("an output must be an add or mul gate")
        return (np.concatenate(rows), np.concatenate(cols),
                np.concatenate(signs), other)


@dataclass
class ParsedProof:
    root: bytes
    lc: list
    sets: list            # per phase: (column byte ranges, limbs, paths)
    q: list
    p0: list


def parse_proof(field: Field, data: bytes, rows: int) -> ParsedProof:
    """The proof's own serialization (u64 LE lengths, canonical LE
    elements); raises ValueError where it is malformed."""
    size, pos = field.byte_size, 0

    def u64():
        nonlocal pos
        if pos + 8 > len(data):
            raise ValueError("truncated")
        (v,) = struct.unpack_from("<Q", data, pos)
        pos += 8
        return v

    def raw():
        nonlocal pos
        ln = u64()
        if pos + ln > len(data):
            raise ValueError("truncated")
        pos += ln
        return data[pos - ln:pos]

    def fvec():
        nonlocal pos
        ln = u64()
        if pos + ln * size > len(data):
            raise ValueError("truncated")
        out = [int.from_bytes(data[pos + i * size:pos + (i + 1) * size],
                              "little") for i in range(ln)]
        pos += ln * size
        return out

    def columns():
        nonlocal pos
        ranges, limbs = [], []
        for _ in range(u64()):
            start = pos
            ln = u64()
            if ln != rows or pos + ln * size > len(data):
                raise ValueError("column of the wrong height")
            limbs.append(bytes_to_limbs(field, data[pos:pos + ln * size], ln))
            pos += ln * size
            ranges.append((start, pos))
        return ranges, limbs

    def paths():
        out = []
        for _ in range(u64()):
            index = u64()
            sibling = raw()
            out.append((index, sibling, [raw() for _ in range(u64())]))
        return out

    root = raw()
    lc = fvec()
    sets = [(*columns(), paths())]
    q = fvec()
    sets.append((*columns(), paths()))
    p0 = fvec()
    sets.append((*columns(), paths()))
    if pos != len(data):
        raise ValueError("trailing bytes")
    return ParsedProof(root, lc, sets, q, p0)


def _path_ok(root: bytes, leaf: bytes, index: int, sibling: bytes,
             auth: list, depth: int) -> bool:
    if len(auth) != depth - 1:
        return False

    def h(a, b):
        return hashlib.sha256(a + b).digest()

    node = h(leaf, sibling) if index % 2 == 0 else h(sibling, leaf)
    index >>= 1
    for s in reversed(auth):
        node = h(node, s) if index % 2 == 0 else h(s, node)
        index >>= 1
    return node == root


def _canonical(field: Field, limbs: np.ndarray) -> np.ndarray:
    """Per element (rows of limbs): whether it is below p."""
    p16 = [(field.p >> (16 * i)) & 0xFFFF for i in range(field.limbs)]
    lt = np.zeros(limbs.shape[:-1], bool)
    decided = np.zeros_like(lt)
    for i in range(field.limbs - 1, -1, -1):
        lt |= ~decided & (limbs[..., i] < p16[i])
        decided |= limbs[..., i] != p16[i]
    return lt


def check_proof(inst: Instance, assignment: dict, proof: bytes,
                draw: random.Random, device) -> dict:
    """Counts of disagreements with the honest proof of ``assignment``:
    {check: count}; all zero for a correct proof."""
    fld, p = inst.field, inst.field.p
    m, k, n, t = inst.m, inst.k, inst.n, inst.t
    rows4 = inst.num_rows
    fails = {name: 0 for name in ("parse", "shape", "canonical", "indices",
                                  "paths", "columns", "lc", "linear",
                                  "quadratic")}
    try:
        pf = parse_proof(fld, proof, rows4)
    except ValueError:
        fails["parse"] = 1
        return fails
    if len(pf.root) != 32 or len(pf.lc) != k:
        fails["shape"] += 1
    for poly in (pf.q, pf.p0):
        if len(poly) > 2 * k - 1 or (poly and poly[-1] == 0):
            fails["shape"] += 1
    fails["canonical"] = sum(v >= p for v in pf.lc + pf.q + pf.p0)
    for _, limbs, paths in pf.sets:
        if len(limbs) != t or len(paths) != t:
            fails["shape"] += 1
        if limbs:
            bad = ~_canonical(fld, np.stack(limbs))
            fails["canonical"] += int(bad.sum())

    # the transcript, as the protocol orders it
    sp = transcript.Sponge(fld)
    sp.absorb_bytes(pf.root)
    seed_int = sp.squeeze_bytes(SEED_BYTES)
    sp.absorb(pf.lc)
    idx = [transcript.column_indices(n, t, sp.squeeze_bytes(SEED_BYTES))]
    seed_lin = sp.squeeze_bytes(SEED_BYTES)
    sp.absorb(pf.q)
    idx.append(transcript.column_indices(n, t, sp.squeeze_bytes(SEED_BYTES)))
    seed_quad = sp.squeeze_bytes(SEED_BYTES)
    sp.absorb(pf.p0)
    idx.append(transcript.column_indices(n, t, sp.squeeze_bytes(SEED_BYTES)))

    depth = n.bit_length() - 1
    for (ranges, _, paths), want in zip(pf.sets, idx):
        if [pt[0] for pt in paths] != want:
            fails["indices"] += 1
        for (start, end), (index, sibling, auth) in zip(ranges, paths):
            leaf = hashlib.blake2s(proof[start:end]).digest()
            if not _path_ok(pf.root, leaf, index, sibling, auth, depth):
                fails["paths"] += 1

    # the honest message rows, on the device as float64 limb planes
    vals = inst.evaluate(assignment)
    msg = torch.from_numpy(inst.messages(vals).astype(np.int32)).to(
        device).double()
    rho = [draw.randrange(p) for _ in range(rows4)]
    r_int = transcript.rand_raw16(fld, rows4, seed_int, device)
    both = torch.stack([r_int.double(), torch.from_numpy(
        ints_to_limbs(fld, rho).astype(np.int32)).to(device).double()])
    lc_raw, g = exact_dot(both, msg, device)
    r_inv = fld.r_inv
    fails["lc"] = sum((raw * r_inv - got) % p != 0
                      for raw, got in zip(lc_raw, pf.lc + [0] * k))
    g_evals = ntt(fld, intt(fld, [v % p for v in g], k), n)
    rho16 = both[1:2]
    for (_, limbs, paths), _want in zip(pf.sets, idx):
        if not limbs:
            continue
        cols = torch.from_numpy(np.stack(limbs).astype(np.int32)).to(device)
        sums = exact_dot(rho16, cols.permute(1, 0, 2).double(), device)[0]
        for s, (index, _, _) in zip(sums, paths):
            if index >= n or s % p != g_evals[index]:
                fails["columns"] += 1
        del cols

    # u_i(z) of every row, and r_lin's rows at z
    z = draw.randrange(p)
    while pow(z, k, p) == 1:
        z = draw.randrange(p)
    lz = torch.from_numpy(ints_to_limbs(fld, lagrange_at(fld, k, z)).astype(
        np.int32)).to(device).double()[:, None, :]
    uz = [v % p for (v,) in exact_dot(msg, lz, device)]
    del msg, both
    rz = _r_lin_at(inst, seed_lin, lz, device)
    q_honest = sum(a * b for a, b in zip(rz, uz)) * r_inv % p
    fails["linear"] = int(horner(fld, pf.q, z) != q_honest)
    r_quad = transcript.rand_raw16(fld, m, seed_quad, device)
    rq = [int(sum(int(v) << (16 * i) for i, v in enumerate(row)))
          for row in r_quad.cpu().tolist()]
    p0_honest = sum(r * (uz[i] * uz[m + i] - uz[2 * m + i])
                    for i, r in enumerate(rq)) % p * r_inv % p
    fails["quadratic"] = int(horner(fld, pf.p0, z) != p0_honest)
    return fails


def _r_lin_at(inst: Instance, seed: bytes, lz: torch.Tensor,
              device) -> list[int]:
    """R times r_i(z) for every row i of r_lin^T A (r_i the interpolant of
    row i on the k-domain), r_lin the 4mk challenges (raw, Montgomery
    form), as ints mod p: the +-1 entries of A summed as limbs on the
    device, the rest on the host."""
    fld, p, k = inst.field, inst.field.p, inst.k
    count = 4 * inst.m * k
    r = transcript.rand_raw16(fld, count, seed, device)
    rows, cols, signs, other = inst.constraint_entries()
    rows_t = torch.from_numpy(rows).to(device)
    cols_t = torch.from_numpy(cols).to(device)
    signs_t = torch.from_numpy(signs).to(device)
    out = [0] * (4 * inst.m)
    for sign in (1, -1):
        sums = torch.zeros((count, fld.limbs), dtype=torch.int64,
                           device=device)
        pick = torch.nonzero(signs_t == sign).flatten()
        step = 1 << 22
        for s in range(0, len(pick), step):
            e = pick[s:s + step]
            sums.index_add_(0, cols_t[e], r.index_select(0, rows_t[e]))
        norm = normalize_limbs(sums).reshape(4 * inst.m, k, -1)
        del sums
        for i, (v,) in enumerate(exact_dot(norm, lz, device)):
            out[i] += sign * v
        del norm
    if other:
        lzi = [int(sum(int(d) << (16 * j) for j, d in enumerate(row)))
               for row in lz[:, 0, :].to(torch.int64).cpu().tolist()]
        for row, col, val in other:
            raw = int(sum(int(d) << (16 * j) for j, d in
                          enumerate(r[row].cpu().tolist())))
            out[col // k] += val * raw * lzi[col % k]
    return [v % p for v in out]
