"""Circuit compile: an arithmetic circuit -> a :class:`CompiledInstance`.

The host half of ``ligero_tpu/ligero/core.py`` (``LigeroCircuit.__init__``
and its helpers), as functions: normalise the circuit so node 0 is the
constant 1, compute the matrix dimensions (m, k), the Reed-Solomon
parameters (n = rate_inv * k, t), the zk parameters, and the constraint
matrix A = [[I | -(P_x; P_y; P_z)], [0 | P_add]] as COO arrays.  All host
work on Python ints and numpy; nothing here touches a device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..circuit.arithmetic import ADD, CONST, MUL, ArithmeticCircuit
from ..fields import FieldSpec
from ..matrices import CooMatrix

DEFAULT_SECURITY_LEVEL = 128
CHACHA_SEED_BYTES = 32


@dataclass
class CompiledInstance:
    """Everything the prover and verifier need of one compiled circuit."""
    field: FieldSpec
    circuit: ArithmeticCircuit       # normalised: node 0 is the constant 1
    outputs: list[int]               # indices into ``circuit.nodes``
    one_index: int                   # where the caller's circuit held 1
    one_found: bool
    rate_inv: int
    m: int
    k: int
    n: int
    t: int
    zk: bool
    blind_t: int                     # b = 3t blinding coefficients (0: non-zk)
    d2: int                          # product-polynomial evaluation domain
    a_rows: np.ndarray               # int64 COO row ids (4mk x 4mk matrix)
    a_cols: np.ndarray               # int64 COO column ids
    a_vals: list[int]                # canonical values

    @property
    def blind_len(self) -> int:
        """Coefficient width of a committed data row: k + b."""
        return self.k + self.blind_t

    @property
    def num_rows(self) -> int:
        """Committed rows: 4m data rows, plus three mask rows under zk."""
        return 4 * self.m + (3 if self.zk else 0)

    @property
    def lin_bound(self) -> int:
        """The verifier rejects deg(q) >= this."""
        return 2 * self.k + self.blind_t - 1

    @property
    def quad_bound(self) -> int:
        """The verifier rejects deg(p0) >= this."""
        return 2 * self.blind_len - 1

    def bump_index(self, index: int) -> int:
        """A node index of the caller's circuit -> the normalised circuit."""
        return bump_index(index, self.one_index, self.one_found)


def calculate_t(field: FieldSpec, sec_param: int, distance: tuple[int, int],
                codeword_len: int) -> int:
    """Number of column openings (ark-poly-commit ``calculate_t``).

    Smallest t with (1-d)^t + (rho+d)^t + n/|F| <= 2^-lambda, with
    d = (1-rho)/2; float evaluation order mirrors the pinned Rust source
    (HungryCatsStudio/poly-commit branch release-0.5).
    """
    field_bits = field.modulus_bit_size
    residual = codeword_len / (2.0 ** field_bits)
    arg = 2.0 ** (-sec_param) - residual
    if arg <= 0.0 or not math.isfinite(arg):
        raise ValueError("field too small for the requested security level")
    rhs = math.log2(arg)
    nom = rhs - 1.0
    denom_arg = 1.0 - 0.5 * distance[0] / distance[1]
    if denom_arg <= 0.0:
        raise ValueError("invalid distance")
    denom = math.log2(denom_arg)
    t = math.ceil(nom / denom)
    return t if t < codeword_len else codeword_len

def bump_index(index: int, one_index: int, one_found: bool) -> int:
    if one_found:
        if index < one_index:
            return index + 1
        if index == one_index:
            return 0
        return index
    return index + 1


def clone_circuit(c: ArithmeticCircuit) -> ArithmeticCircuit:
    clone = ArithmeticCircuit(c.field)
    clone.nodes = list(c.nodes)
    clone.constants = dict(c.constants)
    clone.variables = dict(c.variables)
    return clone


def insert_one(circuit: ArithmeticCircuit, one_index: int,
               one_found: bool) -> None:
    """Move (or insert) the constant 1 to node 0 and renumber, in place."""
    if one_found:
        circuit.nodes.pop(one_index)
    circuit.nodes.insert(0, (CONST, 1))

    def bump(i):
        return bump_index(i, one_index, one_found)

    circuit.nodes = [
        (n[0], bump(n[1]), bump(n[2])) if n[0] in (ADD, MUL) else n
        for n in circuit.nodes]
    circuit.constants = {v: bump(i) for v, i in circuit.constants.items()}
    circuit.constants[1] = 0
    circuit.variables = {s: bump(i) for s, i in circuit.variables.items()}


def compute_dimensions(sol_vec_length: int) -> tuple[int, int]:
    m = math.ceil(math.sqrt(sol_vec_length))
    k = 1 if m <= 1 else 1 << (m - 1).bit_length()
    return m, k


def zk_parameters(k: int, n: int, t: int, zk: bool) -> tuple[int, int]:
    """(blind_t, d2).  Under zk each row's codeword polynomial is blinded
    by (x^k - 1) s_i with s_i random of degree < b = 3t (the three column
    openings are independent, so up to 3t distinct columns get revealed),
    and the product polynomials (deg p0 <= 2(k + b) - 2) are evaluated on
    the d2 domain; without zk b = 0 and d2 = 2k."""
    if not zk:
        return 0, 2 * k
    b = 3 * t
    d2 = max(2 * k, 1 << (2 * (k + b) - 2).bit_length())
    if t > n - k or d2 > n or k + b > n:
        raise ValueError(
            "circuit too small for zk at this rate: need t <= n - k "
            f"and next_pow2(2(k+3t)) <= n (k={k}, n={n}, t={t})")
    return b, d2


def generate_matrices_coo(field: FieldSpec, circuit: ArithmeticCircuit,
                          outputs: list[int], num_cols: int) -> CooMatrix:
    """A = [[I | -(Px;Py;Pz)], [0 | P_add]] assembled directly as COO.

    ``outputs`` are indices into the normalised ``circuit``; numpy index
    arithmetic over the node arrays, no per-row Python lists.  Entry order
    is unspecified: every consumer reduces with exact mod-p sums.
    """
    p = field.p
    nodes = circuit.nodes
    nn = len(nodes)
    K_OTHER, K_ADD, K_MUL, K_CONST = 0, 1, 2, 3
    kinds = np.zeros(nn, np.int8)
    lefts = np.zeros(nn, np.int64)
    rights = np.zeros(nn, np.int64)
    for i, nd in enumerate(nodes):
        k0 = nd[0]
        if k0 == ADD:
            kinds[i], lefts[i], rights[i] = K_ADD, nd[1], nd[2]
        elif k0 == MUL:
            kinds[i], lefts[i], rights[i] = K_MUL, nd[1], nd[2]
        elif k0 == CONST:
            kinds[i] = K_CONST
    is_row = kinds != K_CONST
    is_row[0] = True  # node 0 (the constant 1) owns solution column 0
    im = np.cumsum(is_row, dtype=np.int64) - 1
    im[~is_row] = 0  # const operands land on the constant-one column

    def operand_cols_vals(ids):
        """(cols, vals) for one operand side: (1, im[id]) for gate
        operands, (const_value, 0) for constant operands — as the JAX
        package's ``_generate_matrices`` lays them out."""
        cols = im[ids]
        vals = [1] * len(ids)
        for j in np.where(kinds[ids] == K_CONST)[0]:
            vals[j] = nodes[int(ids[j])][1]
        return cols, vals

    mi = np.where(kinds == K_MUL)[0]
    ai = np.where(kinds == K_ADD)[0]
    x_cols, x_vals = operand_cols_vals(lefts[mi])
    y_cols, y_vals = operand_cols_vals(rights[mi])
    l_cols, l_vals = operand_cols_vals(lefts[ai])
    r_cols, r_vals = operand_cols_vals(rights[ai])
    x_rows, a_rows = im[mi], im[ai]

    # output rows: one extra constraint per output (== 1 via column 0)
    base = int(is_row.sum())
    ox_rows, ox_cols, ox_vals = [], [], []   # Px/Py/Pz output entries
    oy_cols, oy_vals = [], []
    oa_rows, oa_cols, oa_vals = [], [], []   # P_add output entries
    for t, out in enumerate(outputs):
        nd = nodes[out]
        lc, lv = operand_cols_vals(np.asarray([nd[1]]))
        rc, rv = operand_cols_vals(np.asarray([nd[2]]))
        if nd[0] == MUL:
            ox_rows.append(base + t)
            ox_cols.append(int(lc[0])); ox_vals.append(lv[0])
            oy_cols.append(int(rc[0])); oy_vals.append(rv[0])
        elif nd[0] == ADD:
            oa_rows.extend([base + t] * 3)
            oa_cols.extend([int(lc[0]), int(rc[0]), 0])
            oa_vals.extend([lv[0], rv[0], (-1) % p])
        else:
            raise ValueError("output node must be an Add or Mul gate")

    mk = num_cols
    p1 = p - 1

    def neg(vals):
        return [p1 if v == 1 else (p - v) % p for v in vals]

    seg_r, seg_c, seg_v = [], [], []

    def add_seg(rows_, cols_, vals_):
        seg_r.append(np.asarray(rows_, np.int64))
        seg_c.append(np.asarray(cols_, np.int64))
        seg_v.append(vals_)

    # identity block
    eye = np.arange(3 * mk, dtype=np.int64)
    add_seg(eye, eye, [1] * (3 * mk))
    off = 3 * mk
    # -Px / -Py (mul operand entries + output-mul entries)
    add_seg(np.concatenate([x_rows, np.asarray(ox_rows, np.int64)]),
            off + np.concatenate([x_cols, np.asarray(ox_cols, np.int64)]),
            neg(x_vals) + neg(ox_vals))
    add_seg(mk + np.concatenate([x_rows, np.asarray(ox_rows, np.int64)]),
            off + np.concatenate([y_cols, np.asarray(oy_cols, np.int64)]),
            neg(y_vals) + neg(oy_vals))
    # -Pz: (1, im[i]) per mul; (1, 0) per output mul — negated
    add_seg(2 * mk + np.concatenate([x_rows, np.asarray(ox_rows, np.int64)]),
            off + np.concatenate([im[mi], np.zeros(len(ox_rows), np.int64)]),
            [p1] * (len(mi) + len(ox_rows)))
    # P_add (not negated): left + right + (-1, im[i]) per add, + outputs
    add_seg(3 * mk + np.concatenate([a_rows, a_rows, a_rows,
                                     np.asarray(oa_rows, np.int64)]),
            off + np.concatenate([l_cols, r_cols, im[ai],
                                  np.asarray(oa_cols, np.int64)]),
            l_vals + r_vals + [p1] * len(ai) + oa_vals)

    rows_idx = np.concatenate(seg_r)
    cols_idx = np.concatenate(seg_c)
    vals: list = []
    for v in seg_v:
        vals.extend(v)
    return CooMatrix(field, 4 * mk, 4 * mk, rows_idx, cols_idx, vals)


def compile_circuit(circuit: ArithmeticCircuit, outputs: list[int],
                    lambda_: int = DEFAULT_SECURITY_LEVEL, rate_inv: int = 8,
                    zk: bool = False) -> CompiledInstance:
    """``LigeroCircuit::new``: the whole host compile of one circuit."""
    field = circuit.field
    if rate_inv < 2 or rate_inv & (rate_inv - 1):
        raise ValueError("rate_inv must be a power of two >= 2")
    one_index = circuit.constants.get(1)
    one_found = one_index is not None
    if not one_found:
        one_index = 1
    circuit = clone_circuit(circuit)
    if one_index != 0:
        insert_one(circuit, one_index, one_found)

    sol_vec_length = (1 + circuit.num_nodes() - circuit.num_constants()
                      + len(outputs))
    m, k = compute_dimensions(sol_vec_length)
    n = rate_inv * k
    t = calculate_t(field, lambda_, (n - k + 1, n), n)
    blind_t, d2 = zk_parameters(k, n, t, zk)
    outputs = [bump_index(i, one_index, one_found) for i in outputs]
    a = generate_matrices_coo(field, circuit, outputs, m * k)
    if (n.bit_length() - 1) > field.two_adicity:
        raise ValueError(f"field cannot accommodate FFT of size {n}")
    rows, cols, vals = a.to_coo()
    return CompiledInstance(
        field=field, circuit=circuit, outputs=outputs, one_index=one_index,
        one_found=one_found, rate_inv=rate_inv, m=m, k=k, n=n, t=t, zk=zk,
        blind_t=blind_t, d2=d2, a_rows=np.asarray(rows, dtype=np.int64),
        a_cols=np.asarray(cols, dtype=np.int64), a_vals=list(vals))
