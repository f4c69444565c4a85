"""The Ligero SNARK's prover and verifier, plain and zk, on a PyTorch device.

The port's counterpart of ``LigeroCircuit`` in ``ligero_tpu/ligero/core.py``
for the single-device path with the default commitment (Blake2s column
leaves, SHA-256 Merkle tree) in "direct" mode: the whole codeword matrix U
lives on ``device`` as one tensor.  The host keeps what the JAX package
keeps on the host: the circuit compile (``compile``), witness evaluation
(``witness``), the Fiat-Shamir transcript (Poseidon sponge), Merkle paths
and column hashes of the opened columns.  Every bulk step runs through
:class:`TorchBackend`.

zk mode (``zk=True``; an extension of the JAX package, the Rust reference
is non-zk): every data row's codeword polynomial is blinded by
``(x^k - 1) s_i`` with s_i random of degree < b = 3t, which vanishes on the
embedded message domain, so the constraint system is untouched and any
<= 3t opened off-domain columns are uniform; three extra committed mask
rows one-time-pad the three revealed objects (interleaved lc, linear q,
quadratic p0); column sampling avoids the k message-domain points.

Proofs are byte-identical to the JAX package's (for the same ``zk_seed``
under zk): the Fiat-Shamir order is the bit-exactness contract, and every
absorb/squeeze below carries the JAX package's annotation (FS #1-#10).
"""

from __future__ import annotations

import hashlib
import secrets

import numpy as np
import torch

from ..engine.backend import TorchBackend
from ..hashes import column_hash
from ..merkle import MerkleTree
from ..sampling import (
    get_distinct_indices_excluding,
    get_distinct_indices_from_prng,
    rand_field_elements,
    rand_field_elements_limbs,
)
from ..utils.profiling import PhaseTimer
from .compile import (CHACHA_SEED_BYTES, DEFAULT_SECURITY_LEVEL,
                      CompiledInstance, compile_circuit)
from .proof import (
    InterleavedProof,
    LigeroProof,
    LinearConstraintsProof,
    QuadraticConstraintsProof,
)
from .witness import WitnessEvaluator


def _trim(coeffs: list[int]) -> list[int]:
    """ark DensePolynomial invariant: no trailing zero coefficients."""
    end = len(coeffs)
    while end > 0 and coeffs[end - 1] == 0:
        end -= 1
    return coeffs[:end]


def _poly_degree(coeffs: list[int]) -> int:
    return max(len(coeffs) - 1, 0)


def _add_mask(values: list[int], mask: list[int] | None, p: int) -> list[int]:
    """values + mask coefficient-wise mod p (mask no longer than values);
    values unchanged without a mask."""
    if mask is None:
        return values
    return [(a + (mask[i] if i < len(mask) else 0)) % p
            for i, a in enumerate(values)]


class LigeroCircuit:
    """Compiled Ligero instance whose bulk work runs on ``device``.

    ``device`` is ``None`` or ``"cuda"``/``"cuda:i"`` (the hand-written
    kernels; BN254 Fr only) or ``"cpu"`` (the kernels' plain PyTorch
    versions).  The default is the CUDA device; where there is none the
    constructor raises.  ``zk=True`` compiles the zero-knowledge variant;
    a circuit too small for it at this rate raises ``ValueError``."""

    def __init__(self, circuit, outputs: list[int],
                 lambda_: int = DEFAULT_SECURITY_LEVEL, rate_inv: int = 8,
                 zk: bool = False, device=None, timer: PhaseTimer | None = None):
        self._setup(compile_circuit(circuit, outputs, lambda_, rate_inv, zk),
                    device, timer)

    @classmethod
    def from_compiled(cls, state: CompiledInstance, device=None,
                      timer: PhaseTimer | None = None) -> "LigeroCircuit":
        obj = cls.__new__(cls)
        obj._setup(state, device, timer)
        return obj

    def _setup(self, st: CompiledInstance, device, timer) -> None:
        self.state = st
        self.field = st.field
        self.backend = TorchBackend(st.field, device)
        self.device = self.backend.device
        self.timer = timer or PhaseTimer()
        self.circuit, self.outputs = st.circuit, st.outputs
        self.m, self.k, self.n, self.t = st.m, st.k, st.n, st.t
        self.zk, self.blind_t, self.d2 = st.zk, st.blind_t, st.d2
        self.blind_len, self.num_rows = st.blind_len, st.num_rows
        self.lin_bound, self.quad_bound = st.lin_bound, st.quad_bound
        self.backend.check_direct_fits(self.num_rows, self.k, self.n,
                                       len(st.a_vals), self.blind_t, self.d2)
        self._witness = WitnessEvaluator(st)
        self._coo = None

    # ------------------------------------------------------------------
    # prover
    # ------------------------------------------------------------------
    def prove(self, var_assignment: list[tuple[int, int]], sponge,
              zk_seed: bytes | None = None) -> LigeroProof:
        bumped = [(self.state.bump_index(i), v) for i, v in var_assignment]
        return self._prove_inner(bumped, sponge, zk_seed)

    def prove_with_labels(self, var_assignment: list[tuple[str, int]],
                          sponge, zk_seed: bytes | None = None) -> LigeroProof:
        indexed = [(self.circuit.variables[lbl], v) for lbl, v in var_assignment]
        return self._prove_inner(indexed, sponge, zk_seed)

    def _prove_inner(self, var_assignment, sponge,
                     zk_seed: bytes | None = None) -> LigeroProof:
        """One Fiat-Shamir schedule for both modes.  Without zk the
        interleaved reveal is the message-space combination and the
        products run on the 2k domain; under zk the committed rows are
        blinded, the reveal is in coefficient space (the message-space one
        would strip the blinding), the products run on the d2 domain, and
        each revealed object is padded by its mask row."""
        be, ph = self.backend, self.timer.phase
        m, p = self.m, self.field.p
        with ph("witness+preenc"):
            preenc = be.asarray(self._witness.preenc(var_assignment))
        if self.zk:
            with ph("zk_blind"):
                mask0, maskq, maskp, mask3, rows_seed = self._zk_masks(zk_seed)
                coeffs, rows = be.zk_blind_rows(preenc, rows_seed,
                                                self.blind_t, self.d2, mask3)
                lc_rows = coeffs
            with ph("rs_encode"):
                u_canon = be.ntt_and_canon(rows, self.n)
                del rows
        else:
            mask0 = maskq = maskp = None
            lc_rows = preenc
            with ph("rs_encode"):
                coeffs, u_canon = be.rs_encode_and_canon(preenc, self.k,
                                                         self.n)
        del preenc
        with ph("commit"):
            leaves, levels = be.commit_columns(u_canon)
            tree = MerkleTree(leaves, inner_levels=levels)
        sponge.absorb_bytes(tree.root)                           # FS #1

        with ph("interleaved"):
            seed = sponge.squeeze_bytes(CHACHA_SEED_BYTES)       # FS #2
            r = self._expand_field(4 * m, seed)
            lc = _add_mask(be.mont_to_ints(be.row_combine(r, lc_rows)),
                           mask0, p)
            del lc_rows
            sponge.absorb_field_elems(lc)                        # FS #3
            idx1 = self._sample_indices(
                sponge.squeeze_bytes(CHACHA_SEED_BYTES))         # FS #4

        with ph("linear"):
            seed = sponge.squeeze_bytes(CHACHA_SEED_BYTES)       # FS #5
            r_coeffs = self._r_a_coeff_rows(seed)
            with ph("linear.polyprod"):
                q_mont = be.linear_combination_poly(coeffs, r_coeffs, self.d2)
            del r_coeffs
            q = _trim(_add_mask(
                be.canon_limbs_to_ints(be.from_mont(q_mont)), maskq, p))
            sponge.absorb_field_elems(q)                         # FS #6
            idx2 = self._sample_indices(
                sponge.squeeze_bytes(CHACHA_SEED_BYTES))         # FS #7

        with ph("quadratic"):
            seed = sponge.squeeze_bytes(CHACHA_SEED_BYTES)       # FS #8
            r_quad = self._expand_field(m, seed)
            p0_mont = be.quadratic_combination_poly(coeffs[:3 * m], r_quad,
                                                    self.d2)
            p0 = _trim(_add_mask(
                be.canon_limbs_to_ints(be.from_mont(p0_mont)), maskp, p))
            sponge.absorb_field_elems(p0)                        # FS #9
            idx3 = self._sample_indices(
                sponge.squeeze_bytes(CHACHA_SEED_BYTES))         # FS #10

        # opened columns are proof data, never absorbed: one gather for
        # all three index sets (each squeezed at its FS position above)
        with ph("open"):
            o1, o2, o3 = self._open_columns(u_canon, tree, (idx1, idx2, idx3))
        return LigeroProof(tree.root, InterleavedProof(lc, *o1),
                           LinearConstraintsProof(q, *o2),
                           QuadraticConstraintsProof(p0, *o3))

    def _zk_masks(self, zk_seed: bytes | None):
        """The three mask polynomials (canonical ints), their (3, d2, L)
        Montgomery coefficient rows, and the seed of the row blinding, all
        derived from ``zk_seed`` (fresh randomness when None).  Small host
        work: k + b, 2k + b - 1 and k + 2b - 1 draws."""
        field, k, b, p = self.field, self.k, self.blind_t, self.field.p
        if zk_seed is None:
            zk_seed = secrets.token_bytes(CHACHA_SEED_BYTES)

        def sub_seed(tag: bytes) -> bytes:
            return hashlib.blake2s(zk_seed + tag).digest()

        mask0 = rand_field_elements(field, k + b, sub_seed(b"mask0"))
        maskq = rand_field_elements(field, 2 * k + b - 1, sub_seed(b"maskq"))
        # the sum over the k-point domain is k * sum(coeffs at j = 0 mod k);
        # force it to zero so the verifier's linear sum check survives
        maskq[0] = (-sum(maskq[j] for j in range(k, len(maskq), k))) % p
        rho = rand_field_elements(field, k + 2 * b - 1, sub_seed(b"maskp"))
        maskp = [0] * (2 * (k + b) - 1)   # (x^k - 1) * rho: vanishes on
        for j, rv in enumerate(rho):      # the message domain
            maskp[j + k] = (maskp[j + k] + rv) % p
            maskp[j] = (maskp[j] - rv) % p
        mask3 = np.zeros((3, self.d2, field.num_limbs), np.uint32)
        for row, mask in enumerate((mask0, maskq, maskp)):
            mask3[row, :len(mask)] = field.ints_to_mont_limbs(mask)
        return mask0, maskq, maskp, mask3, sub_seed(b"rows")

    def _expand_field(self, count: int, seed: bytes) -> torch.Tensor:
        """Short challenge vectors (4m, m): host ChaCha20, then upload."""
        return self.backend.asarray(
            rand_field_elements_limbs(self.field, count, seed))

    def _sample_indices(self, seed: bytes) -> list[int]:
        if self.zk:
            # exclude the k embedded message-domain points, where the zk
            # blinding vanishes and a column would leak witness values
            return get_distinct_indices_excluding(self.n, self.t, seed,
                                                  self.n // self.k)
        return get_distinct_indices_from_prng(self.n, self.t, seed)

    def _device_coo(self):
        """A's nonzeros on the device: row ids, column ids, Montgomery
        values (one-time upload)."""
        if self._coo is None:
            with self.timer.phase("linear.coo_upload"):
                st, dev = self.state, self.device
                vals = self.field.ints_to_mont_limbs(st.a_vals)
                self._coo = (torch.from_numpy(st.a_rows).to(dev),
                             torch.from_numpy(st.a_cols).to(dev),
                             self.backend.asarray(vals))
        return self._coo

    def _r_a_coeff_rows(self, seed: bytes) -> torch.Tensor:
        """r_linear -> r^T A in 4m rows of k -> iNTT_k (Montgomery)."""
        be, ph = self.backend, self.timer.phase
        four_mk = 4 * self.m * self.k
        with ph("linear.expand"):
            r = be.rand_field_mont(four_mk, seed)
        rowids, colids, vals = self._device_coo()
        with ph("linear.sparse_rA"):
            r_a = be.sparse_rA_mont(rowids, colids, vals, r, four_mk)
        del r
        with ph("linear.intt"):
            return be.intt(r_a.reshape(4 * self.m, self.k, -1), self.k)

    def _open_columns(self, u_canon, tree, idx_sets):
        all_idx = [j for idx in idx_sets for j in idx]
        with self.timer.phase("open.gather"):
            cols = self.backend.gather_columns(u_canon, all_idx)
        out, off = [], 0
        for idx in idx_sets:
            columns = [self.field.limbs_to_ints(cols[:, off + i, :])
                       for i in range(len(idx))]
            paths = [tree.generate_proof(j) for j in idx]
            out.append((columns, paths))
            off += len(idx)
        return out

    # ------------------------------------------------------------------
    # verifier
    # ------------------------------------------------------------------
    def verify(self, proof: LigeroProof, sponge) -> bool:
        if not self._well_formed(proof):
            return False
        sponge.absorb_bytes(proof.u_root)                        # FS #1
        with self.timer.phase("v.interleaved"):
            ok = self._verify_interleaved(proof.interleaved, proof.u_root,
                                          sponge)
        if not ok:
            return False
        with self.timer.phase("v.linear"):
            ok = self._verify_linear(proof.linear, proof.u_root, sponge)
        if not ok:
            return False
        with self.timer.phase("v.quadratic"):
            return self._verify_quadratic(proof.quadratic, proof.u_root, sponge)

    def _well_formed(self, proof: LigeroProof) -> bool:
        """Structural validation of an untrusted proof."""
        if len(proof.interleaved.preenc_u_lc) != self.blind_len:
            return False
        for sub in (proof.interleaved, proof.linear, proof.quadratic):
            if len(sub.columns) != len(sub.paths):
                return False
            if any(len(col) != self.num_rows for col in sub.columns):
                return False
        return True

    def _verify_column_openings(self, columns, paths, u_root, sponge) -> bool:
        indices = self._sample_indices(sponge.squeeze_bytes(CHACHA_SEED_BYTES))
        if len(columns) != len(indices) or len(paths) != len(indices):
            return False
        with self.timer.phase("v.col_openings"):
            for col, idx, path in zip(columns, indices, paths):
                if path.leaf_index != idx or not path.verify(
                        u_root, column_hash(self.field, col)):
                    return False
        return True

    def _columns_limbs(self, columns, rows: int) -> torch.Tensor:
        """Opened columns (lists of ints) -> (rows, t, L) canonical limbs
        on the device."""
        flat = [c for col in columns for c in col[:rows]]
        arr = self.field.ints_to_limbs(flat).reshape(len(columns), rows, -1)
        return self.backend.asarray(arr.transpose(1, 0, 2))

    def _evals(self, poly: list[int]) -> list[int]:
        """n-point evaluations (canonical ints) of a polynomial given by
        at most n canonical coefficients."""
        be = self.backend
        poly = poly or [0]
        limbs = be.ints_to_mont(poly)
        return be.mont_to_ints(be.ntt(limbs.reshape(1, len(poly), -1),
                                      self.n)[0])

    def _spot_matches(self, evals: list[int], proof, sums: list[int],
                      mask_row: int) -> bool:
        """evals[j] == sums[i] (+ the mask row's entry of column i under
        zk) at every opened column j."""
        p = self.field.p
        for path, col, sv in zip(proof.paths, proof.columns, sums):
            if self.zk:
                sv = (sv + col[4 * self.m + mask_row]) % p
            if evals[path.leaf_index] != sv:
                return False
        return True

    def _verify_interleaved(self, proof: InterleavedProof, u_root,
                            sponge) -> bool:
        be = self.backend
        seed = sponge.squeeze_bytes(CHACHA_SEED_BYTES)           # FS #2
        r = self._expand_field(4 * self.m, seed)
        sponge.absorb_field_elems(proof.preenc_u_lc)             # FS #3
        if not self._verify_column_openings(proof.columns, proof.paths,
                                            u_root, sponge):     # FS #4
            return False
        if self.zk:
            # the zk reveal is in coefficient space (deg < k + 3t): check
            # w(omega^j) == <r, U[:4m, j]> + U[mask0, j]
            w = self._evals(proof.preenc_u_lc)
        else:
            # w = RS(preenc_u_lc); spot check w[j] == <r, U[:, j]>
            lc = be.ints_to_mont(proof.preenc_u_lc).reshape(1, self.k, -1)
            _, w_evals = be.rs_encode_rows(lc, self.k, self.n)
            w = be.mont_to_ints(w_evals[0])
        # mont r x canonical columns = canonical sums
        rhs = be.canon_limbs_to_ints(be.row_combine(
            r, self._columns_limbs(proof.columns, 4 * self.m)))
        return self._spot_matches(w, proof, rhs, 0)

    def _verify_linear(self, proof: LinearConstraintsProof, u_root,
                       sponge) -> bool:
        be, p, k = self.backend, self.field.p, self.k
        seed = sponge.squeeze_bytes(CHACHA_SEED_BYTES)           # FS #5
        if _poly_degree(proof.polynomial) >= self.lin_bound:
            return False
        # one n-point NTT of q gives the message-domain sum check (the k
        # message points are the n grid at stride n/k) and q at every
        # opened column
        q_evals = self._evals(proof.polynomial)
        if sum(q_evals[0::self.n // k]) % p != 0:
            return False
        sponge.absorb_field_elems(proof.polynomial)              # FS #6
        if not self._verify_column_openings(proof.columns, proof.paths,
                                            u_root, sponge):     # FS #7
            return False
        # the r_i codewords at the opened columns (full NTT, then take)
        r_coeffs = self._r_a_coeff_rows(seed)
        js = [path.leaf_index for path in proof.paths]
        with self.timer.phase("v.ntt_cols"):
            r_evals = be.ntt_columns(r_coeffs, self.n, js)       # (4m, t, L)
        del r_coeffs
        with self.timer.phase("v.spot"):
            lhs = be.canon_limbs_to_ints(be.row_combine(
                r_evals, self._columns_limbs(proof.columns, 4 * self.m)))
        return self._spot_matches(q_evals, proof, lhs, 1)

    def _verify_quadratic(self, proof: QuadraticConstraintsProof, u_root,
                          sponge) -> bool:
        be, k, m = self.backend, self.k, self.m
        seed = sponge.squeeze_bytes(CHACHA_SEED_BYTES)           # FS #8
        r_quad = self._expand_field(m, seed)
        if _poly_degree(proof.polynomial) >= self.quad_bound:
            return False
        p0_evals = self._evals(proof.polynomial)
        if any(p0_evals[(self.n // k) * c] != 0 for c in range(k)):
            return False
        sponge.absorb_field_elems(proof.polynomial)              # FS #9
        if not self._verify_column_openings(proof.columns, proof.paths,
                                            u_root, sponge):     # FS #10
            return False
        # sum_i r_i (x_i y_i - z_i) per opened column; to_mont(x) * y is
        # the canonical product
        with self.timer.phase("v.spot"):
            cols = self._columns_limbs(proof.columns, 3 * m)     # (3m, t, L)
            term = be.sub(be.mont_mul(be.to_mont(cols[:m]), cols[m:2 * m]),
                          cols[2 * m:])
            rhs = be.canon_limbs_to_ints(be.row_combine(r_quad, term))
        return self._spot_matches(p0_evals, proof, rhs, 2)

