"""``TorchBackend``: the bulk protocol steps of the prover and verifier
(plain and zk) on one PyTorch device.

The counterpart of ``Backend`` in ``ligero_tpu/engine/backend.py`` for the
methods the single-device prove -> verify path calls; names and layouts
follow it.  Limb arrays are ``(..., L)`` int32 tensors of 16-bit limbs.
Every bulk step runs on ``device``: on a CUDA device (BN254 Fr or
BLS12-377 Fq, the fields the kernels are built for; any other raises) the
five hand-written kernels carry the transforms (``cuda_ntt``), Montgomery
products (``cuda_mont``), column hashing (``cuda_hash``), the SHA-256
Merkle tree (``cuda_tree``) and row combinations (``cuda_lc``); ChaCha20,
modular add/sub, gathers and segment sums are PyTorch ops.  On the CPU the
same calls take the kernels' plain versions.

Only the "direct" mode exists: the whole codeword matrix U is one device
tensor.  An instance too large for the device's memory raises
:class:`DeviceMemoryError` before any allocation.

The ``*_batch`` methods serve ``LigeroCircuit.prove_batch`` and
``verify_batch``: B proofs of one circuit share one launch per bulk step
(:meth:`TorchBackend.max_batch` says how many go together).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import FieldSpec
from . import (cuda_build, cuda_hash, cuda_lc, cuda_mont, cuda_ntt, cuda_tree,
               devsampler, fieldops, hashops)

#: on the whole estimate of :meth:`TorchBackend.direct_bytes`: twiddle and
#: twist tables, the tree, index vectors and the allocator's rounding
ESTIMATE_MARGIN = 1.03
#: most proofs that go through the bulk steps together.  The host work is
#: per proof and every proof adds its codeword matrix to the live set, so a
#: larger batch costs memory and has shown no gain (PERF.md, Findings).
MAX_BATCH = 3


class DeviceMemoryError(RuntimeError):
    """The instance does not fit the device in direct mode."""


def resolve_device(device) -> torch.device:
    """``None`` is the CUDA device: an entry point runs on the card unless
    the caller asks for ``"cpu"``, and raises where there is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch.cuda is not "
                               "available")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


class TorchBackend:
    """Bulk limb arithmetic for one field on one device."""

    def __init__(self, field: FieldSpec, device=None):
        self.field = field
        self.device = resolve_device(device)
        self.L = field.num_limbs
        if self.device.type == "cuda":
            cuda_build.kernel_field_id(field, "TorchBackend")

    # ------------------------------------------------------------------
    # field primitives routed through the kernels on CUDA
    # ------------------------------------------------------------------
    def mont_mul(self, a, b):
        return cuda_mont.mont_mul(self.field, a, b)

    def sub(self, a, b):
        return fieldops.sub(self.field, a, b)

    def from_mont(self, a):
        return fieldops.from_mont(self.field, self.asarray(a),
                                  mul=cuda_mont.mont_mul)

    def to_mont(self, a):
        return fieldops.to_mont(self.field, self.asarray(a),
                                mul=cuda_mont.mont_mul)

    # ------------------------------------------------------------------
    # host <-> device
    # ------------------------------------------------------------------
    def asarray(self, a) -> torch.Tensor:
        """Host limb array (uint16/uint32/int) or tensor -> int32 on device."""
        if isinstance(a, torch.Tensor):
            return a.to(device=self.device, dtype=torch.int32)
        # limbs are < 2^16, so the int32 cast is exact
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(
            self.device)

    @staticmethod
    def to_numpy(a) -> np.ndarray:
        """Tensor of non-negative limbs -> host uint32 array."""
        if isinstance(a, torch.Tensor):
            return a.detach().cpu().numpy().view(np.uint32)
        return np.asarray(a)

    def ints_to_mont(self, ints: list[int]) -> np.ndarray:
        return self.field.ints_to_mont_limbs(ints)

    def mont_to_ints(self, limbs) -> list[int]:
        return self.field.mont_limbs_to_ints(self.to_numpy(limbs))

    def canon_limbs_to_ints(self, limbs) -> list[int]:
        return self.field.limbs_to_ints(self.to_numpy(limbs))

    # ------------------------------------------------------------------
    # memory budget (direct mode)
    # ------------------------------------------------------------------
    def memory_budget(self) -> int:
        if self.device.type == "cuda":
            return torch.cuda.get_device_properties(self.device).total_memory
        return 1 << 62

    def direct_bytes(self, rows: int, k: int, n: int, nnz: int,
                     blind_t: int = 0, d2: int | None = None,
                     batch: int = 1) -> int:
        """Estimate of the prover's largest live set in direct mode, for
        ``batch`` proofs proved together.  ``rows`` counts the committed
        rows (4m, or 4m + 3 under zk).

        Non-zk: the encode (A's COO, which stays on the device between
        proofs; message, coefficient and codeword matrices of all the
        batch; its transforms take routes without scratch) or the
        linear phase (every proof's U and coefficients, A's COO, and one
        proof's transients, see below).

        zk (``blind_t`` > 0): the encode holds A's COO, each proof's message,
        (k + b)-wide coefficients and d2-wide row matrix, U and the packed
        intermediate of its two-pass transform; the linear
        phase holds every U and coefficient matrix, A's COO and one
        proof's transients, or its two (4m, d2, L) evaluation matrices.
        NTT scratch is counted as :func:`cuda_ntt.scratch_bytes` gives it
        for each shape.

        One proof's linear-phase transients, the largest of three: the
        challenge sampler's int64 words (the ChaCha20 stream, the
        candidates, the accepted words and their two halves, stacked); the
        sparse product (r, the gathered r and the products in int32, the
        products in int64, the int64 column sums); and the fold of those
        sums (``fieldops.fold_wide``: r, the sums, a part, a term, the
        running sum, and the modular add's int64 operands, sum, carry copy
        and selection)."""
        L = self.L
        d2 = 2 * k if d2 is None else d2
        u, msg = rows * n * L * 4, rows * k * L * 4
        coeffs = rows * (k + blind_t) * L * 4
        coo = nnz * (L * 4 + 16)         # stays on the device between proofs
        linear = self._linear_transients(rows, k, nnz)
        scratch = functools.partial(cuda_ntt.scratch_bytes, self.field)
        if blind_t:
            wide = rows * d2 * L * 4
            # (an estimate takes any sizes; a transform needs w <= n)
            encode = coo + batch * (msg + coeffs + wide + u) + scratch(
                batch * rows, min(d2, n), n)
            products = msg + 2 * wide + scratch(
                rows, min(k + blind_t, d2), d2)
            later = batch * (u + coeffs) + coo + max(linear, products)
        else:
            encode = coo + batch * (2 * msg + u) + max(
                scratch(batch * rows, k, k), scratch(batch * rows, k, n))
            later = batch * (u + coeffs) + coo + linear
        return int(max(encode, later) * ESTIMATE_MARGIN)

    def _linear_transients(self, rows: int, k: int, nnz: int) -> int:
        """One proof's linear-phase transients (see :meth:`direct_bytes`)."""
        msg, nz = rows * k * self.L * 4, nnz * self.L * 4
        words = self.field.num_u64_limbs * 2 * 8
        sampler = (2 * devsampler.plan_attempts(self.field, rows * k) * words
                   + 5 * rows * k * words + msg)
        return max(sampler, 3 * msg + 3 * nz, 12 * msg + msg // 4)

    def verify_bytes(self, rows: int, k: int, n: int, nnz: int,
                     batch: int = 1) -> int:
        """Estimate of the verifier's largest live set for ``batch`` proofs
        verified together (``LigeroCircuit.verify_batch``; ``verify`` is a
        batch of one), for ``rows`` committed rows, message length ``k``,
        codeword length ``n`` and ``nnz`` nonzeros of A.

        A's COO (on the device between calls) and each proof's r^T A
        coefficient rows (4m x k), which wait for the codewords at the
        opened columns; beside them, the largest of: one proof's linear
        transients as the prover counts them (the sampler, the sparse
        product, the fold), or one proof's full n-point transform of its
        coefficient rows with its NTT scratch.  Proof data on the device
        (the reveals' transforms, the opened columns) is small beside
        these."""
        L = self.L
        msg, u = rows * k * L * 4, rows * n * L * 4
        coo = nnz * (L * 4 + 16)
        transform = u + cuda_ntt.scratch_bytes(self.field, rows, k, n)
        return int((coo + batch * msg + max(
            self._linear_transients(rows, k, nnz), transform)) * ESTIMATE_MARGIN)

    def max_verify_batch(self, rows: int, k: int, n: int, nnz: int) -> int:
        """The largest number of proofs, at most :data:`MAX_BATCH`, whose
        joint verifier live set (:meth:`verify_bytes`) fits the device; 0
        where not even one fits."""
        budget = self.memory_budget()
        for batch in range(MAX_BATCH, 0, -1):
            if self.verify_bytes(rows, k, n, nnz, batch) <= budget:
                return batch
        return 0

    def check_direct_fits(self, rows: int, k: int, n: int, nnz: int,
                          blind_t: int = 0, d2: int | None = None) -> None:
        """Raise unless one proof's largest live set
        (:meth:`direct_bytes`) fits the device."""
        need = self.direct_bytes(rows, k, n, nnz, blind_t, d2)
        budget = self.memory_budget()
        if need > budget:
            raise DeviceMemoryError(
                f"instance needs ~{need / 2**30:.1f} GiB on {self.device} in "
                f"direct mode (budget {budget / 2**30:.1f} GiB); resident and "
                "streaming modes are not ported yet")

    def max_batch(self, rows: int, k: int, n: int, nnz: int,
                  blind_t: int = 0, d2: int | None = None) -> int:
        """The largest number of proofs, at most :data:`MAX_BATCH`, whose
        joint live set (:meth:`direct_bytes`) fits the device; 0 where not
        even one fits."""
        budget = self.memory_budget()
        for batch in range(MAX_BATCH, 0, -1):
            if self.direct_bytes(rows, k, n, nnz, blind_t, d2, batch) <= budget:
                return batch
        return 0

    # ------------------------------------------------------------------
    # transforms
    # ------------------------------------------------------------------
    def ntt(self, coeffs, n: int):
        return cuda_ntt.ntt(self.field, self.asarray(coeffs), n)

    def intt(self, evals, n: int):
        return cuda_ntt.ntt(self.field, self.asarray(evals), n, inverse=True)

    def rs_encode_rows(self, preenc, k: int, n: int):
        """(B, k, L) message rows -> (coeffs (B, k, L), evals (B, n, L))."""
        coeffs = self.intt(preenc, k)
        return coeffs, cuda_ntt.ntt(self.field, coeffs, n)

    def rs_encode_and_canon(self, preenc, k: int, n: int):
        """(B, k, L) -> (coeffs, canonical codewords (B, n, L)); the
        from-Montgomery epilogue is fused into the NTT_n."""
        coeffs = self.intt(preenc, k)
        return coeffs, self.ntt_and_canon(coeffs, n)

    def ntt_and_canon(self, coeffs, n: int):
        """(B, w, L) coefficient rows (w <= n, zero-extended) -> (B, n, L)
        canonical codewords.  The zk prover's encode: blinded rows are in
        coefficient space already."""
        return cuda_ntt.ntt(self.field, self.asarray(coeffs), n,
                            canon_out=True)

    def zk_blind_rows(self, preenc, rows_seed: bytes, blind_t: int, d2: int,
                      mask3):
        """Blinding and committed-row assembly on the device.

        ``preenc`` (4m, k, L) message rows, ``mask3`` (3, d2, L) the three
        mask rows' coefficients, all Montgomery.  Each data row becomes
        u_i = msg_i + (x^k - 1) s_i with msg_i = iNTT_k(preenc_i) and
        s_i the next ``blind_t`` draws of ``F::rand`` from ``rows_seed``
        (the host stream, bit for bit).  Returns ``(coeffs (4m, k + b, L),
        rows (4m + 3, d2, L))``: the coefficient rows, and the same rows
        zero-extended to d2 with the mask rows below them."""
        rows4, k, L = preenc.shape
        b = blind_t
        msg = self.intt(preenc, k)
        s = self.rand_field_mont(rows4 * b, rows_seed).reshape(rows4, b, L)
        # +x^k s occupies [k, k + b) and -s occupies [0, b); the regions
        # overlap when b > k (small instances), so subtract from the
        # concatenated layout
        coeffs = torch.cat([msg, s], dim=1)
        del msg
        coeffs[:, :b] = self.sub(coeffs[:, :b], s)
        del s
        rows = torch.zeros((rows4 + 3, d2, L), dtype=torch.int32,
                           device=self.device)
        rows[:rows4, :k + b] = coeffs
        rows[rows4:] = self.asarray(mask3)
        return coeffs, rows

    def ntt_columns(self, coeffs, n: int, js) -> torch.Tensor:
        """All rows' n-point NTTs at the columns ``js`` only: (B, k, L) ->
        (B, len(js), L) Montgomery limbs on the device: the full transform
        and a gather."""
        idx = torch.from_numpy(np.asarray(js, dtype=np.int64)).to(self.device)
        return self.ntt(coeffs, n).index_select(1, idx)

    def ntt_columns_batch(self, coeffs_b, n: int, idx) -> torch.Tensor:
        """Per-proof :meth:`ntt_columns`: B coefficient blocks (rows, w, L)
        and ``idx`` (B, t) -> (B, rows, t, L).  The proofs go one by one,
        so that one (rows, n, L) transform is live at a time."""
        return torch.stack([self.ntt_columns(c, n, j)
                            for c, j in zip(coeffs_b, idx)])

    # ------------------------------------------------------------------
    # commitment
    # ------------------------------------------------------------------
    def commit_columns(self, u_canon):
        """Blake2s column leaves + SHA-256 levels ->
        ``(leaves: list[bytes], inner_levels: list[list[bytes]])``."""
        return self.commit_columns_batch(u_canon, 1)[0]

    def commit_columns_batch(self, u_canon, batch: int):
        """(batch * rows, n, L) canonical limbs, the proofs' matrices
        stacked -> per-proof ``(leaves, inner_levels)``: one Blake2s launch
        over all batch * n columns, one tree launch per proof on one
        stream, one transfer of the flat trees, host unpacking."""
        n = u_canon.shape[1]
        leaves_le = cuda_hash.blake2s_columns(self.field, u_canon, batch)
        flat = self.to_numpy(cuda_tree.forest_flat(
            leaves_le.reshape(batch, n, 8)))
        return [hashops.digest_lists(flat[b], n) for b in range(batch)]

    def gather_columns_batch(self, u_canon, idx) -> np.ndarray:
        """Per-proof openings: (B * rows, n, L) and ``idx`` (B, t) ->
        (B, rows, t, L) host uint32: proof b's columns ``idx[b]``."""
        idx = torch.from_numpy(np.asarray(idx, dtype=np.int64)).to(self.device)
        batch, t = idx.shape
        u4 = u_canon.reshape(batch, -1, *u_canon.shape[1:])
        index = idx[:, None, :, None].expand(batch, u4.shape[1], t, u4.shape[3])
        return self.to_numpy(torch.gather(u4, 2, index))

    def gather_columns(self, u_canon, js) -> np.ndarray:
        """Columns ``js`` of (rows, n, L) -> (rows, len(js), L) host uint32."""
        return self.gather_columns_batch(u_canon, [js])[0]

    # ------------------------------------------------------------------
    # interleaved / linear / quadratic phases
    # ------------------------------------------------------------------
    def row_combine(self, r, mat):
        """sum_i r_i M_i for M (B, k, L) and r (B, L) or (B, k, L) ->
        (k, L) (Montgomery when both are, canonical when M is)."""
        return cuda_lc.row_combine(self.field, self.asarray(r), self.asarray(mat))

    def row_combine_batch(self, r, mats):
        """Per-proof combinations: r (B, rows, L) x mats (B, rows, k, L) ->
        (B, k, L), each as :meth:`row_combine` gives it."""
        return cuda_lc.row_combine_batch(self.field, self.asarray(r),
                                         self.asarray(mats))

    def rand_field_mont(self, count: int, seed: bytes) -> torch.Tensor:
        """``F::rand`` expansion on the device, bit-identical to
        ``sampling.rand_field_elements_limbs``."""
        return devsampler.fr_sample(self.field, count, seed, self.device)

    def sparse_rA_mont(self, rowids, colids, vals_mont, r_mont,
                       num_cols: int) -> torch.Tensor:
        """out[col] = sum of vals[i] * r[rowids[i]] over entries in col,
        mod p; all Montgomery.  Products on the mont_mul kernel, then an
        exact int64 ``index_add_`` of the limbs (order-independent) and one
        :func:`fieldops.fold_wide` reduction."""
        gathered = r_mont.index_select(0, rowids)
        prod = self.mont_mul(vals_mont, gathered)
        del gathered
        sums = torch.zeros((num_cols, self.L), dtype=torch.int64,
                           device=self.device)
        sums.index_add_(0, colids, prod.to(torch.int64))
        del prod
        return fieldops.fold_wide(self.field, sums, mul=cuda_mont.mont_mul)

    def linear_combination_poly(self, u_coeffs, r_coeffs, d2: int):
        """q = sum_i r_i(X) u_i(X) by pointwise products on the d2 domain
        (2k without zk): (d2, L) Montgomery coefficients of q.  The rows
        may be of any widths <= d2 (k + b and k under zk); d2 must exceed
        deg q."""
        eu = self.ntt(u_coeffs, d2)
        er = self.ntt(r_coeffs, d2)
        total = cuda_lc.row_combine(self.field, er, eu)
        del eu, er
        return self.intt(total[None], d2)[0]

    def quadratic_combination_poly(self, xyz_coeffs, r_quad, d2: int):
        """p0 = sum_i r_i (x_i y_i - z_i) on the d2 domain: (d2, L)
        Montgomery coefficients."""
        m = xyz_coeffs.shape[0] // 3
        ev = self.ntt(xyz_coeffs, d2)
        term = self.sub(self.mont_mul(ev[:m], ev[m:2 * m]), ev[2 * m:])
        del ev
        total = self.row_combine(r_quad, term)
        return self.intt(total[None], d2)[0]
