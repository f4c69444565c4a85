"""``TorchBackend``: the bulk protocol steps of the prover and verifier
(plain and zk) on one PyTorch device.

The counterpart of ``Backend`` in ``ligero_tpu/engine/backend.py`` for the
methods the single-device prove -> verify path calls; names and layouts
follow it.  Limb arrays are ``(..., L)`` int32 tensors of 16-bit limbs; the
resident and streaming modes' chunked matrices hold the same limbs in 16
bits (int16 tensors, :func:`fieldops.narrow16`: the JAX package's
``narrow16``), which the kernels read and write as they lie, and every
mode copies the opened columns to the host in 16 bits.
Every bulk step runs on ``device``: on a CUDA device (BN254 Fr or
BLS12-377 Fq, the fields the kernels are built for; any other raises) the
five hand-written kernels carry the transforms (``cuda_ntt``), Montgomery
products (``cuda_mont``), column hashing (``cuda_hash``), the SHA-256
Merkle tree (``cuda_tree``) and row combinations (``cuda_lc``); ChaCha20,
modular add/sub, gathers and segment sums are PyTorch ops.  On the CPU the
same calls take the kernels' plain versions.

Three modes, chosen per instance by :meth:`TorchBackend.encode_mode` from
the live-set estimates before any allocation, in the JAX package's order.
In "direct" mode the whole codeword matrix U is one device tensor
(:meth:`TorchBackend.direct_bytes`).  Where that does not fit, U and its
coefficient rows stay on the device in row chunks (``devmatrix``), and the
linear phase's challenges, sparse product and products run in blocks
aligned with the chunks.  In "resident" mode each chunk is encoded once and
its codewords are held (:meth:`TorchBackend.resident_bytes`): the commit
absorbs each codeword chunk into per-column Blake2s (or, under the
Poseidon commitment, sponge) states and the openings gather the opened
columns from the chunks.  In "streaming" mode, where that does not fit
either, U is never held: only the coefficient chunks stay, and the commit
and the openings re-encode a chunk at a time
(:meth:`TorchBackend.streaming_bytes`).  The bulk steps take a tensor or a
chunked handle and dispatch on its type.  An instance that fits no mode
raises :class:`DeviceMemoryError`.

The ``*_batch`` methods serve ``LigeroCircuit.prove_batch`` and
``verify_batch``: B proofs of one circuit share one launch per bulk step
(:meth:`TorchBackend.max_batch` says how many go together).  The core
reaches the committed matrices only through the backend (``upload_messages``,
``rs_encode_batch``, ``zk_blind_batch``, ``row_matrix``, ``column_blocks``,
``place_chunk``), so that ``parallel.ShardedBackend`` can hold them in row
blocks over a mesh.  The streaming methods run each chunk where it lies and
hash each column block where :meth:`TorchBackend._column_split` puts it:
here everything is on ``device``; over a mesh, chunk i lies on device i
mod D and the commit's column blocks are the devices' own.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from ..fields import FieldSpec
from . import (cuda_build, cuda_hash, cuda_lc, cuda_mont, cuda_ntt, cuda_tree,
               devsampler, fieldops, hashops)
from .devmatrix import RowChunkedMatrix, StreamedCodewords

#: on the whole estimate of :meth:`TorchBackend.direct_bytes`: twiddle and
#: twist tables, the tree, index vectors and the allocator's rounding
ESTIMATE_MARGIN = 1.03
#: most proofs that go through the bulk steps together.  The host work is
#: per proof and every proof adds its codeword matrix to the live set, so a
#: larger batch costs memory and has shown no gain (PERF.md, Findings).
MAX_BATCH = 3
#: most rows a chunk of the streaming mode: a chunk's n-point transform
#: (1024 x n elements) already fills the card, and a larger one only adds
#: memory
STREAM_MAX_CHUNK_ROWS = 1024
#: chunk rows are a multiple of this: a whole number of the Blake2s column
#: map's periods in both fields (hashops.period_rows: 2 and 4 rows)
STREAM_ROW_QUANTUM = 4


class DeviceMemoryError(RuntimeError):
    """The instance fits the device in no mode (or, where
    :meth:`TorchBackend.check_direct_fits` raises it, not in direct
    mode)."""


class MessageRows:
    """The message rows of the streaming prover, held only as their
    coefficients ``coeffs`` (iNTT_k of each row): a row combination of the
    message rows is NTT_k of that of the coefficient rows, by linearity."""

    def __init__(self, coeffs: RowChunkedMatrix):
        self.coeffs = coeffs


class PendingColumns:
    """One index set's opened columns on their way to the host
    (:meth:`TorchBackend.gather_columns_start`): the indices ``js``, the
    int16 host tensor (``host``, pinned on a CUDA device), the side stream
    and the event recorded there after the copy (None on the CPU), or the
    start's error (``err``)."""

    def __init__(self, js):
        self.js = list(js)
        self.host = self.stream = self.event = self.err = None


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

    #: whether :meth:`encode_mode` may take resident mode (one device: a
    #: mesh never does, as in the JAX package, whose mesh sets
    #: ``resident_u_ok = False``)
    RESIDENT = True

    def __init__(self, field: FieldSpec, device=None):
        self.field = field
        self.device = resolve_device(device)
        self.L = field.num_limbs
        self._side = None
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
        """Host limb array (uint16/uint32/int) or tensor -> int32 on device;
        a 16-bit tensor (int16) stays 16-bit: the kernels read it so."""
        if isinstance(a, torch.Tensor):
            if a.dtype == torch.int16:
                return a.to(self.device)
            return a.to(device=self.device, dtype=torch.int32)
        # limbs are < 2^16, so the int32 cast is exact
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(
            self.device)

    @staticmethod
    def to_numpy(a) -> np.ndarray:
        """Tensor of non-negative limbs (int32, or 16-bit as int16) -> host
        uint32 array (16-bit limbs widened on the host)."""
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
            if a.dtype == np.int16:
                return a.view(np.uint16).astype(np.uint32)
            return a.view(np.uint32)
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
        coo = nnz * (self.L * 4 + 16)    # stays on the device between proofs
        enc, enc_t, later, pair, _ = self._direct_phases(rows, k, n, blind_t,
                                                         d2, batch)
        msg = rows * k * self.L * 4      # the r^T A coefficient rows
        linear = self._linear_transients(rows, k, nnz)
        return int(max(coo + enc + enc_t,
                       coo + later + max(linear, msg + pair))
                   * ESTIMATE_MARGIN)

    def _direct_phases(self, rows: int, k: int, n: int, blind_t: int,
                       d2: int | None, batch: int):
        """:meth:`direct_bytes`'s pieces for ``rows`` rows, without A's
        COO and the linear transients: ``(the encode's resident matrices,
        its NTT scratch, the later phases' resident matrices, one proof's
        products on the d2 domain, the commit's resident matrices)``.
        Resident: the message, coefficient and codeword matrices (and the
        zk row matrix) of the batch; the products: two (rows, d2)
        evaluation matrices and their scratch, beside the r^T A coefficient
        rows (without zk they stay under the linear transients).  The
        commit holds the codewords and coefficients of the batch, and
        without zk the message rows too (the interleaved combination takes
        them after it); under zk the message and row matrices are gone by
        then."""
        L = self.L
        d2 = 2 * k if d2 is None else d2
        u, msg = rows * n * L * 4, rows * k * L * 4
        coeffs = rows * (k + blind_t) * L * 4
        wide = rows * d2 * L * 4
        scratch = functools.partial(cuda_ntt.scratch_bytes, self.field)
        pair = 2 * wide + scratch(rows, min(k + blind_t, d2), d2)
        if blind_t:
            # (an estimate takes any sizes; a transform needs w <= n)
            enc = batch * (msg + coeffs + wide + u)
            enc_t = scratch(batch * rows, min(d2, n), n)
        else:
            enc = batch * (2 * msg + u)
            enc_t = max(scratch(batch * rows, k, k),
                        scratch(batch * rows, k, n))
        later = batch * (u + coeffs)
        return enc, enc_t, later, pair, later + (0 if blind_t
                                                 else batch * msg)

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

    def max_verify_batch(self, rows: int, k: int, n: int, nnz: int,
                         chunk_rows: int = 0) -> int:
        """The largest number of proofs, at most :data:`MAX_BATCH`, whose
        joint verifier live set fits the device (:meth:`verify_bytes`, or
        :meth:`streaming_verify_bytes` at ``chunk_rows`` in streaming
        mode); 0 where not even one fits."""
        budget = self.memory_budget()
        for batch in range(MAX_BATCH, 0, -1):
            need = (self.streaming_verify_bytes(rows, k, n, nnz, chunk_rows,
                                                batch) if chunk_rows
                    else self.verify_bytes(rows, k, n, nnz, batch))
            if need <= budget:
                return batch
        return 0

    def check_direct_fits(self, rows: int, k: int, n: int, nnz: int,
                          blind_t: int = 0, d2: int | None = None) -> None:
        """Raise unless one proof's largest live set in direct mode
        (:meth:`direct_bytes`) fits the device (:meth:`encode_mode` then
        takes streaming mode where that fits)."""
        need = self.direct_bytes(rows, k, n, nnz, blind_t, d2)
        budget = self.memory_budget()
        if need > budget:
            raise DeviceMemoryError(
                f"instance needs ~{need / 2**30:.1f} GiB on {self.device} in "
                f"direct mode (budget {budget / 2**30:.1f} GiB); streaming "
                "mode (TorchBackend.streaming_bytes) holds U in coefficient "
                "chunks instead")

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
    # memory budget (streaming mode)
    # ------------------------------------------------------------------
    def _stream_parts(self, rows: int, k: int, n: int, nnz: int,
                      blind_t: int, d2: int, chunk_rows: int,
                      poseidon: bool = False) -> dict:
        """The streaming live set's pieces, in bytes, for ``rows``
        committed rows (4m, or 4m + 3 under zk) in chunks of ``chunk_rows``
        (see :meth:`streaming_bytes`); ``poseidon``: the commit's sponge
        states (3 W words a column) and digests beside the re-encode.  The
        chunked matrices (coefficient, r^T A and codeword chunks) and the
        opened columns are 16-bit limbs, the transforms' int32 outputs and
        everything else int32 limbs."""
        E = self.L * 4                              # bytes of an element
        H = self.L * 2                              # ... in 16-bit limbs
        cr, b = chunk_rows, blind_t
        data = rows - 3 if b else rows              # 4m
        padded = -(-data // cr) * cr
        seg = cr * k                                # attempts a segment
        bc = cr * k                                 # columns a sparse block
        scratch = functools.partial(cuda_ntt.scratch_bytes, self.field)
        sponge = n * (3 * (self.L // 2) * 4 + E) if poseidon else 0
        codewords = cr * n * H + scratch(cr, k + b, n)
        opened = cr * min(n, 512) * H
        return {
            # the column sponges' states and digests (Poseidon)
            "sponge": sponge,
            # one chunk's n-wide int32 transform and its NTT scratch (the
            # verifier's codewords at the opened columns)
            "transform": cr * n * E + scratch(cr, k + b, n),
            # one chunk's canonical codewords, 16-bit, and the scratch
            "codewords": codewords,
            # a chunk's opened columns, 16-bit (3t of them: fewer than 512
            # at any security level the port runs)
            "opened": opened,
            "coo": nnz * (E + 16),
            "coeffs": padded * (k + b) * H + (3 * d2 * E if b else 0),
            "r": data * k * E,
            "r_coeffs": padded * k * H,
            # the column sort of A's upload: keys, sorted keys, the order
            # and the sort's scratch, 8 bytes an entry each
            "upload": 40 * nnz,
            # one message chunk up (16-bit, as the iNTT_k reads it), its
            # iNTT_k (the coefficient chunk, 16-bit; under zk int32); under
            # zk also the blinded chunk in int32 before it is narrowed, its
            # s draws (from a sampler segment) and the subtraction
            "encode": cr * k * H + cr * k * (E if b else H)
            + scratch(cr, k, k) + (cr * (k + b) * E + 3 * cr * b * E
                                   + self._segment_bytes(seg) if b else 0),
            # one chunk's re-encode (commit, openings) and its opened
            # columns, beside the sponges
            "reencode": codewords + opened + sponge,
            "sampler": self._segment_bytes(seg),
            # a block's int64 sums beside a sub-batch of bc entries
            # (gathered r, products in int32 and int64, column ids), the
            # fold of the sums, or the folded block and its iNTT_k
            "block": max(2 * bc * E + bc * (4 * E + 8), 49 * bc * E // 4,
                         2 * bc * E + scratch(cr, k, k)),
            # the linear product: a chunk pair on the d2 domain
            "pair": 2 * cr * d2 * E + scratch(cr, k + b, d2),
            # the quadratic product: a block of x, y and z rows each (16-bit
            # chunk rows), their transforms, the product and the
            # subtraction's int64 operands
            "quad": 3 * cr * (k + b) * H + 9 * cr * d2 * E
            + scratch(cr, k + b, d2),
        }

    def _segment_bytes(self, seg: int) -> int:
        """One :class:`devsampler.FrStream` segment of ``seg`` attempts:
        its keystream, candidates, accepted words and limb halves in int64
        (as :meth:`_linear_transients` counts them), and the draws not yet
        taken."""
        return seg * (7 * self.field.num_u64_limbs * 2 * 8 + self.L * 4)

    def streaming_bytes(self, rows: int, k: int, n: int, nnz: int,
                        blind_t: int = 0, d2: int | None = None,
                        chunk_rows: int = STREAM_MAX_CHUNK_ROWS,
                        poseidon: bool = False) -> int:
        """Estimate of the streaming prover's largest live set for one
        proof: A's COO (sorted by column), the coefficient chunks (k + b
        wide, and the three d2-wide mask rows under zk) and, beside them,
        the largest of: A's upload; a chunk's encode; a chunk's re-encode
        to n points (commit, openings); the linear phase, which holds the
        challenge vector r (4mk elements) and the r^T A coefficient chunks
        beside one sampler segment or one column block of the sparse
        product and its fold; the linear product's chunk pair on the d2
        domain with the r^T A chunks; or a block of the quadratic
        product.  ``poseidon``: the commit is the Poseidon sponge's, whose
        per-column states and digests stand beside a chunk's re-encode."""
        d2 = 2 * k if d2 is None else d2
        p = self._stream_parts(rows, k, n, nnz, blind_t, d2, chunk_rows,
                               poseidon)
        linear = p["r"] + max(p["sampler"], p["r_coeffs"] + p["block"])
        return int((p["coo"] + p["coeffs"] + max(
            p["upload"], p["encode"], p["reencode"], linear,
            p["r_coeffs"] + p["pair"], p["quad"])) * ESTIMATE_MARGIN)

    def resident_bytes(self, rows: int, k: int, n: int, nnz: int,
                       blind_t: int = 0, d2: int | None = None,
                       chunk_rows: int = STREAM_MAX_CHUNK_ROWS,
                       poseidon: bool = False) -> int:
        """Estimate of the resident prover's largest live set for one
        proof: what :meth:`streaming_bytes` holds throughout (A's COO, the
        coefficient chunks) and U's real rows (4m, and the three mask rows
        under zk) n wide in 16-bit limbs, beside the largest of: A's upload;
        a chunk's encode, its codewords and NTT scratch, its opened columns
        and, under ``poseidon``, the column sponges' states and digests
        (the encode, the commit and the openings, summed: an estimate that
        takes every term of :meth:`streaming_bytes` and adds U, so that it
        lies above it at every chunking); the linear phase; the linear
        product's chunk pair with the r^T A chunks; or a block of the
        quadratic product.  Nothing is re-encoded."""
        d2 = 2 * k if d2 is None else d2
        p = self._stream_parts(rows, k, n, nnz, blind_t, d2, chunk_rows,
                               poseidon)
        u = rows * n * self.L * 2
        linear = p["r"] + max(p["sampler"], p["r_coeffs"] + p["block"])
        return int((p["coo"] + p["coeffs"] + u + max(
            p["upload"],
            p["encode"] + p["codewords"] + p["opened"] + p["sponge"],
            linear, p["r_coeffs"] + p["pair"], p["quad"])) * ESTIMATE_MARGIN)

    def streaming_verify_bytes(self, rows: int, k: int, n: int, nnz: int,
                               chunk_rows: int, batch: int = 1) -> int:
        """Estimate of the streaming (and resident: the verifier holds no
        U) verifier's largest live set for
        ``batch`` proofs: A's COO and each proof's r^T A coefficient
        chunks, beside the upload, one proof's challenge vector with a
        sampler segment or a sparse block, or one chunk's n-point int32
        transform with the columns gathered from it (int32: twice the
        prover's 16-bit opened columns)."""
        p = self._stream_parts(rows, k, n, nnz, 0, 2 * k, chunk_rows)
        return int((p["coo"] + batch * p["r_coeffs"] + max(
            p["upload"], p["r"] + max(p["sampler"], p["block"]),
            p["transform"] + 2 * p["opened"])) * ESTIMATE_MARGIN)

    def stream_chunk_rows(self, rows: int, k: int, n: int, nnz: int,
                          blind_t: int = 0, d2: int | None = None,
                          poseidon: bool = False) -> int:
        """The largest chunk, a multiple of :data:`STREAM_ROW_QUANTUM` rows
        and at most :data:`STREAM_MAX_CHUNK_ROWS` (or the rows rounded up,
        over a mesh the rows a device: each step keeps every device busy),
        whose :meth:`streaming_bytes` fits the device; 0 where none does."""
        data = rows - 3 if blind_t else rows
        q = STREAM_ROW_QUANTUM
        devices = len(self._column_split(n))
        top = min(STREAM_MAX_CHUNK_ROWS, -(-data // (q * devices)) * q)
        budget = self.memory_budget()
        for cr in range(top, 0, -q):
            need = self.streaming_bytes(rows, k, n, nnz, blind_t, d2, cr,
                                        poseidon)
            if need <= budget:
                return cr
        return 0

    def encode_mode(self, rows: int, k: int, n: int, nnz: int,
                    blind_t: int = 0, d2: int | None = None,
                    poseidon: bool = False) -> tuple[str, int]:
        """``("direct", 0)`` where :meth:`direct_bytes` fits the device;
        else the chunking streaming mode fits (:meth:`stream_chunk_rows`;
        ``poseidon``: under the Poseidon commitment), and
        ``("resident", chunk rows)`` where :meth:`resident_bytes` fits at
        that chunking too (on one device: :data:`RESIDENT`), else
        ``("streaming", chunk rows)``.  Resident mode holds U beside the
        chunks streaming mode would take and never takes smaller ones to
        make room for it: smaller chunks slow every chunked step, and a
        budget at a streaming estimate gives streaming mode, since
        :meth:`resident_bytes` lies above :meth:`streaming_bytes` at every
        chunking.  Raises :class:`DeviceMemoryError`, naming the estimates,
        where no chunking fits."""
        direct = self.direct_bytes(rows, k, n, nnz, blind_t, d2)
        budget = self.memory_budget()
        if direct <= budget:
            return "direct", 0
        cr = self.stream_chunk_rows(rows, k, n, nnz, blind_t, d2, poseidon)
        if cr and self.RESIDENT and self.resident_bytes(
                rows, k, n, nnz, blind_t, d2, cr, poseidon) <= budget:
            return "resident", cr
        if cr:
            return "streaming", cr
        least = []
        for mode in (["resident"] if self.RESIDENT else []) + ["streaming"]:
            need = getattr(self, f"{mode}_bytes")(
                rows, k, n, nnz, blind_t, d2, STREAM_ROW_QUANTUM, poseidon)
            least.append(f"~{need / 2**30:.1f} GiB in {mode} mode")
        raise DeviceMemoryError(
            f"instance needs ~{direct / 2**30:.1f} GiB on {self.device} in "
            f"direct mode, {', '.join(least)} at its smallest chunks "
            f"(budget {budget / 2**30:.1f} GiB)")

    # ------------------------------------------------------------------
    # transforms
    # ------------------------------------------------------------------
    # the transforms read int32 limbs or 16-bit ones (a chunk), and write
    # 16-bit limbs where ``out16`` (into a chunk)
    def ntt(self, coeffs, n: int, out16: bool = False):
        return cuda_ntt.ntt(self.field, self.asarray(coeffs), n, out16=out16)

    def intt(self, evals, n: int, out16: bool = False):
        return cuda_ntt.ntt(self.field, self.asarray(evals), n, inverse=True,
                            out16=out16)

    def rs_encode_rows(self, preenc, k: int, n: int):
        """(B, k, L) message rows -> (coeffs (B, k, L), evals (B, n, L))."""
        coeffs = self.intt(preenc, k)
        return coeffs, cuda_ntt.ntt(self.field, coeffs, n)

    def rs_encode_and_canon(self, preenc, k: int, n: int):
        """(B, k, L) -> (coeffs, canonical codewords (B, n, L)); the
        from-Montgomery epilogue is fused into the NTT_n."""
        coeffs = self.intt(preenc, k)
        return coeffs, self.ntt_and_canon(coeffs, n)

    def ntt_and_canon(self, coeffs, n: int, out16: bool = False):
        """(B, w, L) coefficient rows (w <= n, zero-extended) -> (B, n, L)
        canonical codewords (16-bit where ``out16``: a codeword chunk).
        The zk prover's encode: blinded rows are in coefficient space
        already."""
        return cuda_ntt.ntt(self.field, self.asarray(coeffs), n,
                            canon_out=True, out16=out16)

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

    # ------------------------------------------------------------------
    # direct mode: the committed matrices of B proofs
    # ------------------------------------------------------------------
    def upload_messages(self, preenc: list) -> torch.Tensor:
        """B host (4m, k, L) message matrices -> (B, 4m, k, L) on the
        device."""
        if len(preenc) == 1:
            return self.asarray(preenc[0])[None]
        return torch.stack([self.asarray(a) for a in preenc])

    def rs_encode_batch(self, msgs, k: int, n: int):
        """(B, 4m, k, L) message rows -> ``(coeffs (B, 4m, k, L), canonical
        codewords (B 4m, n, L))``: every proof's rows in one encode."""
        B, rows = msgs.shape[:2]
        coeffs, u_canon = self.rs_encode_and_canon(
            msgs.reshape(B * rows, k, -1), k, n)
        return coeffs.reshape(B, rows, k, -1), u_canon

    def zk_blind_batch(self, msgs, rows_seeds: list, blind_t: int, d2: int,
                       mask3s: list):
        """:meth:`zk_blind_rows` of each proof of (B, 4m, k, L) message
        rows -> ``(coeffs (B, 4m, k + b, L), rows (B (4m + 3), d2, L))``."""
        blinded = [self.zk_blind_rows(msgs[i], rows_seeds[i], blind_t, d2,
                                      mask3s[i]) for i in range(len(mask3s))]
        if len(blinded) == 1:
            return blinded[0][0][None], blinded[0][1]
        coeffs = torch.stack([c for c, _ in blinded])
        rows = torch.cat([r for _, r in blinded])
        return coeffs, rows

    def row_matrix(self, a):
        """A (rows, w, L) matrix the bulk steps take as a whole (the r^T A
        coefficient rows): the tensor on the device here; row blocks over
        the mesh in ``parallel.ShardedBackend``."""
        return self.asarray(a)

    def column_blocks(self, u_canon, batch: int = 1):
        """The columns of ``batch`` stacked (rows, n, L) matrices for a
        column hash, as (batch, rows, n_i, L) blocks in column order: here
        the whole matrices, one block; over a mesh one block a device
        (``parallel.ShardedBackend``)."""
        u = self.asarray(u_canon)
        yield u.reshape(batch, u.shape[0] // batch, *u.shape[1:])

    # ------------------------------------------------------------------
    # where the parts of a matrix lie (a mesh deals them over its devices)
    # ------------------------------------------------------------------
    def _chunk_device(self, i: int) -> torch.device:
        """The device of chunk ``i`` of a streaming matrix: here the one
        device."""
        return self.device

    def holds_chunk(self, i: int) -> bool:
        """Whether this process holds chunk ``i`` of a streaming matrix:
        here every chunk (over a process mesh, rank i mod D's)."""
        return True

    @contextlib.contextmanager
    def _on(self, device):
        """A context, with ``device`` current for the kernels' launches,
        that yields the single-device backend of ``device``: here this
        backend."""
        yield self

    def _column_split(self, n: int) -> list[tuple[torch.device, int, int]]:
        """Where a column hash runs: ``(device, first column, end)`` per
        block of columns, in column order; here all n on the device."""
        return [(self.device, 0, n)]

    def place_chunk(self, i: int, chunk: torch.Tensor) -> torch.Tensor:
        """Chunk ``i`` of a streaming matrix made on the controller (the
        r^T A coefficient chunks) moved to :meth:`_chunk_device`, beside
        the coefficient chunk it pairs with."""
        return chunk.to(self._chunk_device(i))

    def _join_chunks(self, parts: dict, rcm: RowChunkedMatrix, inner: tuple,
                     device, dtype=torch.int32) -> torch.Tensor:
        """Per chunk i of ``rcm`` held here, a (real rows of chunk i,
        *inner) result of ``dtype`` -> every chunk's, in row order, on
        ``device`` (over a process mesh gathered from the ranks)."""
        return torch.cat([parts[i].to(device) for i in range(len(rcm.chunks))])

    def _combine_ranks(self, total, count: int, shape):
        """A partial sum over the chunks of ``count`` held here -> the sum
        over all (over a process mesh the ranks' sums added mod p)."""
        return total

    def column_digests(self, u_canon, batch: int, digest) -> torch.Tensor:
        """``digest(block)`` ((batch, columns, W)) of each column block of
        :meth:`column_blocks`, joined in column order on the device:
        every column's digests, (batch, n, W)."""
        return torch.cat([digest(block).to(self.device)
                          for block in self.column_blocks(u_canon, batch)],
                         dim=1)

    def _rows_up16(self, preenc, r0: int, r1: int) -> torch.Tensor:
        """Host message rows [r0, r1) on the device in 16-bit limbs
        (int16), as the NTT reads them: 16-bit host limbs cross as they
        are, with no pass over them on either side."""
        blk = np.ascontiguousarray(preenc[r0:r1])
        if blk.dtype != np.uint16:
            return fieldops.narrow16(self.asarray(blk))
        return torch.from_numpy(blk.view(np.int16)).to(self.device)

    def _rows_up(self, preenc, r0: int, r1: int) -> torch.Tensor:
        """Host message rows [r0, r1) as int32 limbs on the device (direct
        mode's row blocks): 16-bit limbs cross as they are and widen
        there (half the bytes of an int32 copy, and no host pass)."""
        blk = np.ascontiguousarray(preenc[r0:r1])
        if blk.dtype != np.uint16:
            return self.asarray(blk)
        return fieldops.widen16(self._rows_up16(blk, 0, blk.shape[0]))

    def _chunk_up(self, preenc, r0: int, chunk_rows: int) -> torch.Tensor:
        """Host message rows [r0, r0 + chunk_rows) (fewer at the end) on
        the device in 16-bit limbs, zero rows below them to
        ``chunk_rows``."""
        blk = self._rows_up16(preenc, r0, r0 + chunk_rows)
        if blk.shape[0] < chunk_rows:
            blk = torch.cat([blk, blk.new_zeros(
                (chunk_rows - blk.shape[0],) + tuple(blk.shape[1:]))])
        return blk

    def encode_chunks(self, preenc, k: int,
                      chunk_rows: int) -> RowChunkedMatrix:
        """Streaming encode: host (rows, k, L) message rows up a chunk at a
        time, each iNTT_k'd into a 16-bit coefficient chunk; the message
        matrix is never whole on the device (``Backend.intt_resident``)."""
        rows, chunks = preenc.shape[0], []
        for i, r0 in enumerate(range(0, rows, chunk_rows)):
            if not self.holds_chunk(i):
                chunks.append(None)
                continue
            with self._on(self._chunk_device(i)) as be:
                chunks.append(be.intt(be._chunk_up(preenc, r0, chunk_rows), k,
                                      out16=True))
        return RowChunkedMatrix(chunks, rows, chunk_rows, k)

    def resident_codewords(self, coeffs: RowChunkedMatrix, n: int,
                           tail: torch.Tensor | None = None
                           ) -> StreamedCodewords:
        """Resident encode (``Backend.rs_encode_resident``, and the
        ``RowChunkedMatrix`` branch of ``_zk_encode_streamed``): the
        coefficient chunks of :meth:`encode_chunks` (zk: the blinded chunks
        of :meth:`zk_blind_chunks`) and the mask rows' ``tail`` (3, d2, L)
        below them, each encoded once to canonical n-point codewords in
        16-bit limbs (``narrow16``) and held beside them; of the last chunk
        only its real rows (the padding's transform is dropped).  One
        device only (:data:`RESIDENT`)."""
        canon = []
        for i, c in enumerate(coeffs.chunks):
            u, real = self.ntt_and_canon(c, n, out16=True), coeffs.real_rows(i)
            canon.append(u if real == u.shape[0] else u[:real].clone())
        return StreamedCodewords(
            coeffs, n, tail, RowChunkedMatrix(canon, coeffs.rows,
                                              coeffs.chunk_rows, n),
            None if tail is None else self.ntt_and_canon(tail, n, out16=True))

    def part_codewords(self, coeffs, real: int, held, n: int) -> torch.Tensor:
        """A part of a :class:`StreamedCodewords` (``parts()``) as the
        canonical codewords of its real rows, 16-bit: ``held`` in resident
        mode, else its coefficient block re-encoded (``ntt_and_canon``)
        where it lies."""
        if held is not None:
            return held
        with self._on(coeffs.device) as be:
            return be.ntt_and_canon(coeffs, n, out16=True)[:real]

    def zk_blind_chunks(self, preenc, rows_seed: bytes, blind_t: int,
                        chunk_rows: int) -> RowChunkedMatrix:
        """Streaming :meth:`zk_blind_rows`: the blinded (k + b)-wide
        coefficient rows u_i = msg_i + (x^k - 1) s_i, a chunk at a time
        from host message rows, the s draws taken in row order from the one
        ``rows_seed`` stream (the draws of :meth:`zk_blind_rows`, bit for
        bit).  The subtraction runs in int32 limbs, and each chunk is
        narrowed to 16 bits once, as the JAX package's ``coeffs_resident``
        stores it.  Padding rows stay zero."""
        rows4, k, L = preenc.shape
        b, cr = blind_t, chunk_rows
        stream = devsampler.FrStream(self.field, rows_seed, self.device,
                                     segment=cr * k)
        chunks = []
        for i, r0 in enumerate(range(0, rows4, cr)):
            real = min(cr, rows4 - r0)
            # every chunk's draws, in row order, wherever the chunk lies
            s = stream.take(real * b).reshape(real, b, L)
            if not self.holds_chunk(i):
                chunks.append(None)
                continue
            with self._on(self._chunk_device(i)) as be:
                msg = be.intt(be._rows_up16(preenc, r0, r0 + real), k)
                s = s.to(be.device)
                chunk = torch.zeros((cr, k + b, L), dtype=torch.int32,
                                    device=be.device)
                chunk[:real, :k] = msg
                del msg
                chunk[:real, k:] = s
                # the regions [0, b) and [k, k + b) overlap when b > k: as
                # in zk_blind_rows, subtract from the concatenated layout
                chunk[:real, :b] = be.sub(chunk[:real, :b], s)
                del s
                chunk = fieldops.narrow16(chunk)
            chunks.append(chunk)
        return RowChunkedMatrix(chunks, rows4, cr, k + b)

    def ntt_columns(self, coeffs, n: int, js) -> torch.Tensor:
        """All rows' n-point NTTs at the columns ``js`` only: (B, k, L) ->
        (B, len(js), L) Montgomery limbs on the device: the full transform
        and a gather; a :class:`RowChunkedMatrix` a chunk at a time where
        the chunk lies, so that one chunk's transform is live."""
        idx = torch.from_numpy(np.asarray(js, dtype=np.int64))
        if isinstance(coeffs, RowChunkedMatrix):
            out = {}
            for i, c in enumerate(coeffs.chunks):
                if c is None:
                    continue
                with self._on(c.device) as be:
                    out[i] = be.ntt(c, n).index_select(
                        1, idx.to(c.device))[:coeffs.real_rows(i)].to(
                            self.device)
            return self._join_chunks(out, coeffs, (len(idx), self.L),
                                     self.device)
        return self.ntt(coeffs, n).index_select(1, idx.to(self.device))

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
        a column block (:meth:`column_blocks`: here all batch * n columns
        at once, over a mesh one block a device), one tree launch per proof
        on one stream, one transfer of the flat trees, host unpacking.  A
        :class:`StreamedCodewords` (one proof, resident or streaming mode)
        takes :meth:`commit_columns_streaming`."""
        if isinstance(u_canon, StreamedCodewords):
            if batch != 1:
                raise ValueError("streaming mode commits one proof at a time")
            return [self.commit_columns_streaming(u_canon)]
        n = u_canon.shape[1]
        leaves_le = self.column_digests(
            u_canon, batch, lambda block: cuda_hash.blake2s_columns(
                self.field, block.reshape(-1, *block.shape[2:]), batch)
            .reshape(batch, -1, 8))
        flat = self.to_numpy(cuda_tree.forest_flat(leaves_le))
        return [hashops.digest_lists(flat[b], n) for b in range(batch)]

    def commit_columns_streaming(self, sc: StreamedCodewords):
        """The commitment of U in row chunks
        (``Backend.commit_columns_streaming``; resident mode: the
        ``RowChunkedMatrix`` branch of ``commit_columns``): each part's
        codewords (:meth:`part_codewords`: held, or the coefficient chunk
        re-encoded where it lies) absorbed into per-column Blake2s states
        (``cuda_hash.ColumnHashStream``, the streamed kernel entry) in row
        order, each block of :meth:`_column_split` on its device (over a
        mesh: the row -> column re-shard of each part); the last part's
        launch finalises, then the tree as in direct mode.  The leaves are
        :meth:`commit_columns`'s on the whole matrix."""
        n = sc.n
        blocks = [(dev, c0, c1, cuda_hash.ColumnHashStream(
            self.field, c1 - c0, sc.rows, dev))
            for dev, c0, c1 in self._column_split(n)]
        for coeffs, real, held in sc.parts():
            canon = self.part_codewords(coeffs, real, held, n)
            for dev, c0, c1, hs in blocks:
                with self._on(dev):
                    hs.absorb(canon[:, c0:c1].to(dev), real)
            del canon
        leaves = torch.cat([hs.digests().to(self.device)
                            for _, _, _, hs in blocks])
        flat = self.to_numpy(cuda_tree.forest_flat(leaves[None]))
        return hashops.digest_lists(flat[0], n)

    def gather_columns_batch(self, u_canon, idx) -> np.ndarray:
        """Per-proof openings: (B * rows, n, L) and ``idx`` (B, t) ->
        (B, rows, t, L) host uint32: proof b's columns ``idx[b]``.  A
        :class:`StreamedCodewords` (one proof) takes each part's codewords
        (:meth:`part_codewords`: held in resident mode, an ``index_select``
        as the JAX package's ``xp.take``; re-encoded in streaming mode) and
        copies the opened columns of its real rows to the host
        (``Backend.gather_columns``), each part where it lies.  In every
        mode the columns cross to the host in 16-bit limbs (narrowed on
        the device where U is int32, as the JAX package's
        ``gather_columns`` does) and widen there."""
        idx = torch.from_numpy(np.asarray(idx, dtype=np.int64))
        if isinstance(u_canon, StreamedCodewords):
            if idx.shape[0] != 1:
                raise ValueError("streaming mode opens one proof at a time")
            rcm, n, parts = u_canon.coeffs, u_canon.n, {}
            for i, (coeffs, real, held) in enumerate(u_canon.parts()):
                if coeffs is None:
                    continue
                canon = self.part_codewords(coeffs, real, held, n)
                parts[i] = self.opened_to_host(canon.index_select(
                    1, idx[0].to(canon.device)))
                del canon
            tail = parts.pop(len(rcm.chunks), None)      # the zk mask rows
            cols = [self._join_chunks(parts, rcm, (idx.shape[1], self.L),
                                      "cpu", torch.int16)]
            return self.to_numpy(torch.cat(
                cols if tail is None else cols + [tail]))[None]
        return self.to_numpy(self._gather_to_host(u_canon, idx))

    def _gather_to_host(self, u_canon, idx, non_blocking: bool = False
                        ) -> torch.Tensor:
        """Direct mode's openings: (B * rows, n, L) on the device and
        ``idx`` (B, t) int64 -> (B, rows, t, L) int16 on the host (see
        :meth:`opened_to_host`)."""
        idx = idx.to(self.device, non_blocking=non_blocking)
        batch, t = idx.shape
        u4 = u_canon.reshape(batch, -1, *u_canon.shape[1:])
        index = idx[:, None, :, None].expand(batch, u4.shape[1], t, u4.shape[3])
        return self.opened_to_host(torch.gather(u4, 2, index),
                                   non_blocking=non_blocking)

    def opened_to_host(self, cols: torch.Tensor,
                       non_blocking: bool = False) -> torch.Tensor:
        """Opened columns where they lie (int32 or 16-bit limbs) -> an
        int16 tensor on the host: narrowed on the device, so that two
        bytes a limb cross (the JAX package's ``gather_columns`` copies
        uint16).  ``non_blocking`` (a CUDA tensor): into pinned host memory
        by the copy engine, ordered on the current stream; the caller waits
        for that stream before it reads the result."""
        cols = fieldops.narrow16(cols)
        if not non_blocking or cols.device.type != "cuda":
            return cols.cpu()
        host = torch.empty(cols.shape, dtype=torch.int16, pin_memory=True)
        return host.copy_(cols, non_blocking=True)

    def gather_columns(self, u_canon, js) -> np.ndarray:
        """Columns ``js`` of (rows, n, L) -> (rows, len(js), L) host uint32."""
        return self.gather_columns_batch(u_canon, [js])[0]

    def gather_columns_start(self, u_canon: torch.Tensor,
                             js) -> "PendingColumns":
        """Start :meth:`gather_columns` of one direct-mode matrix and hand
        back at once (the JAX package's ``_start_open_async``): on a CUDA
        device the index upload, the gather, the narrowing to 16 bits and
        the copy into pinned host memory run on this backend's side stream
        (:meth:`side_stream`), behind the work the current stream holds at
        the call (which wrote U), and ahead of nothing the current stream
        does later; on the CPU the gather runs here.
        :meth:`gather_columns_finish` waits for it.  An error of the start
        is kept and raised at the finish.  U is marked as read by the side
        stream (``record_stream``), so the caching allocator does not hand
        its blocks to the current stream before the gather has read them,
        whenever U is freed; the pinned buffer lives in the handle until
        the finish."""
        pending = PendingColumns(js)
        try:
            idx = torch.tensor([list(js)], dtype=torch.int64)
            if self.device.type != "cuda":
                pending.host = self._gather_to_host(u_canon, idx)
                return pending
            side = self.side_stream()
            side.wait_stream(torch.cuda.current_stream(self.device))
            u_canon.record_stream(side)
            with torch.cuda.stream(side):
                pending.host = self._gather_to_host(u_canon, idx.pin_memory(),
                                                    non_blocking=True)
                pending.event = torch.cuda.Event(enable_timing=True)
                pending.event.record(side)
            pending.stream = side
        except Exception as e:  # noqa: BLE001 -- raised at the finish
            pending.err = e
        return pending

    def gather_columns_finish(self, pending: "PendingColumns") -> np.ndarray:
        """The columns a :meth:`gather_columns_start` gathered, (rows, t,
        L) host uint32: waits for its copy (the event), then widens on the
        host; raises the start's error where it had one."""
        if pending.err is not None:
            raise pending.err
        if pending.event is not None:
            pending.event.synchronize()
        return self.to_numpy(pending.host)[0]

    def side_stream(self) -> torch.cuda.Stream:
        """This backend's side CUDA stream (made at first use; one a
        backend and device), where the openings' gathers and copies run
        beside the prover's later phases.  Raises where it cannot be made:
        the openings never fall back to the current stream quietly."""
        if self._side is None:
            self._side = torch.cuda.Stream(device=self.device)
        return self._side

    # ------------------------------------------------------------------
    # interleaved / linear / quadratic phases
    # ------------------------------------------------------------------
    def row_combine(self, r, mat):
        """sum_i r_i M_i for M (B, k, L) and r (B, L) or (B, k, L) ->
        (k, L) (Montgomery when both are, canonical when M is)."""
        return cuda_lc.row_combine(self.field, self.asarray(r), self.asarray(mat))

    def row_combine_batch(self, r, mats):
        """Per-proof combinations: r (B, rows, L) x mats (B, rows, k, L) ->
        (B, k, L), each as :meth:`row_combine` gives it.  A chunked handle
        (one proof) takes :meth:`row_combine_chunked`."""
        if isinstance(mats, (RowChunkedMatrix, MessageRows)):
            if r.shape[0] != 1:
                raise ValueError("streaming mode combines one proof at a time")
            return self.row_combine_chunked(r[0], mats)[None]
        return cuda_lc.row_combine_batch(self.field, self.asarray(r),
                                         self.asarray(mats))

    def row_combine_chunked(self, r, mat):
        """sum_i r_i M_i over a :class:`RowChunkedMatrix` (the
        ``row_combine`` kernel a chunk where it lies, partials added mod p
        on the device); for :class:`MessageRows`, that of the coefficient
        rows and one NTT_k (``Backend.row_combine_coeffs``): the
        message-space combination, the same field elements by
        linearity."""
        rcm = mat.coeffs if isinstance(mat, MessageRows) else mat
        r = self.asarray(r)
        total = None
        for i, chunk in enumerate(rcm.chunks):
            if chunk is None:
                continue
            r0, real = i * rcm.chunk_rows, rcm.real_rows(i)
            with self._on(chunk.device) as be:
                part = be.row_combine(r[r0:r0 + real].to(chunk.device),
                                      chunk[:real]).to(self.device)
            total = part if total is None else fieldops.add(self.field,
                                                            total, part)
        total = self._combine_ranks(total, len(rcm.chunks),
                                    (rcm.width, self.L))
        if isinstance(mat, MessageRows):
            return self.ntt(total[None], rcm.width)[0]
        return total

    def rand_field_mont(self, count: int, seed: bytes,
                        segment: int = 0) -> torch.Tensor:
        """``F::rand`` expansion on the device, bit-identical to
        ``sampling.rand_field_elements_limbs``; with ``segment``, drawn
        ``segment`` attempts at a time (:class:`devsampler.FrStream`)."""
        if segment:
            return devsampler.FrStream(self.field, seed, self.device,
                                       segment).take(count)
        return devsampler.fr_sample(self.field, count, seed, self.device)

    def sparse_rA_mont(self, rowids, colids, vals_mont, r_mont,
                       num_cols: int) -> torch.Tensor:
        """out[col] = sum of vals[i] * r[rowids[i]] over entries in col,
        mod p; all Montgomery: :meth:`sparse_rA_blocks` with one block of
        all ``num_cols`` columns (A's entries in any order)."""
        return next(self.sparse_rA_blocks(rowids, colids, vals_mont, r_mont,
                                          [0, len(rowids)], num_cols))

    def sparse_rA_blocks(self, rowids, colids, vals_mont, r_mont,
                         bounds: list[int], block_cols: int, only=None):
        """r^T A in column blocks (``Backend.sparse_rA_mont_blocked``):
        A's entries sorted by column, ``bounds[j]`` the first entry of block
        j (columns [j block_cols, (j + 1) block_cols)); yields each block's
        (block_cols, L) Montgomery sums in column order.  A block's entries
        go through the mont_mul kernel and an exact int64 ``index_add_`` of
        the limbs ``block_cols`` at a time (order-independent), then one
        :func:`fieldops.fold_wide`: the same values as the whole product.
        Columns past A's run (the last block's padding) are zeros.  With
        ``only``, a block j where ``only(j)`` is false yields None (over a
        process mesh: a chunk another rank holds)."""
        for j in range(len(bounds) - 1):
            if only is not None and not only(j):
                yield None
                continue
            c0 = j * block_cols
            sums = torch.zeros((block_cols, self.L), dtype=torch.int64,
                               device=self.device)
            for e0 in range(bounds[j], bounds[j + 1], block_cols):
                e1 = min(e0 + block_cols, bounds[j + 1])
                gathered = r_mont.index_select(0, rowids[e0:e1])
                prod = self.mont_mul(vals_mont[e0:e1], gathered)
                del gathered
                sums.index_add_(0, colids[e0:e1] - c0, prod.to(torch.int64))
                del prod
            yield fieldops.fold_wide(self.field, sums, mul=cuda_mont.mont_mul)
            del sums

    def linear_combination_poly(self, u_coeffs, r_coeffs, d2: int):
        """q = sum_i r_i(X) u_i(X) by pointwise products on the d2 domain
        (2k without zk): (d2, L) Montgomery coefficients of q.  The rows
        may be of any widths <= d2 (k + b and k under zk); d2 must exceed
        deg q.  Two row-aligned :class:`RowChunkedMatrix` go a chunk pair
        at a time where the u chunk lies, partials added mod p (padding
        rows add zero)."""
        if isinstance(u_coeffs, RowChunkedMatrix):
            if (not isinstance(r_coeffs, RowChunkedMatrix)
                    or r_coeffs.rows != u_coeffs.rows
                    or r_coeffs.chunk_rows != u_coeffs.chunk_rows):
                raise ValueError("linear_combination_poly: u and r chunks "
                                 "are not row-aligned")
            total = None
            for uc, rc in zip(u_coeffs.chunks, r_coeffs.chunks):
                if uc is None:
                    continue
                with self._on(uc.device) as be:
                    eu = be.ntt(uc, d2)
                    er = be.ntt(rc.to(uc.device), d2)
                    part = cuda_lc.row_combine(self.field, er, eu).to(
                        self.device)
                    del eu, er
                total = part if total is None else fieldops.add(
                    self.field, total, part)
            total = self._combine_ranks(total, len(u_coeffs.chunks),
                                        (d2, self.L))
            return self.intt(total[None], d2)[0]
        eu = self.ntt(u_coeffs, d2)
        er = self.ntt(r_coeffs, d2)
        total = cuda_lc.row_combine(self.field, er, eu)
        del eu, er
        return self.intt(total[None], d2)[0]

    def quadratic_combination_poly(self, xyz_coeffs, r_quad, d2: int,
                                   m: int | None = None):
        """p0 = sum_i r_i (x_i y_i - z_i) on the d2 domain: (d2, L)
        Montgomery coefficients.  ``xyz_coeffs``: the x, y, z rows (3m),
        or with ``m`` given any rows whose first 3m are those.  A
        :class:`RowChunkedMatrix` goes in blocks of its chunk's rows that
        stop at each region's end (rows 0, m, 2m start the regions; a
        chunk may straddle them), each where its x rows lie (the y and z
        rows copied there), partials added mod p."""
        if isinstance(xyz_coeffs, RowChunkedMatrix):
            rcm, qb = xyz_coeffs, xyz_coeffs.chunk_rows
            r_quad = self.asarray(r_quad)
            total = None
            for i in range(0, m, qb):
                end = min(i + qb, m)
                dev = rcm.chunks[i // qb].device
                with self._on(dev) as be:
                    ex, ey, ez = (be.ntt(rcm.row_block(base + i, base + end,
                                                       dev), d2)
                                  for base in (0, m, 2 * m))
                    term = be.mont_mul(ex, ey)
                    del ex, ey
                    term = be.sub(term, ez)
                    del ez
                    part = be.row_combine(r_quad[i:end].to(dev), term).to(
                        self.device)
                    del term
                total = part if total is None else fieldops.add(
                    self.field, total, part)
            return self.intt(total[None], d2)[0]
        if m is not None:
            xyz_coeffs = xyz_coeffs[:3 * m]
        m = xyz_coeffs.shape[0] // 3
        ev = self.ntt(xyz_coeffs, d2)
        term = self.sub(self.mont_mul(ev[:m], ev[m:2 * m]), ev[2 * m:])
        del ev
        total = self.row_combine(r_quad, term)
        return self.intt(total[None], d2)[0]
