"""The Ligero SNARK's prover and verifier, plain and zk, on a PyTorch device.

The port's counterpart of ``LigeroCircuit`` in ``ligero_tpu/ligero/core.py``
for the single-device path.  The mode is chosen per instance from the
backend's live-set estimates (``encode_mode``): "direct", where the whole
codeword matrix U lives on ``device`` as one tensor; past it U and its
coefficient rows in row chunks (``engine/devmatrix.py``), the commit
absorbing a codeword chunk at a time into per-column Blake2s or Poseidon
states and the linear phase in column blocks aligned with the chunks:
"resident", where the codeword chunks fit beside the rest and are encoded
once, or "streaming", where only the coefficient chunks are held and the
commit and the openings re-encode them.  Resident and streaming proofs are
byte-identical to direct ones.  Over a mesh of devices
(``backend=parallel.ShardedBackend(field, mesh)``) the bulk steps run
row-sharded, in direct or streaming mode and for batches;
the core passes the backend's row blocks and chunks on without opening
them.  The commitment is
pluggable
(``mt_params``, ``ligero/types.py``): the default Blake2s column leaves and
SHA-256 Merkle tree, or the Poseidon column sponges and Poseidon tree of
``LigeroMTPoseidonParams``, each computed on the device.  The host keeps
what the JAX package keeps on the host: the circuit compile (``compile``),
witness evaluation (``witness``), the Fiat-Shamir transcript (Poseidon
sponge), Merkle paths, and the verifier's path checks and Blake2s leaves of
the opened columns (Poseidon leaves of the opened columns are computed on
the device).  Every bulk step runs through :class:`TorchBackend`.

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

``prove_batch`` and ``verify_batch`` serve B witnesses or proofs of one
circuit at once: each proof keeps its own transcript, so proofs and
verdicts are those of B single calls, while the encode, the column
hashes, the interleaved combinations, the openings and the verifier's
transforms run once for the whole batch.  One schedule serves a single
proof and a batch: ``prove`` is a batch of one.
"""

from __future__ import annotations

import hashlib
import secrets
import time
import warnings

import numpy as np
import torch

from ..engine import cuda_build
from ..engine.backend import DeviceMemoryError, MessageRows, TorchBackend
from ..engine.devmatrix import RowChunkedMatrix, StreamedCodewords
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
from .types import LigeroMTTestParams, is_default_mt_params
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


def _mont_values(field, ints: list[int]) -> np.ndarray:
    """Montgomery limbs of ``ints``, each distinct value converted once:
    A's values are few (+-1 and the circuit's constants), and the
    conversion of a Python int is what its upload spends its time on."""
    distinct = list(dict.fromkeys(ints))
    pos = {v: i for i, v in enumerate(distinct)}
    idx = np.fromiter(map(pos.__getitem__, ints), dtype=np.int64,
                      count=len(ints))
    return field.ints_to_mont_limbs(distinct)[idx]


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
    kernels, built for BN254 Fr and BLS12-377 Fq; a circuit over another
    field raises) or ``"cpu"`` (the kernels' plain PyTorch versions, any
    field).  The default is the CUDA device; where there is none the
    constructor raises.  ``zk=True`` compiles the zero-knowledge variant;
    a circuit too small for it at this rate raises ``ValueError``.
    ``mt_params`` is the commitment: ``None`` for the default
    (``LigeroMTTestParams``), or params with ``device_col_digests``,
    ``device_tree_levels`` and ``check_backend`` (``LigeroMTPoseidonParams``;
    over BLS12-377 Fq it raises ``ValueError`` here).  ``encode_mode`` is
    "direct", "resident" or "streaming" (``chunk_rows`` rows a chunk; 0
    in direct mode), the first whose estimate fits the device's memory
    (under either commitment); an instance that fits none raises
    ``DeviceMemoryError``.  Resident and streaming mode prove one witness
    at a time.

    ``backend`` takes the place of ``device``: a :class:`TorchBackend` of
    the circuit's field, such as ``parallel.ShardedBackend(field, mesh)``,
    whose bulk steps run row-sharded over a mesh of devices (proofs and
    verdicts byte-identical to one device's, in direct and streaming
    mode, batches included, never in resident mode; the Poseidon
    commitment in direct mode only).
    Giving both raises ``ValueError``."""

    def __init__(self, circuit, outputs: list[int],
                 lambda_: int = DEFAULT_SECURITY_LEVEL, rate_inv: int = 8,
                 zk: bool = False, device=None, timer: PhaseTimer | None = None,
                 mt_params=None, backend: TorchBackend | None = None):
        self._setup(compile_circuit(circuit, outputs, lambda_, rate_inv, zk),
                    device, timer, mt_params, backend)

    @classmethod
    def from_compiled(cls, state: CompiledInstance, device=None,
                      timer: PhaseTimer | None = None,
                      mt_params=None,
                      backend: TorchBackend | None = None) -> "LigeroCircuit":
        obj = cls.__new__(cls)
        obj._setup(state, device, timer, mt_params, backend)
        return obj

    def _setup(self, st: CompiledInstance, device, timer, mt_params,
               backend) -> None:
        self.state = st
        self.field = st.field
        if backend is None:
            backend = TorchBackend(st.field, device)
        elif device is not None:
            raise ValueError("LigeroCircuit: give a device or a backend, "
                             "not both")
        elif backend.field.p != st.field.p:
            raise ValueError(f"a {backend.field.name} backend for a "
                             f"{st.field.name} circuit")
        self.backend = backend
        self.device = self.backend.device
        self.timer = timer or PhaseTimer()
        self.backend.timer = self.timer
        self.mt_params = LigeroMTTestParams() if mt_params is None else mt_params
        self._mt_default = is_default_mt_params(self.mt_params)
        if not self._mt_default:
            # the port commits on the device only
            hooks = ("device_col_digests", "device_tree_levels", "check_backend")
            missing = [h for h in hooks if not hasattr(self.mt_params, h)]
            if missing:
                raise TypeError(f"mt_params {type(self.mt_params).__name__} "
                                f"lacks {', '.join(missing)}")
            self.mt_params.check_backend(self.backend)
        self.circuit, self.outputs = st.circuit, st.outputs
        self.m, self.k, self.n, self.t = st.m, st.k, st.n, st.t
        self.zk, self.blind_t, self.d2 = st.zk, st.blind_t, st.d2
        self.blind_len, self.num_rows = st.blind_len, st.num_rows
        self.lin_bound, self.quad_bound = st.lin_bound, st.quad_bound
        self.encode_mode, self.chunk_rows = self.backend.encode_mode(
            self.num_rows, self.k, self.n, len(st.a_vals), self.blind_t,
            self.d2, poseidon=not self._mt_default)
        self._witness = WitnessEvaluator(st)
        self._coo = None
        self._opening = 0      # the index of the proof being opened

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

    def prove_batch(self, assignments: list[list[tuple[int, int]]], sponge,
                    zk_seeds: list[bytes] | None = None) -> list[LigeroProof]:
        """Prove B witnesses of this circuit with the bulk device work
        shared.  Each proof gets its own clone of ``sponge``, and the
        proofs are byte-identical to B ``prove(a, sponge.clone())`` calls
        (under zk: with ``zk_seed=zk_seeds[i]``; fresh seeds when None).
        A batch larger than ``TorchBackend.max_batch`` allows is proved in
        parts; where not even two proofs fit the device together (as in
        resident and streaming mode), one at a time."""
        if not assignments:
            return []
        if not self.zk:
            zk_seeds = [None] * len(assignments)
        elif zk_seeds is None:
            zk_seeds = [secrets.token_bytes(CHACHA_SEED_BYTES)
                        for _ in assignments]
        elif len(zk_seeds) != len(assignments):
            raise ValueError("prove_batch: one zk seed per witness")
        bumped = [[(self.state.bump_index(i), v) for i, v in a]
                  for a in assignments]
        part = self._max_batch()
        out: list[LigeroProof] = []
        for i in range(0, len(bumped), part):
            group = bumped[i:i + part]
            out.extend(self._prove_many(group, [sponge.clone() for _ in group],
                                        zk_seeds[i:i + part]))
        return out

    def _max_batch(self) -> int:
        """Proofs of this instance that go through the device together:
        one in resident and streaming mode."""
        if self.chunk_rows:
            return 1
        return max(1, self.backend.max_batch(
            self.num_rows, self.k, self.n, len(self.state.a_vals),
            self.blind_t, self.d2))

    def _prove_inner(self, var_assignment, sponge,
                     zk_seed: bytes | None = None) -> LigeroProof:
        return self._prove_many([var_assignment], [sponge], [zk_seed])[0]

    def _prove_many(self, assignments, sponges, zk_seeds) -> list[LigeroProof]:
        """One Fiat-Shamir schedule for both modes and any number B of
        witnesses, proof i on ``sponges[i]``.  Without zk the interleaved
        reveal is the message-space combination and the products run on
        the 2k domain; under zk the committed rows are blinded, the reveal
        is in coefficient space (the message-space one would strip the
        blinding), the products run on the d2 domain, and each revealed
        object is padded by its mask row.  The encode, the commit, the
        interleaved combinations and the openings take all B proofs in one
        call each; the linear and quadratic phases go proof by proof
        (their challenges hang on each proof's own transcript, and their
        transients are the instance's largest).  A single proof in direct
        mode on one device (:meth:`_open_overlap_ok`) starts each set's
        gather and copy as soon as its indices are squeezed (FS #4, #7,
        #10) and finishes the three in order at the end, as the JAX
        package does; every other case gathers all sets at once there."""
        be, ph = self.backend, self.timer.phase
        m, p, B = self.m, self.field.p, len(assignments)
        every = range(B)

        def stack(parts):                # no copy for a single proof
            return parts[0][None] if B == 1 else torch.stack(parts)

        if self.zk:
            with ph("zk_blind"):
                masks = [self._zk_masks(seed) for seed in zk_seeds]
        else:
            masks = [(None, None, None)] * B
        coeffs, lc_rows, u_canon = self._encode(assignments, masks)
        with ph("commit"):
            trees = [MerkleTree(leaves, inner_levels=levels) for leaves, levels
                     in self._commit(u_canon, B)]
        # one proof in direct mode on one device: each set's columns are
        # gathered and copied while the later phases run; otherwise one
        # fused gather of all sets after the quadratic phase
        overlap = self._open_overlap_ok(u_canon, B)
        pending = []

        with ph("interleaved"):
            rs = []
            for i in every:
                sponges[i].absorb_bytes(trees[i].root)           # FS #1
                seed = sponges[i].squeeze_bytes(CHACHA_SEED_BYTES)   # FS #2
                rs.append(self._expand_field(4 * m, seed))
            lc_mont = be.row_combine_batch(stack(rs), lc_rows)
            del lc_rows, rs
            lcs, idx1 = [], []
            for i in every:
                lc = _add_mask(be.mont_to_ints(lc_mont[i]), masks[i][0], p)
                lcs.append(lc)
                sponges[i].absorb_field_elems(lc)                # FS #3
                idx1.append(self._sample_indices(
                    sponges[i].squeeze_bytes(CHACHA_SEED_BYTES)))    # FS #4
        if overlap:
            pending.append(self._start_open_async(u_canon, idx1[0]))

        with ph("linear"):
            qs, idx2 = [], []
            for i in every:
                seed = sponges[i].squeeze_bytes(CHACHA_SEED_BYTES)   # FS #5
                r_coeffs = self._r_a_coeff_rows(seed)
                with ph(f"linear.polyprod/{i}"):
                    q_mont = be.linear_combination_poly(coeffs[i], r_coeffs,
                                                        self.d2)
                del r_coeffs
                q = _trim(_add_mask(be.canon_limbs_to_ints(
                    be.from_mont(q_mont)), masks[i][1], p))
                qs.append(q)
                sponges[i].absorb_field_elems(q)                 # FS #6
                idx2.append(self._sample_indices(
                    sponges[i].squeeze_bytes(CHACHA_SEED_BYTES)))    # FS #7
        if overlap:
            pending.append(self._start_open_async(u_canon, idx2[0]))

        with ph("quadratic"):
            p0s, idx3 = [], []
            for i in every:
                seed = sponges[i].squeeze_bytes(CHACHA_SEED_BYTES)   # FS #8
                r_quad = self._expand_field(m, seed)
                p0_mont = be.quadratic_combination_poly(coeffs[i], r_quad,
                                                        self.d2, m)
                p0 = _trim(_add_mask(be.canon_limbs_to_ints(
                    be.from_mont(p0_mont)), masks[i][2], p))
                p0s.append(p0)
                sponges[i].absorb_field_elems(p0)                # FS #9
                idx3.append(self._sample_indices(
                    sponges[i].squeeze_bytes(CHACHA_SEED_BYTES)))    # FS #10

        # opened columns are proof data, never absorbed: each set is
        # squeezed at its FS position above, and only its fetch is
        # deferred, started there (overlap) or gathered with the others
        with ph("open"):
            if overlap:
                pending.append(self._start_open_async(u_canon, idx3[0]))
                opened = [[self._finish_open_async(h, trees[0])
                           for h in pending]]
            else:
                with ph("open.gather"):
                    cols = be.gather_columns_batch(
                        u_canon, [idx1[i] + idx2[i] + idx3[i] for i in every])
                opened = [self._opened(cols[i], trees[i],
                                       (idx1[i], idx2[i], idx3[i]), i)
                          for i in every]
            proofs = [LigeroProof(
                trees[i].root, InterleavedProof(lcs[i], *opened[i][0]),
                LinearConstraintsProof(qs[i], *opened[i][1]),
                QuadraticConstraintsProof(p0s[i], *opened[i][2]))
                for i in every]
        return proofs

    def _encode(self, assignments, masks):
        """The committed rows of every witness: ``(coeffs, lc_rows,
        u_canon)``, the coefficient rows each proof's products take (index
        i: proof i), the rows its interleaved combination takes, and the
        canonical codewords the commit and the openings take.  Direct mode:
        the backend's batch of all B proofs (tensors; over a mesh, row
        blocks: ``parallel.ShardedBackend``).  Resident and streaming mode
        (one proof; its message rows stay on the host): the coefficient
        chunks (in streaming mode over a mesh dealt over its devices), the
        message rows as their coefficients (zk: the coefficient rows
        themselves), and the codewords as :class:`StreamedCodewords` over
        the chunks (zk: the mask rows' coefficients below them), in
        resident mode with the codeword chunks, each encoded once
        (``_rs_encode_streamed`` and ``_zk_encode_streamed`` of the JAX
        package)."""
        be, ph, B = self.backend, self.timer.phase, len(masks)
        preenc = []
        for i, a in enumerate(assignments):
            with ph(f"witness+preenc/{i}"):
                preenc.append(self._witness.preenc(a))
        if self.chunk_rows:
            if B != 1:
                raise ValueError(f"{self.encode_mode} mode proves one "
                                 "witness at a time")
            tail = None
            if self.zk:
                with ph("zk_blind"):
                    chunks = be.zk_blind_chunks(preenc[0], masks[0][4],
                                                self.blind_t, self.chunk_rows)
                    tail = be.asarray(masks[0][3])
            with ph("rs_encode"):
                if not self.zk:
                    chunks = be.encode_chunks(preenc[0], self.k,
                                              self.chunk_rows)
                sc = (be.resident_codewords if self.encode_mode == "resident"
                      else StreamedCodewords)(chunks, self.n, tail)
            return [chunks], chunks if self.zk else MessageRows(chunks), sc
        with ph("witness+preenc"):                  # (B, 4m, k, L)
            msgs = be.upload_messages(preenc)
            del preenc
        if self.zk:
            with ph("zk_blind"):
                coeffs, rows = be.zk_blind_batch(
                    msgs, [mk[4] for mk in masks], self.blind_t, self.d2,
                    [mk[3] for mk in masks])
                del msgs
            with ph("rs_encode"):
                return coeffs, coeffs, be.ntt_and_canon(rows, self.n)
        with ph("rs_encode"):
            coeffs, u_canon = be.rs_encode_batch(msgs, self.k, self.n)
        # the message rows live on for the interleaved combination
        return coeffs, msgs, u_canon

    def _commit(self, u_canon, batch: int):
        """Per proof ``(leaves, inner_levels)`` of ``batch`` stacked
        (rows, n, L) canonical matrices, through ``mt_params``: the default
        params' one Blake2s launch and trees, or the device digests of all
        proofs' columns at once and their trees' levels, a level of every
        tree at once."""
        if self._mt_default:
            return self.backend.commit_columns_batch(u_canon, batch)
        mt, n = self.mt_params, u_canon.shape[1]
        leaves = mt.device_col_digests(self.backend, u_canon, batch)
        levels = mt.device_tree_levels(self.backend, leaves, batch)
        return [(leaves[b * n:(b + 1) * n],
                 [lv[b * len(lv) // batch:(b + 1) * len(lv) // batch]
                  for lv in levels]) for b in range(batch)]

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
        values (one-time upload).  In resident and streaming mode sorted by
        column (stable, on the device) with the first entry of each column
        block (:meth:`_r_a_coeff_rows`) beside them."""
        if self._coo is None:
            with self.timer.phase("linear.coo_upload"):
                st, dev = self.state, self.device
                vals = _mont_values(self.field, st.a_vals)
                cols = torch.from_numpy(st.a_cols).to(dev)
                if not self.chunk_rows:
                    self._coo = (torch.from_numpy(st.a_rows).to(dev), cols,
                                 self.backend.asarray(vals))
                    return self._coo
                cols, order = torch.sort(cols, stable=True)
                order = order.cpu().numpy()
                block = self.chunk_rows * self.k
                starts = torch.arange(0, 4 * self.m * self.k + block, block,
                                      dtype=torch.int64, device=dev)
                bounds = torch.searchsorted(cols, starts).tolist()
                self._coo = (torch.from_numpy(st.a_rows[order]).to(dev), cols,
                             self.backend.asarray(vals[order]), bounds)
        return self._coo

    def _r_a_coeff_rows(self, seed: bytes):
        """r_linear -> r^T A in 4m rows of k -> iNTT_k (Montgomery): one
        tensor in direct mode (over a mesh, row blocks); in resident and
        streaming mode a :class:`RowChunkedMatrix` of 16-bit chunks (the
        JAX package's ``narrow16``) row-aligned with the coefficient
        chunks, each chunk placed beside its coefficient chunk
        (``place_chunk``), r drawn a segment at a time and the sparse
        product run in column blocks of a chunk's rows (``_r_a_coeff_rows``
        of the JAX package, its blocked branch).  Prover and verifier share
        it."""
        be, ph = self.backend, self.timer.phase
        four_mk = 4 * self.m * self.k
        coo = self._device_coo()
        if not self.chunk_rows:
            with ph("linear.expand"):
                r = be.rand_field_mont(four_mk, seed)
            with ph("linear.sparse_rA"):
                r_a = be.sparse_rA_mont(*coo, r, four_mk)
            del r
            with ph("linear.intt"):
                return be.intt(be.row_matrix(
                    r_a.reshape(4 * self.m, self.k, -1)), self.k)
        cr = self.chunk_rows
        with ph("linear.expand"):
            r = be.rand_field_mont(four_mk, seed, segment=cr * self.k)
        count = len(coo[3]) - 1
        blocks = be.sparse_rA_blocks(*coo[:3], r, coo[3], cr * self.k,
                                     only=be.holds_chunk)
        chunks = []
        for i in range(count):
            with ph("linear.sparse_rA"):
                block = next(blocks)
            if block is None:               # another rank's chunk
                chunks.append(None)
                continue
            with ph("linear.intt"):
                chunks.append(be.place_chunk(i, be.intt(
                    block.reshape(cr, self.k, -1), self.k, out16=True)))
            del block
        return RowChunkedMatrix(chunks, 4 * self.m, cr, self.k)

    def _open_overlap_ok(self, u_canon, batch: int = 1) -> bool:
        """Whether the openings take the overlap route (the JAX package's
        rule): one proof, in direct mode (U one tensor, not a chunked
        handle), on one device (not a mesh, whose gather spans its
        devices).  Batches, resident and streaming mode (whose gathers
        read or re-encode every chunk) and every mesh take the one fused
        gather."""
        return (batch == 1 and isinstance(u_canon, torch.Tensor)
                and getattr(self.backend, "mesh", None) is None)

    def _start_open_async(self, u_canon, idx):
        """Start the gather and the host copy of one phase's opened
        columns (``TorchBackend.gather_columns_start``: a side stream on
        the card), so that they run behind the later phases.  Sound for
        the reason the fused gather is: the columns are proof data, never
        absorbed into the transcript."""
        return self.backend.gather_columns_start(u_canon, idx)

    def _finish_open_async(self, handle, tree):
        """``(columns, paths)`` of a started set: the wait for its copy
        (and its error, where the start had one), then the host work."""
        with self.timer.phase("open.gather"):
            cols = self.backend.gather_columns_finish(handle)
        self._opening = 0              # the overlap route opens one proof
        return self._opened_set(cols, tree, handle.js)

    def _opened(self, cols: np.ndarray, tree, idx_sets, proof: int):
        """Proof ``proof``'s gathered columns (rows, sum of the sets, L;
        copied in 16-bit limbs and widened on the host) -> ``(columns,
        paths)`` per index set."""
        self._opening = proof
        out, off = [], 0
        for idx in idx_sets:
            out.append(self._opened_set(cols[:, off:off + len(idx)], tree,
                                        idx))
            off += len(idx)
        return out

    def _opened_set(self, cols: np.ndarray, tree, idx):
        """One index set's columns (rows, len(idx), L) -> ``(columns as
        ints, Merkle paths)``, timed as ``open.to_ints/<i>`` and
        ``open.paths/<i>``, i the proof's index in the batch
        (``_opening``, set by the callers)."""
        ph, i = self.timer.phase, self._opening
        with ph(f"open.to_ints/{i}"):
            columns = [self.field.limbs_to_ints(cols[:, j, :])
                       for j in range(len(idx))]
        with ph(f"open.paths/{i}"):
            paths = [tree.generate_proof(j) for j in idx]
        return columns, paths

    # ------------------------------------------------------------------
    # verifier
    # ------------------------------------------------------------------
    def verify(self, proof: LigeroProof, sponge) -> bool:
        if not self._well_formed(proof):
            return False
        leaves = self._opened_leaves([proof])[0]
        sponge.absorb_bytes(proof.u_root)                        # FS #1
        # a proof's stages carry its index in the batch, as in
        # ``verify_batch``: this one is proof 0
        with self.timer.phase("v.interleaved/0"):
            ok = self._verify_interleaved(proof.interleaved, proof.u_root,
                                          sponge, leaves[0])
        if not ok:
            return False
        with self.timer.phase("v.linear/0"):
            ok = self._verify_linear(proof.linear, proof.u_root, sponge,
                                     leaves[1])
        if not ok:
            return False
        with self.timer.phase("v.quadratic/0"):
            return self._verify_quadratic(proof.quadratic, proof.u_root, sponge,
                                          leaves[2])

    def verify_batch(self, proofs: list[LigeroProof], sponge) -> list[bool]:
        """Verdicts of B proofs of this circuit, each on its own clone of
        ``sponge``: what B ``verify`` calls return.  A malformed proof is
        False and does not fail the batch.  The transforms are shared: the
        B interleaved reveals take one encode, the 2 B polynomials q and
        p0 one NTT, and the B blocks of r_i coefficients stay on the
        device for their codewords at each proof's opened columns
        (``TorchBackend.ntt_columns_batch``)."""
        if len(proofs) <= 1:
            return [self.verify(p, sponge.clone()) for p in proofs]
        part = max(1, self.backend.max_verify_batch(
            self.num_rows, self.k, self.n, len(self.state.a_vals),
            self.chunk_rows))
        out: list[bool] = []
        for i in range(0, len(proofs), part):
            out.extend(self._verify_many(proofs[i:i + part], sponge))
        return out

    def _verify_many(self, proofs, sponge) -> list[bool]:
        """:meth:`verify_batch` of one part.  Every proof runs the stages
        of :meth:`verify` in their order on its one transcript; the
        stages stop twice, so that what all proofs need next is computed
        in one call.  A proof that fails a stage is done, at the cost
        :meth:`verify` would have spent on it.  Proof i's stages are timed
        as :meth:`verify`'s, ``v.interleaved/<i>``, ``v.linear/<i>`` and
        ``v.quadratic/<i>``."""
        be, n, ph = self.backend, self.n, self.timer.phase
        verdicts = [False] * len(proofs)
        # q and p0 too long are rejected as ``verify`` rejects them, and
        # kept out of the stacks
        live = [i for i, pf in enumerate(proofs) if self._well_formed(pf)
                and _poly_degree(pf.linear.polynomial) < self.lin_bound
                and _poly_degree(pf.quadratic.polynomial) < self.quad_bound]
        if not live:
            return verdicts
        leaves = self._opened_leaves([proofs[i] for i in live])
        # the transforms of proof data, which hang on no transcript
        with ph("v.reveal"):
            lc = be.ints_to_mont(
                [c for i in live for c in proofs[i].interleaved.preenc_u_lc]
            ).reshape(len(live), self.blind_len, -1)
            w_evals = (be.ntt(lc, n) if self.zk
                       else be.rs_encode_rows(lc, self.k, n)[1])
            polys = ([proofs[i].linear.polynomial for i in live]
                     + [proofs[i].quadratic.polynomial for i in live])
            qp_evals = be.ntt(be.ints_to_mont(
                [c for poly in polys
                 for c in poly + [0] * (self.d2 - len(poly))]
            ).reshape(2 * len(live), self.d2, -1), n)

        # each proof up to its linear phase's openings: FS #1-#7
        pending = []     # (proof index, stack index, sponge, r_i rows, q values)
        for j, i in enumerate(live):
            pf, sp = proofs[i], sponge.clone()
            sp.absorb_bytes(pf.u_root)                           # FS #1
            with ph(f"v.interleaved/{i}"):
                ok = self._verify_interleaved(pf.interleaved, pf.u_root, sp,
                                              leaves[j][0],
                                              be.mont_to_ints(w_evals[j]))
            if not ok:
                continue
            with ph(f"v.linear/{i}"):
                opened = self._verify_linear_open(
                    pf.linear, pf.u_root, sp, leaves[j][1],
                    be.mont_to_ints(qp_evals[j]))
            if opened is not None:
                pending.append((i, j, sp, *opened))
        if not pending:
            return verdicts
        # the r_i codewords at the columns each proof opened (its
        # transcript's columns: the openings passed)
        with self.timer.phase("v.ntt_cols"):
            r_evals = be.ntt_columns_batch(
                [entry[3] for entry in pending], n,
                [[path.leaf_index for path in proofs[entry[0]].linear.paths]
                 for entry in pending])                  # (B, 4m, t, L)
        # the rest of each proof: the linear spot check, FS #8-#10
        for slot, (i, j, sp, _, q_evals) in enumerate(pending):
            pf = proofs[i]
            with ph(f"v.linear/{i}"):
                ok = self._verify_linear_spot(pf.linear, r_evals[slot],
                                              q_evals)
            if not ok:
                continue
            with ph(f"v.quadratic/{i}"):
                verdicts[i] = self._verify_quadratic(
                    pf.quadratic, pf.u_root, sp, leaves[j][2],
                    be.mont_to_ints(qp_evals[len(live) + j]))
        return verdicts

    def warmup(self) -> dict:
        """Everything a first request would otherwise pay for: the kernel
        library (built where the sources changed: the Poseidon sponge
        kernel with the others), A's one-time upload and
        the transforms' tables, by one throwaway prove and verify of the
        all-ones witness.  That witness
        satisfies only the interleaved test, so the linear phase's
        ``ntt_columns`` shape, which the failing checks cut short, runs
        on its own.  Returns the two times."""
        from ..sponge import test_sponge

        sponge = test_sponge(self.field)
        if self.device.type == "cuda":
            cuda_build.library()
        self._device_coo()
        ones = [(i, 1) for i in sorted(set(self.circuit.variables.values()))]
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")      # a garbage witness, by design
            proof = self._prove_inner(ones, sponge.clone())
        prove_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sp = sponge.clone()
        leaves = self._opened_leaves([proof])[0]
        sp.absorb_bytes(proof.u_root)
        self._verify_interleaved(proof.interleaved, proof.u_root, sp, leaves[0])
        self._verify_linear(proof.linear, proof.u_root, sp, leaves[1])
        self._verify_quadratic(proof.quadratic, proof.u_root, sp, leaves[2])
        r_coeffs = self._r_a_coeff_rows(bytes(CHACHA_SEED_BYTES))
        self.backend.to_numpy(self.backend.ntt_columns(
            r_coeffs, self.n, [path.leaf_index for path in proof.linear.paths]))
        return {"prove_s": round(prove_s, 3),
                "verify_s": round(time.perf_counter() - t0, 3)}

    def _well_formed(self, proof: LigeroProof) -> bool:
        """Structural validation of an untrusted proof: t columns and t
        paths a set, each column ``num_rows`` high, checked before any of
        its columns is hashed."""
        if len(proof.interleaved.preenc_u_lc) != self.blind_len:
            return False
        for sub in (proof.interleaved, proof.linear, proof.quadratic):
            if len(sub.columns) != self.t or len(sub.paths) != self.t:
                return False
            if any(len(col) != self.num_rows for col in sub.columns):
                return False
        return True

    def _opened_leaves(self, proofs) -> list:
        """Per well-formed proof, the leaf digests of its three opened
        column sets (interleaved, linear, quadratic), all proofs' columns
        in one :meth:`_column_leaves` call."""
        subs = [sub for pf in proofs
                for sub in (pf.interleaved, pf.linear, pf.quadratic)]
        with self.timer.phase("v.col_digests"):
            digests = self._column_leaves(
                [col for sub in subs for col in sub.columns])
        out, off = [], 0
        for sub in subs:
            out.append(digests[off:off + len(sub.columns)])
            off += len(sub.columns)
        return [tuple(out[3 * i:3 * i + 3]) for i in range(len(proofs))]

    def _column_leaves(self, columns) -> list[bytes]:
        """Leaf digests of opened columns (lists of ``num_rows`` ints)."""
        mt = self.mt_params
        if self._mt_default:
            return [mt.col_hash(self.field, col) for col in columns]
        if not columns:
            return []
        return mt.device_col_digests(
            self.backend, self._columns_limbs(columns, self.num_rows))

    def _verify_column_openings(self, paths, u_root, sponge, leaves) -> bool:
        """``leaves``: the opened columns' leaf digests
        (:meth:`_opened_leaves`)."""
        indices = self._sample_indices(sponge.squeeze_bytes(CHACHA_SEED_BYTES))
        if len(leaves) != len(indices) or len(paths) != len(indices):
            return False
        with self.timer.phase("v.col_openings"):
            two_to_one = self.mt_params.two_to_one
            for leaf, idx, path in zip(leaves, indices, paths):
                if path.leaf_index != idx or not path.verify(
                        u_root, leaf, two_to_one=two_to_one):
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

    def _verify_interleaved(self, proof: InterleavedProof, u_root, sponge,
                            leaves, w: list[int] | None = None) -> bool:
        """``leaves``: the opened columns' leaf digests; ``w``: the
        reveal's n codeword values where ``verify_batch`` computed them
        already (the same values as below)."""
        be = self.backend
        seed = sponge.squeeze_bytes(CHACHA_SEED_BYTES)           # FS #2
        r = self._expand_field(4 * self.m, seed)
        sponge.absorb_field_elems(proof.preenc_u_lc)             # FS #3
        if not self._verify_column_openings(proof.paths, u_root, sponge,
                                            leaves):             # FS #4
            return False
        if w is None and self.zk:
            # the zk reveal is in coefficient space (deg < k + 3t): check
            # w(omega^j) == <r, U[:4m, j]> + U[mask0, j]
            w = self._evals(proof.preenc_u_lc)
        elif w is None:
            # w = RS(preenc_u_lc); spot check w[j] == <r, U[:, j]>
            lc = be.ints_to_mont(proof.preenc_u_lc).reshape(1, self.k, -1)
            _, w_evals = be.rs_encode_rows(lc, self.k, self.n)
            w = be.mont_to_ints(w_evals[0])
        # mont r x canonical columns = canonical sums
        rhs = be.canon_limbs_to_ints(be.row_combine(
            r, self._columns_limbs(proof.columns, 4 * self.m)))
        return self._spot_matches(w, proof, rhs, 0)

    def _verify_linear(self, proof: LinearConstraintsProof, u_root,
                       sponge, leaves) -> bool:
        opened = self._verify_linear_open(proof, u_root, sponge, leaves)
        if opened is None:
            return False
        r_coeffs, q_evals = opened
        js = [path.leaf_index for path in proof.paths]
        with self.timer.phase("v.ntt_cols"):
            r_evals = self.backend.ntt_columns(r_coeffs, self.n, js)
        del r_coeffs
        return self._verify_linear_spot(proof, r_evals, q_evals)

    def _verify_linear_open(self, proof: LinearConstraintsProof, u_root,
                            sponge, leaves,
                            q_evals: list[int] | None = None):
        """The linear phase up to its openings (FS #5-#7): ``(the r_i
        coefficient rows on the device, q's n values)``, or None where the
        proof is rejected.  ``leaves``: the opened columns' leaf digests;
        ``q_evals``: q's values where ``verify_batch`` computed them
        already (the same values as below)."""
        p, k = self.field.p, self.k
        seed = sponge.squeeze_bytes(CHACHA_SEED_BYTES)           # FS #5
        if _poly_degree(proof.polynomial) >= self.lin_bound:
            return None
        # one n-point NTT of q gives the message-domain sum check (the k
        # message points are the n grid at stride n/k) and q at every
        # opened column
        if q_evals is None:
            q_evals = self._evals(proof.polynomial)
        if sum(q_evals[0::self.n // k]) % p != 0:
            return None
        sponge.absorb_field_elems(proof.polynomial)              # FS #6
        if not self._verify_column_openings(proof.paths, u_root, sponge,
                                            leaves):             # FS #7
            return None
        return self._r_a_coeff_rows(seed), q_evals

    def _verify_linear_spot(self, proof: LinearConstraintsProof, r_evals,
                            q_evals: list[int]) -> bool:
        """The linear phase's spot check: ``r_evals`` (4m, t, L), the r_i
        codewords at the opened columns only."""
        be = self.backend
        with self.timer.phase("v.spot"):
            lhs = be.canon_limbs_to_ints(be.row_combine(
                r_evals, self._columns_limbs(proof.columns, 4 * self.m)))
        return self._spot_matches(q_evals, proof, lhs, 1)

    def _verify_quadratic(self, proof: QuadraticConstraintsProof, u_root,
                          sponge, leaves,
                          p0_evals: list[int] | None = None) -> bool:
        """``leaves``: the opened columns' leaf digests; ``p0_evals``: p0's
        n values where ``verify_batch`` computed them already (the same
        values as below)."""
        be, k, m = self.backend, self.k, self.m
        seed = sponge.squeeze_bytes(CHACHA_SEED_BYTES)           # FS #8
        r_quad = self._expand_field(m, seed)
        if _poly_degree(proof.polynomial) >= self.quad_bound:
            return False
        if p0_evals is None:
            p0_evals = self._evals(proof.polynomial)
        if any(p0_evals[(self.n // k) * c] != 0 for c in range(k)):
            return False
        sponge.absorb_field_elems(proof.polynomial)              # FS #9
        if not self._verify_column_openings(proof.paths, u_root, sponge,
                                            leaves):             # FS #10
            return False
        # sum_i r_i (x_i y_i - z_i) per opened column; to_mont(x) * y is
        # the canonical product
        with self.timer.phase("v.spot"):
            cols = self._columns_limbs(proof.columns, 3 * m)     # (3m, t, L)
            term = be.sub(be.mont_mul(be.to_mont(cols[:m]), cols[m:2 * m]),
                          cols[2 * m:])
            rhs = be.canon_limbs_to_ints(be.row_combine(r_quad, term))
        return self._spot_matches(p0_evals, proof, rhs, 2)

