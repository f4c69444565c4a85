"""16-bit limb storage of the port (the JAX package's ``Backend.narrow16``)
on device="cpu": the resident and streaming modes hold their coefficient,
codeword and r^T A chunks as int16 tensors whose bytes are the JAX
package's uint16 limbs, and every mode copies the opened columns to the
host in 16 bits.

Inputs are made from seeds (numpy, and the synthetic circuit of
``tests/test_torch_resident.py``); modes are forced by the memory budget,
in chunks of 8 rows: 44 data rows (47 under zk) in six chunks, the last
one ragged, as the JAX package chunks them under a 4096-byte buffer
budget.  The tolerance is none (exact integer arithmetic): the chunks equal
the JAX package's ``rs_encode_resident``, ``intt_resident``,
``coeffs_resident`` and ``_r_a_coeff_rows`` chunks byte for byte, the
opened columns its ``gather_columns``, the proofs its proofs in direct,
resident and streaming mode, in a batch and over a two-device CPU mesh,
under either commitment; each 16-bit plain version equals the int32 one."""

import functools

import numpy as np
import pytest
import torch

from ligero_tpu.engine.backend import Backend
from ligero_tpu.engine.devmatrix import StreamedCodewords as RefStreamed
from ligero_tpu.engine.fieldops import FieldKernel
from ligero_tpu.fields import BLS12_377_FQ, BN254_FR
from ligero_tpu.ligero import LigeroCircuit as RefCircuit
from ligero_tpu.ligero.types import LigeroMTPoseidonParams as RefParams
from ligero_tpu.sampling import rand_field_elements_limbs
from ligero_tpu.sponge import test_sponge
from ligero_tpu.synthetic import generate_random_circuit
from ligero_tpu_torch import LigeroCircuit, convert
from ligero_tpu_torch.engine import (cuda_hash, cuda_lc, cuda_ntt,
                                     cuda_poseidon, devmatrix, fieldops,
                                     hashops, ntt, poseidon_cols)
from ligero_tpu_torch.engine import backend as port_backend
from ligero_tpu_torch.engine.backend import TorchBackend
from ligero_tpu_torch.engine.devmatrix import StreamedCodewords
from ligero_tpu_torch.fields import FIELDS as PORT_FIELDS
from ligero_tpu_torch.ligero.types import LigeroMTPoseidonParams
from ligero_tpu_torch.parallel import RowMesh, ShardedBackend
from ligero_tpu_torch.sponge import test_poseidon_config

# one intra-op thread: the workers of the suite share the host's cores
torch.set_num_threads(1)

ZK_SEED = bytes(range(32))
FIELDS = {"bn254": BN254_FR, "bls12_377": BLS12_377_FQ}
# (gates, num_vars, circuit seed, lambda): 4m = 44 data rows, k 16, n 128
GATES, NUM_VARS, CIRCUIT_SEED, LAMBDA = 96, 4, 3, 10
#: chunk rows of every chunked path here: the JAX package's under
#: MAX_DEVICE_BYTES = 4096 (max(8, 4096 // (n 4 L)) rows, even)
CR = 8
JAX_BUFFER_BYTES = 4096


def pf(field):
    """The port's own FieldSpec for a JAX-package one."""
    return PORT_FIELDS[field.name]


def u16(t: torch.Tensor) -> np.ndarray:
    """An int16 limb tensor's bytes as the JAX package's uint16 limbs."""
    assert t.dtype == torch.int16
    return t.numpy().view(np.uint16)


def rand_mont(field, rng, shape):
    """Montgomery limbs (uint32) of field elements drawn from ``rng``."""
    ints = [int.from_bytes(rng.bytes(48), "little") % field.p
            for _ in range(int(np.prod(shape)))]
    return field.ints_to_mont_limbs(ints).reshape(*shape, -1)


def rand_limbs(field, gen, shape, below_r=False):
    """int32 16-bit limbs, reduced below p (or any value below R)."""
    L = field.num_limbs
    x = torch.randint(0, 1 << 16, tuple(shape) + (L,), generator=gen,
                      dtype=torch.int32)
    if not below_r:
        x[..., L - 1] %= field.p >> (16 * (L - 1))
    return x


def dims(lig):
    return (lig.num_rows, lig.k, lig.n, len(lig.state.a_vals), lig.blind_t,
            lig.d2)


def force(monkeypatch, direct, mode: str, poseidon=False) -> None:
    """Budget and chunk cap that give ``direct``'s instance ``mode``
    ("resident" or "streaming") in chunks of CR rows."""
    be = direct.backend
    estimate = (be.resident_bytes if mode == "resident"
                else be.streaming_bytes)
    budget = estimate(*dims(direct), chunk_rows=CR, poseidon=poseidon)
    assert budget < be.direct_bytes(*dims(direct))
    monkeypatch.setattr(TorchBackend, "memory_budget", lambda self: budget)
    monkeypatch.setattr(port_backend, "STREAM_MAX_CHUNK_ROWS", CR)


class Storage:
    """Records, while installed, the dtype of every chunk a
    ``RowChunkedMatrix`` is built from, of every tensor of opened columns
    (``width`` of them, the proof's 3t) widened on the host, and of every
    host tensor that ``opened_to_host`` copied the opened columns into."""

    def __init__(self, monkeypatch, width: int):
        self.chunks, self.opened, self.crossed = [], [], []
        init = devmatrix.RowChunkedMatrix.__init__
        to_numpy = TorchBackend.to_numpy
        to_host = TorchBackend.opened_to_host

        def record_crossing(be, cols, **kw):
            host = to_host(be, cols, **kw)
            self.crossed.append(host.dtype)
            return host

        def record_init(rcm, chunks, *args, **kw):
            self.chunks += [c.dtype for c in chunks if c is not None]
            init(rcm, chunks, *args, **kw)

        def record_to_numpy(a):
            if (isinstance(a, torch.Tensor) and a.dim() >= 3
                    and a.shape[-2] == width):
                self.opened.append(a.dtype)
            return to_numpy(a)

        monkeypatch.setattr(devmatrix.RowChunkedMatrix, "__init__",
                            record_init)
        monkeypatch.setattr(TorchBackend, "to_numpy",
                            staticmethod(record_to_numpy))
        monkeypatch.setattr(TorchBackend, "opened_to_host", record_crossing)


# ---------------------------------------------------------------------------
# the chunks against the JAX package's, as uint16
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(FIELDS))
def test_resident_and_streaming_chunks_equal_jax_package_u16(name,
                                                             monkeypatch):
    """20 rows of k = 8 -> n = 64 in chunks of 8 (the last of 4): the
    coefficient and codeword chunks of ``resident_codewords`` over
    ``encode_chunks`` against the JAX package's ``rs_encode_resident``, and
    the streaming coefficient chunks against its ``intt_resident``, as
    uint16; the opened columns of both handles, and of a direct-mode
    matrix, against its ``gather_columns``, copied in 16 bits."""
    field = FIELDS[name]
    monkeypatch.setattr(Backend, "MAX_DEVICE_BYTES", JAX_BUFFER_BYTES)
    rows, k, n = 20, 8, 64
    preenc = rand_mont(field, np.random.default_rng(31), (rows, k))
    ref = Backend(field, use_jax=True)
    ref_coeffs, ref_canon = ref.rs_encode_resident(preenc, k, n)
    ref_stream = ref.intt_resident(preenc, k, n)

    be = TorchBackend(pf(field), "cpu")
    chunks = be.encode_chunks(preenc, k, CR)
    sc = be.resident_codewords(chunks, n)
    for mine, theirs in ((sc.coeffs, ref_coeffs), (sc.canon, ref_canon),
                         (chunks, ref_stream)):
        assert theirs.chunk_rows == mine.chunk_rows == CR
        assert len(mine.chunks) == len(theirs.chunks) == 3
        for i, (a, b) in enumerate(zip(mine.chunks, theirs.chunks)):
            b = np.asarray(b)
            assert b.dtype == np.uint16
            # the port's last codeword chunk holds its real rows only
            assert np.array_equal(u16(a), b[:a.shape[0]]), i

    js = [0, 5, 33, 63, 17]
    want = ref.gather_columns(ref_canon, js)
    assert np.array_equal(ref.gather_columns(RefStreamed(ref_stream, n, rows),
                                             js), want)
    u = be.rs_encode_and_canon(torch.from_numpy(preenc.astype(np.int32)), k,
                               n)[1]
    seen = Storage(monkeypatch, len(js))
    for handle in (sc, StreamedCodewords(chunks, n), u):
        got = be.gather_columns(handle, js)
        assert got.dtype == np.uint32 and np.array_equal(got, want)
    assert seen.opened == [torch.int16] * 3


@pytest.mark.parametrize("name", list(FIELDS))
def test_zk_chunks_equal_jax_package_coeffs_resident_u16(name, monkeypatch):
    """The blinded (k + b)-wide chunks of ``zk_blind_chunks`` (the
    subtraction in int32, each chunk narrowed once) against the JAX
    package's ``coeffs_resident`` of its host path's blinded rows (the
    iNTT_k, the ``rand_field_elements_limbs`` draws, the concatenated
    subtraction), and their resident codewords against its narrowed
    ``ntt_and_canon`` of each chunk, as uint16."""
    field = FIELDS[name]
    monkeypatch.setattr(Backend, "MAX_DEVICE_BYTES", JAX_BUFFER_BYTES)
    rows, k, b, n, L = 20, 8, 3, 64, field.num_limbs
    preenc = rand_mont(field, np.random.default_rng(32), (rows, k))
    s = rand_field_elements_limbs(field, rows * b, ZK_SEED).reshape(rows, b, L)
    coeffs = np.zeros((rows, k + b, L), np.uint32)
    coeffs[:, :k] = Backend(field).intt(preenc, k)
    coeffs[:, k:] = s
    coeffs[:, :b] = FieldKernel(field, np).sub(coeffs[:, :b], s)
    ref = Backend(field, use_jax=True)
    theirs = ref.coeffs_resident(coeffs, n)

    be = TorchBackend(pf(field), "cpu")
    mine = be.zk_blind_chunks(preenc, ZK_SEED, b, CR)
    sc = be.resident_codewords(mine, n)
    assert theirs.chunk_rows == CR and len(mine.chunks) == 3
    for i, (a, c) in enumerate(zip(mine.chunks, theirs.chunks)):
        assert np.array_equal(u16(a), np.asarray(c)), i
        canon = np.asarray(ref.ntt_and_canon(ref._widen(c), n)).astype(
            np.uint16)
        held = sc.canon.chunks[i]
        assert np.array_equal(u16(held), canon[:held.shape[0]]), i


@functools.lru_cache(maxsize=None)
def jax_r_a_chunks(name: str):
    """The JAX package's r^T A coefficient chunks at the test circuit, as
    its prover and verifier make them (``_r_a_coeff_rows`` of its chunked
    branch, under a 4096-byte buffer budget: ``intt_resident``'s uint16
    chunks), for the seed ZK_SEED."""
    field = FIELDS[name]
    circ, outs, _ = generate_random_circuit(field, GATES, num_vars=NUM_VARS,
                                            seed=CIRCUIT_SEED)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(Backend, "MAX_DEVICE_BYTES", JAX_BUFFER_BYTES)
        ref = RefCircuit(circ, outs, lambda_=LAMBDA,
                         backend=Backend(field, use_jax=True))
        rcm = ref._r_a_coeff_rows(ZK_SEED)
    finally:
        mp.undo()
    return circ, outs, rcm.chunk_rows, [np.asarray(c) for c in rcm.chunks]


@pytest.mark.parametrize("name", list(FIELDS))
def test_r_a_chunks_equal_jax_package_u16(name, monkeypatch):
    """The port's ``_r_a_coeff_rows`` (prover and verifier) in streaming
    mode, chunks of 8: int16 chunks byte-equal to the JAX package's."""
    field = FIELDS[name]
    circ, outs, ref_cr, ref_chunks = jax_r_a_chunks(name)
    port = convert.circuit_from_reference(circ)
    direct = LigeroCircuit(port, outs, lambda_=LAMBDA, device="cpu")
    force(monkeypatch, direct, "streaming")
    lig = LigeroCircuit(port, outs, lambda_=LAMBDA, device="cpu")
    assert (lig.encode_mode, lig.chunk_rows) == ("streaming", CR) == (
        "streaming", ref_cr)
    rcm = lig._r_a_coeff_rows(ZK_SEED)
    assert len(rcm.chunks) == len(ref_chunks) == 6
    assert rcm.real_rows(5) == 4
    for i, (a, b) in enumerate(zip(rcm.chunks, ref_chunks)):
        assert b.dtype == np.uint16
        assert np.array_equal(u16(a), b), i


# ---------------------------------------------------------------------------
# proofs in every mode
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def reference(name: str, zk: bool, poseidon: bool = False):
    """(the JAX package's proof bytes, the circuit, outputs, witness)."""
    field = FIELDS[name]
    circ, outs, vars_ = generate_random_circuit(field, GATES,
                                                num_vars=NUM_VARS,
                                                seed=CIRCUIT_SEED)
    ref = RefCircuit(circ, outs, lambda_=LAMBDA, zk=zk, backend=Backend(field),
                     mt_params=RefParams(field) if poseidon else None)
    kw = {"zk_seed": ZK_SEED} if zk else {}
    return ref.prove(vars_, test_sponge(field), **kw).to_bytes(field), \
        circ, outs, vars_


def build(name, zk, poseidon=False, backend=None):
    _, circ, outs, _ = reference(name, zk, poseidon)
    field = FIELDS[name]
    kw = {"backend": backend} if backend is not None else {"device": "cpu"}
    return LigeroCircuit(
        convert.circuit_from_reference(circ), outs, lambda_=LAMBDA, zk=zk,
        mt_params=LigeroMTPoseidonParams(pf(field)) if poseidon else None,
        **kw)


PATHS = [(name, zk, mode) for name in FIELDS for zk in (False, True)
         for mode in ("direct", "resident", "streaming")]


@pytest.mark.parametrize("name,zk,mode", PATHS,
                         ids=[f"{n}-{'zk' if z else 'plain'}-{m}"
                              for n, z, m in PATHS])
def test_proof_bytes_equal_jax_package_in_every_mode(name, zk, mode,
                                                     monkeypatch):
    """Direct, resident and streaming mode (chunks of 8), plain and zk,
    both fields: the proof equals the JAX package's byte for byte; every
    chunk the resident and streaming provers build is int16, and in every
    mode the opened columns cross to the host as int16 (in direct mode
    each set of t on its own: the opening overlap; else all 3t at once)."""
    want, _, _, vars_ = reference(name, zk)
    if mode != "direct":
        force(monkeypatch, build(name, zk), mode)
    lig = build(name, zk)
    assert (lig.encode_mode, lig.chunk_rows) == (
        (mode, CR) if mode != "direct" else ("direct", 0))
    sets = 3 if mode == "direct" else 1
    seen = Storage(monkeypatch, 3 * lig.t // sets)
    kw = {"zk_seed": ZK_SEED} if zk else {}
    got = lig.prove(vars_, test_sponge(FIELDS[name]), **kw)
    assert got.to_bytes(pf(FIELDS[name])) == want
    assert seen.opened == [torch.int16] * sets
    assert seen.crossed and set(seen.crossed) == {torch.int16}
    if mode == "direct":
        assert seen.chunks == []
    else:
        # coefficient chunks, (resident) codeword chunks, r^T A chunks
        assert len(seen.chunks) >= 12
        assert set(seen.chunks) == {torch.int16}
    assert lig.verify(got, test_sponge(FIELDS[name]))


@pytest.mark.parametrize("mode", ["resident", "streaming"])
def test_poseidon_proof_bytes_equal_jax_package_16bit(mode, monkeypatch):
    """The Poseidon commitment over the 16-bit codeword chunks (held, or
    re-encoded into 16 bits): BN254, plain, chunks of 8; the proof equals
    the JAX package's."""
    want, _, _, vars_ = reference("bn254", False, True)
    force(monkeypatch, build("bn254", False, True), mode, poseidon=True)
    lig = build("bn254", False, True)
    assert (lig.encode_mode, lig.chunk_rows) == (mode, CR)
    seen = Storage(monkeypatch, 3 * lig.t)
    got = lig.prove(vars_, test_sponge(BN254_FR))
    assert got.to_bytes(pf(BN254_FR)) == want
    assert set(seen.chunks) == {torch.int16} and seen.opened == [torch.int16]


def test_batch_and_mesh_proofs_equal_jax_package_16bit(monkeypatch):
    """A direct-mode batch of two (one gather, in 16 bits, for both), and
    a mesh of two CPU devices in direct and in streaming mode (chunks of 8
    dealt over the devices, int16): BN254 zk, every proof equal to the JAX
    package's."""
    want, _, _, vars_ = reference("bn254", True)
    field = pf(BN254_FR)
    kw = {"zk_seed": ZK_SEED}
    lig = build("bn254", True)
    seen = Storage(monkeypatch, 3 * lig.t)
    proofs = lig.prove_batch([vars_, vars_], test_sponge(BN254_FR),
                             zk_seeds=[ZK_SEED, ZK_SEED])
    assert [p.to_bytes(field) for p in proofs] == [want, want]
    assert seen.opened == [torch.int16]

    mesh = ShardedBackend(field, RowMesh(["cpu"] * 2))
    got = build("bn254", True, backend=mesh).prove(
        vars_, test_sponge(BN254_FR), **kw)
    assert got.to_bytes(field) == want

    direct = build("bn254", True, backend=ShardedBackend(field, ["cpu"] * 2))
    budget = direct.backend.streaming_bytes(*dims(direct), chunk_rows=CR)
    monkeypatch.setattr(TorchBackend, "memory_budget", lambda self: budget)
    monkeypatch.setattr(port_backend, "STREAM_MAX_CHUNK_ROWS", CR)
    streamed = build("bn254", True, backend=ShardedBackend(field,
                                                           ["cpu"] * 2))
    assert streamed.encode_mode == "streaming"
    seen = Storage(monkeypatch, 3 * streamed.t)
    got = streamed.prove(vars_, test_sponge(BN254_FR), **kw)
    assert got.to_bytes(field) == want
    assert set(seen.chunks) == {torch.int16} and seen.opened == [torch.int16]


# ---------------------------------------------------------------------------
# the 16-bit entries' plain versions against the int32 ones
# ---------------------------------------------------------------------------

def test_narrow16_and_widen16_round_trip_every_limb():
    limbs = torch.arange(0, 1 << 16, dtype=torch.int32).reshape(-1, 16)
    narrow = fieldops.narrow16(limbs)
    assert narrow.dtype == torch.int16
    assert np.array_equal(narrow.numpy().view(np.uint16),
                          limbs.numpy().astype(np.uint16))
    assert torch.equal(fieldops.widen16(narrow), limbs)
    assert fieldops.widen16(limbs) is limbs
    # the packed words the kernels compute on
    words = narrow.view(torch.int32).numpy().view(np.uint32)
    lo, hi = limbs[:, 0::2].numpy(), limbs[:, 1::2].numpy()
    assert np.array_equal(words, (lo | (hi << 16)).astype(np.uint32))
    assert np.array_equal(TorchBackend.to_numpy(narrow),
                          limbs.numpy().astype(np.uint32))


@pytest.mark.parametrize("name", list(FIELDS))
def test_16bit_plain_versions_equal_int32(name):
    """The NTT (16-bit in, out, both; every route of a small tile limit),
    row_combine on a 16-bit matrix, the streamed Blake2s absorb and the
    chunked Poseidon absorb (BN254) on 16-bit chunks: each plain version,
    and each wrapper on a CPU tensor, equals the int32 one."""
    field = pf(FIELDS[name])
    gen = torch.Generator().manual_seed(13)
    x = rand_limbs(field, gen, (5, 12))
    x16 = fieldops.narrow16(x)
    for inverse, canon in ((False, False), (True, False), (False, True)):
        want = ntt.ntt_ref(field, x, 32, inverse, canon)
        assert torch.equal(cuda_ntt.ntt16_ref(field, x16, 32, inverse, canon),
                           want)
        for src in (x, x16):
            got = cuda_ntt.ntt16_ref(field, src, 32, inverse, canon,
                                     out16=True)
            assert got.dtype == torch.int16
            assert torch.equal(fieldops.widen16(got), want)
            assert torch.equal(cuda_ntt.ntt(field, src, 32, inverse, canon,
                                            out16=True), got)
    r, m = rand_limbs(field, gen, (9,)), rand_limbs(field, gen, (9, 7))
    want = cuda_lc.row_combine_ref(field, r, m)
    assert torch.equal(cuda_lc.row_combine16_ref(field, r, fieldops.narrow16(m)),
                       want)
    assert torch.equal(cuda_lc.row_combine(field, r, fieldops.narrow16(m)),
                       want)

    rows, n = 11, 5
    u = rand_limbs(field, gen, (rows, n))
    whole = hashops.blake2s_columns_ref(u)
    E = hashops.period_rows(field.num_limbs)
    state = hashops.blake2s_stream_start(n, rows, "cpu")
    state16 = state.clone()
    state = hashops.blake2s_absorb_ref(u[:2 * E], 2 * E, state, 0, False,
                                       rows)
    state16 = hashops.blake2s_absorb_ref(fieldops.narrow16(u[:2 * E]), 2 * E,
                                         state16, 0, False, rows)
    assert torch.equal(state16, state)
    hs = cuda_hash.ColumnHashStream(field, n, rows, "cpu")
    hs.absorb(fieldops.narrow16(u[:2 * E]), 2 * E)
    hs.absorb(fieldops.narrow16(u[2 * E:]), rows - 2 * E)
    assert torch.equal(hs.digests(), whole)

    if field.name != BN254_FR.name:
        return
    cfg = test_poseidon_config(field)
    v = rand_limbs(field, gen, (5, 3))
    whole = poseidon_cols.poseidon_columns_plain(field, cfg, v)
    start = poseidon_cols.poseidon_stream_start(field, 3, "cpu")
    mid = poseidon_cols.poseidon_absorb_plain(field, cfg, v[:2], 2, start,
                                              True, False)
    mid16 = poseidon_cols.poseidon_absorb_plain(
        field, cfg, fieldops.narrow16(v[:2]), 2, start, True, False)
    assert torch.equal(mid16, mid)
    stream = cuda_poseidon.PoseidonColumnStream(field, cfg, 3, 5, "cpu")
    stream.absorb(fieldops.narrow16(v[:2]), 2)
    stream.absorb(fieldops.narrow16(v[2:]), 3)
    assert torch.equal(stream.digests(), whole)


def test_streamed_absorbs_take_16bit_chunks_only():
    """The streamed Blake2s and the chunked Poseidon entries read 16-bit
    limbs only: an int32 chunk raises on the CPU as on the card (nothing
    widens or narrows it silently), and its narrowing is absorbed."""
    gen = torch.Generator().manual_seed(16)
    for field in FIELDS.values():
        field = pf(field)
        u = rand_limbs(field, gen, (5, 3))
        hs = cuda_hash.ColumnHashStream(field, 3, 5, "cpu")
        with pytest.raises(TypeError, match="16-bit"):
            hs.absorb(u, 5)
        hs.absorb(fieldops.narrow16(u), 5)
        assert torch.equal(hs.digests(), hashops.blake2s_columns_ref(u))
    field = pf(BN254_FR)
    cfg = test_poseidon_config(field)
    v = rand_limbs(field, gen, (5, 3))
    start = poseidon_cols.poseidon_stream_start(field, 3, "cpu")
    with pytest.raises(TypeError, match="16-bit"):
        cuda_poseidon.poseidon_absorb(field, cfg, v, 5, start, True, True)
    assert torch.equal(
        cuda_poseidon.poseidon_absorb(field, cfg, fieldops.narrow16(v), 5,
                                      start, True, True),
        poseidon_cols.poseidon_columns_plain(field, cfg, v))


def test_16bit_estimates_hold_chunks_at_two_bytes_a_limb():
    """The streaming estimate's chunked pieces (coefficient, r^T A,
    codeword chunks and opened columns) count 2 L bytes an element, and
    the resident estimate U at 2 L bytes, in both fields and over a mesh
    (its per-device coefficient chunks)."""
    for field in FIELDS.values():
        be = TorchBackend(pf(field), "cpu")
        H = 2 * field.num_limbs
        rows, k, n, nnz, cr = 4100, 2048, 16384, 9_443_331, 1024
        p = be._stream_parts(rows, k, n, nnz, 0, 2 * k, cr)
        assert p["coeffs"] == -(-rows // cr) * cr * k * H
        assert p["r_coeffs"] == p["coeffs"]
        assert p["opened"] == cr * 512 * H
        assert p["codewords"] - cr * n * H == p["transform"] - 2 * cr * n * H
        base = be.resident_bytes(rows, k, n, nnz, chunk_rows=cr)
        assert base - be.streaming_bytes(rows, k, n, nnz, chunk_rows=cr) >= \
            rows * n * H * port_backend.ESTIMATE_MARGIN - 1
    mesh = ShardedBackend(pf(BN254_FR), ["cpu"] * 2)
    one = mesh.stream_device_bytes(4100, 2048, 16384, 9_443_331,
                                   chunk_rows=1024)
    assert len(one) == 1        # both shards on the one CPU device


# ---------------------------------------------------------------------------
# on the card: each 16-bit kernel entry against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FIELDS))
def test_16bit_kernel_entries_on_cuda_equal_plain(cuda, name):
    field = pf(FIELDS[name])
    gen = torch.Generator().manual_seed(14)
    x = rand_limbs(field, gen, (6, 300))
    for inverse, canon in ((False, False), (True, False), (False, True)):
        for out16 in (False, True):
            for src in (x, fieldops.narrow16(x)):
                if src.dtype == torch.int32 and not out16:
                    continue            # the int32 entry: test_torch_ntt
                want = cuda_ntt.ntt16_ref(field, src, 512, inverse, canon,
                                          out16)
                for tile_log in (12, 5, 3):     # one pass, two, + stages
                    rt = ntt.ntt_plan(300, 512, tile_log)
                    got = cuda_ntt.ntt_routed(field, src.to(cuda), 512,
                                              inverse, canon, rt, tile_log,
                                              out16)
                    assert torch.equal(got.cpu(), want), (rt, out16)
    r, m = rand_limbs(field, gen, (70,)), rand_limbs(field, gen, (70, 33))
    assert torch.equal(cuda_lc.row_combine(field, r.to(cuda), fieldops.narrow16(
        m).to(cuda)).cpu(), cuda_lc.row_combine_ref(field, r, m))
    rows, n = 103, 40
    u16_ = fieldops.narrow16(rand_limbs(field, gen, (rows, n)))
    for cr in (4, 32):
        hs = cuda_hash.ColumnHashStream(field, n, rows, cuda)
        for r0 in range(0, rows, cr):
            hs.absorb(u16_[r0:r0 + cr].to(cuda), min(cr, rows - r0))
        assert torch.equal(hs.digests().cpu(),
                           hashops.blake2s_columns_ref(fieldops.widen16(u16_)))
    if field.name != BN254_FR.name:
        return
    cfg = test_poseidon_config(field)
    v = fieldops.narrow16(rand_limbs(field, gen, (9, 20)))
    want = poseidon_cols.poseidon_columns_plain(field, cfg,
                                                fieldops.widen16(v))
    for lanes in cuda_poseidon.LANES:
        st = poseidon_cols.poseidon_stream_start(field, 20, cuda)
        st = cuda_poseidon.poseidon_absorb(field, cfg, v[:4].to(cuda), 4, st,
                                           True, False, lanes)
        out = cuda_poseidon.poseidon_absorb(field, cfg, v[4:].to(cuda), 5, st,
                                            False, True, lanes)
        assert torch.equal(out.cpu(), want), lanes
