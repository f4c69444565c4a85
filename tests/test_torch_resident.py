"""Resident mode of the port on device="cpu": every RS-encoded row chunk
kept, coefficients and canonical codewords (``TorchBackend.
resident_codewords`` over ``encode_chunks``, the JAX package's
``rs_encode_resident``), the
commit and the openings reading the held codeword chunks, nothing
re-encoded.  Forced by a memory budget between the resident and the direct
estimate, so the mode choice itself runs; at least three chunks, the last
one ragged.  Inputs are made from seeds (numpy, and the synthetic circuit
of ``tests/test_torch_streaming.py``); the tolerance is none (exact integer
arithmetic): chunks, columns and leaves equal the JAX package's resident
ones, proofs equal the JAX package's numpy-path proofs and the port's
direct proofs byte for byte (and, on one path, its streaming proof:
``tests/test_torch_streaming.py`` holds streaming against direct mode on
every path)."""

import functools
import warnings

import numpy as np
import pytest
import torch

from ligero_tpu.engine.backend import Backend
from ligero_tpu.fields import BLS12_377_FQ, BN254_FR
from ligero_tpu.ligero import LigeroCircuit as RefCircuit
from ligero_tpu.ligero.types import LigeroMTPoseidonParams as RefParams
from ligero_tpu.sponge import test_sponge
from ligero_tpu.synthetic import generate_random_circuit
from ligero_tpu_torch import LigeroCircuit, LigeroProof, convert
from ligero_tpu_torch.engine import backend as port_backend
from ligero_tpu_torch.engine.backend import (STREAM_ROW_QUANTUM,
                                             DeviceMemoryError, TorchBackend)
from ligero_tpu_torch.engine.devmatrix import (RowChunkedMatrix,
                                               StreamedCodewords)
from ligero_tpu_torch.fields import FIELDS as PORT_FIELDS
from ligero_tpu_torch.ligero.types import LigeroMTPoseidonParams
from ligero_tpu_torch.parallel import ShardedBackend

# one intra-op thread: the workers of the suite share the host's cores
torch.set_num_threads(1)

ZK_SEED = bytes(range(32))
FIELDS = {"bn254": BN254_FR, "bls12_377": BLS12_377_FQ}
# (gates, num_vars, circuit seed, lambda): small enough for the zk blinding
GATES, NUM_VARS, CIRCUIT_SEED, LAMBDA = 96, 4, 3, 10
#: the total memory torch reports for an NVIDIA H100 80GB HBM3 (79.18 GiB)
H100_BYTES = 85_017_493_504


def pf(field):
    """The port's own FieldSpec for a JAX-package one."""
    return PORT_FIELDS[field.name]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def dims(lig):
    return (lig.num_rows, lig.k, lig.n, len(lig.state.a_vals), lig.blind_t,
            lig.d2)


def resident_chunk_rows(lig, poseidon=False) -> int:
    """The largest chunk (a multiple of the row quantum) that cuts the data
    rows into at least three chunks, the last one short, and whose resident
    estimate lies under the direct one."""
    data = lig.num_rows - (3 if lig.zk else 0)
    be, q = lig.backend, STREAM_ROW_QUANTUM
    for cr in range(data // 3 // q * q, 0, -q):
        if data % cr and be.resident_bytes(
                *dims(lig), chunk_rows=cr, poseidon=poseidon) < \
                be.direct_bytes(*dims(lig)):
            return cr
    raise AssertionError(f"{data} rows: no ragged resident cut")


def force(monkeypatch, direct, resident: bool, poseidon=False) -> int:
    """A budget under the direct estimate of ``direct``'s instance, at the
    resident (or streaming) estimate of a ragged cut of three chunks or
    more: returns the chunk rows.  Resident mode takes the chunking
    streaming mode would take, and at these sizes a chunk's transients
    outweigh U, so that a resident budget admits streaming chunks larger
    than the cut: the largest chunk is capped at the cut."""
    cr = resident_chunk_rows(direct, poseidon)
    be = direct.backend
    estimate = be.resident_bytes if resident else be.streaming_bytes
    budget = estimate(*dims(direct), chunk_rows=cr, poseidon=poseidon)
    assert budget < be.direct_bytes(*dims(direct))
    monkeypatch.setattr(TorchBackend, "memory_budget", lambda self: budget)
    monkeypatch.setattr(port_backend, "STREAM_MAX_CHUNK_ROWS", cr)
    return cr


def rand_mont(field, rng, shape):
    """Montgomery limbs (uint32) of field elements drawn from ``rng``."""
    ints = [int.from_bytes(rng.bytes(48), "little") % field.p
            for _ in range(int(np.prod(shape)))]
    return field.ints_to_mont_limbs(ints).reshape(*shape, -1)


# ---------------------------------------------------------------------------
# the encode, the gather and the commit against the JAX package's resident
# chunks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(FIELDS))
def test_resident_chunks_gather_and_commit_equal_jax_package(name,
                                                             monkeypatch):
    """20 rows of k = 8 -> n = 64 in chunks of 8 (the last of 4): the
    JAX package's ``rs_encode_resident`` under a 4096-byte buffer budget
    (its chunks of 8 rows, u16) against ``resident_codewords`` over
    ``encode_chunks``; then
    ``gather_columns`` and ``commit_columns`` on its ``RowChunkedMatrix``
    against the port's on its ``StreamedCodewords``."""
    field = FIELDS[name]
    monkeypatch.setattr(Backend, "MAX_DEVICE_BYTES", 4096)
    rows, k, n, cr = 20, 8, 64, 8
    preenc = rand_mont(field, np.random.default_rng(21), (rows, k))
    ref = Backend(field, use_jax=True)
    ref_coeffs, ref_canon = ref.rs_encode_resident(preenc, k, n)
    assert ref_canon.chunk_rows == cr

    be = TorchBackend(pf(field), "cpu")
    sc = be.resident_codewords(be.encode_chunks(preenc, k, cr), n)
    assert sc.resident and sc.shape == (rows, n, field.num_limbs)
    assert [c.shape[0] for c in sc.canon.chunks] == [8, 8, 4]
    for mine, theirs in ((sc.coeffs, ref_coeffs), (sc.canon, ref_canon)):
        for i, (a, b) in enumerate(zip(mine.chunks, theirs.chunks)):
            real = mine.real_rows(i)
            want = np.asarray(b).astype(np.uint32)[:real]
            assert np.array_equal(be.to_numpy(a[:real]), want), i
    # the coefficient chunks' padding rows are zero, as the products need
    assert not sc.coeffs.chunks[-1][4:].any()

    js = [0, 5, 33, 63, 17]
    assert np.array_equal(be.gather_columns(sc, js),
                          ref.gather_columns(ref_canon, js))
    assert be.commit_columns(sc) == ref.commit_columns(ref_canon)
    # and the streaming mode's handle of the same coefficients
    streamed = StreamedCodewords(sc.coeffs, n)
    assert np.array_equal(be.gather_columns(streamed, js),
                          be.gather_columns(sc, js))
    assert be.commit_columns(streamed) == be.commit_columns(sc)


def test_resident_zk_codewords_and_poseidon_digests_equal_streaming():
    """Blinded-style coefficient chunks (k + b wide) and three d2-wide mask
    rows: ``resident_codewords`` holds what streaming mode re-encodes, so
    the gathered columns, the Blake2s leaves and the Poseidon digests are
    those of the ``StreamedCodewords`` without held codewords."""
    field = pf(BN254_FR)
    rng = np.random.default_rng(5)
    rows, w, d2, n, cr = 22, 12, 16, 32, 8
    mont = rand_mont(BN254_FR, rng, (24, w)).astype(np.int32)
    mont[rows:] = 0
    chunks = [torch.from_numpy(mont[i:i + cr]) for i in range(0, 24, cr)]
    rcm = RowChunkedMatrix(chunks, rows, cr)
    tail = torch.from_numpy(rand_mont(BN254_FR, rng, (3, d2)).astype(np.int32))
    be = TorchBackend(field, "cpu")
    res = be.resident_codewords(rcm, n, tail)
    streamed = StreamedCodewords(rcm, n, tail)
    assert res.resident and not streamed.resident
    assert [c.shape[0] for c in res.canon.chunks] == [8, 8, 6]
    js = [1, 2, 20, 31]
    assert np.array_equal(be.gather_columns(res, js),
                          be.gather_columns(streamed, js))
    assert be.commit_columns(res) == be.commit_columns(streamed)
    mt = LigeroMTPoseidonParams(field)
    assert mt.device_col_digests(be, res) == mt.device_col_digests(
        be, streamed)
    with pytest.raises(ValueError, match="row-aligned"):
        StreamedCodewords(rcm, n, tail, res.canon)      # no tail codewords


# ---------------------------------------------------------------------------
# proofs, forced resident
# ---------------------------------------------------------------------------

PATHS = [("bn254", False, False), ("bn254", True, False),
         ("bls12_377", False, False), ("bls12_377", True, False),
         ("bn254", False, True)]
#: the path whose resident proof is also held against a streaming proof
STREAMING_TOO = ("bn254", True, False)


@functools.lru_cache(maxsize=None)
def proved(name: str, zk: bool, poseidon: bool):
    """(field, witness, the JAX package's proof bytes, the port's direct
    proof bytes, its streaming proof bytes (on STREAMING_TOO, else None),
    the resident instance, its proof)."""
    field = FIELDS[name]
    circ, outs, vars_ = generate_random_circuit(field, GATES,
                                                num_vars=NUM_VARS,
                                                seed=CIRCUIT_SEED)
    port = convert.circuit_from_reference(circ)
    kw = {"zk_seed": ZK_SEED} if zk else {}
    ref = RefCircuit(circ, outs, lambda_=LAMBDA, zk=zk, backend=Backend(field),
                     mt_params=RefParams(field) if poseidon else None)
    want = ref.prove(vars_, test_sponge(field), **kw).to_bytes(field)

    def build():
        return LigeroCircuit(port, outs, lambda_=LAMBDA, zk=zk, device="cpu",
                             mt_params=(LigeroMTPoseidonParams(pf(field))
                                        if poseidon else None))

    direct = build()
    got_direct = direct.prove(vars_, test_sponge(field), **kw)
    proofs = {"streaming": None}
    modes = ((name, zk, poseidon) == STREAMING_TOO) * ["streaming"]
    for mode in modes + ["resident"]:
        mp = pytest.MonkeyPatch()
        try:
            cr = force(mp, direct, mode == "resident", poseidon)
            lig = build()
        finally:
            mp.undo()
        assert (lig.encode_mode, lig.chunk_rows) == (mode, cr)
        proofs[mode] = lig.prove(vars_, test_sponge(field), **kw)
    streaming = proofs["streaming"]
    return (field, vars_, want, got_direct.to_bytes(pf(field)),
            streaming and streaming.to_bytes(pf(field)), lig,
            proofs["resident"])


@pytest.fixture(scope="module", params=PATHS,
                ids=lambda p: f"{p[0]}-{'zk' if p[1] else 'plain'}"
                + ("-poseidon" if p[2] else ""))
def resident(request):
    return proved(*request.param)


def test_resident_proof_bytes_equal_jax_package_direct_and_streaming(
        resident):
    field, _, want, direct, streaming, lig, got = resident
    assert lig.encode_mode == "resident"
    data = lig.num_rows - (3 if lig.zk else 0)
    assert -(-data // lig.chunk_rows) >= 3 and data % lig.chunk_rows
    got = got.to_bytes(pf(field))
    assert got == want
    assert got == direct
    assert streaming is None or got == streaming


def test_resident_verify_verify_batch_and_rejections(resident):
    field, vars_, _, _, _, lig, got = resident
    sp = test_sponge(field)
    assert lig.verify(got, sp.clone())
    flipped = bytearray(got.to_bytes(pf(field)))
    flipped[8 + 32 + 8] ^= 1        # the first interleaved lc element
    bad = LigeroProof.from_bytes(bytes(flipped), pf(field))
    assert lig.verify_batch([bad, got], sp) == [False, True]
    # the last input feeds the output in this circuit
    bad_vars = vars_[:-1] + [(vars_[-1][0], vars_[-1][1] + 1)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tampered = lig.prove(bad_vars, sp.clone(), **(
            {"zk_seed": ZK_SEED} if lig.zk else {}))
    assert not lig.verify(tampered, sp.clone())


def test_resident_reprove_another_witness_and_batches(monkeypatch):
    """The JAX package's resident regression: a second witness on the same
    resident instance is proved from its own rows (its proof equals a fresh
    instance's), and the first witness again gives the first proof;
    ``prove_batch`` proves one witness at a time in resident mode."""
    field, vars_, _, _, _, lig, got = proved("bn254", False, False)
    other = [(i, v + 1) for i, v in vars_]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        again = lig.prove(other, test_sponge(field))
        budget = lig.backend.resident_bytes(*dims(lig),
                                            chunk_rows=lig.chunk_rows)
        monkeypatch.setattr(TorchBackend, "memory_budget",
                            lambda self: budget)
        monkeypatch.setattr(port_backend, "STREAM_MAX_CHUNK_ROWS",
                            lig.chunk_rows)
        fresh = LigeroCircuit.from_compiled(lig.state, device="cpu")
        assert fresh.encode_mode == "resident"
        want = fresh.prove(other, test_sponge(field))
    assert again.to_bytes(pf(field)) == want.to_bytes(pf(field))
    proofs = lig.prove_batch([vars_, vars_], test_sponge(field))
    assert [p.to_bytes(pf(field)) for p in proofs] == \
        [got.to_bytes(pf(field))] * 2
    bumped = [(lig.state.bump_index(i), v) for i, v in vars_]
    with pytest.raises(ValueError, match="resident mode proves one witness"):
        lig._prove_many([bumped, bumped], [test_sponge(field)] * 2,
                        [None, None])


# ---------------------------------------------------------------------------
# the estimates and the mode choice
# ---------------------------------------------------------------------------

def test_resident_estimate_lies_above_streaming_at_every_chunking():
    """At the test instances' shapes and at the card's reach, plain and zk,
    with either commitment: every chunking's resident estimate exceeds its
    streaming estimate by at least U."""
    for field in FIELDS.values():
        be = TorchBackend(pf(field), "cpu")
        E = 4 * field.num_limbs
        for rows, k, n, nnz, b, d2 in ((44, 16, 128, 819, 0, 32),
                                       (47, 16, 128, 819, 42, 128),
                                       (11588, 4096, 32768, 60764163, 0,
                                        8192),
                                       (16391, 8192, 65536, 121531395, 468,
                                        16384)):
            data = rows - (3 if b else 0)
            for cr in range(STREAM_ROW_QUANTUM, min(data, 1024) + 1,
                            STREAM_ROW_QUANTUM):
                for poseidon in (False, True):
                    args = (rows, k, n, nnz, b, d2, cr, poseidon)
                    assert (be.resident_bytes(*args)
                            >= be.streaming_bytes(*args) + rows * n * E), \
                        (field.name, rows, cr, poseidon)


def test_resident_mode_at_the_reach_of_the_card():
    """On an H100's 79.18 GiB: BLS12-377 2^23 (m 2897, k 4096, n 32768,
    nnz of A 60,764,163) takes resident mode, plain and zk, in 1024-row
    chunks.  BN254 2^24 (m 4097, k 8192, n 65536): U alone is 64 GiB in the
    port's int32 words of 16-bit limbs, and the resident estimate passes
    the card, so it streams."""
    for field, (m, k, n, nnz), want in (
            (BLS12_377_FQ, (2897, 4096, 32768, 60764163), "resident"),
            (BN254_FR, (4097, 8192, 65536, 121531395), "streaming")):
        be = TorchBackend(pf(field), "cpu")
        be.memory_budget = lambda: H100_BYTES
        for b in (0, 468):
            d2 = max(2 * k, 1 << (2 * (k + b) - 2).bit_length()) if b else None
            shape = (4 * m + (3 if b else 0), k, n, nnz, b, d2)
            assert be.encode_mode(*shape) == (want, 1024), (field.name, b)
            assert be.direct_bytes(*shape) > H100_BYTES


def test_resident_band_of_the_mode_choice(monkeypatch):
    """Resident exactly where direct does not fit and the resident estimate
    does at the chunking streaming mode takes (plain and zk, either
    commitment); streaming below it, in the same chunks, and at every
    budget set at a streaming estimate; none: the error names all three
    estimates."""
    be = TorchBackend(pf(BN254_FR), "cpu")
    for shape in ((4100, 2048, 16384, 9_443_331),
                  (4103, 2048, 16384, 9_443_331, 468, 8192)):
        for poseidon in (False, True):
            direct = be.direct_bytes(*shape)
            monkeypatch.setattr(be, "memory_budget", lambda: direct - 1)
            assert be.encode_mode(*shape, poseidon=poseidon) == (
                "resident", 1024)
            top = be.resident_bytes(*shape, poseidon=poseidon)
            for budget, want in ((top, "resident"), (top - 1, "streaming")):
                monkeypatch.setattr(be, "memory_budget", lambda: budget)
                assert be.encode_mode(*shape, poseidon=poseidon) == (
                    want, 1024)
            for cr in (1024, 512, 64, 4):
                for estimate in (be.resident_bytes, be.streaming_bytes):
                    budget = estimate(*shape, chunk_rows=cr,
                                      poseidon=poseidon)
                    monkeypatch.setattr(be, "memory_budget", lambda: budget)
                    mode, got = be.encode_mode(*shape, poseidon=poseidon)
                    assert got >= cr
                    assert (mode == "resident") == (be.resident_bytes(
                        *shape, chunk_rows=got, poseidon=poseidon) <= budget)
                    if estimate == be.streaming_bytes:
                        assert mode == "streaming", (shape, cr)
    shape = (4100, 2048, 16384, 9_443_331)
    monkeypatch.setattr(be, "memory_budget", lambda: 1 << 20)
    with pytest.raises(DeviceMemoryError, match="direct mode.*resident "
                                                "mode.*streaming mode"):
        be.encode_mode(*shape)


def test_a_mesh_never_takes_resident_mode(monkeypatch):
    """A ShardedBackend over two CPU devices, at a budget where one
    device's resident estimate fits: the mesh streams (both mesh kinds
    take this one method), and its error names no resident estimate."""
    field = pf(BN254_FR)
    shape = (4100, 2048, 16384, 9_443_331)
    one = TorchBackend(field, "cpu")
    mesh = ShardedBackend(field, ["cpu"] * 2)
    assert not mesh.RESIDENT and one.RESIDENT
    budget = one.resident_bytes(*shape)
    assert budget < mesh.direct_bytes(*shape)
    monkeypatch.setattr(TorchBackend, "memory_budget", lambda self: budget)
    assert one.encode_mode(*shape) == ("resident", 1024)
    assert mesh.encode_mode(*shape)[0] == "streaming"
    monkeypatch.setattr(TorchBackend, "memory_budget", lambda self: 1 << 20)
    with pytest.raises(DeviceMemoryError) as err:
        mesh.encode_mode(*shape)
    assert "resident" not in str(err.value)

    circ, outs, _ = generate_random_circuit(BN254_FR, GATES,
                                            num_vars=NUM_VARS,
                                            seed=CIRCUIT_SEED)
    port = convert.circuit_from_reference(circ)
    direct = LigeroCircuit(port, outs, lambda_=LAMBDA, device="cpu")
    force(monkeypatch, direct, resident=True)
    lig = LigeroCircuit(port, outs, lambda_=LAMBDA,
                        backend=ShardedBackend(field, ["cpu"] * 2))
    assert lig.encode_mode != "resident"


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name,zk", [("bn254", False), ("bn254", True),
                                     ("bls12_377", False)])
def test_resident_proof_on_cuda_equals_cpu(cuda, monkeypatch, name, zk):
    field = FIELDS[name]
    circ, outs, vars_ = generate_random_circuit(field, GATES,
                                                num_vars=NUM_VARS,
                                                seed=CIRCUIT_SEED)
    port = convert.circuit_from_reference(circ)
    kw = {"zk_seed": ZK_SEED} if zk else {}
    direct = LigeroCircuit(port, outs, lambda_=LAMBDA, zk=zk, device="cpu")
    want = direct.prove(vars_, test_sponge(field), **kw)
    force(monkeypatch, direct, resident=True)
    lig = LigeroCircuit(port, outs, lambda_=LAMBDA, zk=zk, device=cuda)
    assert lig.encode_mode == "resident"
    got = lig.prove(vars_, test_sponge(field), **kw)
    assert got.to_bytes(pf(field)) == want.to_bytes(pf(field))
    assert lig.verify(want, test_sponge(field))
