"""Streaming mode of the port on device="cpu": U never held, its coefficient
rows in row chunks (engine/devmatrix.py), the commit through the streamed
Blake2s absorb, the linear phase in column blocks.  Forced by a memory
budget between the streaming and the direct estimate, so the mode choice
itself runs; at least three chunks, the last one ragged.  Proof bytes
equal the JAX package's numpy golden path and the port's direct mode
(tolerance: none); the pieces (streamed absorb, segmented sampler, blocked
sparse product, chunked products) equal their whole forms."""

import hashlib
import warnings

import pytest
import torch

from ligero_tpu.engine.backend import Backend
from ligero_tpu.fields import BLS12_377_FQ, BN254_FR
from ligero_tpu.ligero import LigeroCircuit as RefCircuit
from ligero_tpu.sampling import rand_field_elements_limbs
from ligero_tpu.sponge import test_sponge
from ligero_tpu.synthetic import generate_random_circuit
from ligero_tpu_torch import LigeroCircuit, LigeroProof, convert
from ligero_tpu_torch.engine import cuda_hash, devsampler, fieldops, hashops
from ligero_tpu_torch.engine.backend import (STREAM_ROW_QUANTUM,
                                             DeviceMemoryError, MessageRows,
                                             TorchBackend)
from ligero_tpu_torch.engine.devmatrix import RowChunkedMatrix
from ligero_tpu_torch.fields import FIELDS as PORT_FIELDS
from ligero_tpu_torch.ligero.types import LigeroMTPoseidonParams

# the suite runs in several worker processes that share the host's cores, and
# these tests run many small tensor ops: one intra-op thread each, or the
# workers' thread pools spin against each other
torch.set_num_threads(1)

ZK_SEED = bytes(range(32))
FIELDS = {"bn254": BN254_FR, "bls12_377": BLS12_377_FQ}
# (gates, num_vars, circuit seed, lambda): small enough for the zk blinding
GATES, NUM_VARS, CIRCUIT_SEED, LAMBDA = 96, 4, 3, 10


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


def ragged_chunk_rows(data_rows: int) -> int:
    """The largest chunk (a multiple of the row quantum) that cuts
    ``data_rows`` into at least three chunks, the last one short."""
    q = STREAM_ROW_QUANTUM
    for cr in range(data_rows // 3 // q * q, 0, -q):
        if data_rows % cr:
            return cr
    raise AssertionError(f"{data_rows} rows cannot be cut raggedly")


def force_streaming(monkeypatch, direct):
    """A budget under the direct estimate of ``direct``'s instance, at the
    streaming estimate of a ragged three-chunk cut: returns it."""
    data = direct.num_rows - (3 if direct.zk else 0)
    cr = ragged_chunk_rows(data)
    be = direct.backend
    budget = be.streaming_bytes(*dims(direct), chunk_rows=cr)
    assert budget < be.direct_bytes(*dims(direct))
    monkeypatch.setattr(TorchBackend, "memory_budget", lambda self: budget)
    return budget


def build(field, zk, device="cpu"):
    circ, outs, vars_ = generate_random_circuit(field, GATES,
                                                num_vars=NUM_VARS,
                                                seed=CIRCUIT_SEED)
    ref = RefCircuit(circ, outs, lambda_=LAMBDA, zk=zk, backend=Backend(field))
    port = LigeroCircuit(convert.circuit_from_reference(circ), outs,
                         lambda_=LAMBDA, zk=zk, device=device)
    return circ, outs, vars_, ref, port


@pytest.fixture(scope="module", params=[(f, zk) for f in FIELDS
                                        for zk in (False, True)],
                ids=lambda p: f"{p[0]}-{'zk' if p[1] else 'plain'}")
def streamed(request):
    """(field, ref proof, direct port proof, streaming circuit, its proof,
    the direct circuit)."""
    field = FIELDS[request.param[0]]
    zk = request.param[1]
    circ, outs, vars_, ref, direct = build(field, zk)
    kw = {"zk_seed": ZK_SEED} if zk else {}
    want = ref.prove(vars_, test_sponge(field), **kw)
    got_direct = direct.prove(vars_, test_sponge(field), **kw)
    mp = pytest.MonkeyPatch()
    try:
        force_streaming(mp, direct)
        lig = LigeroCircuit(convert.circuit_from_reference(circ), outs,
                            lambda_=LAMBDA, zk=zk, device="cpu")
        got = lig.prove(vars_, test_sponge(field), **kw)
    finally:
        mp.undo()
    return field, want, got_direct, lig, got, direct


def test_streaming_proof_bytes_equal_jax_package_and_direct_mode(streamed):
    field, want, got_direct, lig, got, direct = streamed
    assert direct.encode_mode == "direct"
    assert lig.encode_mode == "streaming"
    data = lig.num_rows - (3 if lig.zk else 0)
    chunks = -(-data // lig.chunk_rows)
    assert chunks >= 3 and data % lig.chunk_rows, (data, lig.chunk_rows)
    assert got.to_bytes(pf(field)) == want.to_bytes(field)
    assert got.to_bytes(pf(field)) == got_direct.to_bytes(pf(field))


def test_streaming_verify_and_verify_batch(streamed):
    field, want, _, lig, got, direct = streamed
    sp = test_sponge(field)
    port_want = LigeroProof.from_bytes(want.to_bytes(field), pf(field))
    assert lig.verify(got, sp.clone())
    flipped = bytearray(got.to_bytes(pf(field)))
    flipped[8 + 32 + 8] ^= 1        # the first interleaved lc element
    bad = LigeroProof.from_bytes(bytes(flipped), pf(field))
    assert not lig.verify(bad, sp.clone())
    assert lig.verify_batch([bad, port_want], sp) == [False, True]


def test_streaming_rejects_a_witness_that_fails_the_circuit():
    circ, outs, vars_ = generate_random_circuit(BN254_FR, GATES,
                                                num_vars=NUM_VARS,
                                                seed=CIRCUIT_SEED)
    port = LigeroCircuit(convert.circuit_from_reference(circ), outs,
                         device="cpu")
    mp = pytest.MonkeyPatch()
    try:
        force_streaming(mp, port)
        lig = LigeroCircuit(convert.circuit_from_reference(circ), outs,
                            device="cpu")
    finally:
        mp.undo()
    assert lig.encode_mode == "streaming"
    # the last input feeds the output in this circuit
    bad_vars = vars_[:-1] + [(vars_[-1][0], vars_[-1][1] + 1)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        bad = lig.prove(bad_vars, test_sponge(BN254_FR))
    assert not lig.verify(bad, test_sponge(BN254_FR))
    assert not port.verify(bad, test_sponge(BN254_FR))


@pytest.mark.parametrize("name", list(FIELDS))
def test_streamed_blake2s_equals_hashlib_at_every_chunking(name):
    """Rows of every residue mod 4 (and an odd zk-like count), chunks of
    one to three periods, the last one ragged: the streamed absorb's
    digests equal hashlib's over the column's serialization."""
    field = pf(FIELDS[name])
    L, E = field.num_limbs, hashops.period_rows(field.num_limbs)
    gen = torch.Generator().manual_seed(L)
    n = 3
    for rows in (1, 2, 3, 4, 5, 9, 11, 15):
        u = torch.randint(0, 1 << 16, (rows, n, L), dtype=torch.int32,
                          generator=gen)
        want = [hashlib.blake2s(rows.to_bytes(8, "little") + b"".join(
            int(sum(int(u[r, j, i]) << (16 * i) for i in range(L))).to_bytes(
                2 * L, "little") for r in range(rows))).digest()
            for j in range(n)]
        for cr in (E, 2 * E, 3 * E):
            hs = cuda_hash.ColumnHashStream(field, n, rows, "cpu")
            for r0 in range(0, rows, cr):
                real = min(cr, rows - r0)
                chunk = torch.zeros((cr, n, L), dtype=torch.int16)
                chunk[:real] = fieldops.narrow16(u[r0:r0 + real])
                hs.absorb(chunk, real)
            got = hs.digests().numpy().astype("<u4")
            assert [got[j].tobytes() for j in range(n)] == want, (rows, cr)


def test_streamed_blake2s_refuses_a_partial_period():
    field = pf(BLS12_377_FQ)
    hs = cuda_hash.ColumnHashStream(field, 2, 10, "cpu")
    with pytest.raises(ValueError):
        hs.absorb(torch.zeros((6, 2, field.num_limbs), dtype=torch.int16), 6)
    with pytest.raises(ValueError):
        hs.digests()


@pytest.mark.parametrize("name", list(FIELDS))
def test_segmented_sampler_equals_the_host_sampler(name):
    """Segments of 7 attempts: a BLS12-377 attempt is 12 keystream words,
    so segments start inside ChaCha20 blocks; takes of uneven sizes; the
    JAX package's host sampler is the reference."""
    field = FIELDS[name]
    want = torch.from_numpy(rand_field_elements_limbs(field, 61, ZK_SEED)
                            .astype("int32"))
    for segment in (7, 200):
        stream = devsampler.FrStream(pf(field), ZK_SEED, "cpu", segment)
        got = torch.cat([stream.take(c) for c in (5, 1, 20, 0, 35)])
        assert torch.equal(got, want), segment


def chunked(t: torch.Tensor, cr: int) -> RowChunkedMatrix:
    rows = t.shape[0]
    pad = -(-rows // cr) * cr - rows
    full = torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])
    return RowChunkedMatrix(list(full.split(cr)), rows, cr)


def test_blocked_pieces_equal_the_whole_forms(streamed):
    """On the instance's own data: the blocked sparse product against
    sparse_rA_mont, the chunked interleaved combination (message rows as
    coefficients), linear and quadratic products against the whole ones."""
    field, _, _, lig, _, direct = streamed
    be, k, m, cr = lig.backend, lig.k, lig.m, lig.chunk_rows
    four_mk = 4 * m * k
    r = be.rand_field_mont(four_mk, ZK_SEED)
    assert torch.equal(be.rand_field_mont(four_mk, ZK_SEED, segment=cr * k), r)
    whole = be.sparse_rA_mont(*direct._device_coo(), r, four_mk)
    coo = lig._device_coo()
    blocks = list(be.sparse_rA_blocks(*coo[:3], r, coo[3], cr * k))
    assert torch.equal(torch.cat(blocks)[:four_mk], whole)
    assert not torch.cat(blocks)[four_mk:].any()

    gen = torch.Generator().manual_seed(5)
    width = k + lig.blind_t
    coeffs = be.rand_field_mont(4 * m * width, bytes(32)).reshape(
        4 * m, width, -1)
    r_rows = whole.reshape(4 * m, k, -1)
    rc = chunked(coeffs, cr)
    rr = chunked(r_rows, cr)
    lin = be.linear_combination_poly(coeffs, r_rows, lig.d2)
    assert torch.equal(be.linear_combination_poly(rc, rr, lig.d2), lin)
    rq = r[torch.randperm(four_mk, generator=gen)[:m]]
    quad = be.quadratic_combination_poly(coeffs[:3 * m], rq, lig.d2)
    assert torch.equal(be.quadratic_combination_poly(rc, rq, lig.d2, m), quad)
    r_int = r[:4 * m]
    assert torch.equal(be.row_combine_chunked(r_int, rc),
                       be.row_combine(r_int, coeffs))
    if not lig.zk:
        msg = be.ntt(coeffs, k)
        assert torch.equal(be.row_combine_chunked(r_int, MessageRows(rc)),
                           be.row_combine(r_int, msg))


def test_mode_choice_follows_the_budget(monkeypatch):
    """Direct where it fits; resident where that does not and a resident
    chunking does; streaming only below the least resident estimate; none:
    DeviceMemoryError naming the estimates; the Poseidon commitment past
    direct mode: streaming too, in chunks no larger (its estimate counts
    the column sponges' states)."""
    be = TorchBackend(pf(BN254_FR), "cpu")
    shape = (4100, 2048, 16384, 9_443_331)
    direct = be.direct_bytes(*shape)
    monkeypatch.setattr(be, "memory_budget", lambda: direct)
    assert be.encode_mode(*shape) == ("direct", 0)
    monkeypatch.setattr(be, "memory_budget", lambda: direct - 1)
    assert be.encode_mode(*shape) == ("resident", 1024)
    below = be.resident_bytes(*shape, chunk_rows=STREAM_ROW_QUANTUM) - 1
    monkeypatch.setattr(be, "memory_budget", lambda: below)
    mode, cr = be.encode_mode(*shape)
    assert mode == "streaming" and cr == 1024
    assert be.streaming_bytes(*shape, chunk_rows=cr) < direct
    least = be.streaming_bytes(*shape, chunk_rows=STREAM_ROW_QUANTUM)
    monkeypatch.setattr(be, "memory_budget", lambda: least)
    assert be.encode_mode(*shape) == ("streaming", STREAM_ROW_QUANTUM)
    monkeypatch.setattr(be, "memory_budget", lambda: least - 1)
    with pytest.raises(DeviceMemoryError, match="streaming mode"):
        be.encode_mode(*shape)

    circ, outs, _ = generate_random_circuit(BN254_FR, GATES, num_vars=NUM_VARS,
                                            seed=CIRCUIT_SEED)
    port = convert.circuit_from_reference(circ)
    force_streaming(monkeypatch, LigeroCircuit(port, outs, device="cpu"))
    blake = LigeroCircuit(port, outs, device="cpu")
    pos = LigeroCircuit(port, outs, device="cpu",
                        mt_params=LigeroMTPoseidonParams(pf(BN254_FR)))
    assert blake.encode_mode == pos.encode_mode == "streaming"
    assert 0 < pos.chunk_rows <= blake.chunk_rows


def test_streaming_estimates_at_the_reach_of_the_card():
    """The instances direct mode refuses on an 80 GB card fit it in
    streaming mode, prover and verifier, at the shapes they take (nnz about
    9 a gate)."""
    card = 80 * 10**9
    for field, (m, k, n), gates in ((BLS12_377_FQ, (2897, 4096, 32768), 23),
                                    (BN254_FR, (4097, 8192, 65536), 24)):
        be = TorchBackend(pf(field), "cpu")
        shape = (4 * m, k, n, 9 << gates)
        assert be.direct_bytes(*shape) > card
        assert be.streaming_bytes(*shape) < card
        assert be.streaming_verify_bytes(*shape, chunk_rows=1024) < card


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FIELDS))
def test_streamed_blake2s_kernel_matches_plain_and_whole_column(cuda, name):
    field = pf(FIELDS[name])
    L = field.num_limbs
    gen = torch.Generator(device=cuda).manual_seed(3)
    n = 1000
    for rows, cr in ((4100, 1024), (4103, 512), (13, 4), (6, 8)):
        u = torch.randint(0, 1 << 16, (rows, n, L), dtype=torch.int32,
                          device=cuda, generator=gen)
        whole = cuda_hash.blake2s_columns(field, u)
        dev = cuda_hash.ColumnHashStream(field, n, rows, cuda)
        cpu = cuda_hash.ColumnHashStream(field, n, rows, "cpu")
        for r0 in range(0, rows, cr):
            real = min(cr, rows - r0)
            chunk = torch.zeros((cr, n, L), dtype=torch.int16, device=cuda)
            chunk[:real] = fieldops.narrow16(u[r0:r0 + real])
            dev.absorb(chunk, real)
            cpu.absorb(chunk.cpu(), real)
        assert torch.equal(dev.digests(), whole), (rows, cr)
        assert torch.equal(cpu.digests(), whole.cpu()), (rows, cr)


@pytest.mark.cuda
@pytest.mark.parametrize("zk", [False, True])
def test_streaming_proof_on_cuda_equals_cpu(cuda, monkeypatch, zk):
    circ, outs, vars_, _, direct = build(BN254_FR, zk)
    kw = {"zk_seed": ZK_SEED} if zk else {}
    want = direct.prove(vars_, test_sponge(BN254_FR), **kw)
    force_streaming(monkeypatch, direct)
    lig = LigeroCircuit(convert.circuit_from_reference(circ), outs,
                        lambda_=LAMBDA, zk=zk, device=cuda)
    assert lig.encode_mode == "streaming"
    got = lig.prove(vars_, test_sponge(BN254_FR), **kw)
    assert got.to_bytes(pf(BN254_FR)) == want.to_bytes(pf(BN254_FR))
    assert lig.verify(want, test_sponge(BN254_FR))
