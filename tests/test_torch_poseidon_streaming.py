"""The Poseidon commitment under streaming mode, on device="cpu": the
columns' sponges absorb U a re-encoded chunk at a time
(``cuda_poseidon.PoseidonColumnStream``; on the CPU its plain version,
``poseidon_cols.poseidon_absorb_plain``), their states kept between chunks.

Inputs are made from a seed with numpy; the tolerance is none (exact
integer arithmetic).  The chunked digests equal the JAX package's
``PoseidonColumns`` on the same chunks (``_odd_safe``, the path of its
streamed sources) and on a ``StreamedCodewords``, and the host sponge, at
rows of every residue mod 4 and the zk count 4m + 3, chunked raggedly;
streaming proofs, forced by a small budget, plain and zk, equal the JAX
package's Poseidon proofs and the port's direct ones byte for byte."""

import warnings

import numpy as np
import pytest
import torch

from ligero_tpu.engine.backend import Backend, get_backend
from ligero_tpu.engine.devmatrix import RowChunkedMatrix as RefChunks
from ligero_tpu.engine.devmatrix import StreamedCodewords as RefStreamed
from ligero_tpu.engine.poseidon_cols import get_poseidon_columns
from ligero_tpu.fields import BN254_FR as F
from ligero_tpu.ligero import LigeroCircuit as RefCircuit
from ligero_tpu.ligero.types import LigeroMTPoseidonParams as RefParams
from ligero_tpu.sponge import test_poseidon_config as ref_poseidon_config
from ligero_tpu.sponge import test_sponge
from ligero_tpu.synthetic import generate_random_circuit
from ligero_tpu_torch import LigeroCircuit, LigeroProof, convert
from ligero_tpu_torch.engine import cuda_poseidon, poseidon_cols
from ligero_tpu_torch.engine.backend import STREAM_ROW_QUANTUM, TorchBackend
from ligero_tpu_torch.engine.devmatrix import (RowChunkedMatrix,
                                               StreamedCodewords)
from ligero_tpu_torch.fields import BN254_FR as PF
from ligero_tpu_torch.ligero.types import LigeroMTPoseidonParams
from ligero_tpu_torch.sponge import test_poseidon_config

# one intra-op thread: the workers of the suite share the host's cores
torch.set_num_threads(1)

CFG = test_poseidon_config(PF)
CPU = TorchBackend(PF, "cpu")
ZK_SEED = bytes(range(32))
# (gates, num_vars, circuit seed, lambda): small enough for the zk blinding
GATES, NUM_VARS, CIRCUIT_SEED, LAMBDA = 96, 4, 3, 10


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def rand_matrix(rng, rows, n):
    """(rows x n canonical ints, (rows, n, L) int32 limbs)."""
    ints = [[int.from_bytes(rng.bytes(40), "little") % F.p for _ in range(n)]
            for _ in range(rows)]
    limbs = PF.ints_to_limbs([v for row in ints for v in row]).reshape(
        rows, n, PF.num_limbs)
    return ints, torch.from_numpy(limbs.astype(np.int32))


def stream_digests(u: torch.Tensor, chunk_rows: int, device="cpu",
                   lanes=None) -> torch.Tensor:
    """The digests of u's columns absorbed ``chunk_rows`` rows a chunk, each
    chunk zero-padded to its full height (as the re-encoded chunks are):
    through ``PoseidonColumnStream``, or at ``lanes`` lanes a column through
    the chunked entry itself."""
    rows, n, L = u.shape
    chunks = []
    for r0 in range(0, rows, chunk_rows):
        real = min(chunk_rows, rows - r0)
        chunk = torch.zeros((chunk_rows, n, L), dtype=torch.int32,
                            device=device)
        chunk[:real] = u[r0:r0 + real]
        chunks.append((r0, chunk, real))
    if lanes is None:
        stream = cuda_poseidon.PoseidonColumnStream(PF, CFG, n, rows, device)
        for _, chunk, real in chunks:
            stream.absorb(chunk, real)
        return stream.digests()
    state = poseidon_cols.poseidon_stream_start(PF, n, device)
    for r0, chunk, real in chunks:
        state = cuda_poseidon.poseidon_absorb(PF, CFG, chunk, real, state,
                                              r0 == 0, r0 + real == rows,
                                              lanes)
    return state


# rows of every residue mod 4 and zk counts 4m + 3, in chunks of multiples
# of the streaming mode's row quantum, the last one ragged (or odd)
CHUNKINGS = [(12, 8), (13, 4), (14, 8), (15, 4), (15, 8), (23, 12), (2, 4)]


@pytest.mark.parametrize("rows,chunk_rows", CHUNKINGS)
def test_chunked_absorb_equals_jax_package_and_host_sponge(rows, chunk_rows):
    ints, u = rand_matrix(np.random.default_rng(rows * 100 + chunk_rows),
                          rows, 5)
    got = poseidon_cols.digests_to_bytes(stream_digests(u, chunk_rows))
    mt = RefParams(F)
    assert got == [mt.col_hash(F, [row[j] for row in ints]) for j in range(5)]
    kern = get_poseidon_columns(get_backend(F, use_jax=True),
                                ref_poseidon_config(F))
    blocks = [u[r0:r0 + chunk_rows].numpy().astype(np.uint32)
              for r0 in range(0, rows, chunk_rows)]
    assert kern._odd_safe(blocks, rows, 5) == got
    assert got == poseidon_cols.digests_to_bytes(
        poseidon_cols.poseidon_columns_plain(PF, CFG, u))


def test_streamed_codewords_digests_equal_jax_package():
    """A streamed source end to end: coefficient chunks re-encoded to n
    points and absorbed (``device_col_digests`` on a StreamedCodewords)
    against the JAX package's ``PoseidonColumns.digests`` on its own
    StreamedCodewords of the same coefficient chunks; 22 rows in chunks of
    8 (the last one of 6), and with three mask rows below them."""
    rng = np.random.default_rng(7)
    k, n, rows, cr = 8, 64, 22, 8
    mont = PF.ints_to_mont_limbs([int.from_bytes(rng.bytes(40), "little")
                                  % F.p for _ in range(3 * 8 * k)]).reshape(
        3 * cr, k, -1).astype(np.int32)
    mont[rows:] = 0
    chunks = [torch.from_numpy(mont[i:i + cr]) for i in range(0, 3 * cr, cr)]
    sc = StreamedCodewords(RowChunkedMatrix(chunks, rows, cr), n)
    got = LigeroMTPoseidonParams(PF).device_col_digests(CPU, sc)
    be = get_backend(F, use_jax=True)
    ref_sc = RefStreamed(RefChunks([be.asarray(c.numpy().astype(np.uint32))
                                    for c in chunks], rows, cr), n, rows)
    assert get_poseidon_columns(be, ref_poseidon_config(F)).digests(
        ref_sc) == got

    tail = torch.from_numpy(mont[:3])        # three mask rows, n-wide
    zk_sc = StreamedCodewords(RowChunkedMatrix(chunks, rows, cr), n, tail)
    whole = torch.cat([CPU.ntt_and_canon(c, n)[:sc.coeffs.real_rows(i)]
                       for i, c in enumerate(chunks)]
                      + [CPU.ntt_and_canon(tail, n)])
    assert whole.shape[0] == rows + 3
    assert LigeroMTPoseidonParams(PF).device_col_digests(CPU, zk_sc) == \
        poseidon_cols.digests_to_bytes(
            poseidon_cols.poseidon_columns_plain(PF, CFG, whole))


def test_odd_chunk_before_the_last_raises():
    _, u = rand_matrix(np.random.default_rng(1), 9, 3)
    stream = cuda_poseidon.PoseidonColumnStream(PF, CFG, 3, 9, "cpu")
    with pytest.raises(ValueError, match="odd"):
        stream.absorb(u[:5], 5)
    stream.absorb(u[:4], 4)
    with pytest.raises(ValueError, match="exceed"):
        stream.absorb(u[:6], 6)
    with pytest.raises(ValueError, match="absorbed"):
        stream.digests()
    stream.absorb(u[4:], 5)                 # the last chunk may be odd
    assert torch.equal(stream.digests(),
                       poseidon_cols.poseidon_columns_plain(PF, CFG, u))
    state = poseidon_cols.poseidon_stream_start(PF, 3, "cpu")
    with pytest.raises(ValueError, match="odd"):
        cuda_poseidon.poseidon_absorb(PF, CFG, u, 3, state, True, False)


def test_streaming_estimate_counts_the_sponge_states():
    """Beside a chunk's re-encode, the commit holds the n columns' sponge
    states (three 32-byte elements) and digests (64 bytes as limbs)."""
    for shape in ((16388, 8192, 65536, 9 << 24), (4100, 2048, 16384, 9 << 20)):
        n = shape[2]
        parts = [CPU._stream_parts(*shape, 0, 2 * shape[1], 1024, poseidon=p)
                 for p in (False, True)]
        assert parts[1]["reencode"] - parts[0]["reencode"] == n * (96 + 64)
        assert CPU.streaming_bytes(*shape, poseidon=True) >= \
            CPU.streaming_bytes(*shape)
        assert CPU.stream_chunk_rows(*shape, poseidon=True) > 0


# ---------------------------------------------------------------------------
# whole proofs: streaming mode under the Poseidon commitment
# ---------------------------------------------------------------------------

def ragged_chunk_rows(data_rows: int) -> int:
    q = STREAM_ROW_QUANTUM
    for cr in range(data_rows // 3 // q * q, 0, -q):
        if data_rows % cr:
            return cr
    raise AssertionError(f"{data_rows} rows cannot be cut raggedly")


@pytest.fixture(scope="module", params=[False, True],
                ids=["plain", "zk"])
def poseidon_streamed(request):
    """(zk, the JAX package's proof bytes, the port's direct proof, the
    streaming instance, its proof)."""
    zk = request.param
    circ, outs, vars_ = generate_random_circuit(F, GATES, num_vars=NUM_VARS,
                                                seed=CIRCUIT_SEED)
    port = convert.circuit_from_reference(circ)
    kw = {"zk_seed": ZK_SEED} if zk else {}
    ref = RefCircuit(circ, outs, lambda_=LAMBDA, zk=zk, backend=Backend(F),
                     mt_params=RefParams(F))
    want = ref.prove(vars_, test_sponge(F), **kw).to_bytes(F)
    mt = LigeroMTPoseidonParams(PF)
    direct = LigeroCircuit(port, outs, lambda_=LAMBDA, zk=zk, device="cpu",
                           mt_params=mt)
    got_direct = direct.prove(vars_, test_sponge(F), **kw)
    dims = (direct.num_rows, direct.k, direct.n, len(direct.state.a_vals),
            direct.blind_t, direct.d2)
    cr = ragged_chunk_rows(direct.num_rows - (3 if zk else 0))
    budget = direct.backend.streaming_bytes(*dims, chunk_rows=cr,
                                            poseidon=True)
    assert budget < direct.backend.direct_bytes(*dims)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(TorchBackend, "memory_budget", lambda self: budget)
        lig = LigeroCircuit(port, outs, lambda_=LAMBDA, zk=zk, device="cpu",
                            mt_params=mt)
    finally:
        mp.undo()
    got = lig.prove(vars_, test_sponge(F), **kw)
    return zk, vars_, want, got_direct, lig, got


def test_poseidon_streaming_proof_bytes_equal_jax_package_and_direct(
        poseidon_streamed, monkeypatch):
    zk, _, want, got_direct, lig, got = poseidon_streamed
    assert lig.encode_mode == "streaming"
    data = lig.num_rows - (3 if zk else 0)
    assert -(-data // lig.chunk_rows) >= 3 and data % lig.chunk_rows
    assert got.to_bytes(PF) == want
    assert got.to_bytes(PF) == got_direct.to_bytes(PF)


def test_poseidon_streaming_verify_and_rejections(poseidon_streamed):
    zk, vars_, _, _, lig, got = poseidon_streamed
    sp = test_sponge(F)
    assert lig.verify(got, sp.clone())
    flipped = bytearray(got.to_bytes(PF))
    flipped[8 + 32 + 8] ^= 1        # the first interleaved lc element
    assert not lig.verify(LigeroProof.from_bytes(bytes(flipped), PF),
                          sp.clone())
    bad_vars = vars_[:-1] + [(vars_[-1][0], vars_[-1][1] + 1)]
    kw = {"zk_seed": ZK_SEED} if zk else {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        bad = lig.prove(bad_vars, sp.clone(), **kw)
    assert not lig.verify(bad, sp.clone())


# ---------------------------------------------------------------------------
# CUDA twins: the chunked entry against its plain version on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 2, 4, 8])
def test_chunked_kernel_matches_plain_and_whole_column(cuda, lanes):
    for rows, cr, n in ((13, 4, 130), (23, 8, 257), (64, 16, 5), (7, 8, 33)):
        _, u = rand_matrix(np.random.default_rng(rows + n), rows, n)
        whole = cuda_poseidon.poseidon_columns(PF, CFG, u.to(cuda),
                                               lanes=lanes)
        assert torch.equal(stream_digests(u.to(cuda), cr, cuda, lanes),
                           whole), (rows, cr, n)
        assert torch.equal(stream_digests(u, cr).to(cuda), whole)


@pytest.mark.cuda
def test_chunked_kernel_states_equal_plain_states(cuda):
    """The states between chunks, word for word (canonical Montgomery)."""
    _, u = rand_matrix(np.random.default_rng(3), 8, 300)
    for lanes in (1, 2, 4, 8):
        dev = poseidon_cols.poseidon_stream_start(PF, 300, cuda)
        host = poseidon_cols.poseidon_stream_start(PF, 300, "cpu")
        for r0, first in ((0, True), (4, False)):
            dev = cuda_poseidon.poseidon_absorb(PF, CFG, u[r0:r0 + 4].to(cuda),
                                                4, dev, first, False, lanes)
            host = cuda_poseidon.poseidon_absorb(PF, CFG, u[r0:r0 + 4], 4,
                                                 host, first, False)
            assert torch.equal(dev.cpu(), host), (lanes, r0)


@pytest.mark.cuda
@pytest.mark.parametrize("zk", [False, True])
def test_poseidon_streaming_proof_on_cuda_equals_cpu(cuda, monkeypatch, zk):
    circ, outs, vars_ = generate_random_circuit(F, GATES, num_vars=NUM_VARS,
                                                seed=CIRCUIT_SEED)
    port = convert.circuit_from_reference(circ)
    kw = {"zk_seed": ZK_SEED} if zk else {}
    mt = LigeroMTPoseidonParams(PF)
    direct = LigeroCircuit(port, outs, lambda_=LAMBDA, zk=zk, device="cpu",
                           mt_params=mt)
    want = direct.prove(vars_, test_sponge(F), **kw).to_bytes(PF)
    dims = (direct.num_rows, direct.k, direct.n, len(direct.state.a_vals),
            direct.blind_t, direct.d2)
    budget = direct.backend.streaming_bytes(
        *dims, chunk_rows=ragged_chunk_rows(direct.num_rows - 3 * zk),
        poseidon=True)
    monkeypatch.setattr(TorchBackend, "memory_budget", lambda self: budget)
    lig = LigeroCircuit(port, outs, lambda_=LAMBDA, zk=zk, device=cuda,
                        mt_params=mt)
    assert lig.encode_mode == "streaming"
    before = cuda_poseidon.stream_launches.count
    got = lig.prove(vars_, test_sponge(F), **kw)
    assert cuda_poseidon.stream_launches.count > before
    assert got.to_bytes(PF) == want
    assert lig.verify(got, test_sponge(F))
