"""Streaming mode over a mesh of CPU devices: ``ShardedBackend(field,
RowMesh(["cpu"] * D))`` with a memory budget under the mesh's direct
estimate, the coefficient rows in chunks dealt over the devices (chunk i
on device i mod D, the JAX package's block-cyclic ``ShardedCoeffs``
layout), the commit re-sharding each re-encoded chunk row -> column into
the devices' streamed Blake2s states.

Inputs are made from a seed with numpy; the tolerance is none (exact
integer arithmetic).  Proofs over D = 2 and 3, plain and zk, both fields,
equal the JAX package's numpy-backend proofs and the port's single-device
proofs byte for byte, with chunkings whose last step is short; the streamed
leaves at odd row counts equal the JAX package's host column hashes; the
layout is the JAX package's ``_to_cyclic``; the Poseidon commitment is
refused there with ``ValueError``."""

import functools

import numpy as np
import pytest
import torch

from ligero_tpu.engine.backend import Backend
from ligero_tpu.fields import BLS12_377_FQ, BN254_FR
from ligero_tpu.hashes import column_hash
from ligero_tpu.ligero import LigeroCircuit as RefCircuit
from ligero_tpu.merkle import MerkleTree as RefTree
from ligero_tpu.parallel.sharded_backend import _from_cyclic, _to_cyclic
from ligero_tpu.sponge import test_sponge
from ligero_tpu.synthetic import generate_random_circuit
from ligero_tpu_torch import LigeroCircuit, LigeroProof, convert
from ligero_tpu_torch.engine import (cuda_hash, cuda_lc, cuda_mont, cuda_ntt,
                                     cuda_poseidon, cuda_tree)
from ligero_tpu_torch.engine.backend import (STREAM_ROW_QUANTUM,
                                             DeviceMemoryError, TorchBackend)
from ligero_tpu_torch.engine.devmatrix import (RowChunkedMatrix,
                                               StreamedCodewords)
from ligero_tpu_torch.fields import FIELDS as PORT_FIELDS
from ligero_tpu_torch.ligero.types import LigeroMTPoseidonParams
from ligero_tpu_torch.merkle import MerkleTree
from ligero_tpu_torch.parallel import RowMesh, ShardedBackend

# one intra-op thread: the workers of the suite share the host's cores
torch.set_num_threads(1)

ZK_SEED = bytes(range(32))
FIELDS = {"bn254": BN254_FR, "bls12_377": BLS12_377_FQ}
# (gates, num_vars, circuit seed, lambda): 4m = 44 data rows (47 under zk)
GATES, NUM_VARS, CIRCUIT_SEED, LAMBDA = 96, 4, 3, 10


def pf(field):
    return PORT_FIELDS[field.name]


def mesh_backend(field, D: int) -> ShardedBackend:
    return ShardedBackend(pf(field), RowMesh(["cpu"] * D))


def dims(lig):
    return (lig.num_rows, lig.k, lig.n, len(lig.state.a_vals), lig.blind_t,
            lig.d2)


def force_mesh_streaming(monkeypatch, direct):
    """A budget under the mesh's direct estimate of ``direct``'s instance,
    at its streaming estimate for the largest chunk (a multiple of the row
    quantum, each device's rows a step at most) that leaves a short last
    chunk and more chunks than devices: a last step short of the D chunks
    of the others.  Returns the chunk rows."""
    be, q = direct.backend, STREAM_ROW_QUANTUM
    data = direct.num_rows - (3 if direct.zk else 0)
    for cr in range(-(-data // (q * be.D)) * q, 0, -q):
        budget = be.streaming_bytes(*dims(direct), chunk_rows=cr)
        if (data % cr and -(-data // cr) > be.D
                and budget < be.direct_bytes(*dims(direct))):
            monkeypatch.setattr(TorchBackend, "memory_budget",
                                lambda self: budget)
            return cr
    raise AssertionError(f"{data} rows cannot be cut so over {be.D}")


@functools.lru_cache(maxsize=None)
def reference(name: str, zk: bool):
    """(circuit, outputs, witness, the JAX package's proof bytes, the
    port's single-device proof bytes)."""
    field = FIELDS[name]
    circ, outs, vars_ = generate_random_circuit(field, GATES,
                                                num_vars=NUM_VARS,
                                                seed=CIRCUIT_SEED)
    kw = {"zk_seed": ZK_SEED} if zk else {}
    ref = RefCircuit(circ, outs, lambda_=LAMBDA, zk=zk, backend=Backend(field))
    want = ref.prove(vars_, test_sponge(field), **kw).to_bytes(field)
    one = LigeroCircuit(convert.circuit_from_reference(circ), outs,
                        lambda_=LAMBDA, zk=zk, device="cpu")
    single = one.prove(vars_, test_sponge(field), **kw).to_bytes(pf(field))
    return circ, outs, vars_, want, single


# (field, zk, D): BN254 plain and zk over two and three shards, BLS12-377 at
# one small size plain over two and zk over three
CASES = [("bn254", zk, D) for zk in (False, True) for D in (2, 3)] + [
    ("bls12_377", False, 2), ("bls12_377", True, 3)]


@pytest.mark.parametrize("name,zk,D", CASES, ids=[
    f"{f}-{'zk' if zk else 'plain'}-D{D}" for f, zk, D in CASES])
def test_mesh_streaming_proof_bytes_equal_jax_package_and_single_device(
        monkeypatch, name, zk, D):
    field = FIELDS[name]
    circ, outs, vars_, want, single = reference(name, zk)
    port = convert.circuit_from_reference(circ)
    direct = LigeroCircuit(port, outs, lambda_=LAMBDA, zk=zk,
                           backend=mesh_backend(field, D))
    assert direct.encode_mode == "direct"
    cr = force_mesh_streaming(monkeypatch, direct)
    be = mesh_backend(field, D)
    lig = LigeroCircuit(port, outs, lambda_=LAMBDA, zk=zk, backend=be)
    assert (lig.encode_mode, lig.chunk_rows) == ("streaming", cr)
    kw = {"zk_seed": ZK_SEED} if zk else {}
    proof = lig.prove(vars_, test_sponge(field), **kw)
    data = proof.to_bytes(pf(field))
    assert data == want
    assert data == single
    sp = test_sponge(field)
    assert lig.verify(proof, sp.clone())
    flipped = bytearray(data)
    flipped[8 + 32 + 8] ^= 1        # the first interleaved lc element
    bad = LigeroProof.from_bytes(bytes(flipped), pf(field))
    assert not lig.verify(bad, sp.clone())
    assert lig.verify_batch([bad, proof], sp) == [False, True]


@pytest.mark.parametrize("name", list(FIELDS))
@pytest.mark.parametrize("D", [2, 3])
def test_mesh_streamed_leaves_equal_host_column_hashes_at_odd_rows(name, D):
    """4m data rows in chunks with a short last step, then the three zk
    mask rows (an odd total): the mesh's streaming commit gives the JAX
    package's host Blake2s leaves and Merkle root."""
    field, port_field = FIELDS[name], pf(FIELDS[name])
    gen = np.random.default_rng(D)
    be, one = mesh_backend(field, D), TorchBackend(port_field, "cpu")
    data, cr, w, n = 20, 8, 6, 16           # chunks of 8, 8, 4 (+ 3 rows)
    ints = [int.from_bytes(gen.bytes(56), "little") % field.p
            for _ in range((data + 3) * w)]
    coeffs = torch.from_numpy(port_field.ints_to_mont_limbs(ints).astype(
        np.int32).reshape(data + 3, w, -1))
    chunks = [be.place_chunk(i, torch.cat([
        coeffs[r0:min(r0 + cr, data)],
        coeffs.new_zeros((max(0, r0 + cr - data), w, port_field.num_limbs))]))
        for i, r0 in enumerate(range(0, data, cr))]
    sc = StreamedCodewords(RowChunkedMatrix(chunks, data, cr), n,
                           coeffs[data:])
    assert sc.rows % 2 == 1
    leaves, levels = be.commit_columns_streaming(sc)
    u = one.ntt_and_canon(coeffs, n).numpy().view(np.uint32)
    want = [column_hash(field, field.limbs_to_ints(u[:, j])) for j in range(n)]
    assert leaves == want
    assert MerkleTree(leaves, inner_levels=levels).root == RefTree(want).root
    assert (leaves, levels) == one.commit_columns(one.ntt_and_canon(coeffs, n))
    # the openings of the same streamed matrix
    idx = [[3, 0, 15, 8]]
    assert np.array_equal(be.gather_columns_batch(sc, idx)[0],
                          u[:, idx[0]])


@pytest.mark.parametrize("D", [2, 3])
def test_mesh_chunks_take_the_jax_cyclic_layout(D):
    """Device d's coefficient chunks (16-bit limbs, as the JAX package's
    uint16 ``ShardedCoeffs``), in order, are row block d of the JAX
    package's ``_to_cyclic``, and ``_from_cyclic`` gives the rows back."""
    field = pf(BN254_FR)
    gen = np.random.default_rng(7)
    be, one = mesh_backend(BN254_FR, D), TorchBackend(field, "cpu")
    rows, k, cr = 30, 8, 4
    ints = [int.from_bytes(gen.bytes(40), "little") % field.p
            for _ in range(rows * k)]
    msg = field.ints_to_mont_limbs(ints).reshape(rows, k, -1).astype(
        np.uint16)
    rcm = be.encode_chunks(msg, k, cr)
    assert [c.device for c in rcm.chunks] == [
        be.mesh.devices[i % D] for i in range(len(rcm.chunks))]
    whole = one.intt(msg.astype(np.uint32), k).numpy().astype(np.uint16)
    shares = [torch.cat(rcm.chunks[d::D]).numpy().view(np.uint16)
              for d in range(D)]
    cyc = _to_cyclic(whole, cr, D)
    for d in range(D):
        assert np.array_equal(shares[d], cyc[d][:len(shares[d])])
        assert not cyc[d][len(shares[d]):].any()
    padded = np.stack([np.concatenate([s, np.zeros(
        (cyc.shape[1] - len(s),) + s.shape[1:], s.dtype)]) for s in shares])
    assert np.array_equal(_from_cyclic(padded, rows, cr, D), whole)


def refuse_poseidon(monkeypatch, devices):
    """Poseidon over ``devices`` under a budget below the mesh's direct
    estimate: the constructor (which compiles and launches nothing)
    raises; the default commitment takes streaming mode there."""
    circ, outs, _, _, _ = reference("bn254", False)
    port = convert.circuit_from_reference(circ)
    mt = LigeroMTPoseidonParams(pf(BN254_FR))
    be = ShardedBackend(pf(BN254_FR), devices)
    direct = LigeroCircuit(port, outs, lambda_=LAMBDA, mt_params=mt,
                           backend=be)
    assert direct.encode_mode == "direct"
    need = be.direct_bytes(*dims(direct))
    monkeypatch.setattr(TorchBackend, "memory_budget", lambda self: need - 1)
    with pytest.raises(ValueError, match="Poseidon commitment does not run "
                                         "in streaming mode over a mesh"):
        LigeroCircuit(port, outs, lambda_=LAMBDA, mt_params=mt, backend=be)
    with pytest.raises(ValueError, match="Poseidon"):
        be.streaming_bytes(*dims(direct), poseidon=True)
    lig = LigeroCircuit(port, outs, lambda_=LAMBDA, backend=be)
    assert lig.encode_mode == "streaming"


def test_mesh_refuses_poseidon_in_streaming_mode(monkeypatch):
    refuse_poseidon(monkeypatch, ["cpu"] * 2)


@pytest.mark.cuda
def test_mesh_refuses_poseidon_in_streaming_mode_before_a_launch(
        monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    counters = [cuda_ntt.launches, cuda_mont.launches, cuda_hash.launches,
                cuda_hash.stream_launches, cuda_lc.launches,
                cuda_tree.launches, cuda_poseidon.launches,
                cuda_poseidon.stream_launches]
    before = [c.count for c in counters]
    refuse_poseidon(monkeypatch, ["cuda:0"] * 2)
    assert [c.count for c in counters] == before


def test_mesh_mode_choice_and_streaming_estimates(monkeypatch):
    """Streaming under the mesh's direct estimate, chunks no larger than a
    device's rows a step; neither mode: DeviceMemoryError naming both.  On
    one physical device the streaming estimate holds every chunk, as one
    device's does, plus the commit's column slice and states."""
    field = pf(BN254_FR)
    one = TorchBackend(field, "cpu")
    shape = (4100, 2048, 16384, 9_443_331)
    for D in (2, 3):
        be = ShardedBackend(field, ["cpu"] * D)
        direct = be.direct_bytes(*shape)
        monkeypatch.setattr(TorchBackend, "memory_budget",
                            lambda self: direct - 1)
        mode, cr = be.encode_mode(*shape)
        assert mode == "streaming" and cr == 1024
        est = be.stream_device_bytes(*shape, chunk_rows=cr)
        assert list(est) == ["cpu"]
        assert est["cpu"] >= one.streaming_bytes(*shape, chunk_rows=cr)
        assert est["cpu"] < 1.05 * one.streaming_bytes(*shape, chunk_rows=cr)
        ver = be.streaming_verify_bytes(*shape, chunk_rows=cr, batch=2)
        assert ver == one.streaming_verify_bytes(*shape, chunk_rows=cr,
                                                 batch=2)
        least = be.streaming_bytes(*shape, chunk_rows=STREAM_ROW_QUANTUM)
        monkeypatch.setattr(TorchBackend, "memory_budget",
                            lambda self: least - 1)
        with pytest.raises(DeviceMemoryError, match="streaming mode"):
            be.encode_mode(*shape)
    # a small instance: the chunk stops at each device's rows a step
    be = ShardedBackend(field, ["cpu"] * 3)
    monkeypatch.setattr(TorchBackend, "memory_budget", lambda self: 1 << 62)
    assert be.stream_chunk_rows(44, 8, 64, 100) == 16
