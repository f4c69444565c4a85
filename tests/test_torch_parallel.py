"""The row-sharded backend (``ligero_tpu_torch.parallel``) on meshes of CPU
devices: ``ShardedBackend(field, RowMesh(["cpu"] * D))``, the counterpart of
the JAX package's ``ShardedBackend`` over a virtual mesh
(``tests/test_parallel.py``).

Inputs are made from a seed with numpy; the tolerance is none (exact
integer arithmetic).  Proofs over D = 2 and 3 shards, in both fields,
plain and zk, under the default and the Poseidon commitment, equal the JAX
package's numpy-backend proofs and the port's single-device proofs byte for
byte; each sharded step (the leaves, row combinations, the linear and
quadratic products, openings, the zk blind) equals its single-device form;
the mesh's memory estimate adds up the shards of each physical device; the
Poseidon commitment past the mesh's direct mode raises.  Mesh streaming
and batches: ``tests/test_torch_mesh_streaming.py``,
``tests/test_torch_mesh_batch.py``."""

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
from ligero_tpu_torch.engine.backend import (ESTIMATE_MARGIN,
                                             DeviceMemoryError, TorchBackend)
from ligero_tpu_torch.fields import FIELDS as PORT_FIELDS
from ligero_tpu_torch.ligero.types import LigeroMTPoseidonParams
from ligero_tpu_torch.parallel import RowMesh, ShardedBackend, ShardedRows

# one intra-op thread: the workers of the suite share the host's cores
torch.set_num_threads(1)

ZK_SEED = bytes(range(32))
FIELDS = {"bn254": BN254_FR, "bls12_377": BLS12_377_FQ}
# (gates, num_vars, circuit seed, lambda): small enough for the zk blinding;
# 4m = 44 rows (47 under zk): over three shards the last block is padded
GATES, NUM_VARS, CIRCUIT_SEED, LAMBDA = 96, 4, 3, 10


def pf(field):
    return PORT_FIELDS[field.name]


def mesh_backend(field, D: int) -> ShardedBackend:
    return ShardedBackend(pf(field), RowMesh(["cpu"] * D))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def reference(name: str, zk: bool, poseidon: bool):
    """(circuit, outputs, witness, the JAX package's proof bytes, the
    port's single-device proof bytes)."""
    field = FIELDS[name]
    circ, outs, vars_ = generate_random_circuit(field, GATES,
                                                num_vars=NUM_VARS,
                                                seed=CIRCUIT_SEED)
    kw = {"zk_seed": ZK_SEED} if zk else {}
    ref = RefCircuit(circ, outs, lambda_=LAMBDA, zk=zk, backend=Backend(field),
                     mt_params=RefParams(field) if poseidon else None)
    want = ref.prove(vars_, test_sponge(field), **kw).to_bytes(field)
    one = LigeroCircuit(convert.circuit_from_reference(circ), outs,
                        lambda_=LAMBDA, zk=zk, device="cpu",
                        mt_params=(LigeroMTPoseidonParams(pf(field))
                                   if poseidon else None))
    single = one.prove(vars_, test_sponge(field), **kw).to_bytes(pf(field))
    return circ, outs, vars_, want, single


# (field, zk, D, poseidon): both fields, plain and zk, at D = 2 and 3; the
# Poseidon commitment (BN254 only) plain at D = 2 and zk at D = 3
PROOF_CASES = [(f, zk, D, False) for f in FIELDS for zk in (False, True)
               for D in (2, 3)] + [("bn254", False, 2, True),
                                   ("bn254", True, 3, True)]


@pytest.mark.parametrize(
    "name,zk,D,poseidon", PROOF_CASES,
    ids=[f"{f}-{'zk' if zk else 'plain'}-D{D}{'-poseidon' if p else ''}"
         for f, zk, D, p in PROOF_CASES])
def test_sharded_proof_bytes_equal_jax_package_and_single_device(
        name, zk, D, poseidon):
    field = FIELDS[name]
    circ, outs, vars_, want, single = reference(name, zk, poseidon)
    be = mesh_backend(field, D)
    lig = LigeroCircuit(convert.circuit_from_reference(circ), outs,
                        lambda_=LAMBDA, zk=zk, backend=be,
                        mt_params=(LigeroMTPoseidonParams(pf(field))
                                   if poseidon else None))
    assert lig.backend is be and lig.device == torch.device("cpu")
    assert lig.encode_mode == "direct"
    kw = {"zk_seed": ZK_SEED} if zk else {}
    proof = lig.prove(vars_, test_sponge(field), **kw)
    data = proof.to_bytes(pf(field))
    assert data == want
    assert data == single
    sp = test_sponge(field)
    assert lig.verify(proof, sp.clone())
    flipped = bytearray(data)
    flipped[8 + 32 + 8] ^= 1        # the first interleaved lc element
    assert not lig.verify(LigeroProof.from_bytes(bytes(flipped), pf(field)),
                          sp.clone())


def test_sharded_rejects_a_witness_that_fails_the_circuit():
    circ, outs, vars_, _, _ = reference("bn254", False, False)
    lig = LigeroCircuit(convert.circuit_from_reference(circ), outs,
                        lambda_=LAMBDA, backend=mesh_backend(BN254_FR, 3))
    bad_vars = vars_[:-1] + [(vars_[-1][0], vars_[-1][1] + 1)]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        bad = lig.prove(bad_vars, test_sponge(BN254_FR))
    assert not lig.verify(bad, test_sponge(BN254_FR))


# ---------------------------------------------------------------------------
# each sharded step against its single-device form
# ---------------------------------------------------------------------------

def rand_mont(field, gen, *shape) -> torch.Tensor:
    """Montgomery limbs of random elements (numpy seed)."""
    ints = [int.from_bytes(gen.bytes(56), "little") % field.p
            for _ in range(int(np.prod(shape)))]
    return torch.from_numpy(field.ints_to_mont_limbs(ints).reshape(
        *shape, -1).astype(np.int32))


@pytest.mark.parametrize("name", list(FIELDS))
@pytest.mark.parametrize("D", [2, 3])
def test_sharded_steps_equal_single_device(name, D):
    field = pf(FIELDS[name])
    gen = np.random.default_rng(D)
    one, be = TorchBackend(field, "cpu"), mesh_backend(FIELDS[name], D)
    rows, k, n, m = 23, 8, 64, 5                # 23 rows divide neither D
    msg = rand_mont(field, gen, rows, k)
    sr = be.row_matrix(msg)
    assert isinstance(sr, ShardedRows) and sr.rows == rows
    assert len({b.shape[0] for b in sr.blocks}) == 1
    assert not torch.cat([b[r:] for b, r in zip(sr.blocks, sr.real)]).any()
    assert torch.equal(be.gather_rows(sr), msg)

    coeffs, u = one.rs_encode_batch(msg[None], k, n)
    [s_coeffs], s_u = be.rs_encode_batch(sr, k, n)
    assert torch.equal(be.gather_rows(s_coeffs), coeffs[0])
    assert torch.equal(be.gather_rows(s_u), u)
    assert be.commit_columns_batch(s_u, 1) == one.commit_columns_batch(u, 1)
    idx = [[0, 5, 17, 63, 40]]
    assert np.array_equal(be.gather_columns_batch(s_u, idx),
                          one.gather_columns_batch(u, idx))

    r = rand_mont(field, gen, rows)
    assert torch.equal(be.row_combine(r, sr), one.row_combine(r, msg))
    assert torch.equal(be.row_combine_batch(r[None], [sr]),
                       one.row_combine_batch(r[None], msg[None]))
    r_rows = rand_mont(field, gen, rows, k)
    s_r = be.intt(be.row_matrix(r_rows), k)
    assert torch.equal(be.gather_rows(s_r), one.intt(r_rows, k))
    assert torch.equal(
        be.linear_combination_poly(s_coeffs, s_r, 2 * k),
        one.linear_combination_poly(coeffs[0], one.intt(r_rows, k), 2 * k))
    r_quad = rand_mont(field, gen, m)
    assert torch.equal(
        be.quadratic_combination_poly(s_coeffs, r_quad, 2 * k, m),
        one.quadratic_combination_poly(coeffs[0], r_quad, 2 * k, m))
    js = [1, 9, 33, 62]
    assert torch.equal(be.ntt_columns(s_r, n, js),
                       one.ntt_columns(one.intt(r_rows, k), n, js))


@pytest.mark.parametrize("D", [2, 3])
def test_sharded_zk_blind_equals_single_device(D):
    field = pf(BN254_FR)
    gen = np.random.default_rng(11)
    one, be = TorchBackend(field, "cpu"), mesh_backend(BN254_FR, D)
    rows, k, b, d2, n = 20, 8, 3, 32, 64
    msg = rand_mont(field, gen, rows, k)
    mask3 = rand_mont(field, gen, 3, d2)
    coeffs, committed = one.zk_blind_batch(msg[None], [ZK_SEED], b, d2,
                                           [mask3])
    [s_coeffs], s_rows = be.zk_blind_batch(be.upload_messages(
        [msg.numpy().astype(np.uint32)]), [ZK_SEED], b, d2, [mask3])
    assert torch.equal(be.gather_rows(s_coeffs), coeffs[0])
    assert s_rows.rows == rows + 3
    assert torch.equal(be.gather_rows(s_rows), committed)
    assert torch.equal(be.gather_rows(be.ntt_and_canon(s_rows, n)),
                       one.ntt_and_canon(committed, n))


def test_sharded_poseidon_leaves_equal_single_device():
    """The Poseidon sponge over each device's whole columns after the
    re-shard: the leaves of the whole matrix, in column order."""
    field = pf(BN254_FR)
    gen = np.random.default_rng(5)
    u = rand_mont(field, gen, 7, 6)             # any limbs below p
    mt = LigeroMTPoseidonParams(field)
    want = mt.device_col_digests(TorchBackend(field, "cpu"), u)
    for D in (2, 3, 4):
        be = mesh_backend(BN254_FR, D)
        blocks = list(be.column_blocks(be.row_matrix(u)))
        assert [blk.shape[2] for blk in blocks] == {
            2: [3, 3], 3: [2, 2, 2], 4: [2, 2, 2]}[D]
        assert mt.device_col_digests(be, be.row_matrix(u)) == want, D


# ---------------------------------------------------------------------------
# memory estimates and refusals
# ---------------------------------------------------------------------------

def test_mesh_estimate_adds_up_the_shards_of_a_device():
    """Shards on one physical device add up what they hold, their
    transients counted once (the controller runs them one after another);
    the controller carries A, the sampler and the sparse product once; each
    device the re-shard's column block.  So on one device the mesh's
    estimate lies above one device's (it holds the whole instance, and the
    r^T A rows before they are sharded) and within 5 % of it at the 2^20
    shapes, whatever D; a batch and the verifier's estimates grow with B."""
    field = pf(BN254_FR)
    one = TorchBackend(field, "cpu")
    for rows, b, d2 in ((4100, 0, 4096), (4103, 468, 8192)):
        shape = (rows, 2048, 16384, 9_443_331, b, d2)
        single = one.direct_bytes(*shape)
        for D in (2, 3):
            be = ShardedBackend(field, ["cpu"] * D)
            est = be.device_bytes(*shape)
            assert list(est) == ["cpu"]
            assert est["cpu"] == be.direct_bytes(*shape)
            assert single < est["cpu"] < 1.05 * single
            ver = be.device_bytes(*shape[:4], verifier=True)["cpu"]
            assert ver == be.verify_bytes(*shape[:4])
            assert one.verify_bytes(*shape[:4]) < ver < est["cpu"]
            assert be.direct_bytes(*shape, batch=2) > est["cpu"]
            assert be.verify_bytes(*shape[:4], batch=2) > ver


def test_mesh_refuses_streaming_batches_and_device_with_backend(monkeypatch):
    """What the mesh still refuses: a device and a backend together, a
    backend of another field, and the Poseidon commitment past direct
    mode.  A budget under the mesh's direct estimate now gives streaming
    mode, and batches run."""
    circ, outs, vars_, _, _ = reference("bn254", False, False)
    port = convert.circuit_from_reference(circ)
    be = mesh_backend(BN254_FR, 2)
    with pytest.raises(ValueError, match="not both"):
        LigeroCircuit(port, outs, lambda_=LAMBDA, device="cpu", backend=be)
    with pytest.raises(ValueError, match="backend for a"):
        LigeroCircuit(port, outs, lambda_=LAMBDA,
                      backend=mesh_backend(BLS12_377_FQ, 2))
    lig = LigeroCircuit(port, outs, lambda_=LAMBDA, backend=be)
    proof = lig.prove(vars_, test_sponge(BN254_FR))
    [again] = lig.prove_batch([vars_], test_sponge(BN254_FR))
    assert again.to_bytes(pf(BN254_FR)) == proof.to_bytes(pf(BN254_FR))
    assert lig.verify_batch([proof], test_sponge(BN254_FR)) == [True]
    dims = (lig.num_rows, lig.k, lig.n, len(lig.state.a_vals))
    need = be.direct_bytes(*dims)
    # a budget that one device's direct mode would meet, the mesh's not
    monkeypatch.setattr(TorchBackend, "memory_budget", lambda self: need - 1)
    assert TorchBackend(pf(BN254_FR), "cpu").direct_bytes(*dims) < need - 1
    streamed = LigeroCircuit(port, outs, lambda_=LAMBDA,
                             backend=mesh_backend(BN254_FR, 2))
    assert streamed.encode_mode == "streaming"
    with pytest.raises(ValueError, match="Poseidon commitment does not run "
                                         "in streaming mode over a mesh"):
        LigeroCircuit(port, outs, lambda_=LAMBDA,
                      backend=mesh_backend(BN254_FR, 2),
                      mt_params=LigeroMTPoseidonParams(pf(BN254_FR)))


def test_row_mesh_checks_its_devices():
    with pytest.raises(ValueError):
        RowMesh([])
    mesh = RowMesh(["cpu", "cpu", "cpu"])
    assert mesh.size == 3 and mesh.physical == [torch.device("cpu")]
    assert ShardedBackend(pf(BN254_FR), ["cpu", "cpu"]).D == 2


# ---------------------------------------------------------------------------
# CUDA twin: a mesh of shards on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("zk", [False, True])
def test_sharded_proof_on_cuda_equals_cpu(cuda, zk):
    """Two shards on the card (on two cards where there are two) against
    the port's single-device proof on the CPU."""
    field = pf(BN254_FR)
    circ, outs, vars_ = generate_random_circuit(BN254_FR, GATES,
                                                num_vars=NUM_VARS,
                                                seed=CIRCUIT_SEED)
    port = convert.circuit_from_reference(circ)
    kw = {"zk_seed": ZK_SEED} if zk else {}
    one = LigeroCircuit(port, outs, lambda_=LAMBDA, zk=zk, device="cpu")
    want = one.prove(vars_, test_sponge(BN254_FR), **kw).to_bytes(field)
    devices = ([f"cuda:{i}" for i in range(2)]
               if torch.cuda.device_count() >= 2 else ["cuda:0"] * 2)
    lig = LigeroCircuit(port, outs, lambda_=LAMBDA, zk=zk,
                        backend=ShardedBackend(field, devices))
    proof = lig.prove(vars_, test_sponge(BN254_FR), **kw)
    assert proof.to_bytes(field) == want
    assert lig.verify(proof, test_sponge(BN254_FR))
