"""Batches over a mesh of CPU devices: ``prove_batch`` / ``verify_batch``
through ``ShardedBackend(field, RowMesh(["cpu"] * D))``, B proofs in one
``ShardedRows`` of batch B (each block holds every proof's rows of the
block), so that a bulk step runs once a device for the batch.

Inputs are made from a seed with numpy; the tolerance is none (exact
integer arithmetic).  Batches of the default commitment (B = 3), zk (B =
2) and the Poseidon commitment (B = 2) equal sequential single-device
proofs and the JAX package's ``prove_batch`` byte for byte; honest and
tampered proofs get the verdicts of single calls; the batched steps equal
the single-device backend's; the estimates take B."""

import functools
import warnings

import numpy as np
import pytest
import torch

from ligero_tpu.engine.backend import Backend
from ligero_tpu.fields import BN254_FR
from ligero_tpu.ligero import LigeroCircuit as RefCircuit
from ligero_tpu.ligero.types import LigeroMTPoseidonParams as RefParams
from ligero_tpu.sponge import test_sponge
from ligero_tpu.synthetic import generate_random_circuit
from ligero_tpu_torch import LigeroCircuit, LigeroProof, convert
from ligero_tpu_torch.engine.backend import TorchBackend
from ligero_tpu_torch.fields import FIELDS as PORT_FIELDS
from ligero_tpu_torch.ligero.types import LigeroMTPoseidonParams
from ligero_tpu_torch.parallel import RowMesh, ShardedBackend, ShardedRows

# one intra-op thread: the workers of the suite share the host's cores
torch.set_num_threads(1)

F = PORT_FIELDS[BN254_FR.name]
# (gates, num_vars, circuit seed, lambda): 4m = 44 rows (47 under zk), which
# divide neither two nor three shards evenly once the mask rows come in
GATES, NUM_VARS, CIRCUIT_SEED, LAMBDA = 96, 4, 3, 10


def seeds(B: int) -> list[bytes]:
    return [bytes([17 * i + 1]) * 32 for i in range(B)]


@functools.lru_cache(maxsize=None)
def instance():
    """(circuit, outputs, three witnesses: the circuit's own, which
    satisfies it, then two with its first input raised by 1 and 2, whose
    proofs differ and fail)."""
    circ, outs, vars_ = generate_random_circuit(BN254_FR, GATES,
                                                num_vars=NUM_VARS,
                                                seed=CIRCUIT_SEED)
    (i, v), rest = vars_[0], vars_[1:]
    return circ, outs, [vars_] + [[(i, v + d)] + rest for d in (1, 2)]


def quiet(fn, *args, **kw):
    """``fn`` with the warning a failing witness raises silenced."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return fn(*args, **kw)


@functools.lru_cache(maxsize=None)
def reference(zk: bool, poseidon: bool, B: int):
    """The JAX package's ``prove_batch`` bytes and the port's sequential
    single-device proof bytes (under the Poseidon commitment, whose plain
    sponge is slow on the CPU, the JAX package's only: its ``prove_batch``
    equals its sequential proofs, ``tests/test_prove_batch.py``)."""
    circ, outs, witnesses = instance()
    witnesses = witnesses[:B]
    zk_seeds = seeds(B) if zk else None
    ref = RefCircuit(circ, outs, lambda_=LAMBDA, zk=zk,
                     backend=Backend(BN254_FR),
                     mt_params=RefParams(BN254_FR) if poseidon else None)
    want = [p.to_bytes(BN254_FR) for p in quiet(
        ref.prove_batch, witnesses, test_sponge(BN254_FR), zk_seeds=zk_seeds)]
    if poseidon:
        return want, want
    one = LigeroCircuit(convert.circuit_from_reference(circ), outs,
                        lambda_=LAMBDA, zk=zk, device="cpu")
    single = [quiet(one.prove, w, test_sponge(BN254_FR),
                    **({"zk_seed": zk_seeds[i]} if zk else {})).to_bytes(F)
              for i, w in enumerate(witnesses)]
    return want, single


# (zk, Poseidon, B, D)
CASES = [(False, False, 3, 2), (True, False, 2, 2), (False, True, 2, 2)]


@pytest.mark.parametrize("zk,poseidon,B,D", CASES, ids=[
    f"{'zk' if zk else 'plain'}{'-poseidon' if p else ''}-B{B}-D{D}"
    for zk, p, B, D in CASES])
def test_mesh_batch_equals_sequential_and_jax_package(zk, poseidon, B, D):
    circ, outs, witnesses = instance()
    want, single = reference(zk, poseidon, B)
    assert want == single
    lig = LigeroCircuit(convert.circuit_from_reference(circ), outs,
                        lambda_=LAMBDA, zk=zk,
                        backend=ShardedBackend(F, RowMesh(["cpu"] * D)),
                        mt_params=LigeroMTPoseidonParams(F) if poseidon
                        else None)
    assert lig._max_batch() == 3
    proofs = quiet(lig.prove_batch, witnesses[:B], test_sponge(BN254_FR),
                   zk_seeds=seeds(B) if zk else None)
    assert [p.to_bytes(F) for p in proofs] == want
    # honest, flipped byte, a failing witness's, honest from the JAX bytes
    # (under Poseidon, whose verifier hashes its paths on the host sponge,
    # the first two)
    flipped = bytearray(want[0])
    flipped[8 + 32 + 8] ^= 1
    mixed = [proofs[0], LigeroProof.from_bytes(bytes(flipped), F), proofs[1],
             LigeroProof.from_bytes(want[0], F)][:2 if poseidon else 4]
    got = lig.verify_batch(mixed, test_sponge(BN254_FR))
    assert got == [True, False, False, True][:len(mixed)]
    if not poseidon:
        assert got == [lig.verify(p, test_sponge(BN254_FR)) for p in mixed]


@pytest.mark.parametrize("D", [2, 3])
def test_mesh_batched_steps_equal_single_device(D):
    """The batch's row blocks, encode, commit, openings and interleaved
    combinations (one call a device for B = 3) against the single-device
    backend's batch forms; the zk blind of a batch against each proof's."""
    gen = np.random.default_rng(D)
    one, be = TorchBackend(F, "cpu"), ShardedBackend(F, ["cpu"] * D)
    B, rows, k, n = 3, 23, 8, 64                 # 23 rows divide neither D

    def rand(*shape):
        ints = [int.from_bytes(gen.bytes(40), "little") % F.p
                for _ in range(int(np.prod(shape)))]
        return F.ints_to_mont_limbs(ints).reshape(*shape, -1)

    msgs = [rand(rows, k) for _ in range(B)]
    sr = be.upload_messages(msgs)
    assert isinstance(sr, ShardedRows) and sr.batch == B
    assert sr.shape == (B * rows, k, F.num_limbs)
    stacked = torch.from_numpy(np.stack(msgs).astype(np.int32))
    assert torch.equal(be.gather_rows(sr), stacked.reshape(B * rows, k, -1))
    coeffs, u = one.rs_encode_batch(one.upload_messages(msgs), k, n)
    s_coeffs, s_u = be.rs_encode_batch(sr, k, n)
    assert len(s_coeffs) == B
    for b in range(B):
        assert torch.equal(be.gather_rows(s_coeffs[b]), coeffs[b])
    assert torch.equal(be.gather_rows(s_u), u)
    assert [blk.shape for blk in be.column_blocks(s_u, B)] == [
        (B, rows, c, F.num_limbs) for c in
        {2: [32, 32], 3: [22, 22, 20]}[D]]
    assert be.commit_columns_batch(s_u, B) == one.commit_columns_batch(u, B)
    idx = [[0, 5, 17], [63, 40, 1], [2, 2 + D, 60]]
    assert np.array_equal(be.gather_columns_batch(s_u, idx),
                          one.gather_columns_batch(u, idx))
    r = torch.from_numpy(rand(B, rows).astype(np.int32))
    want = one.row_combine_batch(r, one.upload_messages(msgs))
    assert torch.equal(be.row_combine_batch(r, sr), want)
    assert torch.equal(be.row_combine_batch(r, [sr.proof(b)
                                                for b in range(B)]), want)

    blind, d2, mask3s = 3, 32, [rand(3, 32) for _ in range(2)]
    zk_seeds = [bytes([b]) * 32 for b in range(2)]
    z_coeffs, z_rows = be.zk_blind_batch(be.upload_messages(msgs[:2]),
                                         zk_seeds, blind, d2, mask3s)
    assert z_rows.batch == 2 and z_rows.rows == rows + 3
    for b in range(2):
        c, committed = one.zk_blind_rows(msgs[b].astype(np.int32), zk_seeds[b],
                                         blind, d2, mask3s[b])
        assert torch.equal(be.gather_rows(z_coeffs[b]), c)
        assert torch.equal(be.gather_rows(z_rows.proof(b)), committed)


def test_mesh_batch_estimates_take_the_batch(monkeypatch):
    """``max_batch`` / ``max_verify_batch`` from the per-device estimates:
    budgets at the estimate of 2 proofs give parts of 2 (prover) and the
    verifier's likewise; a batch of 5 goes as 2, 2, 1."""
    circ, outs, witnesses = instance()
    be = ShardedBackend(F, ["cpu"] * 2)
    lig = LigeroCircuit(convert.circuit_from_reference(circ), outs,
                        lambda_=LAMBDA, backend=be)
    dims = (lig.num_rows, lig.k, lig.n, len(lig.state.a_vals))
    two = be.direct_bytes(*dims, batch=2)
    assert be.direct_bytes(*dims) < two < be.direct_bytes(*dims, batch=3)
    monkeypatch.setattr(TorchBackend, "memory_budget", lambda self: two)
    assert be.max_batch(*dims) == 2
    assert be.max_verify_batch(*dims) >= 2
    seen = []
    real = LigeroCircuit._prove_many

    def spy(self, group, sponges, zk_seeds):
        seen.append(len(group))
        return real(self, group, sponges, zk_seeds)

    monkeypatch.setattr(LigeroCircuit, "_prove_many", spy)
    proofs = lig.prove_batch(witnesses[:1] * 5, test_sponge(BN254_FR))
    assert seen == [2, 2, 1]
    assert len({p.to_bytes(F) for p in proofs}) == 1
    monkeypatch.setattr(TorchBackend, "memory_budget",
                        lambda self: be.verify_bytes(*dims, batch=2))
    assert be.max_verify_batch(*dims) == 2
