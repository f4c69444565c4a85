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
from ligero_tpu_torch.engine.backend import ESTIMATE_MARGIN, TorchBackend
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


# the BN254 2^18-gate synthetic instance (seed 0) of the card's batch
# paths: committed rows, k, n, nnz of A, b, d2 (zk; plain: 2052 rows, b = 0,
# d2 = 2k)
ZK_18 = (2055, 1024, 8192, 2362371, 468, 4096)


@pytest.mark.parametrize("zk", [False, True], ids=["plain", "zk"])
def test_mesh_batch_estimate_counts_the_commit_resident_set(zk):
    """``device_bytes`` term by term for a batch of 2 over two shards of
    one device, at the 2^18 instance's dimensions: the commit holds each
    shard's codewords and coefficients (and, without zk, its message rows,
    which the interleaved combination takes later; under zk the message
    and d2-wide row matrices are freed before it) beside two column blocks
    of the re-shard; the estimate is the largest phase, plus A's COO, with
    the margin.  Under zk the commit now dominates at 4.692 GiB, against
    5.984 while it counted the encode's matrices (the card's measured
    peak: 4.38 GiB)."""
    rows, k, n, nnz, b, d2 = ZK_18 if zk else (2052, 1024, 8192, 2362371,
                                                0, 2048)
    B, D, E = 2, 2, 4 * F.num_limbs
    be = ShardedBackend(F, ["cpu"] * D)
    data = rows - 3 if zk else rows
    h = -(-data // D)
    heights = [h, h + 3] if zk else [h, h]
    msg = [s * k * E for s in heights]
    u = [s * n * E for s in heights]
    coeffs = [s * (k + b) * E for s in heights]
    commit = (sum(B * (ui + ci) for ui, ci in zip(u, coeffs))
              + (0 if zk else sum(B * m for m in msg))
              + 2 * B * rows * (n // D) * E)
    phases = [be._direct_phases(s, k, n, b, d2, B) for s in heights]
    assert [p[4] for p in phases] == [
        B * (ui + ci) + (0 if zk else B * m)
        for ui, ci, m in zip(u, coeffs, msg)]
    enc = sum(p[0] for p in phases) + max(p[1] for p in phases)
    linear = be._linear_transients(data, k, nnz) + data * k * E
    later = sum(p[2] for p in phases) + max(
        sum(s * k * E for s in heights) + max(p[3] for p in phases), linear)
    want = int((max(enc, commit, later) + nnz * (E + 16)) * ESTIMATE_MARGIN)
    assert be.device_bytes(rows, k, n, nnz, b, d2, batch=B) == {"cpu": want}
    if zk:
        assert commit > max(enc, later)
        assert round(want / 2**30, 3) == 4.692
        # the encode's matrices, the message and d2-wide row matrices
        # included, are more than the commit holds
        assert sum(p[0] for p in phases) > sum(p[4] for p in phases)
        # within the single-proof estimates' 7-18 % above the card's peak
        assert 1.0 < want / (4.38 * 2**30) < 1.18
