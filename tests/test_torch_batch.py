"""Batched proving and verifying in the port (device="cpu": the batched
schedule on the kernels' plain versions) against the port's own sequential
calls and the JAX package's numpy golden path.  Proof bytes and verdicts
must be equal exactly; the batched backend steps against per-proof calls."""

import warnings

import numpy as np
import pytest
import torch

from ligero_tpu.engine.backend import Backend
from ligero_tpu.fields import BN254_FR as F
from ligero_tpu.ligero import LigeroCircuit as RefCircuit
from ligero_tpu.ligero import LigeroProof as RefProof
from ligero_tpu.sponge import test_sponge
from ligero_tpu.synthetic import generate_random_circuit
from ligero_tpu_torch import LigeroCircuit, LigeroProof, convert
from ligero_tpu_torch.engine import cuda_hash, cuda_lc, cuda_tree, hashops
from ligero_tpu_torch.engine.backend import TorchBackend
from ligero_tpu_torch.fields import BN254_FR as PF

# the suite runs in several worker processes that share the host's cores, and
# these tests run many small tensor ops: one intra-op thread each, or the
# workers' thread pools spin against each other
torch.set_num_threads(1)

ZK_SEEDS = [bytes([i + 1]) * 32 for i in range(5)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def build(zk: bool, device="cpu"):
    """(JAX-package instance, port instance, five witnesses: the honest one
    and four with another first input, which no longer satisfy the
    circuit)."""
    circ, outs, vars_ = generate_random_circuit(F, 96, num_vars=4, seed=3)
    ref = RefCircuit(circ, outs, lambda_=10, zk=zk, backend=Backend(F))
    port = LigeroCircuit(convert.circuit_from_reference(circ), outs,
                         lambda_=10, zk=zk, device=device)
    witnesses = [[(vars_[0][0], (vars_[0][1] + i) % F.p)] + vars_[1:]
                 for i in range(5)]
    return ref, port, witnesses


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "zk"])
def proved(request):
    """Both instances, the witnesses, and the sequential proofs' bytes of
    each package."""
    zk = request.param
    ref, port, witnesses = build(zk)
    sp = test_sponge(F)
    seeds = ZK_SEEDS if zk else [None] * 5
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        port_seq = [port.prove(w, sp.clone(), zk_seed=s).to_bytes(PF)
                    for w, s in zip(witnesses, seeds)]
        ref_seq = [ref.prove(w, sp.clone(), zk_seed=s).to_bytes(F)
                   for w, s in zip(witnesses, seeds)]
    return zk, ref, port, witnesses, port_seq, ref_seq


def prove_batch(port, witnesses, zk, count=None):
    count = len(witnesses) if count is None else count
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return port.prove_batch(witnesses[:count], test_sponge(F),
                                zk_seeds=ZK_SEEDS[:count] if zk else None)


def test_prove_batch_bytes_equal_sequential_and_jax_package(proved):
    zk, ref, port, witnesses, port_seq, ref_seq = proved
    assert port_seq == ref_seq
    got = [p.to_bytes(PF) for p in prove_batch(port, witnesses, zk)]
    assert got == port_seq
    sp = test_sponge(F)
    proofs = [LigeroProof.from_bytes(b, PF) for b in got]
    assert [port.verify(p, sp.clone()) for p in proofs] == [
        True, False, False, False, False]


def test_prove_batch_of_one_and_of_none(proved):
    zk, _, port, witnesses, port_seq, _ = proved
    assert port.prove_batch([], test_sponge(F)) == []
    one = prove_batch(port, witnesses, zk, count=1)
    assert [p.to_bytes(PF) for p in one] == port_seq[:1]


def test_prove_batch_in_parts_through_the_budget(proved, monkeypatch):
    """A budget that holds two proofs: parts of 2, 2 and 1, same bytes; one
    that holds a single proof: one at a time; one that holds them all: parts
    of ``MAX_BATCH`` at most."""
    zk, _, port, witnesses, port_seq, _ = proved
    be = port.backend
    shape = (port.num_rows, port.k, port.n, len(port.state.a_vals),
             port.blind_t, port.d2)
    sizes = []
    real = port._prove_many

    def recorded(assignments, sponges, seeds):
        sizes.append(len(assignments))
        return real(assignments, sponges, seeds)

    monkeypatch.setattr(port, "_prove_many", recorded)
    for budget, want in ((be.direct_bytes(*shape, batch=2), [2, 2, 1]),
                         (be.direct_bytes(*shape, batch=1), [1] * 5),
                         (be.direct_bytes(*shape, batch=5), [3, 2])):
        monkeypatch.setattr(be, "memory_budget", lambda: budget)
        assert be.max_batch(*shape) == want[0]
        sizes.clear()
        got = [p.to_bytes(PF) for p in prove_batch(port, witnesses, zk)]
        assert sizes == want and got == port_seq


def test_zk_batch_draws_fresh_seeds_and_checks_their_count():
    _, port, witnesses = build(zk=True)
    sp = test_sponge(F)
    a, b = port.prove_batch([witnesses[0]] * 2, sp)
    assert a.to_bytes(PF) != b.to_bytes(PF)
    assert port.verify(a, sp.clone()) and port.verify(b, sp.clone())
    with pytest.raises(ValueError, match="one zk seed per witness"):
        port.prove_batch(witnesses[:2], sp, zk_seeds=ZK_SEEDS[:1])


def tampered(proofs, field):
    """From two proofs of different transcripts, variants of the first: a
    flipped lc byte, a truncated column list (malformed), columns opened at
    the wrong places (the second proof's openings), an over-long q, a wrong
    root."""
    data = bytearray(proofs[0].to_bytes(field))
    data[8 + 32 + 8] ^= 1
    flipped = LigeroProof.from_bytes(bytes(data), field)
    short = LigeroProof.from_bytes(proofs[0].to_bytes(field), field)
    short.linear.columns = short.linear.columns[:-1]
    swapped = LigeroProof.from_bytes(proofs[0].to_bytes(field), field)
    swapped.linear.columns = proofs[1].linear.columns
    swapped.linear.paths = proofs[1].linear.paths
    long_q = LigeroProof.from_bytes(proofs[0].to_bytes(field), field)
    long_q.linear.polynomial = long_q.linear.polynomial + [1] * 10_000
    rooted = LigeroProof.from_bytes(proofs[0].to_bytes(field), field)
    rooted.u_root = bytes(32)
    return [flipped, short, swapped, long_q, rooted]


def test_verify_batch_verdicts_equal_sequential(proved):
    zk, ref, port, witnesses, port_seq, _ = proved
    sp = test_sponge(F)
    proofs = [LigeroProof.from_bytes(b, PF) for b in port_seq]
    batch = proofs + tampered(proofs[:2], PF) + [proofs[0]]
    want = [port.verify(p, sp.clone()) for p in batch]
    assert want == [True] + [False] * 9 + [True]
    assert port.verify_batch(batch, sp) == want
    assert [ref.verify(RefProof.from_bytes(p.to_bytes(PF), F), sp.clone())
            for p in batch] == want
    assert port.verify_batch([], sp) == []
    assert port.verify_batch(batch[:1], sp) == [True]
    assert port.verify_batch([batch[6]], sp) == [False]


def test_verify_batch_in_parts_and_all_dead(proved, monkeypatch):
    zk, _, port, _, port_seq, _ = proved
    sp = test_sponge(F)
    proofs = [LigeroProof.from_bytes(b, PF) for b in port_seq]
    dead = tampered(proofs[:2], PF)[1]
    assert port.verify_batch([dead, dead], sp) == [False, False]
    sizes = []
    real = port._verify_many

    def recorded(part, sponge):
        sizes.append(len(part))
        return real(part, sponge)

    monkeypatch.setattr(port, "_verify_many", recorded)
    monkeypatch.setattr(port.backend, "memory_budget", lambda: 1)
    assert port.verify_batch(proofs, sp) == [True] + [False] * 4
    assert sizes == [1, 1, 1, 1, 1]


def test_verify_batch_parts_follow_the_verifier_estimate(proved, monkeypatch):
    """verify_batch sizes its parts from ``TorchBackend.verify_bytes``:
    a budget that admits one proof's verifier live set gives parts of one,
    one that admits two gives parts of two; the verdicts are what
    sequential ``verify`` calls give."""
    zk, _, port, _, port_seq, _ = proved
    sp = test_sponge(F)
    proofs = [LigeroProof.from_bytes(b, PF) for b in port_seq]
    want = [port.verify(p, sp.clone()) for p in proofs]
    be = port.backend
    dims = (port.num_rows, port.k, port.n, len(port.state.a_vals))
    sizes = []
    real = port._verify_many

    def recorded(part, sponge):
        sizes.append(len(part))
        return real(part, sponge)

    monkeypatch.setattr(port, "_verify_many", recorded)
    for fits, parts in ((1, [1] * 5), (2, [2, 2, 1])):
        budget = be.verify_bytes(*dims, batch=fits)
        assert be.verify_bytes(*dims, batch=fits + 1) > budget
        monkeypatch.setattr(be, "memory_budget", lambda: budget)
        assert be.max_verify_batch(*dims) == fits
        sizes.clear()
        assert port.verify_batch(proofs, sp) == want
        assert sizes == parts


def test_verify_batch_reads_injected_codewords_only_after_the_openings(proved):
    """A proof opened at other columns than its transcript asks for is
    rejected by the openings: no r_i codewords are made for it or read."""
    _, _, port, _, port_seq, _ = proved
    sp = test_sponge(F)
    swapped = tampered([LigeroProof.from_bytes(b, PF)
                        for b in port_seq[:2]], PF)[2]
    read = []
    real = port.backend.row_combine

    def spying(r, mat):
        read.append(tuple(r.shape))
        return real(r, mat)

    port.backend.row_combine = spying
    try:
        assert port.verify_batch([swapped, swapped], sp) == [False, False]
    finally:
        del port.backend.row_combine
    # only the interleaved phase's (4m, L) challenge was combined: the
    # linear phase's (4m, t, L) codewords never were
    assert read and all(len(shape) == 2 for shape in read)


def test_verify_batch_stops_a_rejected_proof_where_verify_stops_it(
        proved, monkeypatch):
    """The r_i coefficient rows (the verifier's dearest step) are made only
    for proofs that passed everything before them, as in ``verify``."""
    _, _, port, _, port_seq, _ = proved
    sp = test_sponge(F)
    proofs = [LigeroProof.from_bytes(b, PF) for b in port_seq[:2]]
    flipped, short, swapped, long_q, rooted = tampered(proofs, PF)
    calls = []
    real = port._r_a_coeff_rows

    def counted(seed):
        calls.append(seed)
        return real(seed)

    monkeypatch.setattr(port, "_r_a_coeff_rows", counted)
    batch = [flipped, proofs[0], short, swapped, long_q, rooted]
    assert port.verify_batch(batch, sp) == [False, True] + [False] * 4
    assert len(calls) == 1
    calls.clear()
    assert [port.verify(pf, sp.clone()) for pf in batch] == [
        False, True] + [False] * 4
    assert len(calls) == 1


def test_warmup_proves_and_verifies_once(proved):
    _, _, port, _, _, _ = proved
    with warnings.catch_warnings():
        warnings.simplefilter("error")        # the garbage witness is silent
        stats = port.warmup()
    assert set(stats) == {"prove_s", "verify_s"}
    assert port._coo is not None


# ---------------------------------------------------------------------------
# the batched backend steps against per-proof calls and the JAX package
# ---------------------------------------------------------------------------

def rand_canon(rng, shape):
    ints = [int.from_bytes(rng.bytes(48), "little") % F.p
            for _ in range(int(np.prod(shape)))]
    return F.ints_to_limbs(ints).reshape(*shape, 16)


@pytest.mark.parametrize("rows", [4, 7])      # 7: an odd row count, as zk has
def test_commit_columns_batch_matches_per_proof_and_backend(rows):
    rng = np.random.default_rng(61)
    B, n = 3, 16
    u = rand_canon(rng, (B * rows, n))
    be, ref = TorchBackend(PF, "cpu"), Backend(F)
    got = be.commit_columns_batch(be.asarray(u), B)
    assert len(got) == B
    for b in range(B):
        part = u[b * rows:(b + 1) * rows]
        assert got[b] == be.commit_columns(be.asarray(part))
        assert got[b] == ref.commit_columns(part)
    leaves = cuda_hash.blake2s_columns(PF, be.asarray(u), B)
    assert leaves.shape == (B * n, 8)
    assert torch.equal(leaves[n:2 * n],
                       hashops.blake2s_columns_ref(be.asarray(u[rows:2 * rows])))
    with pytest.raises(ValueError, match="do not split"):
        cuda_hash.blake2s_columns(PF, be.asarray(u[:-1]), B)


def test_row_combine_batch_matches_per_proof_and_backend():
    rng = np.random.default_rng(67)
    B, rows, k = 3, 9, 8
    mats = F.ints_to_mont_limbs(
        [int.from_bytes(rng.bytes(48), "little") % F.p
         for _ in range(B * rows * k)]).reshape(B, rows, k, 16)
    r = F.ints_to_mont_limbs(
        [int.from_bytes(rng.bytes(48), "little") % F.p
         for _ in range(B * rows)]).reshape(B, rows, 16)
    be, ref = TorchBackend(PF, "cpu"), Backend(F)
    got = be.row_combine_batch(r, mats)
    assert got.shape == (B, k, 16) and got.dtype == torch.int32
    assert np.array_equal(be.to_numpy(got),
                          np.asarray(ref.row_combine_batch(r, mats)))
    for b in range(B):
        assert torch.equal(got[b], be.row_combine(r[b], mats[b]))


def test_gather_columns_batch_matches_per_proof_and_backend():
    rng = np.random.default_rng(71)
    B, rows, n = 3, 5, 32
    u = rand_canon(rng, (B * rows, n))
    idx = np.asarray([[0, 31, 7, 7], [1, 2, 3, 4], [30, 0, 15, 16]])
    be, ref = TorchBackend(PF, "cpu"), Backend(F)
    got = be.gather_columns_batch(be.asarray(u), idx)
    assert got.shape == (B, rows, 4, 16) and got.dtype == np.uint32
    assert np.array_equal(got, ref.gather_columns_batch(u, idx))
    for b in range(B):
        assert np.array_equal(got[b], be.gather_columns(
            be.asarray(u[b * rows:(b + 1) * rows]), idx[b]))


def test_forest_flat_is_tree_flat_per_tree():
    rng = np.random.default_rng(73)
    leaves = torch.from_numpy(rng.integers(-2**31, 2**31, (3, 16, 8)).astype(
        np.int32))
    got = cuda_tree.forest_flat(leaves)
    assert got.shape == (3, 8 * 31)
    for b in range(3):
        assert torch.equal(got[b], hashops.tree_flat(leaves[b]))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("rows,n", [(4, 16), (7, 33), (131, 200)])
def test_blake2s_batch_kernel_matches_plain(cuda, rows, n):
    rng = np.random.default_rng(79)
    u = torch.from_numpy(rng.integers(0, 1 << 16, (3 * rows, n, 16)).astype(
        np.int32))
    before = cuda_hash.launches.count
    got = cuda_hash.blake2s_columns(PF, u.to(cuda), 3)
    assert cuda_hash.launches.count == before + 1
    assert torch.equal(got.cpu(), cuda_hash.blake2s_columns_batch_ref(u, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,k", [(9, 8), (200, 130), (65, 1)])
def test_row_combine_batch_kernel_matches_plain(cuda, rows, k):
    rng = np.random.default_rng(83)
    mats = torch.from_numpy(F.ints_to_mont_limbs(
        [int.from_bytes(rng.bytes(48), "little") % F.p
         for _ in range(3 * rows * k)]).reshape(3, rows, k, 16).astype(np.int32))
    r = torch.from_numpy(F.ints_to_mont_limbs(
        [int.from_bytes(rng.bytes(48), "little") % F.p
         for _ in range(3 * rows)]).reshape(3, rows, 16).astype(np.int32))
    before = cuda_lc.launches.count
    got = cuda_lc.row_combine_batch(PF, r.to(cuda), mats.to(cuda))
    assert cuda_lc.launches.count == before + 1
    assert torch.equal(got.cpu(), cuda_lc.row_combine_batch_ref(PF, r, mats))
    with pytest.raises(ValueError):
        cuda_lc.row_combine_batch(PF, r[:2].to(cuda), mats.to(cuda))


@pytest.mark.cuda
def test_forest_on_the_card_matches_plain(cuda):
    rng = np.random.default_rng(89)
    for n in (2, 64, 4096):
        leaves = torch.from_numpy(rng.integers(-2**31, 2**31, (3, n, 8)).astype(
            np.int32))
        got = cuda_tree.forest_flat(leaves.to(cuda))
        for b in range(3):
            assert torch.equal(got[b].cpu(), hashops.tree_flat(leaves[b]))


@pytest.mark.cuda
@pytest.mark.parametrize("zk", [False, True], ids=["plain", "zk"])
def test_batch_on_the_card_equals_cpu(cuda, zk):
    _, on_cpu, witnesses = build(zk)
    _, on_card, _ = build(zk, device=cuda)
    want = [p.to_bytes(PF) for p in prove_batch(on_cpu, witnesses, zk, 3)]
    proofs = prove_batch(on_card, witnesses, zk, 3)
    assert [p.to_bytes(PF) for p in proofs] == want
    sp = test_sponge(F)
    batch = proofs + tampered(proofs[:2], PF)[:2]
    assert on_card.verify_batch(batch, sp) == [True, False, False, False, False]
