"""The Poseidon Merkle-tree commitment in the port (``LigeroMTPoseidonParams``)
against the JAX package: column digests against its host ``col_hash``, tree
levels against its ``create_merkle_tree``, whole proofs against its
``LigeroCircuit(..., mt_params=...)`` on the numpy golden path.  Everything
is exact (tolerance 0): bytes and limbs must be equal.  On the CPU the
port's commitment takes the plain version (``engine/poseidon_cols.py``);
the CUDA twins, marked ``cuda``, hold the kernel against it on a card."""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from ligero_tpu.circuit import ArithmeticCircuit as RefArithmetic
from ligero_tpu.engine.backend import Backend
from ligero_tpu.fields import BLS12_377_FQ as FQ
from ligero_tpu.fields import BN254_FR as F
from ligero_tpu.ligero import LigeroCircuit as RefCircuit
from ligero_tpu.ligero import LigeroProof as RefProof
from ligero_tpu.ligero.types import LigeroMTPoseidonParams as RefParams
from ligero_tpu.merkle import create_merkle_tree
from ligero_tpu.sponge import test_sponge
from ligero_tpu.synthetic import generate_random_circuit
from ligero_tpu_torch import LigeroCircuit, LigeroProof, convert
from ligero_tpu_torch.engine import cuda_poseidon, fieldops, poseidon_cols
from ligero_tpu_torch.engine.backend import TorchBackend
from ligero_tpu_torch.fields import BLS12_377_FQ as PFQ
from ligero_tpu_torch.fields import BN254_FR as PF
from ligero_tpu_torch.fields import FIELDS as PORT_FIELDS
from ligero_tpu_torch.ligero.types import LigeroMTPoseidonParams
from ligero_tpu_torch.merkle import MerkleTree
from ligero_tpu_torch.sponge import PoseidonSponge, test_poseidon_config

from fixtures import generate_lemniscate_circuit

# the suite runs in several worker processes that share the host's cores, and
# these tests run many small tensor ops: one intra-op thread each, or the
# workers' thread pools spin against each other
torch.set_num_threads(1)

CFG = test_poseidon_config(PF)
WITNESS, BAD_WITNESS = [(1, 8), (2, 4)], [(1, 8), (2, 5)]
ZK_SEED = bytes(range(32))
CPU = TorchBackend(PF, "cpu")


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


def host_digests(ints):
    mt = RefParams(F)
    return [mt.col_hash(F, [row[j] for row in ints])
            for j in range(len(ints[0]))]


# ---------------------------------------------------------------------------
# digests and levels against the JAX package's host hashers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows", [2, 6, 7, 13, 64])
def test_plain_digests_match_jax_host_col_hash(rows):
    """Odd heights leave the tail element that zk columns (4m + 3) have."""
    ints, limbs = rand_matrix(np.random.default_rng(40 + rows), rows, 8)
    got = poseidon_cols.poseidon_columns_plain(PF, CFG, limbs)
    assert got.shape == (8, PF.num_limbs) and got.dtype == torch.int32
    assert poseidon_cols.digests_to_bytes(got) == host_digests(ints)


@pytest.mark.parametrize("rows", [5, 17])
def test_plain_digests_take_each_configs_round_constants(rows):
    """The round constants are the config's own: under the test config
    with every constant + 1 the digests are that config's host sponge's
    (17 rows take the host sponge's native absorb, 5 its Python one), and
    the test config's digests stay its own after it."""
    ints, limbs = rand_matrix(np.random.default_rng(90 + rows), rows, 4)
    other = dataclasses.replace(
        CFG, ark=[[(c + 1) % F.p for c in row] for row in CFG.ark])

    def host(cfg):
        out = []
        for j in range(4):
            sp = PoseidonSponge(cfg)
            sp.absorb_field_elems([row[j] for row in ints])
            out.append(sp.squeeze_native_field_elements(1)[0].to_bytes(
                32, "little"))
        return out

    assert host(CFG) == host_digests(ints) != host(other)
    for cfg in (CFG, other, CFG):
        assert poseidon_cols.digests_to_bytes(
            poseidon_cols.poseidon_columns_plain(PF, cfg, limbs)) == host(cfg)
    with pytest.raises(ValueError, match="test sponge"):
        poseidon_cols.check_config(
            PF, dataclasses.replace(CFG, ark=CFG.ark[:-1]))


def test_params_route_on_the_cpu_is_the_plain_version():
    ints, limbs = rand_matrix(np.random.default_rng(3), 3, 5)
    mt = LigeroMTPoseidonParams(PF)
    want = host_digests(ints)
    assert mt.device_col_digests(CPU, limbs) == want
    assert mt.device_col_digests(CPU, limbs.numpy()) == want
    assert [mt.col_hash(PF, [row[j] for row in ints]) for j in range(5)] == want
    # a tensor that is not on the CPU never takes the plain version
    with pytest.raises(ValueError, match="CUDA"):
        poseidon_cols.poseidon_columns(PF, CFG, limbs.to("meta"))


@pytest.mark.parametrize("n", [8, 64])
def test_plain_tree_levels_match_jax_create_merkle_tree(n):
    ref = RefParams(F)
    leaves = [ref.col_hash(F, [i, (i * i + 7) % F.p]) for i in range(n)]
    tree = create_merkle_tree(leaves, two_to_one=ref.two_to_one)
    mt = LigeroMTPoseidonParams(PF)
    levels = mt.device_tree_levels(CPU, leaves)
    assert levels == tree.levels
    port_tree = MerkleTree(leaves, inner_levels=levels)
    for i in (0, n - 1, n // 2 + 1):
        path = port_tree.generate_proof(i)
        assert path.verify(tree.root, leaves[i], two_to_one=mt.two_to_one)
    with pytest.raises(ValueError, match="power of two"):
        poseidon_cols.tree_levels(PF, CFG, torch.zeros(6, 16, dtype=torch.int32))


@pytest.mark.parametrize("fname", ["bn254_fr", "bls12_377_fq"])
def test_vector_field_ops_equal_the_limb_loops(fname):
    """``mont_mul_vec`` / ``add_vec`` (the plain Poseidon's products and
    sums) against ``mont_mul`` / ``add``: random operands, the extremes
    (0, 1, p - 1, and R - 1 as the first factor), both fields."""
    field = PORT_FIELDS[fname]
    L, p = field.num_limbs, field.p
    rng = np.random.default_rng(11)
    reduced = [int.from_bytes(rng.bytes(60), "little") % p for _ in range(400)]
    reduced += [0, 1, p - 1, p - 2, (p - 1) // 2] * 8
    wide = [int.from_bytes(rng.bytes(60), "little") % (1 << (16 * L))
            for _ in range(len(reduced) - 40)] + [(1 << (16 * L)) - 1] * 40

    def limbs(xs):
        return torch.from_numpy(field.ints_to_limbs(xs).astype(np.int32))

    a, b, c = limbs(wide), limbs(reduced), limbs(reduced[::-1])
    assert torch.equal(fieldops.mont_mul_vec(field, a, b),
                       fieldops.mont_mul(field, a, b))
    assert torch.equal(fieldops.mont_mul_vec(field, b[:7], b[3]),
                       fieldops.mont_mul(field, b[:7], b[3]))
    assert torch.equal(fieldops.add_vec(field, b, c), fieldops.add(field, b, c))
    assert torch.equal(fieldops.add_vec(field, b, b), fieldops.add(field, b, b))


def test_normalize_resolves_carry_ripples():
    """Columns left at 2^16 after the carry passes ripple through 0xFFFF
    columns in one step; a carry out of the top column is dropped."""
    cols = torch.tensor([[0x10000, 0xFFFF, 0xFFFF, 5, 0x10000, 0xFFFF],
                         [0xFFFF, 0x10000, 3, 0xFFFF, 0xFFFF, 0xFFFF],
                         [7 << 16 | 9, 0xFFFF, 0, 0, 0, 0]])
    got = fieldops._normalize(cols.clone(), 20)
    for row, out in zip(cols.tolist(), got.tolist()):
        value = sum(v << (16 * i) for i, v in enumerate(row)) % (1 << 96)
        assert out == [(value >> (16 * i)) & 0xFFFF for i in range(6)]


# ---------------------------------------------------------------------------
# whole proofs against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def lemniscate():
    """JAX-package and port instances of the lemniscate fixture under the
    Poseidon params, and the port's honest and bad-witness proofs."""
    circ = generate_lemniscate_circuit()
    ref = RefCircuit(circ, [circ.last()], backend=Backend(F),
                     mt_params=RefParams(F))
    port = LigeroCircuit(convert.circuit_from_reference(circ), [circ.last()],
                         device="cpu", mt_params=LigeroMTPoseidonParams(PF))
    sp = test_sponge(F)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")          # the bad witness, by design
        proofs = [port.prove(w, sp.clone()) for w in (WITNESS, BAD_WITNESS)]
    return circ, ref, port, proofs


def test_lemniscate_proof_bytes_equal_jax_package(lemniscate):
    _, ref, port, (proof, _) = lemniscate
    sp = test_sponge(F)
    data = proof.to_bytes(PF)
    assert data == ref.prove(WITNESS, sp.clone()).to_bytes(F)
    assert port.verify(proof, sp.clone())
    assert ref.verify(RefProof.from_bytes(data, F), sp.clone())


def test_lemniscate_zk_proof_bytes_equal_jax_package():
    """zk columns are 4m + 3 high: the odd tail goes through the prover's
    commit and the verifier's leaves (same zk_seed in both packages; the
    fixture needs a reduced lambda and a lower rate to fit the blinding)."""
    circ = generate_lemniscate_circuit()
    kw = dict(lambda_=5, rate_inv=16, zk=True)
    ref = RefCircuit(circ, [circ.last()], backend=Backend(F),
                     mt_params=RefParams(F), **kw)
    port = LigeroCircuit(convert.circuit_from_reference(circ), [circ.last()],
                         device="cpu", mt_params=LigeroMTPoseidonParams(PF),
                         **kw)
    assert port.num_rows % 2 == 1
    sp = test_sponge(F)
    proof = port.prove(WITNESS, sp.clone(), zk_seed=ZK_SEED)
    want = ref.prove(WITNESS, sp.clone(), zk_seed=ZK_SEED).to_bytes(F)
    assert proof.to_bytes(PF) == want
    assert port.verify(proof, sp.clone())


def test_synthetic_2e6_proof_bytes_equal_jax_package():
    circ, outs, vars_ = generate_random_circuit(F, 1 << 6, num_vars=16, seed=6)
    ref = RefCircuit(circ, outs, backend=Backend(F), mt_params=RefParams(F))
    port = LigeroCircuit(convert.circuit_from_reference(circ), outs,
                         device="cpu", mt_params=LigeroMTPoseidonParams(PF))
    sp = test_sponge(F)
    assert (port.prove(vars_, sp.clone()).to_bytes(PF)
            == ref.prove(vars_, sp.clone()).to_bytes(F))


def tampered_column(proof):
    bad = LigeroProof.from_bytes(proof.to_bytes(PF), PF)
    bad.interleaved.columns[0][0] = (bad.interleaved.columns[0][0] + 1) % PF.p
    return bad


def test_poseidon_tampered_column_rejected(lemniscate):
    """The verifier recomputes the opened columns' Poseidon leaves: one
    changed element breaks its Merkle path."""
    _, ref, port, (proof, _) = lemniscate
    bad = tampered_column(proof)
    assert not port.verify(bad, test_sponge(F))
    assert not ref.verify(RefProof.from_bytes(bad.to_bytes(PF), F),
                          test_sponge(F))


def test_poseidon_bad_witness_rejected(lemniscate):
    _, _, port, (_, bad) = lemniscate
    assert not port.verify(bad, test_sponge(F))


def test_poseidon_params_change_the_transcript(lemniscate):
    """A proof committed under the default params does not verify under the
    Poseidon params, nor the other way round: the roots, and so every
    challenge, differ."""
    circ, _, port, (proof, _) = lemniscate
    default = LigeroCircuit(convert.circuit_from_reference(circ), [circ.last()],
                            device="cpu")
    sp = test_sponge(F)
    other = default.prove(WITNESS, sp.clone())
    assert other.u_root != proof.u_root
    assert default.verify(other, sp.clone())
    assert not port.verify(other, sp.clone())
    assert not default.verify(proof, sp.clone())


def test_poseidon_prove_batch_equals_sequential(lemniscate):
    _, _, port, proofs = lemniscate
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = port.prove_batch([WITNESS, BAD_WITNESS], test_sponge(F))
    assert [p.to_bytes(PF) for p in got] == [p.to_bytes(PF) for p in proofs]


def test_poseidon_verify_batch_verdicts(lemniscate, monkeypatch):
    """verify_batch gives what verify gives one by one (honest: True, the
    bad witness and the tampered column: False, as the tests above show),
    with the opened columns of all live proofs in one digest call."""
    _, _, port, (proof, bad) = lemniscate
    calls = []
    real = LigeroMTPoseidonParams.device_col_digests

    def counted(self, backend, cols):
        calls.append(tuple(cols.shape))
        return real(self, backend, cols)

    monkeypatch.setattr(LigeroMTPoseidonParams, "device_col_digests", counted)
    batch = [proof, bad, tampered_column(proof)]
    assert port.verify_batch(batch, test_sponge(F)) == [True, False, False]
    assert calls == [(port.num_rows, 3 * 3 * port.t, PF.num_limbs)]


@pytest.mark.parametrize("extra", [1, -1], ids=["t+1", "t-1"])
def test_column_count_checked_before_any_digest(lemniscate, monkeypatch,
                                                 extra):
    """A proof whose opened set holds other than t columns is refused by
    the structural check, by verify and verify_batch alike: none of its
    columns reaches the digest call."""
    _, _, port, (proof, _) = lemniscate
    calls = []
    monkeypatch.setattr(LigeroMTPoseidonParams, "device_col_digests",
                        lambda self, backend, cols: calls.append(cols.shape))
    bad = LigeroProof.from_bytes(proof.to_bytes(PF), PF)
    if extra > 0:
        bad.linear.columns.append(bad.linear.columns[0])
        bad.linear.paths.append(bad.linear.paths[0])
    else:
        del bad.linear.columns[-1], bad.linear.paths[-1]
    assert not port.verify(bad, test_sponge(F))
    assert port.verify_batch([bad, bad], test_sponge(F)) == [False, False]
    assert calls == []


def test_bls12_377_poseidon_refused_by_both_packages():
    """Poseidon digests are 32-byte elements: a BLS12-377 Fq element does
    not fit.  The JAX package fails at ``to_bytes(32)`` with OverflowError;
    the port refuses with ValueError before any launch."""
    c = RefArithmetic(FQ)
    x = c.new_variable_with_label("x")
    c.add(c.pow(x, 3), c.constant(-26))
    ref = RefCircuit(c, [c.last()], backend=Backend(FQ), mt_params=RefParams(FQ))
    with pytest.raises(OverflowError):
        ref.prove_with_labels([("x", 3)], test_sponge(FQ))
    with pytest.raises(ValueError, match="32-byte"):
        LigeroCircuit(convert.circuit_from_reference(c), [c.last()],
                      device="cpu", mt_params=LigeroMTPoseidonParams(PFQ))
    mt = LigeroMTPoseidonParams(PFQ)
    zeros = torch.zeros((2, 3, PFQ.num_limbs), dtype=torch.int32)
    with pytest.raises(ValueError, match="32-byte"):
        mt.device_col_digests(TorchBackend(PFQ, "cpu"), zeros)
    with pytest.raises(ValueError, match="over a bn254_fr backend"):
        mt.device_col_digests(CPU, zeros)


# ---------------------------------------------------------------------------
# CUDA twins: the kernel against its plain version on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("rows,n", [(1, 5), (2, 130), (7, 300), (64, 257)])
def test_poseidon_kernel_matches_plain(cuda, rows, n):
    _, limbs = rand_matrix(np.random.default_rng(rows), rows, n)
    got = cuda_poseidon.poseidon_columns(PF, CFG, limbs.to(cuda))
    assert torch.equal(got.cpu(), poseidon_cols.poseidon_columns_plain(
        PF, CFG, limbs))


@pytest.mark.cuda
def test_poseidon_kernel_takes_each_configs_round_constants(cuda):
    """The kernel's constants are cached by value: a second config's
    launch uses its own, and the first config's after it uses the first's."""
    _, limbs = rand_matrix(np.random.default_rng(8), 9, 130)
    other = dataclasses.replace(
        CFG, ark=[[(c + 1) % F.p for c in row] for row in CFG.ark])
    for cfg in (CFG, other, CFG):
        got = cuda_poseidon.poseidon_columns(PF, cfg, limbs.to(cuda))
        assert torch.equal(got.cpu(), poseidon_cols.poseidon_columns_plain(
            PF, cfg, limbs))


@pytest.mark.cuda
def test_poseidon_tree_levels_on_the_card_match_plain(cuda):
    _, leaves = rand_matrix(np.random.default_rng(5), 1, 256)
    want = poseidon_cols.tree_levels(PF, CFG, leaves[0])
    before = cuda_poseidon.launches.count
    got = poseidon_cols.tree_levels(PF, CFG, leaves[0].to(cuda))
    assert cuda_poseidon.launches.count - before == 8
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


@pytest.mark.cuda
def test_poseidon_kernel_refuses_what_it_cannot_take(cuda):
    with pytest.raises(ValueError, match="int32"):
        cuda_poseidon.poseidon_columns(PF, CFG, torch.zeros(
            (2, 3, 16), dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        cuda_poseidon.poseidon_columns(PF, CFG, torch.zeros(
            (2, 3, 32), dtype=torch.int32, device=cuda)[..., ::2])


@pytest.mark.cuda
@pytest.mark.parametrize("zk", [False, True], ids=["plain", "zk"])
def test_poseidon_proofs_on_the_card_equal_cpu(cuda, zk):
    circ = generate_lemniscate_circuit()
    kw = dict(lambda_=5, rate_inv=16, zk=True) if zk else {}
    seed = {"zk_seed": ZK_SEED} if zk else {}
    sp = test_sponge(F)
    proofs = []
    for device in ("cpu", cuda):
        lig = LigeroCircuit(convert.circuit_from_reference(circ), [circ.last()],
                            device=device, mt_params=LigeroMTPoseidonParams(PF),
                            **kw)
        proofs.append(lig.prove(WITNESS, sp.clone(), **seed).to_bytes(PF))
        assert lig.verify(LigeroProof.from_bytes(proofs[-1], PF), sp.clone())
    assert proofs[0] == proofs[1]
