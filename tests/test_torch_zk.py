"""zk mode of the port on device="cpu" against the JAX package's numpy
golden path: proofs with one ``zk_seed`` byte-equal (tolerance: none), each
package verifies the other's proofs, negatives rejected, and the device
blind against the host blind of ``ligero_tpu/ligero/core.py``."""

import warnings

import numpy as np
import pytest
import torch

from ligero_tpu.engine.backend import Backend
from ligero_tpu.fields import BN254_FR as F
from ligero_tpu.ligero import LigeroCircuit as RefCircuit
from ligero_tpu.ligero import LigeroProof as RefProof
from ligero_tpu.sampling import rand_field_elements_limbs
from ligero_tpu.sponge import test_sponge
from ligero_tpu.synthetic import generate_random_circuit
from ligero_tpu_torch import LigeroCircuit, LigeroProof, convert
from ligero_tpu_torch.engine.backend import DeviceMemoryError, TorchBackend
from ligero_tpu_torch.fields import BN254_FR as PF
from torch_columns import bumped

# the suite runs in several worker processes that share the host's cores, and
# these tests run many small tensor ops: one intra-op thread each, or the
# workers' thread pools spin against each other
torch.set_num_threads(1)

SEED_A = b"\x01" * 32
SEED_B = b"\x02" * 32
# (gates, num_vars, circuit seed, lambda): the instance of tests/test_zk.py,
# and synthetic 2^8 at a lambda whose blinding fits it
INSTANCES = {"zk_96": (96, 4, 3, 10), "zk_2e8": (256, 64, 8, 20)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def build(name, zk=True, device="cpu"):
    gates, num_vars, seed, lam = INSTANCES[name]
    circ, outs, vars_ = generate_random_circuit(F, gates, num_vars=num_vars,
                                                seed=seed)
    ref = RefCircuit(circ, outs, lambda_=lam, zk=zk, backend=Backend(F))
    port = LigeroCircuit(convert.circuit_from_reference(circ), outs,
                         lambda_=lam, zk=zk, device=device)
    return ref, port, vars_


@pytest.fixture(scope="module", params=list(INSTANCES))
def proved(request):
    ref, port, vars_ = build(request.param)
    want = ref.prove(vars_, test_sponge(F), zk_seed=SEED_A)
    got = port.prove(vars_, test_sponge(F), zk_seed=SEED_A)
    return ref, port, vars_, want, got


@pytest.fixture(scope="module")
def small():
    ref, port, vars_ = build("zk_96")
    return ref, port, vars_, port.prove(vars_, test_sponge(F), zk_seed=SEED_A)


def reparsed(proof) -> LigeroProof:
    return LigeroProof.from_bytes(proof.to_bytes(PF), PF)


def test_zk_proof_bytes_equal_jax_package(proved):
    ref, port, _, want, got = proved
    assert (port.m, port.k, port.n, port.t) == (ref.m, ref.k, ref.n, ref.t)
    assert (port.blind_t, port.d2, port.num_rows) == (ref.blind_t, ref.d2,
                                                      ref.num_rows)
    assert got.to_bytes(PF) == want.to_bytes(F)


def test_zk_cross_verification(proved):
    ref, port, _, want, got = proved
    assert port.verify(got, test_sponge(F))
    assert port.verify(reparsed(want), test_sponge(F))
    assert ref.verify(RefProof.from_bytes(got.to_bytes(PF), F), test_sponge(F))


def test_zk_shape_and_column_exclusion(small):
    _, port, _, proof = small
    assert port.blind_t == 3 * port.t and port.num_rows == 4 * port.m + 3
    assert len(proof.interleaved.preenc_u_lc) == port.k + 3 * port.t
    assert len(proof.linear.polynomial) <= 2 * port.k + port.blind_t - 1
    assert len(proof.quadratic.polynomial) <= 2 * (port.k + port.blind_t) - 1
    stride = port.n // port.k
    for sub in (proof.interleaved, proof.linear, proof.quadratic):
        assert len(sub.columns) == port.t
        assert all(len(col) == 4 * port.m + 3 for col in sub.columns)
        assert all(path.leaf_index % stride != 0 for path in sub.paths)


def test_zk_seed_determinism_and_masking(small):
    ref, port, vars_, proof = small
    again = port.prove(vars_, test_sponge(F), zk_seed=SEED_A)
    assert again.to_bytes(PF) == proof.to_bytes(PF)
    other = port.prove(vars_, test_sponge(F), zk_seed=SEED_B)
    assert port.verify(other, test_sponge(F))
    assert other.to_bytes(PF) == ref.prove(vars_, test_sponge(F),
                                           zk_seed=SEED_B).to_bytes(F)
    assert other.u_root != proof.u_root
    assert other.interleaved.preenc_u_lc != proof.interleaved.preenc_u_lc
    assert other.linear.polynomial != proof.linear.polynomial
    assert other.quadratic.polynomial != proof.quadratic.polynomial
    assert not np.array_equal(other.interleaved.columns,
                              proof.interleaved.columns)
    fresh = port.prove(vars_, test_sponge(F))    # fresh os randomness
    assert port.verify(fresh, test_sponge(F))
    assert fresh.u_root not in (proof.u_root, other.u_root)


def test_zk_tampered_witness_rejected(small):
    ref, port, vars_, _ = small
    bad = [(vars_[0][0], (vars_[0][1] + 1) % F.p)] + vars_[1:]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        proof = port.prove(bad, test_sponge(F), zk_seed=SEED_A)
    assert not port.verify(proof, test_sponge(F))
    assert not ref.verify(RefProof.from_bytes(proof.to_bytes(PF), F),
                          test_sponge(F))


def test_zk_flipped_bytes_rejected(small):
    _, port, _, proof = small
    data = proof.to_bytes(PF)
    for pos in (8, 8 + 32 + 8, len(data) // 3, len(data) // 2, len(data) - 1):
        flipped = bytearray(data)
        flipped[pos] ^= 1
        try:
            bad = LigeroProof.from_bytes(bytes(flipped), PF)
        except ValueError:
            continue  # the deserializer rejected it
        assert not port.verify(bad, test_sponge(F)), pos


@pytest.mark.parametrize("tamper", [
    "lc_too_short", "lc_too_long", "lc_value", "q_degree", "q_value",
    "p0_degree", "p0_value", "mask_row_entry", "data_row_entry",
    "message_domain_index", "column_dropped"])
def test_zk_tampered_proof_rejected(small, tamper):
    _, port, _, proof = small
    bad = reparsed(proof)
    p, stride = F.p, port.n // port.k
    if tamper == "lc_too_short":
        bad.interleaved.preenc_u_lc = bad.interleaved.preenc_u_lc[:port.k]
    elif tamper == "lc_too_long":     # degree >= k + 3t
        bad.interleaved.preenc_u_lc = bad.interleaved.preenc_u_lc + [1]
    elif tamper == "lc_value":
        bad.interleaved.preenc_u_lc[-1] = (bad.interleaved.preenc_u_lc[-1] + 1) % p
    elif tamper == "q_degree":
        bad.linear.polynomial = (bad.linear.polynomial
                                 + [0] * (port.lin_bound - len(bad.linear.polynomial))
                                 + [1])
    elif tamper == "q_value":
        bad.linear.polynomial[1] = (bad.linear.polynomial[1] + 1) % p
    elif tamper == "p0_degree":
        bad.quadratic.polynomial = (bad.quadratic.polynomial + [0] * (
            port.quad_bound - len(bad.quadratic.polynomial)) + [1])
    elif tamper == "p0_value":
        bad.quadratic.polynomial[0] = (bad.quadratic.polynomial[0] + 1) % p
    elif tamper == "mask_row_entry":
        bad.linear.columns = bumped(PF, bad.linear.columns, 0, 4 * port.m + 1)
    elif tamper == "data_row_entry":
        bad.quadratic.columns = bumped(PF, bad.quadratic.columns, 0, 0)
    elif tamper == "message_domain_index":
        path = bad.interleaved.paths[0]
        path.leaf_index -= path.leaf_index % stride
    elif tamper == "column_dropped":
        bad.linear.columns = bad.linear.columns[:-1]
        bad.linear.paths = bad.linear.paths[:-1]
    assert port.verify(reparsed(proof), test_sponge(F))
    assert not port.verify(bad, test_sponge(F))


def test_zk_and_plain_instances_reject_each_others_proofs(small):
    _, port, vars_, proof = small
    _, plain, _ = build("zk_96", zk=False)
    assert not plain.verify(proof, test_sponge(F))
    plain_proof = plain.prove(vars_, test_sponge(F))
    assert plain.verify(plain_proof, test_sponge(F))
    assert not port.verify(plain_proof, test_sponge(F))


def test_zk_too_small_raises_like_the_jax_package():
    """At the default lambda = 128 a toy instance cannot fit the blinding:
    both constructors refuse with the same message."""
    circ, outs, _ = generate_random_circuit(F, 96, num_vars=4, seed=3)
    with pytest.raises(ValueError) as ref_err:
        RefCircuit(circ, outs, zk=True, backend=Backend(F))
    with pytest.raises(ValueError) as port_err:
        LigeroCircuit(convert.circuit_from_reference(circ), outs, zk=True,
                      device="cpu")
    assert str(port_err.value) == str(ref_err.value)
    assert "circuit too small for zk" in str(port_err.value)


def host_blind(ref, preenc, rows_seed, mask3):
    """The host blind of the JAX package's zk prover, on its numpy kernels."""
    m, k, b, L = ref.m, ref.k, ref.blind_t, F.num_limbs
    fk = ref._host_fk()
    msg = np.asarray(Backend(F).intt(preenc, k))
    s = rand_field_elements_limbs(F, 4 * m * b, rows_seed).reshape(4 * m, b, L)
    coeffs = np.zeros((4 * m, k + b, L), np.uint32)
    coeffs[:, :k] = msg
    coeffs[:, k:] = s
    coeffs[:, :b] = fk.sub(coeffs[:, :b], s)
    rows = np.zeros((ref.num_rows, ref.d2, L), np.uint32)
    rows[:4 * m, :k + b] = coeffs
    rows[4 * m:] = mask3
    return coeffs, rows


@pytest.mark.parametrize("name", list(INSTANCES))   # zk_96 has b > k
def test_zk_blind_rows_matches_host_blind(name):
    ref, port, vars_ = build(name)
    preenc = np.asarray(ref._build_preenc(
        [(ref._bump_index(i), v) for i, v in vars_]), dtype=np.uint32)
    rng = np.random.default_rng(5)
    mask3 = F.ints_to_mont_limbs(
        [int.from_bytes(rng.bytes(32), "little") % F.p
         for _ in range(3 * ref.d2)]).reshape(3, ref.d2, -1)
    rows_seed = bytes(range(32))
    want_c, want_r = host_blind(ref, preenc, rows_seed, mask3)
    be = port.backend
    got_c, got_r = be.zk_blind_rows(be.asarray(preenc), rows_seed,
                                    port.blind_t, port.d2, mask3)
    assert np.array_equal(be.to_numpy(got_c), want_c)
    assert np.array_equal(be.to_numpy(got_r), want_r)
    # the encode of the blinded rows, and the products on the d2 domain
    np_be = Backend(F)
    assert np.array_equal(be.to_numpy(be.ntt_and_canon(got_r, ref.n)),
                          np.asarray(np_be.ntt_and_canon(want_r, ref.n)))
    r_coeffs = F.ints_to_mont_limbs(
        [int.from_bytes(rng.bytes(32), "little") % F.p
         for _ in range(4 * ref.m * ref.k)]).reshape(4 * ref.m, ref.k, -1)
    assert np.array_equal(
        be.to_numpy(be.linear_combination_poly(got_c, r_coeffs, ref.d2)),
        np_be.linear_combination_poly(want_c, r_coeffs, ref.d2))
    rq = r_coeffs[:ref.m, 0]
    assert np.array_equal(
        be.to_numpy(be.quadratic_combination_poly(got_c[:3 * ref.m], rq, ref.d2)),
        np_be.quadratic_combination_poly(want_c[:3 * ref.m], rq, ref.d2))


def test_zk_direct_mode_budget():
    """The zk live set at 2^20 gates (4103 rows, b = 468, d2 = 8192) fits
    an 80 GB card in direct mode and not an 8 GB one."""
    be = TorchBackend(PF, "cpu")
    args = (4103, 2048, 16384, 9_443_331, 468, 8192)
    be.memory_budget = lambda: 80 * 10**9
    be.check_direct_fits(*args)
    be.memory_budget = lambda: 8 * 10**9
    with pytest.raises(DeviceMemoryError):
        be.check_direct_fits(*args)
    be.check_direct_fits(75, 16, 128, 500, 75, 256)


@pytest.mark.cuda
def test_zk_proof_on_cuda_matches_cpu(cuda):
    ref, cpu, vars_ = build("zk_2e8")
    _, dev, _ = build("zk_2e8", device=cuda)
    want = cpu.prove(vars_, test_sponge(F), zk_seed=SEED_A)
    got = dev.prove(vars_, test_sponge(F), zk_seed=SEED_A)
    assert got.to_bytes(PF) == want.to_bytes(PF)
    assert dev.verify(want, test_sponge(F)) and cpu.verify(got, test_sponge(F))
    assert ref.verify(RefProof.from_bytes(got.to_bytes(PF), F), test_sponge(F))
