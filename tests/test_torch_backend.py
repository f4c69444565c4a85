"""TorchBackend's bulk protocol steps (on the CPU: the kernels' plain
versions) against the JAX package's numpy Backend, on the operands of a
real compiled instance."""

import numpy as np
import pytest
import torch

from ligero_tpu.engine.backend import Backend
from ligero_tpu.fields import BN254_FR
from ligero_tpu.ligero import LigeroCircuit as RefCircuit
from ligero_tpu.sampling import rand_field_elements_limbs
from ligero_tpu.synthetic import generate_random_circuit
from ligero_tpu_torch import convert
from ligero_tpu_torch.engine.backend import (MAX_BATCH, DeviceMemoryError,
                                             TorchBackend)
from ligero_tpu_torch.fields import FIELDS as PORT_FIELDS

# the suite runs in several worker processes that share the host's cores, and
# these tests run many small tensor ops: one intra-op thread each, or the
# workers' thread pools spin against each other
torch.set_num_threads(1)


def pf(field):
    """The port's own FieldSpec for a JAX-package one."""
    return PORT_FIELDS[field.name]

F = BN254_FR


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def instance():
    circ, outs, vars_ = generate_random_circuit(F, 1 << 8, seed=3)
    ref = RefCircuit(circ, outs, backend=Backend(F))
    preenc = np.asarray(ref._build_preenc(
        [(ref._bump_index(i), v) for i, v in vars_]), dtype=np.uint32)
    return ref, preenc


def rand_mont(rng, shape):
    ints = [int.from_bytes(rng.bytes(32), "little") % F.p
            for _ in range(int(np.prod(shape)))]
    return F.ints_to_mont_limbs(ints).reshape(*shape, 16)


def test_rs_encode_and_canon_matches_backend(instance):
    ref, preenc = instance
    want_c, want_u = Backend(F).rs_encode_and_canon(preenc, ref.k, ref.n)
    be = TorchBackend(pf(F), "cpu")
    got_c, got_u = be.rs_encode_and_canon(be.asarray(preenc), ref.k, ref.n)
    assert np.array_equal(be.to_numpy(got_c), want_c)
    assert np.array_equal(be.to_numpy(got_u), want_u)


def test_commit_and_gather_match_backend(instance):
    ref, preenc = instance
    _, u = Backend(F).rs_encode_and_canon(preenc, ref.k, ref.n)
    be = TorchBackend(pf(F), "cpu")
    assert be.commit_columns(be.asarray(u)) == Backend(F).commit_columns(u)
    js = [0, 5, ref.n - 1]
    assert np.array_equal(be.gather_columns(be.asarray(u), js),
                          Backend(F).gather_columns(u, js))


def test_sparse_ra_matches_backend(instance):
    ref, _ = instance
    rows, cols, vals = ref._a_fast.to_coo()
    four_mk = 4 * ref.m * ref.k
    seed = bytes(range(32))
    vals_mont = F.ints_to_mont_limbs(vals)
    r = rand_field_elements_limbs(F, four_mk, seed)
    want = Backend(F).sparse_rA_mont(np.asarray(rows), np.asarray(cols),
                                     vals_mont, r, four_mk)
    be = TorchBackend(pf(F), "cpu")
    r_dev = be.rand_field_mont(four_mk, seed)
    got = be.sparse_rA_mont(torch.as_tensor(np.asarray(rows, np.int64)),
                            torch.as_tensor(np.asarray(cols, np.int64)),
                            be.asarray(vals_mont), r_dev, four_mk)
    assert np.array_equal(be.to_numpy(got), want)


def test_row_combine_and_polys_match_backend(instance):
    ref, preenc = instance
    m, k = ref.m, ref.k
    rng = np.random.default_rng(9)
    np_be, be = Backend(F), TorchBackend(pf(F), "cpu")
    coeffs = np.asarray(np_be.intt(preenc, k))
    r = rand_mont(rng, (4 * m,))
    assert np.array_equal(be.to_numpy(be.row_combine(r, preenc)),
                          np_be.row_combine(r, preenc))
    r_coeffs = rand_mont(rng, (4 * m, k))
    assert np.array_equal(
        be.to_numpy(be.linear_combination_poly(be.asarray(coeffs), r_coeffs,
                                               2 * k)),
        np_be.linear_combination_poly(coeffs, r_coeffs, 2 * k))
    rq = rand_mont(rng, (m,))
    assert np.array_equal(
        be.to_numpy(be.quadratic_combination_poly(be.asarray(coeffs[:3 * m]),
                                                  be.asarray(rq), 2 * k)),
        np_be.quadratic_combination_poly(coeffs[:3 * m], rq, 2 * k))


def test_ntt_columns_and_from_mont_match_backend(instance):
    ref, preenc = instance
    np_be, be = Backend(F), TorchBackend(pf(F), "cpu")
    coeffs = np.asarray(np_be.intt(preenc, ref.k))
    js = np.asarray([1, 2, 40, ref.n - 2])
    assert np.array_equal(
        be.to_numpy(be.ntt_columns(be.asarray(coeffs), ref.n, js)),
        np_be.ntt_columns(coeffs, ref.n, js))
    assert np.array_equal(be.to_numpy(be.from_mont(coeffs[:2])),
                          np_be.from_mont(coeffs[:2]))


def test_direct_mode_budget_raises(monkeypatch):
    be = TorchBackend(pf(F), "cpu")
    monkeypatch.setattr(be, "memory_budget", lambda: 1 << 30)
    be.check_direct_fits(8, 64, 512, 1000)
    with pytest.raises(DeviceMemoryError):
        be.check_direct_fits(4100, 2048, 16384, 9_000_000)


def test_direct_estimate_is_not_below_the_recorded_peaks():
    """The live-set estimate at the 2^20-gate shapes against the peaks of
    ``torch.cuda.max_memory_allocated()`` recorded on an H100 (PERF.md §5:
    11.49 GiB plain, 11.61 GiB zk): an estimate below a measured peak would
    let ``max_batch`` pack more proofs than the card holds."""
    be = TorchBackend(pf(F), "cpu")
    rows, k, n, nnz = 4100, 2048, 16384, 9_443_331
    plain = be.direct_bytes(rows, k, n, nnz) / 2**30
    zk = be.direct_bytes(rows + 3, k, n, nnz, blind_t=468, d2=8192) / 2**30
    assert 11.49 <= plain < 11.49 * 1.1
    assert 11.61 <= zk < 11.61 * 1.1


def test_direct_estimate_is_not_below_the_recorded_bls12_377_peaks():
    """The same for BLS12-377 Fq (96-byte elements) at 2^20 gates, against
    the peaks chip_smoke.py recorded on an H100 (PERF.md §6: 17.04 GiB
    plain, 17.21 GiB zk, 23.79 GiB for a plain batch of 2); a CUDA
    backend takes the field (here on the CPU: the estimate is arithmetic)."""
    from ligero_tpu_torch.fields import BLS12_377_FQ
    be = TorchBackend(BLS12_377_FQ, "cpu")
    rows, k, n, nnz = 4100, 2048, 16384, 9_443_331
    plain = be.direct_bytes(rows, k, n, nnz) / 2**30
    zk = be.direct_bytes(rows + 3, k, n, nnz, blind_t=468, d2=8192) / 2**30
    pair = be.direct_bytes(rows, k, n, nnz, batch=2) / 2**30
    assert 17.04 <= plain < 17.04 * 1.1
    assert 17.21 <= zk < 17.21 * 1.1
    assert 23.79 <= pair < 23.79 * 1.1


def test_max_batch_follows_the_budget(monkeypatch):
    be = TorchBackend(pf(F), "cpu")
    shape = (4100, 2048, 16384, 9_443_331)
    for budget_gib, want in ((8, 0), (12, 1), (20, 2), (80, MAX_BATCH)):
        monkeypatch.setattr(be, "memory_budget", lambda: budget_gib << 30)
        got = be.max_batch(*shape)
        assert got == want
        assert be.direct_bytes(*shape, batch=max(got, 1)) <= (
            budget_gib << 30) or got == 0
        assert (got == MAX_BATCH
                or be.direct_bytes(*shape, batch=got + 1) > budget_gib << 30)
    # every further proof costs at least its U and its coefficients
    step = be.direct_bytes(*shape, batch=3) - be.direct_bytes(*shape, batch=2)
    assert step >= 4100 * (16384 + 2048) * 64


def test_compiled_state_carries_instance(instance):
    ref, _ = instance
    st = convert.compiled_state(ref)
    assert (st.m, st.k, st.n, st.t) == (ref.m, ref.k, ref.n, ref.t)
    assert st.outputs == ref.outputs
    rows, cols, vals = ref._a_fast.to_coo()
    assert np.array_equal(st.a_rows, rows) and np.array_equal(st.a_cols, cols)
    assert st.a_vals == list(vals)
    assert (st.zk, st.blind_t, st.d2) == (ref.zk, ref.blind_t, ref.d2)
    assert st.circuit.nodes == ref.circuit.nodes
    assert type(st.circuit).__module__.startswith("ligero_tpu_torch.")
    assert type(st.field).__module__.startswith("ligero_tpu_torch.")


def test_cuda_request_without_device_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        TorchBackend(pf(F), "cuda")


@pytest.mark.cuda
def test_backend_on_cuda_matches_cpu(cuda, instance):
    ref, preenc = instance
    cpu, dev = TorchBackend(pf(F), "cpu"), TorchBackend(pf(F), cuda)
    c1, u1 = cpu.rs_encode_and_canon(cpu.asarray(preenc), ref.k, ref.n)
    c2, u2 = dev.rs_encode_and_canon(dev.asarray(preenc), ref.k, ref.n)
    assert torch.equal(c1, c2.cpu()) and torch.equal(u1, u2.cpu())
    assert cpu.commit_columns(u1) == dev.commit_columns(u2)
