"""The port's spot-column evaluation (``engine/spot.py``) against the JAX
package's ``mxu_spot_numpy`` and against the port's own NTT route, at the
shapes of ``tests/test_mxu_spot.py``.  Exact integer arithmetic: tolerance
0 everywhere.  Inputs come from a numpy seed."""

import numpy as np
import pytest
import torch

from ligero_tpu.engine.backend import Backend
from ligero_tpu.engine.mxu_ntt import _limbs16_to_7
from ligero_tpu.engine.mxu_spot import K_MAX as REF_K_MAX
from ligero_tpu.engine.mxu_spot import mxu_spot_numpy
from ligero_tpu.fields import BLS12_377_FQ, BN254_FR
from ligero_tpu_torch.engine import ntt, spot
from ligero_tpu_torch.engine.backend import TorchBackend
from ligero_tpu_torch.fields import FIELDS as PORT_FIELDS

# the suite runs in several worker processes that share the host's cores, and
# these tests run many small tensor ops: one intra-op thread each, or the
# workers' thread pools spin against each other
torch.set_num_threads(1)

F = BN254_FR
PF = PORT_FIELDS[F.name]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def rand_coeffs(seed: int, rows: int, k: int, field=F) -> np.ndarray:
    rng = np.random.default_rng(seed)
    ints = [int.from_bytes(rng.bytes(48), "little") % field.p
            for _ in range(rows * k)]
    return field.ints_to_mont_limbs(ints).reshape(rows, k, field.num_limbs)


def tensor(a: np.ndarray, device="cpu") -> torch.Tensor:
    return torch.from_numpy(a.astype(np.int32)).to(device)


def bits(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


@pytest.mark.parametrize("canon", [False, True])
@pytest.mark.parametrize("rows,k,n", [(6, 64, 512), (5, 128, 1024)])
def test_spot_eval_matches_mxu_spot_numpy_and_ntt_route(rows, k, n, canon):
    coeffs = rand_coeffs(17, rows, k)
    js = np.sort(np.random.default_rng(18).choice(n, size=9, replace=False))
    got = spot.spot_eval(PF, tensor(coeffs), js, n, canon_out=canon)
    assert got.dtype == torch.int32 and got.shape == (rows, 9, 16)
    assert np.array_equal(bits(got),
                          mxu_spot_numpy(F, coeffs, js, n, canon_out=canon))
    full = ntt.ntt_ref(PF, tensor(coeffs), n, canon_out=canon)
    assert torch.equal(got, full[:, torch.from_numpy(js)])
    assert torch.equal(got, spot.spot_ref(PF, tensor(coeffs), js, n, canon))


@pytest.mark.parametrize("canon", [False, True])
def test_spot_eval_chunks_rows_longer_than_k_max(canon):
    assert spot.K_MAX == REF_K_MAX
    rows, k, n = 2, spot.K_MAX + 256, 8192
    coeffs = rand_coeffs(19, rows, k)
    js = np.asarray([0, 1, 4097, n - 1])
    got = spot.spot_eval(PF, tensor(coeffs), js, n, canon_out=canon)
    assert np.array_equal(bits(got),
                          mxu_spot_numpy(F, coeffs, js, n, canon_out=canon))
    assert torch.equal(got, spot.spot_ref(PF, tensor(coeffs), js, n, canon))


def test_spot_eval_dense_operands_at_the_accumulation_bound():
    """p - 1 everywhere at exactly K_MAX coefficients: the int32 columns
    reach their largest values."""
    rows, n = 2, 8192
    dense = np.tile(F.ints_to_mont_limbs([F.p - 1] * spot.K_MAX).reshape(
        1, spot.K_MAX, -1), (rows, 1, 1))
    js = np.arange(0, n, n // 16)
    got = spot.spot_eval(PF, tensor(dense), js, n)
    assert np.array_equal(bits(got), mxu_spot_numpy(F, dense, js, n))
    # the worst case of the bound itself: every 7-bit limb at 127
    assert spot.L7 * spot.K_MAX * 127 ** 2 < 1 << 31
    assert spot.L7 * (2 * spot.K_MAX) * 127 ** 2 >= 1 << 31


@pytest.mark.parametrize("rows,k,n,t,block", [
    (20, 61, 256, 7, 4),       # k and t no multiples of 8, ragged last block
    (3, 8, 16, 16, None),      # every column of a small domain
    (1, 1, 2, 1, None),
])
def test_spot_eval_odd_shapes_and_row_blocks(rows, k, n, t, block,
                                             monkeypatch):
    if block:
        monkeypatch.setattr(spot, "rows_per_block", lambda *a: block)
    coeffs = rand_coeffs(23, rows, k)
    js = np.random.default_rng(24).choice(n, size=t, replace=False)
    for canon in (False, True):
        got = spot.spot_eval(PF, tensor(coeffs), js, n, canon)
        assert np.array_equal(bits(got),
                              mxu_spot_numpy(F, coeffs, js, n, canon_out=canon))


def test_limb_split_matches_the_jax_package():
    x = np.random.default_rng(29).integers(0, 1 << 16, (16, 3, 5)).astype(
        np.uint32)
    x[:, 0, 0] = 0xFFFF
    out = torch.zeros((spot.L7, 3, 5), dtype=torch.int8)
    spot.limbs16_to_7(tensor(x), out)
    want = np.stack(_limbs16_to_7(np, x))
    assert np.array_equal(out.numpy().astype(np.uint32), want)


def test_omega_power_table_is_the_transform_root():
    table = spot.omega_powers(PF.name, 64)
    ints = PF.mont_limbs_to_ints(table.astype(np.uint32))
    omega = PF.root_of_unity(64)
    assert ints == [pow(omega, i, PF.p) for i in range(64)]


def test_spot_eval_rejects_what_it_does_not_handle():
    x = tensor(rand_coeffs(31, 2, 8))
    with pytest.raises(ValueError, match="spot route"):
        spot.spot_eval(PF, x, [1], 24)                   # n no power of two
    with pytest.raises(ValueError, match="bad coefficients"):
        spot.spot_eval(PF, x, [1], 4)                    # k > n
    with pytest.raises(ValueError, match="outside"):
        spot.spot_eval(PF, x, [16], 16)
    bls = PORT_FIELDS[BLS12_377_FQ.name]
    with pytest.raises(ValueError, match="spot route"):
        spot.spot_eval(bls, torch.zeros((1, 8, 24), dtype=torch.int32), [1], 16)
    assert spot.spot_eval(PF, x, [], 16).shape == (2, 0, 16)


def test_route_gate():
    assert spot.spot_ok(PF, 4096) and not spot.spot_ok(PF, 4095)
    assert not spot.spot_ok(PORT_FIELDS[BLS12_377_FQ.name], 4096)
    assert spot.spot_ok(PF, 1) and not spot.spot_ok(PF, 0)
    assert spot.rows_per_block(4100, 2048, 156, "cpu") == 4100
    assert spot.chunk_bytes_per_row(4096, 156) == spot.chunk_bytes_per_row(
        2048, 156) > spot.chunk_bytes_per_row(64, 156)


def count_calls(monkeypatch):
    calls = []
    real = spot.spot_eval

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(spot, "spot_eval", counted)
    return calls


def test_ntt_columns_takes_the_ntt_route_and_matches_spot_and_backend(
        monkeypatch):
    """The verifier's path is the full transform and a gather; the spot
    evaluation gives the same limbs and is not called."""
    be, ref = TorchBackend(PF, "cpu"), Backend(F)
    coeffs, n = rand_coeffs(37, 5, 32), 256
    js = np.asarray([1, 2, 40, n - 2])
    want = spot.spot_eval(PF, tensor(coeffs), js, n)
    calls = count_calls(monkeypatch)
    got = be.ntt_columns(coeffs, n, js)
    assert not calls
    assert torch.equal(got, want)
    assert np.array_equal(be.to_numpy(got), ref.ntt_columns(coeffs, n, js))


def test_ntt_columns_of_a_24_limb_field_takes_the_ntt_route(monkeypatch):
    calls = count_calls(monkeypatch)
    bls = PORT_FIELDS[BLS12_377_FQ.name]
    be, ref = TorchBackend(bls, "cpu"), Backend(BLS12_377_FQ)
    coeffs = rand_coeffs(41, 3, 16, BLS12_377_FQ)
    js = np.asarray([0, 5, 63])
    got = be.ntt_columns(coeffs, 64, js)
    assert not calls
    assert np.array_equal(be.to_numpy(got), ref.ntt_columns(coeffs, 64, js))


def test_ntt_columns_batch_is_ntt_columns_per_proof():
    be, ref = TorchBackend(PF, "cpu"), Backend(F)
    blocks = [rand_coeffs(43 + b, 4, 16) for b in range(3)]
    idx = np.asarray([[0, 9, 127], [5, 6, 7], [127, 64, 1]])
    got = be.ntt_columns_batch([be.asarray(b) for b in blocks], 128, idx)
    assert got.shape == (3, 4, 3, 16)
    want = ref.ntt_columns_batch(np.stack(blocks), 128, idx)
    assert np.array_equal(be.to_numpy(got), want)
    for b in range(3):
        assert torch.equal(got[b], be.ntt_columns(blocks[b], 128, idx[b]))


# ---------------------------------------------------------------------------
# on the card: the int8 product's shape rules and the Montgomery products
# of the fold on the mont_mul kernel
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("rows,k,n,t", [
    (40, 128, 1024, 9), (3, 61, 256, 7), (17, 8, 16, 16),
    (2, spot.K_MAX + 24, 8192, 5), (1, 1, 2, 1)])
def test_spot_eval_on_the_card_matches_cpu(cuda, rows, k, n, t):
    coeffs = rand_coeffs(47, rows, k)
    js = np.random.default_rng(48).choice(n, size=t, replace=False)
    for canon in (False, True):
        want = spot.spot_eval(PF, tensor(coeffs), js, n, canon)
        got = spot.spot_eval(PF, tensor(coeffs, cuda), js, n, canon)
        assert got.device.type == "cuda" and torch.equal(got.cpu(), want)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(spot, "rows_per_block", lambda *a: 7)
            blocked = spot.spot_eval(PF, tensor(coeffs, cuda), js, n, canon)
        assert torch.equal(blocked.cpu(), want)


@pytest.mark.cuda
def test_spot_eval_on_the_card_never_builds_the_transform(cuda):
    """Its peak stays far below the (rows, n, L) transform."""
    rows, k, n = 64, 256, 65536
    coeffs = tensor(rand_coeffs(53, rows, k), cuda)
    js = np.random.default_rng(54).choice(n, size=156, replace=False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = spot.spot_eval(PF, coeffs, js, n)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base < rows * n * 64 // 4
    assert torch.equal(got, spot.spot_ref(PF, coeffs, js, n))
