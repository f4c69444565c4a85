"""The port's plain row combination (ligero_tpu_torch.engine.cuda_lc.
row_combine_ref, the CPU path of the row_combine kernel's wrapper) against
the MXU kernel's numpy oracle (mxu_lc_numpy) and the numpy FieldKernel."""

import numpy as np
import pytest
import torch

from ligero_tpu.engine.backend import Backend
from ligero_tpu.engine.fieldops import FieldKernel
from ligero_tpu.engine.mxu_lc import mxu_lc_numpy
from ligero_tpu.fields import BLS12_377_FQ, BN254_FR
from ligero_tpu_torch.engine import cuda_lc
from ligero_tpu_torch.fields import FIELDS as PORT_FIELDS

# the suite runs in several worker processes that share the host's cores, and
# these tests run many small tensor ops: one intra-op thread each, or the
# workers' thread pools spin against each other
torch.set_num_threads(1)


def pf(field):
    """The port's own FieldSpec for a JAX-package one."""
    return PORT_FIELDS[field.name]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def rand_mont(rng, shape, field=BN254_FR):
    ints = [int.from_bytes(rng.bytes(2 * field.num_limbs), "little") % field.p
            for _ in range(int(np.prod(shape)))]
    return field.ints_to_mont_limbs(ints).reshape(*shape, field.num_limbs)


def t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.int32))


@pytest.mark.parametrize("rows,k", [(1, 128), (136, 128), (300, 256)])
def test_row_combine_matches_mxu_oracle(rows, k):
    rng = np.random.default_rng(rows + k)
    mat, r = rand_mont(rng, (rows, k)), rand_mont(rng, (rows,))
    got = cuda_lc.row_combine(pf(BN254_FR), t(r), t(mat))
    assert np.array_equal(got.numpy(), mxu_lc_numpy(BN254_FR, mat, r))


def test_row_combine_per_element_matches_fieldkernel():
    rng = np.random.default_rng(21)
    fk = FieldKernel(BN254_FR, np)
    mat, r = rand_mont(rng, (50, 9)), rand_mont(rng, (50, 9))
    got = cuda_lc.row_combine(pf(BN254_FR), t(r), t(mat))
    assert np.array_equal(got.numpy(), fk.sum_mod(fk.mont_mul(r, mat), axis=0))


@pytest.mark.parametrize("rows,k", [(1, 8), (65, 16), (130, 40)])
def test_row_combine_matches_backend_bls12_377(rows, k):
    """BLS12-377 Fq, where the JAX package has no mxu_lc (16 limbs only) and
    combines rows with FieldKernel products and sum_mod: Backend.row_combine
    on numpy (one r per row), the FieldKernel for one r per element, and
    Backend.row_combine_batch."""
    field = BLS12_377_FQ
    rng = np.random.default_rng(rows + k)
    be, fk = Backend(field), FieldKernel(field, np)
    mat, r = rand_mont(rng, (rows, k), field), rand_mont(rng, (rows,), field)
    got = cuda_lc.row_combine(pf(field), t(r), t(mat))
    assert np.array_equal(got.numpy(), np.asarray(be.row_combine(r, mat)))
    r = rand_mont(rng, (rows, k), field)
    got = cuda_lc.row_combine(pf(field), t(r), t(mat))
    assert np.array_equal(got.numpy(), fk.sum_mod(fk.mont_mul(r, mat), axis=0))
    mats, rs = rand_mont(rng, (2, rows, k), field), rand_mont(rng, (2, rows), field)
    got = cuda_lc.row_combine_batch(pf(field), t(rs), t(mats))
    assert np.array_equal(got.numpy(),
                          np.asarray(be.row_combine_batch(rs, mats)))


def test_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(22)
    mat, r = t(rand_mont(rng, (4, 8))), t(rand_mont(rng, (4,)))
    before = cuda_lc.launches.count
    assert torch.equal(cuda_lc.row_combine(pf(BN254_FR), r, mat),
                       cuda_lc.row_combine_ref(pf(BN254_FR), r, mat))
    assert cuda_lc.launches.count == before


@pytest.mark.cuda
@pytest.mark.parametrize("field", [BN254_FR, BLS12_377_FQ], ids=lambda f: f.name)
@pytest.mark.parametrize("rows,k", [(1, 1), (65, 3), (4100, 64)])
def test_row_combine_kernel_matches_plain(cuda, rows, k, field):
    rng = np.random.default_rng(rows)
    mat = t(rand_mont(rng, (rows, k), field))
    for r in (t(rand_mont(rng, (rows,), field)),
              t(rand_mont(rng, (rows, k), field))):
        got = cuda_lc.row_combine(pf(field), r.to(cuda), mat.to(cuda))
        assert torch.equal(got.cpu(), cuda_lc.row_combine_ref(pf(field), r, mat))
    rs = t(rand_mont(rng, (3, rows), field))
    mats = torch.stack([mat, mat.flip(0), mat.flip(1)])
    got = cuda_lc.row_combine_batch(pf(field), rs.to(cuda), mats.to(cuda))
    assert torch.equal(got.cpu(),
                       cuda_lc.row_combine_batch_ref(pf(field), rs, mats))
