"""Plain PyTorch field arithmetic of the port (ligero_tpu_torch.engine.fieldops,
the CPU path of the mont_mul kernel's wrapper) against the JAX package's
numpy FieldKernel, bit for bit (tolerance 0: exact field arithmetic)."""

import os
import re

import numpy as np
import pytest
import torch

from ligero_tpu.engine.fieldops import FieldKernel
from ligero_tpu.fields import BLS12_377_FQ, BN254_FR
from ligero_tpu_torch.engine import cuda_mont, fieldops
from ligero_tpu_torch.fields import FIELDS as PORT_FIELDS

# the suite runs in several worker processes that share the host's cores, and
# these tests run many small tensor ops: one intra-op thread each, or the
# workers' thread pools spin against each other
torch.set_num_threads(1)


def pf(field):
    """The port's own FieldSpec for a JAX-package one."""
    return PORT_FIELDS[field.name]

FIELDS = [BN254_FR, BLS12_377_FQ]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def rand_reduced(field, rng, shape):
    """Limbs of uniformly random elements below p."""
    ints = [int.from_bytes(rng.bytes(field.num_limbs * 2), "little") % field.p
            for _ in range(int(np.prod(shape)))]
    return field.ints_to_limbs(ints).reshape(*shape, field.num_limbs)


def t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.int32))


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_mont_mul_add_sub_match_fieldkernel(field):
    rng = np.random.default_rng(1)
    fk = FieldKernel(field, np)
    a, b = rand_reduced(field, rng, (40, 3)), rand_reduced(field, rng, (40, 3))
    assert np.array_equal(fieldops.mont_mul(pf(field), t(a), t(b)).numpy(),
                          fk.mont_mul(a, b))
    assert np.array_equal(fieldops.add(pf(field), t(a), t(b)).numpy(), fk.add(a, b))
    assert np.array_equal(fieldops.sub(pf(field), t(a), t(b)).numpy(), fk.sub(a, b))
    assert np.array_equal(fieldops.sub(pf(field), t(b), t(a)).numpy(), fk.sub(b, a))


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_mont_mul_a_below_r(field):
    """The sparse r^T A fold feeds a < R (any 16-bit limbs) with b < p; the
    product must still come out fully reduced."""
    rng = np.random.default_rng(2)
    fk = FieldKernel(field, np)
    a = rng.integers(0, 1 << 16, size=(64, field.num_limbs)).astype(np.uint32)
    a[0] = 0xFFFF  # R - 1
    b = rand_reduced(field, rng, (64,))
    got = fieldops.mont_mul(pf(field), t(a), t(b)).numpy()
    assert np.array_equal(got, fk.mont_mul(a, b))
    vals = field.limbs_to_ints(got.astype(np.uint32))
    assert all(v < field.p for v in vals)


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_sum_mod_and_montgomery_conversions(field):
    rng = np.random.default_rng(3)
    fk = FieldKernel(field, np)
    a = rand_reduced(field, rng, (37, 5))
    assert np.array_equal(fieldops.sum_mod(pf(field), t(a), 0).numpy(),
                          fk.sum_mod(a, axis=0))
    assert np.array_equal(fieldops.sum_mod(pf(field), t(a), 1).numpy(),
                          fk.sum_mod(a, axis=1))
    assert np.array_equal(fieldops.to_mont(pf(field), t(a)).numpy(), fk.to_mont(a))
    assert np.array_equal(fieldops.from_mont(pf(field), t(a)).numpy(),
                          fk.from_mont(a))


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_fold_wide_reduces_int64_limb_sums(field):
    rng = np.random.default_rng(4)
    s = rng.integers(0, 1 << 48, size=(20, field.num_limbs), dtype=np.int64)
    got = field.limbs_to_ints(
        fieldops.fold_wide(pf(field), torch.from_numpy(s)).numpy().astype(np.uint32))
    want = [sum(int(v) << (16 * j) for j, v in enumerate(row)) % field.p
            for row in s]
    assert got == want


def test_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(5)
    a, b = rand_reduced(BN254_FR, rng, (8,)), rand_reduced(BN254_FR, rng, (8,))
    before = cuda_mont.launches.count
    got = cuda_mont.mont_mul(pf(BN254_FR), t(a), t(b))
    assert cuda_mont.launches.count == before
    assert torch.equal(got, fieldops.mont_mul(pf(BN254_FR), t(a), t(b)))


def test_field_header_constants_match_bn254():
    """csrc/field.cuh hard-codes p and -p^-1 mod 2^32 for its CIOS."""
    path = os.path.join(os.path.dirname(cuda_mont.__file__), "..", "csrc",
                        "field.cuh")
    with open(path) as f:
        src = f.read()
    words = re.search(r"constexpr uint32_t P\[W\] = \{([^}]*)\}", src).group(1)
    p_words = [int(w.strip().rstrip("u"), 16) for w in words.split(",")]
    assert sum(w << (32 * i) for i, w in enumerate(p_words)) == BN254_FR.p
    np0 = int(re.search(r"NP0 = (0x[0-9a-fA-F]+)u", src).group(1), 16)
    assert np0 == (-pow(BN254_FR.p, -1, 1 << 32)) % (1 << 32)


@pytest.mark.cuda
def test_mont_mul_kernel_matches_plain(cuda):
    rng = np.random.default_rng(6)
    a = rng.integers(0, 1 << 16, size=(5000, 16)).astype(np.int32)
    b = rand_reduced(BN254_FR, rng, (5000,))
    want = fieldops.mont_mul(pf(BN254_FR), t(a), t(b))
    got = cuda_mont.mont_mul(pf(BN254_FR), t(a).to(cuda), t(b).to(cuda))
    assert torch.equal(got.cpu(), want)
    got_b = cuda_mont.mont_mul(pf(BN254_FR), t(a).to(cuda), t(b[0]).to(cuda))
    assert torch.equal(got_b.cpu(), fieldops.mont_mul(pf(BN254_FR), t(a), t(b[0])))
