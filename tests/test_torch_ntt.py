"""The port's plain NTT (ligero_tpu_torch.engine.ntt.ntt_ref, the CPU path of
the NTT kernel's wrapper) against the JAX package's DomainOps and the MXU
kernel's numpy oracle (mxu_ntt_numpy), bit for bit."""

import numpy as np
import pytest
import torch

from ligero_tpu.engine.fieldops import FieldKernel
from ligero_tpu.engine.mxu_ntt import mxu_ntt_numpy
from ligero_tpu.engine.ntt import DomainOps
from ligero_tpu.fields import BLS12_377_FQ, BN254_FR
from ligero_tpu_torch.engine import cuda_ntt, ntt
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


def rand_mont(field, rng, shape):
    ints = [int.from_bytes(rng.bytes(field.num_limbs * 2), "little") % field.p
            for _ in range(int(np.prod(shape)))]
    return field.ints_to_mont_limbs(ints).reshape(*shape, field.num_limbs)


def t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.int32))


@pytest.mark.parametrize("n", [8, 64, 512, 1024, 2048])
def test_ntt_ref_matches_domainops(n):
    field = BN254_FR
    rng = np.random.default_rng(n)
    fk = FieldKernel(field, np)
    dom = DomainOps(fk, n)
    x = rand_mont(field, rng, (2, n))
    assert np.array_equal(ntt.ntt_ref(pf(field), t(x), n).numpy(), dom.fft(x))
    assert np.array_equal(ntt.ntt_ref(pf(field), t(x), n, inverse=True).numpy(),
                          dom.ifft(x))
    assert np.array_equal(
        ntt.ntt_ref(pf(field), t(x), n, inverse=True, canon_out=True).numpy(),
        fk.from_mont(dom.ifft(x)))
    short = x[:, :max(1, n // 8)]
    assert np.array_equal(
        ntt.ntt_ref(pf(field), t(short), n, canon_out=True).numpy(),
        fk.from_mont(dom.fft_padded(short)))


@pytest.mark.parametrize("n", [1024, 2048])
@pytest.mark.parametrize("inverse,canon_out", [(False, False), (True, False),
                                               (False, True), (True, True)])
def test_ntt_ref_matches_mxu_oracle(n, inverse, canon_out):
    field = BN254_FR
    rng = np.random.default_rng(7)
    x = rand_mont(field, rng, (2, n))
    want = mxu_ntt_numpy(field, x, n, inverse=inverse, canon_out=canon_out)
    got = ntt.ntt_ref(pf(field), t(x), n, inverse=inverse, canon_out=canon_out)
    assert np.array_equal(got.numpy(), want)


def test_ntt_ref_other_field_and_roundtrip():
    field = BLS12_377_FQ
    rng = np.random.default_rng(8)
    x = rand_mont(field, rng, (3, 32))
    fwd = ntt.ntt_ref(pf(field), t(x), 32)
    assert np.array_equal(fwd.numpy(), DomainOps(FieldKernel(field, np), 32).fft(x))
    assert np.array_equal(ntt.ntt_ref(pf(field), fwd, 32, inverse=True).numpy(), x)


def test_size_checks_and_epilogue_constants():
    f = BN254_FR
    with pytest.raises(ValueError):
        ntt.check_size(pf(f), 12)
    with pytest.raises(ValueError):
        ntt.check_size(pf(f), 1 << 29)
    n_inv = pow(64, -1, f.p)
    assert ntt.epilogue_const(pf(f), 64, False, False) is None
    assert ntt.epilogue_const(pf(f), 64, False, True) == 1
    assert ntt.epilogue_const(pf(f), 64, True, False) == n_inv * f.R % f.p
    assert ntt.epilogue_const(pf(f), 64, True, True) == n_inv
    with pytest.raises(ValueError):
        ntt.ntt_ref(pf(f), torch.zeros((1, 16, 16), dtype=torch.int32), 8)


def test_packed_twiddles_layout():
    limbs = ntt.twiddle_limbs(BN254_FR.name, 16, False)
    words = cuda_ntt.pack_words(limbs).view(np.uint32)
    ints = [sum(int(w) << (32 * i) for i, w in enumerate(row)) for row in words]
    assert ints == BN254_FR.limbs_to_ints(limbs)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 64, 1024, 4096])
def test_ntt_kernel_matches_plain(cuda, n):
    rng = np.random.default_rng(n)
    x = t(rand_mont(BN254_FR, rng, (3, n)))
    for inverse in (False, True):
        for canon in (False, True):
            want = ntt.ntt_ref(pf(BN254_FR), x, n, inverse, canon)
            got = cuda_ntt.ntt(pf(BN254_FR), x.to(cuda), n, inverse, canon)
            assert torch.equal(got.cpu(), want)
    short = x[:, :max(1, n // 8)].contiguous()
    assert torch.equal(cuda_ntt.ntt(pf(BN254_FR), short.to(cuda), n).cpu(),
                       ntt.ntt_ref(pf(BN254_FR), short, n))
