"""The port's device sampler (ligero_tpu_torch.engine.devsampler: ChaCha20 +
F::rand as PyTorch ops) against the JAX package's host sampler and ChaCha."""

import numpy as np
import pytest
import torch

from ligero_tpu.chacha import chacha_blocks
from ligero_tpu.fields import BLS12_377_FQ, BN254_FR
from ligero_tpu.sampling import rand_field_elements_limbs
from ligero_tpu_torch.engine import devsampler
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


def test_chacha20_blocks_match_host():
    key = np.arange(8, dtype=np.uint32) * 0x01020304
    got = devsampler.chacha20_blocks(key, 37, "cpu").numpy().astype(np.uint32)
    assert np.array_equal(got, chacha_blocks(key, 0, 37))


@pytest.mark.parametrize("field", [BN254_FR, BLS12_377_FQ], ids=lambda f: f.name)
@pytest.mark.parametrize("count", [0, 1, 7, 1000, 20000])
def test_fr_sample_matches_host_sampler(field, count):
    seed = bytes((count * 7 + i) % 256 for i in range(32))
    got = devsampler.fr_sample(pf(field), count, seed, "cpu")
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(),
                          rand_field_elements_limbs(field, count, seed))


def test_fr_sample_shortfall_redraws_exactly(monkeypatch):
    """Too few first-round attempts: the longer redraw keeps the stream."""
    monkeypatch.setattr(devsampler, "plan_attempts", lambda field, count: 3)
    seed = bytes(range(32))
    got = devsampler.fr_sample(pf(BN254_FR), 500, seed, "cpu")
    assert np.array_equal(got.numpy(),
                          rand_field_elements_limbs(BN254_FR, 500, seed))


def test_fr_sample_rejects_short_seed():
    with pytest.raises(ValueError):
        devsampler.fr_sample(pf(BN254_FR), 4, b"short", "cpu")


@pytest.mark.cuda
def test_fr_sample_on_cuda_matches_host(cuda):
    seed = bytes(range(100, 132))
    got = devsampler.fr_sample(pf(BN254_FR), 100_000, seed, cuda)
    assert np.array_equal(got.cpu().numpy(),
                          rand_field_elements_limbs(BN254_FR, 100_000, seed))
