"""The port's plain Blake2s column hashing and SHA-256 Merkle levels
(ligero_tpu_torch.engine.hashops) against hashlib, the host column hash and
the JAX package's numpy Backend commit helpers."""

import hashlib

import numpy as np
import pytest
import torch

from ligero_tpu.engine.backend import Backend
from ligero_tpu.fields import BLS12_377_FQ, BN254_FR
from ligero_tpu.hashes import column_hash
from ligero_tpu_torch.engine import cuda_hash, cuda_tree, hashops
from ligero_tpu_torch.engine.backend import TorchBackend
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


def rand_canon(rng, shape, field=BN254_FR):
    ints = [int.from_bytes(rng.bytes(2 * field.num_limbs), "little") % field.p
            for _ in range(int(np.prod(shape)))]
    return field.ints_to_limbs(ints).reshape(*shape, field.num_limbs)


def t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.int32))


@pytest.mark.parametrize("rows", [1, 2, 3, 7, 16])
def test_blake2s_columns_match_column_hash(rows):
    rng = np.random.default_rng(rows)
    u = rand_canon(rng, (rows, 6))
    digests = hashops.blake2s_columns_ref(t(u)).numpy().view(np.uint32)
    for j in range(6):
        col = BN254_FR.limbs_to_ints(u[:, j])
        assert digests[j].astype("<u4").tobytes() == column_hash(BN254_FR, col)


@pytest.mark.parametrize("rows", [4, 5, 6, 7, 103])
def test_blake2s_columns_match_column_hash_bls12_377(rows):
    """48-byte elements: the message repeats every 3 blocks of 4 rows, so
    rows at each residue mod 4 (103 = 4 25 + 3, as the zk path's 4m + 3)."""
    rng = np.random.default_rng(rows)
    cols = 2 if rows > 100 else 5
    u = rand_canon(rng, (rows, cols), BLS12_377_FQ)
    digests = hashops.blake2s_columns_ref(t(u)).numpy().view(np.uint32)
    for j in range(cols):
        col = BLS12_377_FQ.limbs_to_ints(u[:, j])
        assert digests[j].astype("<u4").tobytes() == column_hash(
            BLS12_377_FQ, col)


@pytest.mark.parametrize("field", [BN254_FR, BLS12_377_FQ], ids=lambda f: f.name)
@pytest.mark.parametrize("rows", [1, 2, 3, 4, 8, 9, 10, 11])
def test_column_block_words_match_the_serialization(field, rows):
    """The column kernel's word map, block by block, rebuilds each column's
    ark serialization (u64 row count, then 4 W-byte elements) zero-padded
    to whole blocks, and hashlib's Blake2s of it is column_hash."""
    W = field.num_limbs // 2
    rng = np.random.default_rng(100 * W + rows)
    u = rand_canon(rng, (rows, 1), field)[:, 0]
    words = (u[:, 0::2] | (u[:, 1::2] << 16)).astype(np.uint64)
    byte_len = 8 + 4 * W * rows
    nblocks = -(-byte_len // 64)
    msg = []
    for blk in range(nblocks):
        for row, word in hashops.column_block_words(W, blk):
            if row < 0:
                msg.append((rows >> (32 * word)) & 0xFFFFFFFF)
            else:
                msg.append(int(words[row, word]) if row < rows else 0)
    data = np.array(msg, dtype="<u4").tobytes()
    col = field.limbs_to_ints(u)
    serial = rows.to_bytes(8, "little") + b"".join(
        v.to_bytes(4 * W, "little") for v in col)
    assert data == serial + bytes(64 * nblocks - byte_len)
    assert hashlib.blake2s(data[:byte_len]).digest() == column_hash(field, col)


def test_blake2s_batch_matches_column_hash_bls12_377():
    """Two stacked BLS12-377 matrices of 7 rows: each column's digest opens
    with its own matrix's row count."""
    u = rand_canon(np.random.default_rng(21), (14, 3), BLS12_377_FQ)
    got = cuda_hash.blake2s_columns(pf(BLS12_377_FQ), t(u), 2).numpy().view(np.uint32)
    for b in range(2):
        for j in range(3):
            col = BLS12_377_FQ.limbs_to_ints(u[7 * b:7 * b + 7, j])
            assert got[3 * b + j].astype("<u4").tobytes() == column_hash(
                BLS12_377_FQ, col)


def test_blake2s_columns_match_backend_leaves():
    rng = np.random.default_rng(11)
    u = rand_canon(rng, (12, 32))
    want = np.asarray(Backend(BN254_FR)._column_leaves_device(u))
    got = hashops.blake2s_columns_ref(t(u)).numpy().view(np.uint32)
    assert np.array_equal(got, want)


def test_sha256_two_to_one_matches_hashlib():
    rng = np.random.default_rng(12)
    left = rng.bytes(32 * 5)
    right = rng.bytes(32 * 5)
    lw = np.frombuffer(left, ">u4").reshape(5, 8).astype(np.int64)
    rw = np.frombuffer(right, ">u4").reshape(5, 8).astype(np.int64)
    out = hashops.sha256_two_to_one(torch.from_numpy(lw), torch.from_numpy(rw))
    for i in range(5):
        want = hashlib.sha256(left[32 * i:32 * i + 32]
                              + right[32 * i:32 * i + 32]).digest()
        assert out[i].numpy().astype(">u4").tobytes() == want


@pytest.mark.parametrize("n", [2, 16, 64])
def test_tree_flat_and_digest_lists_match_backend(n):
    rng = np.random.default_rng(n)
    leaves = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64).astype(np.uint32)
    be = Backend(BN254_FR)
    leaves_t = torch.from_numpy(leaves.view(np.int32))
    flat = hashops.tree_flat(leaves_t).numpy()
    assert np.array_equal(flat.view(np.uint32), np.asarray(be._tree_flat(leaves)))
    port = TorchBackend(pf(BN254_FR), "cpu")
    assert hashops.digest_lists(port.to_numpy(cuda_tree.tree_flat(leaves_t)),
                                n) == be._digest_lists(leaves)


def test_wrapper_takes_plain_version_on_cpu():
    u = t(rand_canon(np.random.default_rng(13), (3, 4)))
    before = cuda_hash.launches.count
    assert torch.equal(cuda_hash.blake2s_columns(pf(BN254_FR), u), hashops.blake2s_columns_ref(u))
    assert cuda_hash.launches.count == before


@pytest.mark.cuda
@pytest.mark.parametrize("field", [BN254_FR, BLS12_377_FQ], ids=lambda f: f.name)
@pytest.mark.parametrize("rows,n", [(1, 5), (2, 33), (7, 128), (136, 512),
                                    (4, 64), (5, 64), (6, 64), (4103, 96)])
def test_blake2s_kernel_matches_plain(cuda, rows, n, field):
    u = t(rand_canon(np.random.default_rng(rows), (rows, n), field))
    got = cuda_hash.blake2s_columns(pf(field), u.to(cuda))
    assert torch.equal(got.cpu(), hashops.blake2s_columns_ref(u))
    # two matrices in one launch: each its own column hashes
    both = torch.cat([u, u.flip(0)])
    got = cuda_hash.blake2s_columns(pf(field), both.to(cuda), 2)
    assert torch.equal(got.cpu(), cuda_hash.blake2s_columns(pf(field), both, 2))
