"""The port's plain Blake2s column hashing and SHA-256 Merkle levels
(ligero_tpu_torch.engine.hashops) against hashlib, the host column hash and
the JAX package's numpy Backend commit helpers."""

import hashlib
import os
import re

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


# ---------------------------------------------------------------------------
# The column kernel's staging and the streamed entry's chunkings
# ---------------------------------------------------------------------------

BLAKE_CU = os.path.join(os.path.dirname(cuda_hash.__file__), "..", "csrc",
                        "blake2s_cols.cu")


def test_blake2s_batch_matches_column_hash_bn254():
    """Two stacked BN254 matrices of 5 rows (an odd count: the last block
    holds one row and the prefix's shift): each column's digest opens with
    its own matrix's row count."""
    u = rand_canon(np.random.default_rng(22), (10, 3))
    got = cuda_hash.blake2s_columns(pf(BN254_FR), t(u), 2).numpy().view(np.uint32)
    for b in range(2):
        for j in range(3):
            col = BN254_FR.limbs_to_ints(u[5 * b:5 * b + 5, j])
            assert got[3 * b + j].astype("<u4").tobytes() == column_hash(
                BN254_FR, col)


#: the smoke's absorb chunkings (chip_smoke.STREAM_PLAIN_CASES) cut further
#: in depth, each absorb's rows a multiple of 4 where the smoke's are, so
#: every absorb starts at the same offset in its 64-byte block
STREAM_CASES = ((16,) * 4 + (4,), (16,) * 4 + (4, 3),
                (68,) * 3 + (56,), (64,) * 3 + (60, 3))


@pytest.mark.parametrize("field", [BN254_FR, BLS12_377_FQ], ids=lambda f: f.name)
@pytest.mark.parametrize("cuts", STREAM_CASES, ids=lambda c: "+".join(map(str, c)))
def test_streamed_absorb_at_smoke_chunkings_matches_hashlib(field, cuts):
    """The plain streamed absorb of 16-bit chunks, chunk by chunk at the
    smoke's chunkings: after every chunk but the last the carried words
    are its last row's last two words, and the final digests are hashlib's
    Blake2s of each column's serialization."""
    import ligero_tpu_torch.engine.fieldops as fops
    L, rows = field.num_limbs, sum(cuts)
    u = rand_canon(np.random.default_rng(sum(cuts) + L), (rows, 2), field)
    u16 = fops.narrow16(t(u))
    state = hashops.blake2s_stream_start(2, rows, "cpu")
    blocks = r0 = 0
    for cr in cuts:
        final = r0 + cr == rows
        state = hashops.blake2s_absorb_ref(u16[r0:r0 + cr], cr, state, blocks,
                                           final, rows)
        if not final:
            last = t(u[r0 + cr - 1])
            want = (last[:, L - 4::2] | (last[:, L - 3::2] << 16))
            assert torch.equal(state[:, 8:], want), (cuts, r0)
        blocks += (2 + cr * L // 2) // 16
        r0 += cr
    got = state[:, :8].numpy().view(np.uint32)
    for j in range(2):
        col = field.limbs_to_ints(u[:, j])
        assert got[j].astype("<u4").tobytes() == column_hash(field, col)


def _kernel_block_stage(W: int, bb: int) -> int:
    """blake2s_cols.cu HashShape::block_stage, read from the source and
    evaluated with C's integer division."""
    with open(BLAKE_CU) as f:
        src = f.read()
    m = re.search(r"int block_stage\(int bb\) \{\s*return (.*?);", src, re.S)
    return eval(m.group(1).replace("/", "//"), {"bb": bb, "W": W})


@pytest.mark.parametrize("field", [BN254_FR, BLS12_377_FQ], ids=lambda f: f.name)
def test_kernel_block_stage_holds_every_word(field):
    """The kernel's ring holds two rows a stage and compresses block bb of
    a period in the stage where its last word arrives: every other word of
    the block lies in that stage or the one before (the two it reads),
    by the word map column_block_words."""
    W = field.num_limbs // 2
    E = hashops.period_rows(field.num_limbs)
    P = W * E // 16
    for bb in range(P):
        words = hashops.column_block_words(W, bb)
        stages = {row // 2 for row, _ in words if row >= 0}
        stage = _kernel_block_stage(W, bb)
        assert stage == max(stages), (bb, stages)
        assert min(stages) >= stage - 1, (bb, stages)
        assert 0 <= stage < E // 2


@pytest.mark.parametrize("field", [BN254_FR, BLS12_377_FQ], ids=lambda f: f.name)
@pytest.mark.parametrize("narrow", [False, True], ids=["int32", "16-bit"])
def test_hash_shared_memory_fits(field, narrow):
    """A block's ring (4 warps x 3 stages x 2 rows x 32 columns) fits the
    card's shared memory with three blocks an SM at least."""
    from ligero_tpu_torch.engine import staging
    smem = staging.hash_smem_bytes(field.num_limbs // 2, narrow)
    assert smem == 4 * 3 * 2 * 32 * (2 if narrow else 4) * field.num_limbs
    assert staging.SMEM_MAX // smem >= 3


@pytest.mark.parametrize("eb", [32, 48, 64, 96])
def test_stage_swizzle_is_free_of_bank_conflicts(eb):
    """A 16-byte read of chunk q by 8 neighbouring lanes (one phase of
    LDS.128) lands on 8 distinct 16-byte bank groups, and each element's
    chunks stay a permutation of its slots."""
    from ligero_tpu_torch.engine import staging
    for q in range(eb // 16):
        for first in range(0, 32, 8):
            groups = staging.phase_bank_groups(eb, q, range(first, first + 8))
            assert len(set(groups)) == 8, (eb, q, first, groups)
    for c in range(32):
        assert sorted(q ^ staging.stage_swizzle(eb, c)
                      for q in range(eb // 16)) == list(range(eb // 16))


@pytest.mark.cuda
@pytest.mark.parametrize("field", [BN254_FR, BLS12_377_FQ], ids=lambda f: f.name)
def test_blake2s_kernel_both_entries_match_plain(cuda, field):
    """Both entries: the whole-column kernel on ragged row counts and a
    batch of two, the streamed 16-bit entry at ragged chunkings, against
    the plain versions."""
    from ligero_tpu_torch.engine import fieldops as fops
    F = pf(field)
    for rows, n in ((1, 5), (7, 33), (103, 129), (4100, 70)):
        u = t(rand_canon(np.random.default_rng(rows + n), (rows, n), field))
        want = hashops.blake2s_columns_ref(u)
        got = cuda_hash.blake2s_columns(F, u.to(cuda))
        assert torch.equal(got.cpu(), want), (rows, n)
        both = torch.cat([u, u.flip(0)])
        got = cuda_hash.blake2s_columns(F, both.to(cuda), 2)
        assert torch.equal(got.cpu(), cuda_hash.blake2s_columns(F, both, 2))
        u16 = fops.narrow16(u)
        E = hashops.period_rows(field.num_limbs)
        for cr in (E, 3 * E, 1024):
            hs = cuda_hash.ColumnHashStream(F, n, rows, cuda)
            for r0 in range(0, rows, cr):
                hs.absorb(u16[r0:r0 + cr].to(cuda), min(cr, rows - r0))
            assert torch.equal(hs.digests().cpu(), want), (rows, n, cr)
