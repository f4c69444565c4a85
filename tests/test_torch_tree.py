"""The SHA-256 Merkle tree of the port: the plain version
(ligero_tpu_torch.engine.hashops.tree_flat / tree_root, the CPU path of the
sha256_tree kernel's wrapper) against the JAX package's level-by-level
reference (HashKernel.sha256_two_to_one on numpy, the oracle of
sha256_tree_root_pallas) and against hashlib.  Tolerance: none, bits."""

import hashlib
import os
import re

import numpy as np
import pytest
import torch

from ligero_tpu.engine.hashops import HashKernel
from ligero_tpu_torch.engine import cuda_tree, hashops
from ligero_tpu_torch.merkle import MerkleTree

# the suite runs in several worker processes that share the host's cores, and
# these tests run many small tensor ops: one intra-op thread each, or the
# workers' thread pools spin against each other
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [2, 4, 8, 64, 512, 1024, 2048, 4096]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def rand_leaves(seed: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64).astype(np.uint32)


def t(leaves: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(leaves.view(np.int32))


def reference_flat(leaves: np.ndarray) -> np.ndarray:
    """The JAX package's levels on numpy: LE leaves, byte-swapped once,
    then sha256_two_to_one level by level."""
    hk = HashKernel(np)
    level = leaves.astype("<u4").view(np.uint8).view(">u4").astype(np.uint32)
    level = level.reshape(-1, 8)
    parts = [leaves.reshape(-1)]
    while level.shape[0] > 1:
        level = np.asarray(hk.sha256_two_to_one(level[0::2], level[1::2]),
                           dtype=np.uint32)
        parts.append(level.reshape(-1))
    return np.concatenate(parts)


def hashlib_levels(leaves: np.ndarray) -> list[list[bytes]]:
    cur = [leaves[i].astype("<u4").tobytes() for i in range(leaves.shape[0])]
    levels = []
    while len(cur) > 1:
        cur = [hashlib.sha256(cur[2 * i] + cur[2 * i + 1]).digest()
               for i in range(len(cur) // 2)]
        levels.append(cur)
    return levels


@pytest.mark.parametrize("n", SIZES)
def test_tree_flat_matches_jax_package_levels(n):
    leaves = rand_leaves(n, n)
    got = hashops.tree_flat(t(leaves)).numpy().view(np.uint32)
    assert got.shape == (8 * (2 * n - 1),)
    assert np.array_equal(got, reference_flat(leaves))


@pytest.mark.parametrize("n", SIZES)
def test_tree_flat_and_root_match_hashlib(n):
    leaves = rand_leaves(100 + n, n)
    flat = hashops.tree_flat(t(leaves)).numpy()
    got_leaves, got_levels = hashops.digest_lists(flat, n)
    want_levels = hashlib_levels(leaves)
    assert got_leaves == [leaves[i].astype("<u4").tobytes() for i in range(n)]
    assert got_levels == want_levels
    root = hashops.tree_root(t(leaves)).numpy().view(np.uint32)
    assert root.astype(">u4").tobytes() == want_levels[-1][0]
    tree = MerkleTree(got_leaves, inner_levels=got_levels)
    assert tree.root == MerkleTree(got_leaves).root
    for j in (0, n - 1, n // 2):
        assert tree.generate_proof(j).verify(tree.root, got_leaves[j])


@pytest.mark.parametrize("n", [2, 64, 2048])
def test_wrapper_takes_plain_version_on_cpu(n):
    leaves = t(rand_leaves(7, n))
    before = cuda_tree.launches.count
    assert torch.equal(cuda_tree.tree_flat(leaves), hashops.tree_flat(leaves))
    assert torch.equal(cuda_tree.tree_root(leaves), hashops.tree_root(leaves))
    assert cuda_tree.launches.count == before


def test_kernel_source_constants_match_the_schedule():
    """The round constants and the folded padding-block schedule written
    out in csrc/sha256_tree.cu are SHA_K and SHA_K + W_pad of the plain
    version."""
    with open(os.path.join(REPO, "ligero_tpu_torch", "csrc",
                           "sha256_tree.cu")) as f:
        src = f.read()

    def table(name):
        body = re.search(name + r"\[64\] = \{(.*?)\};", src, re.S).group(1)
        return [int(x, 16) for x in re.findall(r"0x([0-9a-f]{8})u", body)]

    assert table("SHA_K") == hashops._SHA_K
    assert table("PAD_KW") == [(k + w) & 0xFFFFFFFF for k, w in
                               zip(hashops._SHA_K, hashops._PAD_SCHEDULE)]
    assert hashops._PAD_SCHEDULE[:16] == [0x80000000] + [0] * 14 + [512]


def tree_by_steps(leaves: np.ndarray) -> np.ndarray:
    """The flat tree built the kernel's way on the host: by
    cuda_tree.tree_steps' schedule, every group of nodes (64, or a wide
    tree's 128 or 256 leaves) reduced on its own, every level written at
    cuda_tree.level_offset."""
    n = leaves.shape[0]
    hk = HashKernel(np)
    out = np.zeros(8 * (2 * n - 1), dtype=np.uint32)
    out[:8 * n] = leaves.reshape(-1)
    counters = np.zeros(cuda_tree.counter_words(n), dtype=np.int64)
    for level, groups, cnt, base in cuda_tree.tree_steps(n):
        for g in range(groups):
            if level == 0:
                nodes = leaves[g * cnt:(g + 1) * cnt].astype("<u4").view(
                    np.uint8).view(">u4").astype(np.uint32).reshape(cnt, 8)
            else:
                off = cuda_tree.level_offset(n, level) + 8 * g * cnt
                nodes = out[off:off + 8 * cnt].reshape(cnt, 8)
                counters[base + g] += cnt      # one ticket per input root
            lv, wd = level, cnt
            while wd > 1:
                nodes = np.asarray(hk.sha256_two_to_one(nodes[0::2], nodes[1::2]),
                                   dtype=np.uint32)
                lv, wd = lv + 1, wd // 2
                off = cuda_tree.level_offset(n, lv) + 8 * g * wd
                assert not out[off:off + 8 * wd].any()   # written once
                out[off:off + 8 * wd] = nodes.reshape(-1)
    # every counter drew exactly its group's tickets
    want = [cnt for level, groups, cnt, _ in cuda_tree.tree_steps(n) if level
            for _ in range(groups)]
    assert counters.tolist()[:len(want)] == want
    return out


@pytest.mark.parametrize("log_n", range(1, 19))
def test_kernel_schedule_and_offsets_give_the_flat_layout(log_n):
    n = 1 << log_n
    steps = cuda_tree.tree_steps(n)
    # levels: offsets are the running sum of the level widths
    for lv in range(log_n + 1):
        assert cuda_tree.level_offset(n, lv) == 8 * sum(
            n >> j for j in range(lv))
    # the steps' levels chain up to the root: 64 J leaves a block (J = 1 up
    # to 32768 leaves, then 2, then 4), 64 nodes a group above, until the last
    passes = cuda_tree.leaf_passes(n)
    assert passes == {15: 1, 16: 2}.get(log_n, 1 if log_n < 15 else 4)
    assert steps[0][:3] == (0, max(1, n // (64 * passes)), min(n, 64 * passes))
    level = 0
    for lv, groups, cnt, base in steps:
        assert lv == level and groups * cnt == n >> level
        assert cnt == min(n >> level, 64 * (1 if level else passes))
        level += cnt.bit_length() - 1
    assert level == log_n and steps[-1][1] == 1
    if log_n <= 12 or log_n == 16:    # the host emulation hashes every node
        leaves = rand_leaves(log_n, n)
        assert np.array_equal(
            tree_by_steps(leaves),
            hashops.tree_flat(t(leaves)).numpy().view(np.uint32))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4, 32, 64, 128, 512, 1024, 2048, 4096, 8192,
                               16384, 32768, 65536, 131072])
def test_tree_kernel_matches_plain(cuda, n):
    before = cuda_tree.launches.count
    reps = 20 if n <= 65536 else 3
    for rep in range(reps):
        leaves = t(rand_leaves(1000 * rep + n, n))
        got = cuda_tree.tree_flat(leaves.to(cuda))
        assert torch.equal(got.cpu(), hashops.tree_flat(leaves)), (n, rep)
    assert cuda_tree.launches.count == before + reps
    assert torch.equal(cuda_tree.tree_root(leaves.to(cuda)).cpu(),
                       hashops.tree_root(leaves))


@pytest.mark.cuda
def test_tree_kernel_same_input_100_times(cuda):
    """A wrong last-block handshake shows as a rare stale read: the same
    leaves give the same tree 100 times running, and the ticket counters
    are back at 0 after every launch."""
    leaves = t(rand_leaves(5, 16384))
    want = hashops.tree_flat(leaves).to(cuda)
    dev = leaves.to(cuda)
    for rep in range(100):
        assert torch.equal(cuda_tree.tree_flat(dev), want), rep
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert not bool(cuda_tree._counters(16384, cuda, stream).any())


@pytest.mark.cuda
def test_tree_kernel_on_two_streams_at_once(cuda):
    """Each stream draws its tickets from counters of its own, so trees that
    run side by side do not take each other's."""
    leaves = [t(rand_leaves(40 + i, 16384)) for i in range(2)]
    want = [hashops.tree_flat(x).to(cuda) for x in leaves]
    dev = [x.to(cuda) for x in leaves]
    streams = [torch.cuda.Stream(device=cuda) for _ in range(2)]
    torch.cuda.synchronize(cuda)
    got = [[], []]
    for rep in range(50):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                got[i].append(cuda_tree.tree_flat(dev[i]))
    torch.cuda.synchronize(cuda)
    for i in range(2):
        assert all(torch.equal(g, want[i]) for g in got[i]), i


@pytest.mark.cuda
def test_tree_kernel_rejects_bad_shapes(cuda):
    for shape in [(3, 8), (1, 8), (4, 7)]:
        with pytest.raises(ValueError):
            cuda_tree.tree_flat(torch.zeros(shape, dtype=torch.int32,
                                            device=cuda))
    with pytest.raises(TypeError):
        cuda_tree.tree_flat(torch.zeros((4, 8), dtype=torch.int64, device=cuda))
