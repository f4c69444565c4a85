"""SHA-256 Merkle tree: the CUDA kernel ``csrc/sha256_tree.cu`` and its
wrapper.

Replaces ``ligero_tpu/engine/pallas_tree.py:_tree_kernel_factory``
(``sha256_tree_root_pallas``), widened to every level: the prover's commit
needs all levels for its Merkle paths (:func:`tree_flat`), a root-only
caller takes the last digest (:func:`tree_root`).  On this card the tree is
bound by its dependent chain (log2 n levels of two 64-round compressions),
not by memory or instruction rate: 2 (n - 1) compressions are little work.
So the kernel keeps everything else off the chain: one launch, a warp per
64 nodes across the whole card (128 or 256 leaves a warp in a tree too wide
for that), levels handed between lanes by shuffles,
and a ticket per group of 64 roots that lets the block that finishes last
go on one step up (:func:`tree_steps` is that schedule).

A tensor on the CPU takes the plain version (:func:`hashops.tree_flat`); a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import cuda_build, hashops

#: kernel launches by :func:`tree_flat` (one per call, one kernel each)
launches = cuda_build.LaunchCounter()

#: log2 of the nodes one warp reduces to one (``GROUP_LOG`` of the source)
GROUP_LOG = 6

_COUNTERS: dict = {}


def level_offset(n: int, level: int) -> int:
    """Word offset of tree level ``level`` (0: the leaves, n >> level
    nodes) in the flat output."""
    return 0 if level == 0 else 8 * (2 * n - 2 * (n >> level))


def leaf_passes(n: int) -> int:
    """Passes of 64 leaves a warp hashes at the bottom (J of the kernel):
    1 up to 32768 leaves (512 warps, one to a scheduler of the card's 132
    SMs), then 2 and at most 4, which keeps a wider tree's first levels
    about one warp deep too."""
    return max(1, min(4, n >> 15))


def tree_steps(n: int) -> list[tuple[int, int, int, int]]:
    """The kernel's schedule for n leaves: one ``(input level, groups,
    nodes a group, counter base)`` per step.  Step 0 is every block's own
    ``64 leaf_passes(n)`` leaves; a later step's group of up to 64 roots is
    taken by the block that drew the last ticket of counter ``base +
    group``."""
    steps, level, width, base = [], 0, n, 0
    while width > 1:
        cnt = min(width, (1 << GROUP_LOG) * (1 if level else leaf_passes(n)))
        groups = width // cnt
        steps.append((level, groups, cnt, base))
        if level:
            base += groups
        level += cnt.bit_length() - 1
        width = groups
    return steps


def counter_words(n: int) -> int:
    """Ticket counters a tree of n leaves needs (at least one word)."""
    return max(1, sum(groups for level, groups, _, _ in tree_steps(n) if level))


def _counters(n: int, device, stream: int) -> torch.Tensor:
    """Zeroed ticket counters on ``device``; the kernel leaves them zeroed,
    so one tensor serves every launch on a stream (trees on two streams may
    run side by side, so each stream has its own)."""
    key = (str(device), stream)
    have = _COUNTERS.get(key)
    if have is None or have.numel() < counter_words(n):
        have = torch.zeros(counter_words(n), dtype=torch.int32, device=device)
        _COUNTERS[key] = have
    return have


def tree_flat(leaves_le: torch.Tensor) -> torch.Tensor:
    """(n, 8) int32 LE leaf digest words, n a power of two >= 2 -> the flat
    int32 vector of ``hashops.tree_flat``: the leaves' LE words, then every
    SHA-256 level's BE words bottom-up."""
    if leaves_le.device.type == "cpu":
        return hashops.tree_flat(leaves_le)
    n = leaves_le.shape[0]
    if leaves_le.dim() != 2 or leaves_le.shape[1] != 8 or n < 2 or n & (n - 1):
        raise ValueError("tree_flat: leaves must be (n, 8) with n a power of "
                         f"two >= 2, got {tuple(leaves_le.shape)}")
    leaves_le = leaves_le.contiguous()
    out = torch.empty(8 * (2 * n - 1), dtype=torch.int32,
                      device=leaves_le.device)
    stream = cuda_build.stream_handle(leaves_le.device)
    counters = _counters(n, leaves_le.device, stream)
    cuda_build.require_cuda_tensors("tree_flat", leaves_le, out, counters)
    lib = cuda_build.library()
    cuda_build.check(lib.lt_sha256_tree(leaves_le.data_ptr(), n, out.data_ptr(),
                                        counters.data_ptr(), leaf_passes(n),
                                        stream), "lt_sha256_tree")
    launches.add()
    return out


def forest_flat(leaves_le: torch.Tensor) -> torch.Tensor:
    """(B, n, 8) leaf digest words of B trees -> (B, 8 (2 n - 1)): one
    :func:`tree_flat` launch per tree, all on the current stream, where each
    finds the ticket counters zeroed by the one before."""
    return torch.stack([tree_flat(leaves) for leaves in leaves_le])


def tree_root(leaves_le: torch.Tensor) -> torch.Tensor:
    """The Merkle root's 8 BE words as int32 bits."""
    return tree_flat(leaves_le)[-8:]


def chain_probe_ms(iters: int, device) -> float:
    """Milliseconds one warp takes for ``iters`` two-to-one hashes, each of
    the one before, with the card otherwise idle: the dependent latency a
    tree of log2 n levels cannot go below is ``log2 n / iters`` of it."""
    out = torch.empty(256, dtype=torch.int32, device=device)
    cuda_build.require_cuda_tensors("chain_probe", out)
    lib = cuda_build.library()
    stream = cuda_build.stream_handle(out.device)
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    cuda_build.check(lib.lt_sha256_chain_probe(out.data_ptr(), iters, stream),
                     "lt_sha256_chain_probe")  # warm-up
    start.record()
    cuda_build.check(lib.lt_sha256_chain_probe(out.data_ptr(), iters, stream),
                     "lt_sha256_chain_probe")
    stop.record()
    torch.cuda.synchronize(out.device)
    return start.elapsed_time(stop)
