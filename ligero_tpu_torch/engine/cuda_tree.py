"""SHA-256 Merkle tree: the CUDA kernel ``csrc/sha256_tree.cu`` and its
wrapper.

Replaces ``ligero_tpu/engine/pallas_tree.py:_tree_kernel_factory``
(``sha256_tree_root_pallas``), widened to every level: the prover's commit
needs all levels for its Merkle paths (:func:`tree_flat`), a root-only
caller takes the last digest (:func:`tree_root`).  On this card the tree is
bound by its dependent chain (log2 n levels of two 64-round compressions),
not by memory or instruction rate: 2 (n - 1) compressions are little work.  The kernel
reduces 1024-node subtrees per block in shared memory and finishes the
subtree roots in a second one-block launch.

A tensor on the CPU takes the plain version (:func:`hashops.tree_flat`); a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from . import cuda_build, hashops

#: kernel launches by :func:`tree_flat` (one per call; a call runs one
#: kernel per factor of 1024 in n, rounded up)
launches = cuda_build.LaunchCounter()


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
    cuda_build.require_cuda_tensors("tree_flat", leaves_le, out)
    lib = cuda_build.library()
    cuda_build.check(lib.lt_sha256_tree(leaves_le.data_ptr(), n, out.data_ptr(),
                                        cuda_build.stream_handle(leaves_le.device)),
                     "lt_sha256_tree")
    launches.add()
    return out


def tree_root(leaves_le: torch.Tensor) -> torch.Tensor:
    """The Merkle root's 8 BE words as int32 bits."""
    return tree_flat(leaves_le)[-8:]
