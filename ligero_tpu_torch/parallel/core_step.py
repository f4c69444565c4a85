"""The prover's compute core on the card: one device, and a mesh.

The port's counterpart of ``ligero_tpu/parallel/core_step.py``: the
prover's bulk phase as one function,

    preenc (4m x k)  --iNTT_k, NTT_n with the canonical epilogue-->  U (4m x n)
                     --Blake2s columns (u64 row count 4m, then elements)-->
                     leaves  --SHA-256 tree-->  Merkle root
    plus the interleaved combination  lc = r^T preenc  (k)

on the hand-written kernels: ``csrc/ntt.cu`` (both transforms, the
canonical epilogue fused into NTT_n), ``csrc/blake2s_cols.cu`` (which reads
the canonical limbs in place: the JAX package's ``_column_words``
serialisation has no counterpart here), ``csrc/sha256_tree.cu`` and
``csrc/row_combine.cu``; on the CPU their plain versions.  Both fields the
kernels take, BN254 Fr and BLS12-377 Fq.  The JAX functions' TPU switches
(``unroll``, ``row_chunk``, ``use_pallas``, ``use_pallas_hash``, the
``LIGERO_MXU_*`` variables) choose among XLA and Pallas routes; here there
is one route and no switch.

Tensors are the port's: (..., L) int32 limbs of 16 bits, Montgomery for
``preenc``, ``r`` and ``lc``, canonical for U; digests are (..., 8) int32
words, the leaves little-endian and the roots big-endian (the JAX
functions' uint32 words, bit for bit).

The sharded core follows the JAX package's design over a
:class:`~.sharded_backend.RowMesh`: each device encodes its own row block
with no communication; a row -> column re-shard (the all_to_all) hands
device d columns [d n/D, (d + 1) n/D) of every row; each device hashes its
columns and reduces its subtree with the tree kernel; the controller
finishes the top log2 D levels over the D subtree roots and adds the D
partial combinations mod p.  Its outputs are the single core's.  Over a
:class:`~.sharded_backend.ProcessRowMesh` (one device a process,
``parallel.multihost``) every rank runs the same function on the same
inputs and does its own device's part: it encodes its row block, the
re-shard is an all_to_all, it hashes its columns and reduces its subtree,
and an all_gather of the D subtree roots and of the D partial combinations
lets every rank finish the top levels and the sum in rank order: root and
lc replicated on every rank, as the JAX function's are.
"""

from __future__ import annotations

import torch

from ..engine import cuda_hash, cuda_tree, hashops
from ..engine.backend import TorchBackend
from ..fields import FieldSpec
from .sharded_backend import RowMesh, ShardedBackend, on_device

#: the sharded core's truncations, for per-phase attribution: the encode;
#: + the re-shard; + the column hashes and subtrees; + the tree's top and
#: the combination
STAGES = ("encode", "encode+a2a", "encode+a2a+hash", "full")


def _check(preenc, r, four_m: int, k: int, L: int) -> None:
    if tuple(preenc.shape) != (four_m, k, L) or tuple(r.shape) != (four_m, L):
        raise ValueError(f"prover core: preenc {tuple(preenc.shape)} and r "
                         f"{tuple(r.shape)} for 4m = {four_m}, k = {k}, "
                         f"L = {L}")


def make_prover_core(field: FieldSpec, four_m: int, k: int, n: int,
                     device=None):
    """The single-device core on ``device`` (``None``: the CUDA device;
    ``"cpu"``: the plain versions).

    Returns ``fn(preenc (4m, k, L) Montgomery, r (4m, L) Montgomery) ->
    (u_canon (4m, n, L) canonical, leaves_le (n, 8), root_be (8,), lc
    (k, L) Montgomery)``, tensors on the device (inputs may be host arrays
    or tensors anywhere)."""
    be = TorchBackend(field, device)
    if n < 2 or n & (n - 1):
        raise ValueError(f"prover core: n = {n} is not a power of two >= 2")

    def fn(preenc, r):
        preenc, r = be.asarray(preenc), be.asarray(r)
        _check(preenc, r, four_m, k, be.L)
        u_canon = be.rs_encode_and_canon(preenc, k, n)[1]
        leaves_le = cuda_hash.blake2s_columns(field, u_canon)
        root = cuda_tree.tree_root(leaves_le)
        return u_canon, leaves_le, root, be.row_combine(r, preenc)

    return fn


def make_sharded_prover_core(field: FieldSpec, mesh, four_m: int, k: int,
                             n: int, stage: str = "full"):
    """The core over ``mesh`` (a :class:`RowMesh` or a list of devices; a
    device may repeat), one controller issuing every device's work.

    Returns ``fn(preenc, r)`` with the JAX function's ``stage``
    truncations, each stage's outputs materialised; an output sharded over
    the mesh is a list of its D per-device tensors in mesh order:

    * ``"encode"``: ``(u_blocks,)``, the (4m/D, n, L) canonical row blocks;
    * ``"encode+a2a"``: ``(u_blocks, u_cols)``, + the (4m, n/D, L) column
      blocks after the re-shard;
    * ``"encode+a2a+hash"``: ``(u_blocks, leaves, subtree_roots)``, + the
      (n/D, 8) LE leaf words of each device and the (D, 8) BE roots of
      their subtrees, on the controller;
    * ``"full"``: ``(u_blocks, leaves, root_be (8,), lc (k, L))``, root and
      lc on the controller.

    Concatenated, the blocks are :func:`make_prover_core`'s outputs, bit
    for bit.  Over a process mesh a sharded output lists this rank's block
    alone, and the subtree roots, root and lc are on every rank.  As the
    JAX function asserts: 4m and n divisible by D, D and n/D powers of
    two."""
    mesh = mesh if isinstance(mesh, RowMesh) else RowMesh(mesh)
    D = mesh.size
    if stage not in STAGES:
        raise ValueError(f"prover core: stage {stage!r} is not one of "
                         f"{STAGES}")
    assert four_m % D == 0, "4m must divide the mesh"
    assert n % D == 0, "n must divide the mesh"
    # the pairwise Merkle reductions (local subtree + gathered-roots top)
    # assume power-of-two node counts at every level
    assert D & (D - 1) == 0, "device count must be a power of two"
    assert (n // D) & (n // D - 1) == 0, \
        "per-device leaf count must be a power of two"
    be = ShardedBackend(field, mesh)

    def fn(preenc, r):
        _check(preenc, r, four_m, k, be.L)
        rows = be.row_matrix(preenc)           # row block d on device d
        u = be.ntt_and_canon(be.intt(rows, k), n)
        u_blocks = [blk for blk in u.blocks if blk is not None]
        if stage == "encode":
            return (u_blocks,)
        blocks = be.column_blocks(u)        # the re-shard, a device at a time
        if stage == "encode+a2a":
            return u_blocks, [blk[0] for blk in blocks]
        leaves, roots = [], []
        for blk in blocks:
            with on_device(blk.device):
                lv = cuda_hash.blake2s_columns(field, blk[0])
                roots.append((cuda_tree.tree_root(lv) if lv.shape[0] > 1
                              else hashops.byteswap_words(lv[0]))
                             .to(be.device))
            leaves.append(lv)
            del blk
        roots = (torch.stack(roots) if be.comm is None          # (D, 8) BE
                 else torch.stack(be.comm.all_gather(roots[0])))
        if stage == "encode+a2a+hash":
            return u_blocks, leaves, roots
        with on_device(be.device):
            root = (roots[0] if D == 1 else
                    cuda_tree.tree_root(hashops.byteswap_words(roots)))
        return u_blocks, leaves, root, be.row_combine(be.asarray(r), rows)

    return fn
