"""The prover's compute core (``ligero_tpu_torch.parallel.core_step``) on
the CPU: ``make_prover_core`` and ``make_sharded_prover_core`` over
``["cpu"] * D`` against the JAX package's ``make_prover_core`` run by jax
on the CPU (no Pallas), as ``tests/test_parallel.py`` runs it, and against
the host reference (numpy ``Backend``, hashlib column hashes, the host
Merkle tree).

Inputs are made from a seed with numpy, in both fields, at 4m = 16, k =
16, n = 128; the tolerance is none: U, the leaves, the root and lc are
bit-exact, for the single core and for every stage of the sharded core at
D = 2 and 4."""

import functools

import numpy as np
import pytest
import torch

from ligero_tpu.engine.backend import Backend
from ligero_tpu.engine.hashops import be_words_to_bytes, words_to_le_bytes
from ligero_tpu.fields import BLS12_377_FQ, BN254_FR
from ligero_tpu.hashes import column_hash
from ligero_tpu.merkle import MerkleTree
from ligero_tpu_torch.engine import cuda_tree
from ligero_tpu_torch.fields import FIELDS as PORT_FIELDS
from ligero_tpu_torch.parallel import (make_prover_core,
                                       make_sharded_prover_core)
from ligero_tpu_torch.parallel.core_step import STAGES

# one intra-op thread: the workers of the suite share the host's cores
torch.set_num_threads(1)

FIELDS = {"bn254": BN254_FR, "bls12_377": BLS12_377_FQ}
FOUR_M, K, N = 16, 16, 128


def words(t) -> np.ndarray:
    """A port tensor's int32 limbs or digest words as the JAX package's
    uint32."""
    return t.numpy().view(np.uint32)


@functools.lru_cache(maxsize=None)
def host_reference(name: str):
    """(preenc (4m, k, L), r (4m, L) Montgomery limbs, the host
    reference's (u_canon, leaf digests, root, lc)): numpy engine, hashlib
    commitment (no jax: the CUDA twin runs where there is none)."""
    field = FIELDS[name]
    rng = np.random.default_rng(len(name))
    preenc = field.ints_to_mont_limbs(
        [int(x) for x in rng.integers(0, 2**62, FOUR_M * K)]
    ).reshape(FOUR_M, K, field.num_limbs)
    r = field.ints_to_mont_limbs(
        [int(x) for x in rng.integers(0, 2**62, FOUR_M)])
    be = Backend(field)
    _, evals = be.rs_encode_rows(preenc, K, N)
    u_canon = be.to_numpy(be.from_mont(evals))
    leaves = [column_hash(field, field.limbs_to_ints(u_canon[:, j]))
              for j in range(N)]
    return preenc, r, (u_canon, leaves, MerkleTree(leaves).root,
                       np.asarray(be.row_combine(r, preenc)))


@functools.lru_cache(maxsize=None)
def inputs_and_reference(name: str):
    """(preenc, r, the JAX core's (u_canon, leaves_le, root_be, lc) run by
    jax on the CPU), the JAX core checked against the host reference."""
    import jax

    from ligero_tpu.parallel import make_prover_core as jax_prover_core
    preenc, r, (u_canon, leaves, root, lc) = host_reference(name)
    out = tuple(np.asarray(x) for x in jax.jit(
        jax_prover_core(FIELDS[name], FOUR_M, K, N))(preenc, r))
    assert np.array_equal(out[0], u_canon)
    assert [words_to_le_bytes(w) for w in out[1]] == leaves
    assert be_words_to_bytes(out[2]) == root
    assert np.array_equal(out[3], lc)
    return preenc, r, out


@pytest.mark.parametrize("name", list(FIELDS))
def test_prover_core_equals_jax_core_and_host(name):
    preenc, r, (u, leaves, root, lc) = inputs_and_reference(name)
    fn = make_prover_core(PORT_FIELDS[FIELDS[name].name], FOUR_M, K, N,
                          device="cpu")
    got = fn(preenc, r)
    assert [t.device.type for t in got] == ["cpu"] * 4
    for have, want in zip(got, (u, leaves, root, lc)):
        assert np.array_equal(words(have), want)
    # the port's own tensors in, the same out
    again = fn(torch.from_numpy(preenc.astype(np.int32)),
               torch.from_numpy(r.astype(np.int32)))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("D", [2, 4])
@pytest.mark.parametrize("name", list(FIELDS))
def test_sharded_prover_core_equals_jax_core(name, D, stage):
    preenc, r, (u, leaves, root, lc) = inputs_and_reference(name)
    fn = make_sharded_prover_core(PORT_FIELDS[FIELDS[name].name],
                                  ["cpu"] * D, FOUR_M, K, N, stage=stage)
    out = fn(preenc, r)
    assert len(out) == {"encode": 1, "encode+a2a": 2, "encode+a2a+hash": 3,
                        "full": 4}[stage]
    u_blocks = out[0]
    assert [tuple(b.shape) for b in u_blocks] == [
        (FOUR_M // D, N, preenc.shape[-1])] * D
    assert np.array_equal(words(torch.cat(u_blocks)), u)
    if stage == "encode+a2a":
        assert [tuple(b.shape[:2]) for b in out[1]] == [(FOUR_M, N // D)] * D
        assert np.array_equal(words(torch.cat(out[1], dim=1)), u)
    if stage in ("encode+a2a+hash", "full"):
        assert np.array_equal(words(torch.cat(out[1])), leaves)
    if stage == "encode+a2a+hash":
        # each device's subtree root: the tree's level log2(n / D)
        flat = words(cuda_tree.tree_flat(torch.from_numpy(
            leaves.astype(np.int32))))
        level = (N // D).bit_length() - 1
        off = cuda_tree.level_offset(N, level)
        assert np.array_equal(words(out[2]), flat[off:off + 8 * D].reshape(
            D, 8))
    if stage == "full":
        assert np.array_equal(words(out[2]), root)
        assert np.array_equal(words(out[3]), lc)


def test_sharded_prover_core_keeps_the_jax_asserts():
    field = PORT_FIELDS[BN254_FR.name]
    with pytest.raises(AssertionError, match="power of two"):
        make_sharded_prover_core(field, ["cpu"] * 3, 24, K, 96)
    with pytest.raises(AssertionError, match="4m must divide"):
        make_sharded_prover_core(field, ["cpu"] * 4, 18, K, N)
    with pytest.raises(AssertionError, match="leaf count"):
        make_sharded_prover_core(field, ["cpu"] * 2, FOUR_M, K, 96)
    with pytest.raises(ValueError, match="stage"):
        make_sharded_prover_core(field, ["cpu"] * 2, FOUR_M, K, N,
                                 stage="hash")
    # one leaf a device (n = D = 16): the subtree roots are the leaves,
    # byte-swapped
    preenc, r, _ = inputs_and_reference("bn254")
    few = make_sharded_prover_core(field, ["cpu"] * 16, FOUR_M, K, 16)(
        preenc, r)
    whole = make_prover_core(field, FOUR_M, K, 16, device="cpu")(preenc, r)
    for have, want in zip(few, whole):
        assert torch.equal(torch.cat(have) if isinstance(have, list)
                           else have, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(FIELDS))
def test_prover_cores_on_cuda_equal_cpu(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    preenc, r, (u, leaves, root, lc) = host_reference(name)
    field = PORT_FIELDS[FIELDS[name].name]
    got = make_prover_core(field, FOUR_M, K, N, device="cuda")(preenc, r)
    assert [t.device.type for t in got] == ["cuda"] * 4
    assert np.array_equal(words(got[0].cpu()), u)
    assert [words_to_le_bytes(w) for w in words(got[1].cpu())] == leaves
    assert be_words_to_bytes(words(got[2].cpu())) == root
    assert np.array_equal(words(got[3].cpu()), lc)
    for D in (2, 4):
        out = make_sharded_prover_core(field, ["cuda:0"] * D, FOUR_M, K,
                                       N)(preenc, r)
        for have, want in zip(out, got):
            assert torch.equal(torch.cat(have) if isinstance(have, list)
                               else have, want)
