"""The port's graft entry points (``ligero_tpu_torch.graft_entry``, the
counterpart of ``__graft_entry__.py``) on the CPU: ``entry("cpu")`` gives
the single prover core at the JAX entry's CPU shapes, whose outputs equal
the JAX package's host golden; ``dryrun_multichip(2, device="cpu")`` runs
the sharded core and the JAX entry's 600-gate proof over a mesh of two CPU
shards, in direct and streaming mode, each byte-equal to one device's and
to the JAX package's numpy-backend proof.  Inputs are made from a seed
with numpy; the tolerance is none (exact integer arithmetic)."""

import numpy as np
import pytest
import torch

from ligero_tpu.engine.backend import Backend
from ligero_tpu.fields import BN254_FR
from ligero_tpu.hashes import column_hash
from ligero_tpu.ligero import LigeroCircuit as RefCircuit
from ligero_tpu.merkle import MerkleTree
from ligero_tpu.sponge import test_sponge
from ligero_tpu.synthetic import generate_random_circuit
from ligero_tpu_torch import graft_entry

# one intra-op thread: the workers of the suite share the host's cores
torch.set_num_threads(1)


def test_entry_gives_the_core_at_the_cpu_shapes():
    fn, (preenc, r) = graft_entry.entry("cpu")
    four_m, k, n = graft_entry._example_shapes()
    L = BN254_FR.num_limbs
    assert tuple(preenc.shape) == (four_m, k, L)
    assert preenc.device.type == "cpu"
    u, leaves, root, lc = fn(preenc, r)
    assert tuple(u.shape) == (four_m, n, L) and tuple(leaves.shape) == (n, 8)
    pre, rr = (t.numpy().view(np.uint32) for t in (preenc, r))
    be = Backend(BN254_FR)
    _, evals = be.rs_encode_rows(pre, k, n)
    u_h = be.to_numpy(be.from_mont(evals))
    assert np.array_equal(u.numpy().view(np.uint32), u_h)
    host = [column_hash(BN254_FR, BN254_FR.limbs_to_ints(u_h[:, j]))
            for j in range(n)]
    assert (root.numpy().view(np.uint32).astype(">u4").tobytes()
            == MerkleTree(host).root)
    assert np.array_equal(lc.numpy().view(np.uint32),
                          be.to_numpy(be.row_combine(rr, pre)))


def test_entry_and_the_dryrun_take_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="cuda"):
        graft_entry.dryrun_multichip(2)


def test_dryrun_multichip_proofs_equal_one_device_and_the_jax_package():
    res = graft_entry.dryrun_multichip(2, device="cpu")
    assert res["devices"] == ["cpu", "cpu"]
    c, outs, vars_ = generate_random_circuit(
        BN254_FR, graft_entry.PROOF_GATES, num_vars=graft_entry.PROOF_VARS,
        seed=graft_entry.PROOF_SEED)
    want = RefCircuit(c, outs, backend=Backend(BN254_FR)).prove(
        vars_, test_sponge(BN254_FR)).to_bytes(BN254_FR)
    assert res["proof"] == want
    # streaming mode really cut the rows: more chunks than shards
    assert 0 < res["chunk_rows"] and -(-res["rows"] // res["chunk_rows"]) > 2
