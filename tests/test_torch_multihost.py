"""The port's multi-process mesh on the CPU: ``parallel.multihost`` on
``torch.distributed`` (gloo), and its collective layer.

Two ranks of ``scripts/torch_multihost_worker.py`` (the port's counterpart
of ``scripts/multihost_worker.py``; they import neither jax nor the JAX
package) join one process group, take the global row mesh of one CPU
device each, and run the sharded core on the JAX worker's seeded inputs
and proofs of the JAX worker's circuit: plain in direct mode, plain in
streaming mode (forced by the memory budget) and zk in direct mode (and,
in a run of its own, a batch of two plain ones), each verified on every
rank.  Both ranks' outputs equal each other and the JAX
package's, byte for byte: the core's root and lc against the host golden
(``Backend(F)``, ``column_hash``, ``MerkleTree``), the proofs against
``ligero_tpu.ligero.LigeroCircuit(..., backend=Backend(F))``.  The
tolerance is none (exact integer arithmetic).

The collective layer (``parallel/collectives.py``) in a process group of
one: shapes and order of all_gather and all_to_all, empty pieces, the host
staging's byte count; ``initialize`` and ``global_row_mesh``'s choices; a
process mesh of one rank proving as one device does."""

import functools
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from ligero_tpu.engine.backend import Backend
from ligero_tpu.fields import BLS12_377_FQ, BN254_FR
from ligero_tpu.hashes import column_hash
from ligero_tpu.ligero import LigeroCircuit as RefCircuit
from ligero_tpu.merkle import MerkleTree
from ligero_tpu.sponge import test_sponge
from ligero_tpu.synthetic import generate_random_circuit
from ligero_tpu_torch import LigeroCircuit, native
from ligero_tpu_torch.fields import FIELDS as PORT_FIELDS
from ligero_tpu_torch.parallel import (ProcessRowMesh, ShardedBackend,
                                       make_prover_core,
                                       make_sharded_prover_core, multihost)
from ligero_tpu_torch.parallel.collectives import Collectives
from ligero_tpu_torch.parallel.core_step import STAGES
from ligero_tpu_torch.sponge import test_sponge as port_sponge
from ligero_tpu_torch.synthetic import \
    generate_random_circuit as port_circuit

# one intra-op thread: the workers of the suite share the host's cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "scripts", "torch_multihost_worker.py")
FIELDS = {"bn254": BN254_FR, "bls12_377": BLS12_377_FQ}
ZK_SEED = bytes(range(32))
# the JAX worker's circuit and core shape (4 rows a rank there: 4 D x 16 ->
# 128; here 16 x 16 -> 128 over two ranks), the worker's zk lambda (the
# circuit is too small for the blinding at 128)
GATES, NUM_VARS, CIRCUIT_SEED, ZK_LAMBDA = 300, 8, 9, 10
CORE = (16, 16, 128)
RANKS, TIMEOUT_S = 2, 120
RUNS = ("core", "direct", "streaming", "zk")
PROOF_RUNS = RUNS[1:]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def core_inputs(field):
    """The worker's seeded core inputs: random 16-bit limbs from
    ``default_rng(42)``, the top limb cut under p's."""
    four_m, k, _ = CORE
    L = field.num_limbs
    rng = np.random.default_rng(42)
    top = field.p >> (16 * (L - 1))
    preenc = rng.integers(0, 1 << 16, (four_m, k, L), dtype=np.uint32)
    r = rng.integers(0, 1 << 16, (four_m, L), dtype=np.uint32)
    for a in (preenc, r):
        a[..., L - 1] %= top
    return preenc, r


@functools.lru_cache(maxsize=None)
def references(name: str) -> dict:
    """The JAX package's outputs: the core's root (bytes) and lc (LE u32
    bytes) from the host golden, the proofs' bytes from its numpy
    backend."""
    field = FIELDS[name]
    four_m, k, n = CORE
    preenc, r = core_inputs(field)
    be = Backend(field)
    _, evals = be.rs_encode_rows(preenc, k, n)
    u_canon = be.to_numpy(be.from_mont(evals))
    leaves = [column_hash(field, field.limbs_to_ints(u_canon[:, j, :]))
              for j in range(n)]
    lc = be.to_numpy(be.row_combine(r, preenc)).astype("<u4").tobytes()
    circ, outs, vars_ = generate_random_circuit(field, GATES,
                                                num_vars=NUM_VARS,
                                                seed=CIRCUIT_SEED)
    plain = RefCircuit(circ, outs, backend=Backend(field)).prove(
        vars_, test_sponge(field)).to_bytes(field)
    zk = RefCircuit(circ, outs, zk=True, lambda_=ZK_LAMBDA,
                    backend=Backend(field)).prove(
        vars_, test_sponge(field), zk_seed=ZK_SEED).to_bytes(field)
    return {"root": MerkleTree(leaves).root, "lc": lc,
            "direct": plain, "streaming": plain, "zk": zk}


def run_ranks(tmp_path, field_name: str, runs=RUNS) -> list[dict]:
    """Both ranks of the worker over gloo on the CPU, doing ``runs``; their
    JSON records with each proof's bytes under ``"data"``."""
    native.available()     # build the host library once, before the ranks
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs, outs = [], []
    for pid in range(RANKS):
        out = tmp_path / f"rank{pid}.json"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, str(pid), str(RANKS), str(port),
             str(out), "--field", field_name, "--device", "cpu",
             "--core", ",".join(map(str, CORE)), "--gates", str(GATES),
             "--mode", ",".join(runs)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            for q in procs:
                q.communicate()
            raise
        logs.append((p.returncode, stdout.decode(errors="replace")))
    for code, log in logs:
        assert code == 0, f"rank failed:\n{log[-3000:]}"
    records = []
    for out in outs:
        rec = json.loads(out.read_text())
        for name, run in rec["runs"].items():
            if name != "core":
                with open(f"{out}.{name}.bin", "rb") as f:
                    run["data"] = f.read()
        records.append(rec)
    return records


@pytest.mark.parametrize("name", list(FIELDS))
def test_two_ranks_equal_each_other_and_the_jax_package(tmp_path, name):
    field = FIELDS[name]
    want = references(name)
    records = run_ranks(tmp_path, field.name)
    assert [rec["rank"] for rec in records] == list(range(RANKS))
    for rec in records:
        assert rec["size"] == RANKS and rec["backend"] == "gloo"
        core = rec["runs"]["core"]
        # each rank held its own block and its own columns
        assert core["block_rows"] == CORE[0] // RANKS
        assert core["leaf_rows"] == CORE[2] // RANKS
        assert bytes.fromhex(core["root"]) == want["root"]
        assert bytes.fromhex(core["lc"]) == want["lc"]
        for run in PROOF_RUNS:
            got = rec["runs"][run]
            assert got["data"] == want[run], run
            assert got["verified"] is True, run
            assert got["mode"] == ("streaming" if run == "streaming"
                                   else "direct")
        # more chunks than ranks: a last step short of a chunk a rank
        rows = 4 * 18
        assert -(-rows // rec["runs"]["streaming"]["chunk_rows"]) > RANKS
    first, second = (rec["runs"] for rec in records)
    assert first["core"]["root"] == second["core"]["root"]
    assert first["core"]["lc"] == second["core"]["lc"]
    for run in PROOF_RUNS:
        assert first[run]["data"] == second[run]["data"], run


def test_two_ranks_prove_a_batch_as_single_proofs(tmp_path):
    """``prove_batch`` of two witnesses over the two ranks (one launch a
    rank a bulk step for both): each proof equals the JAX package's single
    proof, and ``verify_batch`` accepts both, on both ranks."""
    want = references("bn254")["direct"]
    for rec in run_ranks(tmp_path, BN254_FR.name, runs=("batch",)):
        got = rec["runs"]["batch"]
        assert got["proofs"] == 2 and got["mode"] == "direct"
        assert got["data"] == want and got["verified"] is True


# ---------------------------------------------------------------------------
# the collective layer and the entry points, in a process group of one
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def group():
    """A gloo process group of one rank in this process (torch.distributed
    holds one default group a process: made once for the module)."""
    assert not dist.is_initialized()
    multihost.initialize(f"localhost:{_free_port()}", 1, 0, backend="gloo",
                         device="cpu")
    assert dist.is_initialized() and dist.get_world_size() == 1
    yield
    multihost.shutdown()
    assert not dist.is_initialized()


def comm_of_one() -> Collectives:
    return Collectives(None, 0, 1, "gloo", torch.device("cpu"))


def test_all_gather_returns_every_rank_in_order(group):
    comm = comm_of_one()
    t = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    got = comm.all_gather(t[:, 1:])          # a strided view goes too
    assert len(got) == 1 and torch.equal(got[0], t[:, 1:])
    assert comm.min_int(7) == 7 and comm.staged_bytes == 0


def test_all_to_all_takes_any_shapes_and_empty_pieces(group):
    comm = comm_of_one()
    blk = torch.arange(2 * 5 * 3, dtype=torch.int32).reshape(2, 5, 3)
    piece = blk[:, 1:4]                       # a column slice of a row block
    got = comm.all_to_all([piece], [(2, 3, 3)])
    assert len(got) == 1 and torch.equal(got[0], piece)
    empty = comm.all_to_all([blk[:0]], [(0, 5, 3)])
    assert empty[0].shape == (0, 5, 3)
    with pytest.raises(ValueError, match="sends"):
        comm.all_to_all([piece, piece], [(2, 3, 3)])


def test_staging_counts_what_crosses_the_host(group):
    """Gloo over CUDA tensors goes through host memory: every tensor sent
    out and every tensor received back is counted (a rank on the CPU,
    made to stage, moves the same bytes through the same path)."""
    comm = comm_of_one()
    comm.staged = True
    t = torch.ones((4, 16), dtype=torch.int32)
    comm.all_gather(t)
    assert comm.staged_bytes == 2 * t.numel() * 4
    comm.staged_bytes = 0
    out = comm.all_to_all([t[:, :8]], [(4, 8)])
    assert torch.equal(out[0], t[:, :8])
    assert comm.staged_bytes == 2 * 4 * 8 * 4


def test_collectives_refuse_nccl_on_the_cpu_and_other_backends():
    with pytest.raises(ValueError, match="NCCL"):
        Collectives(None, 0, 1, "nccl", torch.device("cpu"))
    with pytest.raises(ValueError, match="mpi"):
        Collectives(None, 0, 1, "mpi", torch.device("cpu"))
    assert not Collectives(None, 0, 1, "gloo", torch.device("cpu")).staged


def test_initialize_does_nothing_for_one_process(monkeypatch):
    for var in ("LIGERO_NUM_PROCESSES", "LIGERO_PROCESS_ID",
                "LIGERO_COORDINATOR"):
        monkeypatch.delenv(var, raising=False)
    was = dist.is_initialized()
    multihost.initialize()
    multihost.initialize(num_processes=1)
    monkeypatch.setenv("LIGERO_NUM_PROCESSES", "1")
    multihost.initialize()
    assert dist.is_initialized() == was


def test_initialize_and_the_mesh_refuse_without_asking():
    """NCCL on the CPU raises before joining; without a card and without
    ``device="cpu"`` the mesh raises, as the port's entry points do."""
    with pytest.raises(ValueError, match="NCCL"):
        multihost.initialize("localhost:1", 2, 0, backend="nccl",
                             device="cpu")
    with pytest.raises(ValueError, match="backend"):
        multihost.initialize("localhost:1", 2, 0, backend="mpi",
                             device="cpu")
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        multihost.rank_device()
    with pytest.raises(RuntimeError, match="cuda"):
        multihost.global_row_mesh()


def test_mesh_of_one_process_proves_as_one_device(group):
    """The process mesh over the group of one: the sharded core at every
    stage and a plain and a zk proof equal one device's."""
    field = PORT_FIELDS[BN254_FR.name]
    mesh = multihost.global_row_mesh("cpu")
    assert isinstance(mesh, ProcessRowMesh) and mesh.size == 1
    assert mesh.holds(0) and mesh.comm.backend == "gloo"
    four_m, k, n = CORE
    preenc, r = core_inputs(field)
    one = make_prover_core(field, four_m, k, n, device="cpu")(preenc, r)
    for stage in STAGES:
        out = make_sharded_prover_core(field, mesh, four_m, k, n,
                                       stage=stage)(preenc, r)
        assert torch.equal(out[0][0], one[0])
        if stage != "encode":
            assert torch.equal(out[1][0], one[0] if stage == "encode+a2a"
                               else one[1])
        if stage == "full":
            assert torch.equal(out[2], one[2]) and torch.equal(out[3], one[3])
    circ, outs, vars_ = port_circuit(field, 96, num_vars=4, seed=3)
    sp = port_sponge(field)
    for zk in (False, True):
        kw = {"zk_seed": ZK_SEED} if zk else {}
        single = LigeroCircuit(circ, outs, lambda_=10, zk=zk, device="cpu")
        lig = LigeroCircuit(circ, outs, lambda_=10, zk=zk,
                            backend=ShardedBackend(field, mesh))
        proof = lig.prove(vars_, sp.clone(), **kw)
        assert proof.to_bytes(field) == single.prove(
            vars_, sp.clone(), **kw).to_bytes(field)
        assert lig.verify(proof, sp.clone())
