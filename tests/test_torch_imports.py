"""The port is a package of its own: it runs with ``jax`` and the JAX package
``ligero_tpu`` made unimportable, and no source of it imports either."""

import json
import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

# the suite runs in several worker processes that share the host's cores, and
# these tests run many small tensor ops: one intra-op thread each, or the
# workers' thread pools spin against each other
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

BLOCK = '''
import importlib.abc, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "ligero_tpu"):
            raise ImportError("blocked in this test: " + name)

sys.meta_path.insert(0, Block())
'''


def run_blocked(code: str) -> str:
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", BLOCK + code], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    return res.stdout


def port_modules() -> list[str]:
    import ligero_tpu_torch
    return sorted(m.name for m in pkgutil.walk_packages(
        ligero_tpu_torch.__path__, "ligero_tpu_torch."))


def test_every_module_imports_with_jax_and_the_jax_package_blocked():
    names = port_modules()
    assert len(names) >= 35 and "ligero_tpu_torch.engine.cuda_tree" in names
    for new in ("engine.spot", "engine.poseidon_cols", "engine.cuda_poseidon",
                "engine.devmatrix", "circuit.r1cs", "cli", "server",
                "parallel", "parallel.sharded_backend", "parallel.core_step",
                "parallel.multihost", "parallel.collectives", "bench",
                "graft_entry", "__main__"):
        assert f"ligero_tpu_torch.{new}" in names
    names.remove("ligero_tpu_torch.__main__")    # importing it runs the CLI
    out = run_blocked(
        "import importlib\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "import ligero_tpu_torch\n"
        "for name in ligero_tpu_torch.__all__:\n"
        "    getattr(ligero_tpu_torch, name)\n"
        "assert not any(m.split('.')[0] in ('jax', 'ligero_tpu')\n"
        "               for m in sys.modules)\n"
        "print('imported', len(sys.modules))\n")
    assert "imported" in out


PROVE = (
    "from ligero_tpu_torch import (BN254_FR as F, ArithmeticCircuit,\n"
    "                              LigeroCircuit, LigeroProof, test_sponge)\n"
    "from ligero_tpu_torch.synthetic import generate_random_circuit\n"
    "sp = test_sponge(F)\n")


def test_cube_proves_and_verifies_with_both_blocked():
    out = run_blocked(
        PROVE +
        "c = ArithmeticCircuit(F)\n"
        "x = c.new_variable_with_label('x')\n"
        "c.add(c.pow(x, 3), c.constant(-26))\n"
        "lig = LigeroCircuit(c, [c.last()], device='cpu')\n"
        "proof = lig.prove_with_labels([('x', 3)], sp.clone())\n"
        "assert lig.verify(proof, sp.clone())\n"
        "back = LigeroProof.from_bytes(proof.to_bytes(F), F)\n"
        "assert lig.verify(back, sp.clone())\n"
        "bad = lig.prove_with_labels([('x', 4)], sp.clone())\n"
        "assert not lig.verify(bad, sp.clone())\n"
        "print('cube ok')\n")
    assert "cube ok" in out


def test_poseidon_commitment_proves_and_verifies_with_both_blocked():
    out = run_blocked(
        PROVE +
        "from ligero_tpu_torch.ligero.types import LigeroMTPoseidonParams\n"
        "c = ArithmeticCircuit(F)\n"
        "x = c.new_variable_with_label('x')\n"
        "c.add(c.pow(x, 3), c.constant(-26))\n"
        "lig = LigeroCircuit(c, [c.last()], device='cpu',\n"
        "                    mt_params=LigeroMTPoseidonParams(F))\n"
        "proof = lig.prove_with_labels([('x', 3)], sp.clone())\n"
        "assert lig.verify(proof, sp.clone())\n"
        "bad = lig.prove_with_labels([('x', 4)], sp.clone())\n"
        "assert not lig.verify(bad, sp.clone())\n"
        "print('poseidon ok')\n")
    assert "poseidon ok" in out


def test_zk_proves_and_verifies_with_both_blocked():
    out = run_blocked(
        PROVE +
        "c, outs, vs = generate_random_circuit(F, 96, num_vars=4, seed=3)\n"
        "lig = LigeroCircuit(c, outs, lambda_=10, zk=True, device='cpu')\n"
        "seed = bytes(range(32))\n"
        "proof = lig.prove(vs, sp.clone(), zk_seed=seed)\n"
        "assert lig.verify(proof, sp.clone())\n"
        "again = lig.prove(vs, sp.clone(), zk_seed=seed)\n"
        "assert again.to_bytes(F) == proof.to_bytes(F)\n"
        "assert len(proof.interleaved.columns[0]) == 4 * lig.m + 3\n"
        "print('zk ok')\n")
    assert "zk ok" in out


def test_bls12_377_proves_and_verifies_with_both_blocked():
    """The kernels' second field: plain and zk over BLS12-377 Fq."""
    out = run_blocked(
        "from ligero_tpu_torch import (BLS12_377_FQ as F, LigeroCircuit,\n"
        "                              LigeroProof, test_sponge)\n"
        "from ligero_tpu_torch.synthetic import generate_random_circuit\n"
        "sp = test_sponge(F)\n"
        "c, outs, vs = generate_random_circuit(F, 96, num_vars=4, seed=3)\n"
        "for zk in (False, True):\n"
        "    lig = LigeroCircuit(c, outs, lambda_=10, zk=zk, device='cpu')\n"
        "    kw = {'zk_seed': bytes(range(32))} if zk else {}\n"
        "    proof = lig.prove(vs, sp.clone(), **kw)\n"
        "    assert lig.verify(proof, sp.clone())\n"
        "    back = LigeroProof.from_bytes(proof.to_bytes(F), F)\n"
        "    assert lig.verify(back, sp.clone())\n"
        "print('bls ok')\n")
    assert "bls ok" in out


def test_streaming_proves_and_verifies_with_both_blocked():
    """Streaming mode, forced by a budget under the direct estimate: U in
    row chunks, the streamed column hash, the blocked linear phase."""
    out = run_blocked(
        PROVE +
        "from ligero_tpu_torch.engine.backend import TorchBackend\n"
        "c, outs, vs = generate_random_circuit(F, 96, num_vars=4, seed=3)\n"
        "direct = LigeroCircuit(c, outs, lambda_=10, device='cpu')\n"
        "want = direct.prove(vs, sp.clone()).to_bytes(F)\n"
        "dims = (direct.num_rows, direct.k, direct.n,\n"
        "        len(direct.state.a_vals), 0, direct.d2)\n"
        "budget = direct.backend.streaming_bytes(*dims, chunk_rows=12)\n"
        "assert budget < direct.backend.direct_bytes(*dims)\n"
        "TorchBackend.memory_budget = lambda self: budget\n"
        "lig = LigeroCircuit(c, outs, lambda_=10, device='cpu')\n"
        "assert lig.encode_mode == 'streaming', lig.encode_mode\n"
        "proof = lig.prove(vs, sp.clone())\n"
        "assert proof.to_bytes(F) == want\n"
        "assert lig.verify(proof, sp.clone())\n"
        "assert not any(m.split('.')[0] in ('jax', 'ligero_tpu')\n"
        "               for m in sys.modules)\n"
        "print('streaming ok')\n")
    assert "streaming ok" in out


def test_resident_proves_and_verifies_with_both_blocked():
    """Resident mode, forced by a budget under the direct estimate at the
    resident one: U's codeword chunks held, the commit and the openings
    reading them, plain and zk."""
    out = run_blocked(
        PROVE +
        "from ligero_tpu_torch.engine import backend\n"
        "from ligero_tpu_torch.engine.backend import TorchBackend\n"
        "c, outs, vs = generate_random_circuit(F, 96, num_vars=4, seed=3)\n"
        "seed = bytes(range(32))\n"
        "for zk, cr in ((False, 12), (True, 8)):\n"
        "    backend.STREAM_MAX_CHUNK_ROWS = cr   # the streaming chunking\n"
        "    kw = {'zk_seed': seed} if zk else {}\n"
        "    direct = LigeroCircuit(c, outs, lambda_=10, zk=zk, device='cpu')\n"
        "    want = direct.prove(vs, sp.clone(), **kw).to_bytes(F)\n"
        "    dims = (direct.num_rows, direct.k, direct.n,\n"
        "            len(direct.state.a_vals), direct.blind_t, direct.d2)\n"
        "    budget = direct.backend.resident_bytes(*dims, chunk_rows=cr)\n"
        "    assert budget < direct.backend.direct_bytes(*dims)\n"
        "    TorchBackend.memory_budget = lambda self: budget\n"
        "    lig = LigeroCircuit(c, outs, lambda_=10, zk=zk, device='cpu')\n"
        "    assert (lig.encode_mode, lig.chunk_rows) == ('resident', cr)\n"
        "    proof = lig.prove(vs, sp.clone(), **kw)\n"
        "    assert proof.to_bytes(F) == want\n"
        "    assert lig.verify(proof, sp.clone())\n"
        "assert not any(m.split('.')[0] in ('jax', 'ligero_tpu')\n"
        "               for m in sys.modules)\n"
        "print('resident ok')\n")
    assert "resident ok" in out


def test_poseidon_streaming_proves_and_verifies_with_both_blocked():
    """The Poseidon commitment in streaming mode: the column sponges absorb
    U a re-encoded chunk at a time, their states kept between chunks."""
    out = run_blocked(
        PROVE +
        "from ligero_tpu_torch.engine.backend import TorchBackend\n"
        "from ligero_tpu_torch.ligero.types import LigeroMTPoseidonParams\n"
        "mt = LigeroMTPoseidonParams(F)\n"
        "c, outs, vs = generate_random_circuit(F, 96, num_vars=4, seed=3)\n"
        "direct = LigeroCircuit(c, outs, lambda_=10, device='cpu',\n"
        "                       mt_params=mt)\n"
        "want = direct.prove(vs, sp.clone()).to_bytes(F)\n"
        "dims = (direct.num_rows, direct.k, direct.n,\n"
        "        len(direct.state.a_vals), 0, direct.d2)\n"
        "budget = direct.backend.streaming_bytes(*dims, chunk_rows=12,\n"
        "                                        poseidon=True)\n"
        "TorchBackend.memory_budget = lambda self: budget\n"
        "lig = LigeroCircuit(c, outs, lambda_=10, device='cpu', mt_params=mt)\n"
        "assert lig.encode_mode == 'streaming', lig.encode_mode\n"
        "proof = lig.prove(vs, sp.clone())\n"
        "assert proof.to_bytes(F) == want\n"
        "assert lig.verify(proof, sp.clone())\n"
        "assert not any(m.split('.')[0] in ('jax', 'ligero_tpu')\n"
        "               for m in sys.modules)\n"
        "print('poseidon streaming ok')\n")
    assert "poseidon streaming ok" in out


def test_sharded_backend_proves_and_verifies_with_both_blocked():
    """``ShardedBackend`` over a mesh of three CPU shards, zk (4m + 3 rows,
    the last block padded): the single-device proof, byte for byte."""
    out = run_blocked(
        PROVE +
        "from ligero_tpu_torch.parallel import RowMesh, ShardedBackend\n"
        "c, outs, vs = generate_random_circuit(F, 96, num_vars=4, seed=3)\n"
        "seed = bytes(range(32))\n"
        "one = LigeroCircuit(c, outs, lambda_=10, zk=True, device='cpu')\n"
        "want = one.prove(vs, sp.clone(), zk_seed=seed).to_bytes(F)\n"
        "be = ShardedBackend(F, RowMesh(['cpu'] * 3))\n"
        "lig = LigeroCircuit(c, outs, lambda_=10, zk=True, backend=be)\n"
        "proof = lig.prove(vs, sp.clone(), zk_seed=seed)\n"
        "assert proof.to_bytes(F) == want\n"
        "assert lig.verify(proof, sp.clone())\n"
        "assert not any(m.split('.')[0] in ('jax', 'ligero_tpu')\n"
        "               for m in sys.modules)\n"
        "print('sharded ok')\n")
    assert "sharded ok" in out


def test_core_and_mesh_streaming_run_with_both_blocked():
    """The prover core, single and over a mesh of two CPU shards, and the
    mesh's streaming mode (forced by a budget under its direct estimate)
    with a batch of verdicts."""
    out = run_blocked(
        PROVE +
        "import numpy as np, torch\n"
        "from ligero_tpu_torch.engine.backend import TorchBackend\n"
        "from ligero_tpu_torch.parallel import (RowMesh, ShardedBackend,\n"
        "    make_prover_core, make_sharded_prover_core)\n"
        "rng = np.random.default_rng(0)\n"
        "preenc = F.ints_to_mont_limbs([int(x) for x in rng.integers(\n"
        "    0, 2**62, 16 * 16)]).reshape(16, 16, -1)\n"
        "r = F.ints_to_mont_limbs([int(x) for x in rng.integers(0, 2**62, 16)])\n"
        "one = make_prover_core(F, 16, 16, 128, device='cpu')(preenc, r)\n"
        "two = make_sharded_prover_core(F, ['cpu'] * 2, 16, 16, 128)(preenc, r)\n"
        "assert torch.equal(torch.cat(two[1]), one[1])\n"
        "assert torch.equal(two[2], one[2]) and torch.equal(two[3], one[3])\n"
        "c, outs, vs = generate_random_circuit(F, 96, num_vars=4, seed=3)\n"
        "want = LigeroCircuit(c, outs, lambda_=10, device='cpu').prove(\n"
        "    vs, sp.clone()).to_bytes(F)\n"
        "be = ShardedBackend(F, RowMesh(['cpu'] * 2))\n"
        "direct = LigeroCircuit(c, outs, lambda_=10, backend=be)\n"
        "dims = (direct.num_rows, direct.k, direct.n,\n"
        "        len(direct.state.a_vals), 0, direct.d2)\n"
        "budget = be.streaming_bytes(*dims, chunk_rows=12)\n"
        "assert budget < be.direct_bytes(*dims)\n"
        "TorchBackend.memory_budget = lambda self: budget\n"
        "lig = LigeroCircuit(c, outs, lambda_=10, backend=be)\n"
        "assert lig.encode_mode == 'streaming', lig.encode_mode\n"
        "proof = lig.prove(vs, sp.clone())\n"
        "assert proof.to_bytes(F) == want\n"
        "assert lig.verify_batch([proof, proof], sp) == [True, True]\n"
        "assert not any(m.split('.')[0] in ('jax', 'ligero_tpu')\n"
        "               for m in sys.modules)\n"
        "print('core and mesh streaming ok')\n")
    assert "core and mesh streaming ok" in out


def test_multihost_worker_and_bench_run_with_both_blocked(tmp_path):
    """``parallel.multihost`` and ``parallel.collectives`` through the
    worker script (a process group of one, gloo, on the CPU: the sharded
    core and a direct, a streaming and a zk proof, each verified), and the
    port's bench at the small scale after its canary."""
    worker = os.path.join(REPO, "scripts", "torch_multihost_worker.py")
    out = tmp_path / "rank0.json"
    res = run_blocked(
        "import json, runpy, socket\n"
        "with socket.socket() as s:\n"
        "    s.bind(('localhost', 0))\n"
        "    port = s.getsockname()[1]\n"
        f"sys.argv = ['worker', '0', '1', str(port), {str(out)!r},\n"
        "            '--device', 'cpu', '--backend', 'gloo', '--gates', '96']\n"
        "try:\n"
        f"    runpy.run_path({worker!r}, run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        f"rec = json.load(open({str(out)!r}))\n"
        "assert rec['size'] == 1 and rec['backend'] == 'gloo'\n"
        "assert all(rec['runs'][r]['verified'] for r in\n"
        "           ('direct', 'streaming', 'zk'))\n"
        "assert rec['runs']['streaming']['mode'] == 'streaming'\n"
        "from ligero_tpu_torch import bench\n"
        "assert bench.main(['--device', 'cpu', '--scale', 'small']) == 0\n"
        "assert not any(m.split('.')[0] in ('jax', 'ligero_tpu')\n"
        "               for m in sys.modules)\n"
        "print('multihost and bench ok')\n")
    assert "multihost and bench ok" in res
    assert json.loads(res.splitlines()[-2])["metric"].startswith("RS-encode")


def test_graft_entry_runs_with_both_blocked():
    out = run_blocked(
        "from ligero_tpu_torch import graft_entry\n"
        "fn, (preenc, r) = graft_entry.entry('cpu')\n"
        "assert tuple(fn(preenc, r)[2].shape) == (8,)\n"
        "res = graft_entry.dryrun_multichip(2, device='cpu')\n"
        "assert res['devices'] == ['cpu', 'cpu'] and res['proof']\n"
        "assert not any(m.split('.')[0] in ('jax', 'ligero_tpu')\n"
        "               for m in sys.modules)\n"
        "print('graft entry ok')\n")
    assert "graft entry ok" in out


def test_batch_proves_and_verifies_with_both_blocked():
    out = run_blocked(
        PROVE +
        "c, outs, vs = generate_random_circuit(F, 96, num_vars=4, seed=3)\n"
        "lig = LigeroCircuit(c, outs, lambda_=10, device='cpu')\n"
        "proofs = lig.prove_batch([vs, vs], sp)\n"
        "assert proofs[0].to_bytes(F) == lig.prove(vs, sp.clone()).to_bytes(F)\n"
        "assert lig.verify_batch(proofs, sp) == [True, True]\n"
        "print('batch ok')\n")
    assert "batch ok" in out


def test_cli_and_service_run_with_both_blocked(tmp_path):
    """``python -m ligero_tpu_torch info --cpu`` and a service round trip,
    on a repeated-squaring ``.r1cs`` written through the port's own
    constraint system, with ``jax`` and ``ligero_tpu`` unimportable."""
    from torch_circom_files import write_cs
    from ligero_tpu_torch.circuit.r1cs import (
        repeated_squaring_constraint_system, repeated_squaring_witness)
    from ligero_tpu_torch.fields import BN254_FR
    path = write_cs(tmp_path / "sq.r1cs",
                    repeated_squaring_constraint_system(BN254_FR, 4))
    wit = repeated_squaring_witness(BN254_FR, 3, 4)
    out = run_blocked(
        "import io, json, runpy, contextlib\n"
        f"sys.argv = ['ligero_tpu_torch', 'info', '--r1cs', {path!r}, '--cpu']\n"
        "buf = io.StringIO()\n"
        "try:\n"
        "    with contextlib.redirect_stdout(buf):\n"
        "        runpy.run_module('ligero_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "info = json.loads(buf.getvalue())\n"
        "assert info['constraints'] == 4 and info['device'] == 'cpu'\n"
        "from ligero_tpu_torch.server import ProverService\n"
        "svc = ProverService(device='cpu')\n"
        f"svc.register('sq', {path!r})\n"
        f"res = svc.prove('sq', witness={wit!r})\n"
        "assert svc.verify('sq', res['proof'])['verified'] is True\n"
        "assert not any(m.split('.')[0] in ('jax', 'ligero_tpu')\n"
        "               for m in sys.modules)\n"
        "print('entry points ok')\n")
    assert "entry points ok" in out


IMPORT_LINE = re.compile(
    r"^\s*(?:import|from)\s+(jax|jaxlib|ligero_tpu)(?:\.|\s|$)", re.M)


def port_sources() -> list[str]:
    paths = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "scripts", "profile_torch_port.py"),
             os.path.join(REPO, "scripts", "torch_multihost_worker.py")]
    for dirpath, _, files in os.walk(os.path.join(REPO, "ligero_tpu_torch")):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def test_no_source_imports_jax_or_the_jax_package():
    paths = port_sources()
    assert len(paths) >= 40
    assert any(path.endswith("server.py") for path in paths)
    for new in ("poseidon_cols.py", "cuda_poseidon.py"):
        assert os.path.join(REPO, "ligero_tpu_torch", "engine", new) in paths
    for new in (("parallel", "multihost.py"), ("parallel", "collectives.py"),
                ("bench.py",), ("graft_entry.py",)):
        assert os.path.join(REPO, "ligero_tpu_torch", *new) in paths
    assert os.path.join(REPO, "scripts", "torch_multihost_worker.py") in paths
    for path in paths:
        with open(path) as f:
            found = IMPORT_LINE.findall(f.read())
        assert not found, (path, found)
    # the scan itself sees what it is looking for
    assert IMPORT_LINE.findall("import os\nfrom ligero_tpu.fields import X\n")
    assert IMPORT_LINE.findall("    import jax\n")
    assert not IMPORT_LINE.findall("from ligero_tpu_torch import X\n")


def test_profiler_groups_name_every_kernel_of_the_sources():
    """A renamed __global__ function must not fall into the traced
    benchmark's torch-glue group (``benchmark/harness/trace.py``, read by
    ``torch_ops_ms.prove``): its list of the port's kernels is the
    sources'."""
    csrc = os.path.join(REPO, "ligero_tpu_torch", "csrc")
    found = set()
    for name in sorted(os.listdir(csrc)):
        with open(os.path.join(csrc, name)) as f:
            found |= set(re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\(",
                f.read()))
    with open(os.path.join(REPO, "benchmark", "harness", "trace.py")) as f:
        listed = re.search(r"PORT_KERNELS = \((.*?)\)", f.read(), re.S).group(1)
    assert len(found) >= 8
    assert found == set(re.findall(r'"(\w+)"', listed))


def test_default_device_is_the_card_and_raises_without_one():
    """``LigeroCircuit(c, outs)`` with no ``device`` runs on the CUDA device;
    where there is none it raises rather than proving on the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from ligero_tpu_torch import BN254_FR, ArithmeticCircuit, LigeroCircuit
    from ligero_tpu_torch.engine.backend import TorchBackend, resolve_device
    c = ArithmeticCircuit(BN254_FR)
    x = c.new_variable_with_label("x")
    c.add(c.pow(x, 3), c.constant(-26))
    with pytest.raises(RuntimeError, match="cuda"):
        LigeroCircuit(c, [c.last()])
    with pytest.raises(RuntimeError, match="cuda"):
        TorchBackend(BN254_FR)
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device(None)
    assert resolve_device("cpu").type == "cpu"


@pytest.mark.cuda
def test_default_device_is_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ligero_tpu_torch.engine.backend import resolve_device
    assert resolve_device(None).type == "cuda"
