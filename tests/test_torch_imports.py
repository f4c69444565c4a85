"""The port is a package of its own: it runs with ``jax`` and the JAX package
``ligero_tpu`` made unimportable, and no source of it imports either."""

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
    assert len(names) >= 30 and "ligero_tpu_torch.engine.cuda_tree" in names
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


IMPORT_LINE = re.compile(
    r"^\s*(?:import|from)\s+(jax|jaxlib|ligero_tpu)(?:\.|\s|$)", re.M)


def port_sources() -> list[str]:
    paths = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "scripts", "profile_torch_port.py"),
             os.path.join(REPO, "scripts", "compare_kernels_with_parent.py")]
    for dirpath, _, files in os.walk(os.path.join(REPO, "ligero_tpu_torch")):
        paths += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(paths)


def test_no_source_imports_jax_or_the_jax_package():
    paths = port_sources()
    assert len(paths) >= 35
    for path in paths:
        with open(path) as f:
            found = IMPORT_LINE.findall(f.read())
        assert not found, (path, found)
    # the scan itself sees what it is looking for
    assert IMPORT_LINE.findall("import os\nfrom ligero_tpu.fields import X\n")
    assert IMPORT_LINE.findall("    import jax\n")
    assert not IMPORT_LINE.findall("from ligero_tpu_torch import X\n")


def test_profiler_groups_name_every_kernel_of_the_sources():
    """A renamed __global__ function must not fall into the profiler's
    "torch ops" group: its list of the port's kernels is the sources'."""
    csrc = os.path.join(REPO, "ligero_tpu_torch", "csrc")
    found = set()
    for name in sorted(os.listdir(csrc)):
        with open(os.path.join(csrc, name)) as f:
            found |= set(re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\(",
                f.read()))
    with open(os.path.join(REPO, "scripts", "profile_torch_port.py")) as f:
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
