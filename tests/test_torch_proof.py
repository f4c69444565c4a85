"""Whole proofs: the port's LigeroCircuit on device="cpu" against the JAX
package's numpy golden path.  Proofs must be byte-equal, verify both ways,
and tampered proofs must be rejected."""

import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from fixtures import (
    generate_3_by_3_determinant_circuit,
    generate_lemniscate_circuit,
)
from ligero_tpu.circuit import ArithmeticCircuit
from ligero_tpu.engine.backend import Backend
from ligero_tpu.fields import BN254_FR
from ligero_tpu.ligero import LigeroCircuit as RefCircuit
from ligero_tpu.sponge import test_sponge
from ligero_tpu.synthetic import generate_random_circuit
from ligero_tpu_torch import LigeroCircuit, convert
from ligero_tpu_torch import native as port_native
from ligero_tpu_torch.fields import BN254_FR as PF
from ligero_tpu_torch.ligero import LigeroProof

# the suite runs in several worker processes that share the host's cores, and
# these tests run many small tensor ops: one intra-op thread each, or the
# workers' thread pools spin against each other
torch.set_num_threads(1)

F = BN254_FR
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def cube():
    c = ArithmeticCircuit(F)
    x = c.new_variable_with_label("x")
    c.add(c.pow(x, 3), c.constant(-26))
    return c, [c.last()], [(x, 3)]


def lemniscate():
    c = generate_lemniscate_circuit()
    return c, [c.last()], [(1, 8), (2, 4)]


def determinant():
    values = [(1, 2), (2, 0), (3, (-1) % F.p), (4, 3), (5, 5), (6, 2),
              (7, (-4) % F.p), (8, 1), (9, 4), (10, 13)]
    c = generate_3_by_3_determinant_circuit()
    return c, [c.last()], values


def synthetic(log2_gates):
    return lambda: generate_random_circuit(F, 1 << log2_gates, seed=log2_gates)


CASES = {"cube": cube, "lemniscate": lemniscate, "determinant": determinant,
         "synthetic_2e8": synthetic(8), "synthetic_2e10": synthetic(10)}


def port_circuit(circuit, outputs, **kwargs):
    """The port's LigeroCircuit on the CPU for a JAX-package circuit,
    rebuilt as the port's own ArithmeticCircuit over the port's field."""
    kwargs.setdefault("device", "cpu")
    return LigeroCircuit(convert.circuit_from_reference(circuit), outputs,
                         **kwargs)


@pytest.mark.parametrize("name", list(CASES))
def test_proof_bytes_equal_jax_package(name):
    circuit, outputs, vars_ = CASES[name]()
    sponge = test_sponge(F)
    ref = RefCircuit(circuit, outputs)
    port = port_circuit(circuit, outputs)
    assert (port.m, port.k, port.n, port.t) == (ref.m, ref.k, ref.n, ref.t)
    want = ref.prove(vars_, sponge.clone())
    got = port.prove(vars_, sponge.clone())
    assert isinstance(got, LigeroProof)
    assert got.to_bytes(PF) == want.to_bytes(F)
    assert port.verify(want, sponge.clone())
    assert ref.verify(got, sponge.clone())


def test_prove_with_labels_and_from_reference():
    circuit, outputs, _ = cube()
    sponge = test_sponge(F)
    ref = RefCircuit(circuit, outputs)
    port = convert.from_reference(ref, device="cpu")
    got = port.prove_with_labels([("x", 3)], sponge.clone())
    assert got.to_bytes(F) == ref.prove_with_labels([("x", 3)],
                                                    sponge.clone()).to_bytes(F)


@pytest.fixture(scope="module")
def lemniscate_proof():
    circuit, outputs, vars_ = lemniscate()
    port = port_circuit(circuit, outputs)
    sponge = test_sponge(F)
    return port, port.prove(vars_, sponge.clone()), sponge


def test_rejects_flipped_bytes(lemniscate_proof):
    port, proof, sponge = lemniscate_proof
    data = proof.to_bytes(F)
    assert port.verify(LigeroProof.from_bytes(data, PF), sponge.clone())
    for pos in (8, 8 + 32 + 8, len(data) // 2, len(data) - 1):
        flipped = bytearray(data)
        flipped[pos] ^= 1
        try:
            bad = LigeroProof.from_bytes(bytes(flipped), PF)
        except ValueError:
            continue  # the deserializer rejected it
        assert not port.verify(bad, sponge.clone()), pos


def test_rejects_tampered_fields(lemniscate_proof):
    port, proof, sponge = lemniscate_proof
    bad = LigeroProof.from_bytes(proof.to_bytes(F), PF)
    bad.linear.polynomial[0] = (bad.linear.polynomial[0] + 1) % F.p
    assert not port.verify(bad, sponge.clone())
    bad = LigeroProof.from_bytes(proof.to_bytes(F), PF)
    bad.quadratic.columns[0][0] = (bad.quadratic.columns[0][0] + 1) % F.p
    assert not port.verify(bad, sponge.clone())
    bad = LigeroProof.from_bytes(proof.to_bytes(F), PF)
    bad.interleaved.preenc_u_lc = bad.interleaved.preenc_u_lc[:-1]
    assert not port.verify(bad, sponge.clone())
    bad = LigeroProof.from_bytes(proof.to_bytes(F), PF)
    bad.linear.polynomial = bad.linear.polynomial + [1] * (2 * port.k)
    assert not port.verify(bad, sponge.clone())


def test_rejects_wrong_witness():
    circuit, outputs, vars_ = determinant()
    sponge = test_sponge(F)
    port = port_circuit(circuit, outputs)
    bad_vars = [(vars_[0][0], vars_[0][1] + 1)] + vars_[1:]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        bad = port.prove(bad_vars, sponge.clone())
    assert not port.verify(bad, sponge.clone())
    assert not RefCircuit(circuit, outputs).verify(bad, sponge.clone())


def test_does_not_run_jax_package_backend_bulk_methods(monkeypatch):
    bulk = ["rs_encode_and_canon", "rs_encode_rows", "ntt", "intt",
            "ntt_columns", "from_mont", "commit_columns",
            "_column_leaves_device", "_tree_flat", "row_combine",
            "rand_field_mont", "sparse_rA_mont", "linear_combination_poly",
            "quadratic_combination_poly", "gather_columns"]

    def forbidden(*args, **kwargs):
        raise AssertionError("the port ran a JAX-package Backend bulk method")

    circuit, outputs, vars_ = CASES["synthetic_2e8"]()
    port = port_circuit(circuit, outputs)
    for name in bulk:
        monkeypatch.setattr(Backend, name, forbidden)
    sponge = test_sponge(F)
    proof = port.prove(vars_, sponge.clone())
    assert port.verify(proof, sponge.clone())


@pytest.mark.parametrize("name", ["cube", "lemniscate", "determinant"])
def test_preenc_python_fallback_matches_native(monkeypatch, name):
    circuit, outputs, vars_ = CASES[name]()
    port = port_circuit(circuit, outputs)
    bumped = [(port.state.bump_index(i), v) for i, v in vars_]
    want = np.asarray(port._witness.preenc(bumped), dtype=np.uint32)
    monkeypatch.setattr(port_native, "available", lambda: False)
    got = np.asarray(port._witness.preenc(bumped), dtype=np.uint32)
    assert got.shape == (4 * port.m, port.k, F.num_limbs)
    assert np.array_equal(got, want)


def test_zk_is_not_ported():
    """zk is ported now (tests/test_torch_zk.py).  What is still refused:
    a circuit too small for the blinding at this rate, with the JAX
    package's error, and the Poseidon commitment's device path."""
    import types

    from ligero_tpu_torch.ligero.types import LigeroMTPoseidonParams
    circuit, outputs, _ = cube()
    with pytest.raises(ValueError, match="circuit too small for zk"):
        RefCircuit(circuit, outputs, zk=True, backend=Backend(F))
    with pytest.raises(ValueError, match="circuit too small for zk"):
        port_circuit(circuit, outputs, zk=True)
    poseidon = LigeroMTPoseidonParams(PF)
    on_cpu = types.SimpleNamespace(device=torch.device("cpu"))
    on_card = types.SimpleNamespace(device=torch.device("cuda"))
    assert poseidon.device_col_digests(on_cpu, None) is None
    with pytest.raises(NotImplementedError, match="queue 1 #14"):
        poseidon.device_col_digests(on_card, None)


def test_port_runs_with_jax_blocked():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "sys.modules['ligero_tpu'] = None\n"
        "from ligero_tpu_torch import BN254_FR as F, LigeroCircuit\n"
        "from ligero_tpu_torch import test_sponge\n"
        "from ligero_tpu_torch.synthetic import generate_random_circuit\n"
        "c, outs, vs = generate_random_circuit(F, 1 << 6, seed=6)\n"
        "lig = LigeroCircuit(c, outs, device='cpu')\n"
        "sp = test_sponge(F)\n"
        "assert lig.verify(lig.prove(vs, sp.clone()), sp.clone())\n"
        "assert sys.modules['jax'] is None\n"
        "print('proved without jax')\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "proved without jax" in res.stdout


def test_profile_script_runs_on_cpu():
    script = os.path.join(REPO, "scripts", "profile_torch_port.py")
    res = subprocess.run([sys.executable, script, "--log2-gates", "6",
                          "--device", "cpu"], cwd=REPO, capture_output=True,
                         env=dict(os.environ, OMP_NUM_THREADS="1"),
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    rec = json.loads(res.stdout)
    for call in ("prove", "verify"):
        assert len(rec[call]["walls_s"]) == 3
        assert rec[call]["phases_ms"]
        assert rec[call]["device_busy_ms"] is None  # no device on the CPU


def test_port_sources_do_not_import_jax():
    for root in (os.path.join(REPO, "ligero_tpu_torch"),):
        for dirpath, _, files in os.walk(root):
            for fname in files:
                if fname.endswith(".py"):
                    with open(os.path.join(dirpath, fname)) as f:
                        src = f.read()
                    assert "import jax" not in src and "from jax" not in src, fname
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        src = f.read()
    assert "import jax" not in src and "from jax" not in src


@pytest.mark.cuda
def test_proof_on_cuda_matches_cpu(cuda):
    circuit, outputs, vars_ = CASES["synthetic_2e8"]()
    sponge = test_sponge(F)
    cpu = port_circuit(circuit, outputs)
    dev = port_circuit(circuit, outputs, device=cuda)
    want = cpu.prove(vars_, sponge.clone())
    got = dev.prove(vars_, sponge.clone())
    assert got.to_bytes(F) == want.to_bytes(F)
    assert dev.verify(want, sponge.clone())
