"""Whole proofs over BLS12-377 Fq, the kernels' second field: the port's
LigeroCircuit on device="cpu" against the JAX package's numpy golden path
(Backend(BLS12_377_FQ)).  Proofs must be byte-equal (tolerance: none),
verify both ways, batches must equal sequential proves, and tampered
proofs must be rejected.  The synthetic 2^8 / 2^10 digests of both modes
are also held in tests/test_torch_golden.py."""

import warnings

import pytest
import torch

from fixtures import generate_bls12_377_circuit
from ligero_tpu.engine.backend import Backend
from ligero_tpu.fields import BLS12_377_FQ
from ligero_tpu.ligero import LigeroCircuit as RefCircuit
from ligero_tpu.sponge import test_sponge
from ligero_tpu.synthetic import generate_random_circuit
from ligero_tpu_torch import LigeroCircuit, convert
from ligero_tpu_torch.fields import BLS12_377_FQ as PF
from ligero_tpu_torch.ligero import LigeroProof

# the suite runs in several worker processes that share the host's cores, and
# these tests run many small tensor ops: one intra-op thread each, or the
# workers' thread pools spin against each other
torch.set_num_threads(1)

F = BLS12_377_FQ
ZK_SEED = bytes(range(32))
ZK_LAMBDA = 20   # small circuits cannot fit the blinding at lambda = 128


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def port_circuit(circuit, outputs, **kwargs):
    kwargs.setdefault("device", "cpu")
    return LigeroCircuit(convert.circuit_from_reference(circuit), outputs,
                         **kwargs)


def test_curve_circuit_bytes_equal_jax_package():
    """y^2 = x^3 + 1 at (2, 3), the reference's BLS12-377 fixture."""
    c = generate_bls12_377_circuit()
    sponge = test_sponge(F)
    labels = [("x", 2), ("y", 3)]
    ref = RefCircuit(c, [c.last()], backend=Backend(F))
    port = port_circuit(c, [c.last()])
    want = ref.prove_with_labels(labels, sponge.clone())
    got = port.prove_with_labels(labels, sponge.clone())
    assert got.to_bytes(PF) == want.to_bytes(F)
    assert port.verify(got, sponge.clone())
    assert ref.verify(want, sponge.clone())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")   # the witness fails the circuit
        bad = port.prove_with_labels([("x", 2), ("y", 4)], sponge.clone())
    assert not port.verify(bad, sponge.clone())


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "zk"])
def proved(request):
    """A synthetic 2^8-gate instance, port and JAX package, one proof each."""
    zk = request.param
    circ, outs, vars_ = generate_random_circuit(F, 256, num_vars=64, seed=8)
    kw = dict(zk=zk, lambda_=ZK_LAMBDA if zk else 128)
    seed = {"zk_seed": ZK_SEED} if zk else {}
    sponge = test_sponge(F)
    ref = RefCircuit(circ, outs, backend=Backend(F), **kw)
    port = port_circuit(circ, outs, **kw)
    want = ref.prove(vars_, sponge.clone(), **seed)
    got = port.prove(vars_, sponge.clone(), **seed)
    return dict(ref=ref, port=port, vars=vars_, sponge=sponge, want=want,
                got=got, seed=seed)


def test_synthetic_bytes_equal_and_cross_verify(proved):
    got, want, sp = proved["got"], proved["want"], proved["sponge"]
    assert got.to_bytes(PF) == want.to_bytes(F)
    assert proved["port"].verify(got, sp.clone())
    assert proved["ref"].verify(want, sp.clone())
    back = LigeroProof.from_bytes(want.to_bytes(F), PF)
    assert proved["port"].verify(back, sp.clone())


def test_synthetic_tampered_witness_and_flipped_byte_rejected(proved):
    port, vars_, sp = proved["port"], proved["vars"], proved["sponge"]
    bad_vars = [(v, (x + 1) % F.p) for v, x in vars_]   # every input off
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        bad = port.prove(bad_vars, sp.clone(), **proved["seed"])
    assert not port.verify(bad, sp.clone())
    data = bytearray(proved["got"].to_bytes(PF))
    data[8 + 32 + 8] ^= 1   # the first interleaved lc element's low byte
    try:
        flipped = LigeroProof.from_bytes(bytes(data), PF)
    except ValueError:
        return
    assert not port.verify(flipped, sp.clone())


def test_prove_batch_of_two_equals_sequential(proved):
    port, vars_, sp = proved["port"], proved["vars"], proved["sponge"]
    zk = proved["seed"]
    seeds = [ZK_SEED, ZK_SEED[::-1]] if zk else None
    proofs = port.prove_batch([vars_, vars_], sp, zk_seeds=seeds)
    single = [port.prove(vars_, sp.clone(),
                         **({"zk_seed": s} if zk else {}))
              for s in (seeds or [None, None])]
    assert [p.to_bytes(PF) for p in proofs] == [p.to_bytes(PF) for p in single]
    assert proofs[0].to_bytes(PF) == proved["got"].to_bytes(PF)
    assert port.verify_batch(proofs, sp) == [True, True]


def test_from_reference_carries_a_bls12_377_instance():
    """convert.from_reference rebuilds a compiled JAX-package instance over
    BLS12-377 as the port's own; the proofs are the same bytes."""
    circ, outs, vars_ = generate_random_circuit(F, 96, num_vars=8, seed=5)
    sponge = test_sponge(F)
    ref = RefCircuit(circ, outs, backend=Backend(F))
    port = convert.from_reference(ref, device="cpu")
    assert port.field == PF
    assert (port.m, port.k, port.n, port.t) == (ref.m, ref.k, ref.n, ref.t)
    got = port.prove(vars_, sponge.clone())
    assert got.to_bytes(PF) == ref.prove(vars_, sponge.clone()).to_bytes(F)
    assert port.verify(got, sponge.clone())


@pytest.mark.cuda
def test_bls12_377_proof_on_the_card_equals_cpu(cuda):
    """Plain and zk over BLS12-377 on the card's kernels: the CPU's bytes,
    verified on both; every field kernel launched."""
    from ligero_tpu_torch.engine import cuda_hash, cuda_lc, cuda_mont, cuda_ntt
    circ, outs, vars_ = generate_random_circuit(F, 1024, num_vars=64, seed=10)
    sponge = test_sponge(F)
    for zk in (False, True):
        kw = dict(zk=zk, lambda_=ZK_LAMBDA if zk else 128)
        seed = {"zk_seed": ZK_SEED} if zk else {}
        on_cpu = port_circuit(circ, outs, **kw)
        on_card = port_circuit(circ, outs, device=cuda, **kw)
        counts = [m.launches.count for m in (cuda_ntt, cuda_mont, cuda_hash,
                                             cuda_lc)]
        got = on_card.prove(vars_, sponge.clone(), **seed)
        assert got.to_bytes(PF) == on_cpu.prove(
            vars_, sponge.clone(), **seed).to_bytes(PF)
        assert on_card.verify(got, sponge.clone())
        assert on_cpu.verify(got, sponge.clone())
        assert all(m.launches.count > c for m, c in zip(
            (cuda_ntt, cuda_mont, cuda_hash, cuda_lc), counts))
