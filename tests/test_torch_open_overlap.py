"""The opening overlap of the port on device="cpu" (and, marked ``cuda``, on
the card): a single proof in direct mode on one device starts each set's
gather and host copy as soon as the set's indices are squeezed (FS #4, #7,
#10: ``_start_open_async``) and finishes the three in order at the end
(``_finish_open_async``), as ``ligero_tpu/ligero/core.py`` does; batches,
resident and streaming mode and every mesh take the fused gather.  Proofs
of either route equal the JAX package's numpy-path proofs byte for byte
(tolerance: none).  Also the phase timer's counts, report and trace, and
the malloc tuning ``import ligero_tpu_torch`` does.  Inputs: the seeded
synthetic circuit of the sibling files."""

import json
import os
import subprocess
import sys
import warnings

import pytest
import torch

from ligero_tpu.engine.backend import Backend
from ligero_tpu.fields import BLS12_377_FQ, BN254_FR
from ligero_tpu.ligero import LigeroCircuit as RefCircuit
from ligero_tpu.sponge import test_sponge
from ligero_tpu.synthetic import generate_random_circuit
from ligero_tpu_torch import LigeroCircuit, convert
from ligero_tpu_torch.engine import backend as port_backend
from ligero_tpu_torch.engine.backend import STREAM_ROW_QUANTUM, TorchBackend
from ligero_tpu_torch.fields import FIELDS as PORT_FIELDS
from ligero_tpu_torch.parallel import RowMesh, ShardedBackend
from ligero_tpu_torch.utils.profiling import PhaseTimer, trace

# one intra-op thread: the workers of the suite share the host's cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ZK_SEED = bytes(range(32))
FIELDS = {"bn254": BN254_FR, "bls12_377": BLS12_377_FQ}
# (gates, num_vars, circuit seed, lambda): small enough for the zk blinding
GATES, NUM_VARS, CIRCUIT_SEED, LAMBDA = 96, 4, 3, 10
_REFS = {}


def pf(field):
    """The port's own FieldSpec for a JAX-package one."""
    return PORT_FIELDS[field.name]


def reference(name: str, zk: bool):
    """(the JAX package's proof bytes on its numpy golden path, circuit,
    outputs, witness), made once a case."""
    if (name, zk) not in _REFS:
        field = FIELDS[name]
        circ, outs, vars_ = generate_random_circuit(
            field, GATES, num_vars=NUM_VARS, seed=CIRCUIT_SEED)
        ref = RefCircuit(circ, outs, lambda_=LAMBDA, zk=zk,
                         backend=Backend(field))
        kw = {"zk_seed": ZK_SEED} if zk else {}
        want = ref.prove(vars_, test_sponge(field), **kw).to_bytes(field)
        _REFS[name, zk] = want, circ, outs, vars_
    return _REFS[name, zk]


def build(name: str, zk: bool, timer=None, **place) -> LigeroCircuit:
    _, circ, outs, _ = reference(name, zk)
    place = place or {"device": "cpu"}
    return LigeroCircuit(convert.circuit_from_reference(circ), outs,
                         lambda_=LAMBDA, zk=zk, timer=timer, **place)


def dims(lig):
    return (lig.num_rows, lig.k, lig.n, len(lig.state.a_vals), lig.blind_t,
            lig.d2)


def force(monkeypatch, name: str, zk: bool, mode: str) -> None:
    """A budget under the direct estimate at ``mode``'s estimate ("resident"
    or "streaming") of a ragged cut of the data rows into three chunks or
    more, the largest chunk capped at the cut."""
    lig = build(name, zk)
    data, q = lig.num_rows - (3 if zk else 0), STREAM_ROW_QUANTUM
    cr = next(c for c in range(data // 3 // q * q, 0, -q) if data % c)
    budget = getattr(lig.backend, f"{mode}_bytes")(*dims(lig), chunk_rows=cr)
    assert budget < lig.backend.direct_bytes(*dims(lig))
    monkeypatch.setattr(TorchBackend, "memory_budget", lambda self: budget)
    monkeypatch.setattr(port_backend, "STREAM_MAX_CHUNK_ROWS", cr)


class Spy:
    """Records, while installed, every ``_start_open_async`` (the timer's
    counts at that moment and the handle) and every
    ``_finish_open_async`` (its handle)."""

    def __init__(self, monkeypatch):
        self.starts, self.finishes = [], []
        start = LigeroCircuit._start_open_async
        finish = LigeroCircuit._finish_open_async

        def spy_start(lig, u_canon, idx):
            handle = start(lig, u_canon, idx)
            self.starts.append((dict(lig.timer.counts), handle))
            return handle

        def spy_finish(lig, handle, tree):
            self.finishes.append(handle)
            return finish(lig, handle, tree)

        monkeypatch.setattr(LigeroCircuit, "_start_open_async", spy_start)
        monkeypatch.setattr(LigeroCircuit, "_finish_open_async", spy_finish)


def fused(monkeypatch) -> None:
    """Every proof of the test from here on takes the fused gather."""
    monkeypatch.setattr(LigeroCircuit, "_open_overlap_ok",
                        lambda self, u_canon, batch=1: False)


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------

ROUTES = ["plain", "zk", "batch", "resident", "streaming", "mesh"]


@pytest.mark.parametrize("case", ROUTES)
def test_route_choice_and_proof_bytes(case, monkeypatch):
    """A single direct-mode proof, plain and zk, takes the overlap (three
    starts, three finishes); a batch of two, forced resident and streaming
    mode and a mesh of two CPU devices take the fused gather (none).  Every
    proof equals the JAX package's."""
    zk = case in ("zk", "mesh")
    want, _, _, vars_ = reference("bn254", zk)
    if case in ("resident", "streaming"):
        force(monkeypatch, "bn254", zk, case)
    place = ({"backend": ShardedBackend(pf(BN254_FR), RowMesh(["cpu"] * 2))}
             if case == "mesh" else {})
    lig = build("bn254", zk, **place)
    assert lig.encode_mode == (case if case in ("resident", "streaming")
                               else "direct")
    spy = Spy(monkeypatch)
    kw = {"zk_seed": ZK_SEED} if zk else {}
    if case == "batch":
        proofs = lig.prove_batch([vars_, vars_], test_sponge(BN254_FR))
    else:
        proofs = [lig.prove(vars_, test_sponge(BN254_FR), **kw)]
    assert [p.to_bytes(pf(BN254_FR)) for p in proofs] == [want] * len(proofs)
    overlap = case in ("plain", "zk")
    assert len(spy.starts) == len(spy.finishes) == (3 if overlap else 0)


PARITY = [("bn254", False), ("bn254", True), ("bls12_377", False)]


@pytest.mark.parametrize("name,zk", PARITY,
                         ids=[f"{n}-{'zk' if z else 'plain'}"
                              for n, z in PARITY])
def test_overlap_proof_equals_jax_package_and_fused_route(name, zk,
                                                          monkeypatch):
    want, _, _, vars_ = reference(name, zk)
    field = FIELDS[name]
    kw = {"zk_seed": ZK_SEED} if zk else {}
    lig = build(name, zk)
    spy = Spy(monkeypatch)
    got = lig.prove(vars_, test_sponge(field), **kw)
    assert len(spy.starts) == 3
    fused(monkeypatch)
    got_fused = lig.prove(vars_, test_sponge(field), **kw)
    assert len(spy.starts) == 3
    assert got.to_bytes(pf(field)) == want == got_fused.to_bytes(pf(field))
    assert lig.verify(got, test_sponge(field))


@pytest.mark.parametrize("zk", [False, True], ids=["plain", "zk"])
def test_gathers_start_at_the_jax_packages_positions(zk, monkeypatch):
    """Set 1 starts after the interleaved phase (FS #4), set 2 after the
    linear phase (FS #7), set 3 after the quadratic phase (FS #10), each
    with the indices its proof opens; then each finishes once, in
    order."""
    _, _, _, vars_ = reference("bn254", zk)
    lig = build("bn254", zk, timer=PhaseTimer(enabled=True))
    spy = Spy(monkeypatch)
    kw = {"zk_seed": ZK_SEED} if zk else {}
    proof = lig.prove(vars_, test_sponge(BN254_FR), **kw)
    done = [{ph for ph in ("interleaved", "linear", "quadratic")
             if counts.get(ph)} for counts, _ in spy.starts]
    assert done == [{"interleaved"}, {"interleaved", "linear"},
                    {"interleaved", "linear", "quadratic"}]
    assert not any(counts.get("open.gather") for counts, _ in spy.starts)
    handles = [h for _, h in spy.starts]
    assert spy.finishes == handles
    for h, sub in zip(handles, (proof.interleaved, proof.linear,
                                proof.quadratic)):
        assert h.js == [path.leaf_index for path in sub.paths]


def test_error_of_a_started_gather_surfaces_at_its_finish(monkeypatch):
    """A gather that fails when started raises from ``prove`` once the
    prover waits for it (the later phases ran), and from
    ``gather_columns_finish`` on the backend."""
    _, _, _, vars_ = reference("bn254", False)
    lig = build("bn254", False, timer=PhaseTimer(enabled=True))

    def broken(self, u_canon, idx, non_blocking=False):
        raise RuntimeError("gather failed")

    monkeypatch.setattr(TorchBackend, "_gather_to_host", broken)
    with pytest.raises(RuntimeError, match="gather failed"):
        lig.prove(vars_, test_sponge(BN254_FR))
    assert lig.timer.counts["quadratic"] == 1
    assert lig.timer.counts["open.gather"] == 1
    pending = lig.backend.gather_columns_start(
        torch.zeros((4, 8, lig.field.num_limbs), dtype=torch.int32), [1, 2])
    assert isinstance(pending.err, RuntimeError)
    with pytest.raises(RuntimeError, match="gather failed"):
        lig.backend.gather_columns_finish(pending)


# ---------------------------------------------------------------------------
# the phase timer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["direct", "streaming"])
def test_timed_prove_counts_the_open_sub_phases(mode, monkeypatch):
    """``open.to_ints`` and ``open.paths`` three times each in one timed
    prove, in either route; ``open.gather`` three times on the overlap
    route, once on the fused one; ``report`` lists every phase with its
    count, the longest first, then every counter."""
    _, _, _, vars_ = reference("bn254", False)
    if mode == "streaming":
        force(monkeypatch, "bn254", False, mode)
    timer = PhaseTimer(enabled=True)
    lig = build("bn254", False, timer=timer)
    assert lig.encode_mode == mode
    lig.prove(vars_, test_sponge(BN254_FR))
    assert timer.counts["open.to_ints"] == timer.counts["open.paths"] == 3
    assert timer.counts["open.gather"] == (3 if mode == "direct" else 1)
    assert timer.counts["open"] == timer.counts["quadratic"] == 1
    assert set(timer.counts) == set(timer.totals)
    lines = timer.report().splitlines()
    assert timer.counters
    assert len(lines) == len(timer.totals) + len(timer.counters)
    phases, counters = lines[:len(timer.totals)], lines[len(timer.totals):]
    ms = [float(line.split()[1]) for line in phases]
    assert ms == sorted(ms, reverse=True)
    for line in phases:
        name = line.split()[0]
        assert line.endswith(f"x{timer.counts[name]}")
    assert [line.split() for line in counters] == [
        [name, str(timer.counters[name])] for name in sorted(timer.counters)]
    timer.reset()
    assert not timer.totals and not timer.counts and not timer.counters
    assert timer.report() == ""


def test_disabled_timer_keeps_nothing_and_trace_writes_a_chrome_trace(
        tmp_path):
    """A prove under the default (disabled) timer records nothing;
    ``trace`` over one transform writes one Chrome trace."""
    _, _, _, vars_ = reference("bn254", False)
    lig = build("bn254", False)
    lig.prove(vars_, test_sponge(BN254_FR))
    assert not lig.timer.totals and not lig.timer.counts
    coeffs = torch.zeros((2, lig.k, lig.field.num_limbs), dtype=torch.int32)
    with trace(str(tmp_path / "trace")) as prof:
        lig.backend.ntt(coeffs, lig.n)
    assert prof.key_averages()
    files = os.listdir(tmp_path / "trace")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    with open(tmp_path / "trace" / files[0]) as f:
        assert json.load(f)["traceEvents"]


# ---------------------------------------------------------------------------
# malloc tuning at import
# ---------------------------------------------------------------------------

PROBE = '''
import ctypes, json, sys
import ligero_tpu_torch
from ligero_tpu_torch import native
libc = ctypes.CDLL(None)
libc.malloc.restype = libc.sbrk.restype = ctypes.c_void_p
libc.malloc.argtypes, libc.sbrk.argtypes = [ctypes.c_size_t], [ctypes.c_long]
libc.free.argtypes = [ctypes.c_void_p]
p = libc.malloc(1 << 26)     # above glibc's largest default mmap threshold
top = libc.sbrk(0)
libc.free(p)
print(json.dumps({"tuned": native.MALLOC_TUNED, "on_brk_heap": p < top,
                  "loaded": [m for m in ("jax", "ligero_tpu")
                             if m in sys.modules]}))
'''


@pytest.mark.parametrize("tune", ["default", "0"])
def test_import_tunes_malloc_unless_disabled(tune):
    """``import ligero_tpu_torch`` raises the mmap threshold (a 64 MiB
    malloc then comes from the brk heap, below its top) unless
    ``LIGERO_MALLOC_TUNE=0``; it loads neither jax nor the JAX package."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    env.pop("LIGERO_MALLOC_TUNE", None)
    if tune == "0":
        env["LIGERO_MALLOC_TUNE"] = "0"
    res = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    out = json.loads(res.stdout.splitlines()[-1])
    tuned = tune == "default"
    assert out == {"tuned": tuned, "on_brk_heap": tuned, "loaded": []}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name,zk", PARITY,
                         ids=[f"{n}-{'zk' if z else 'plain'}"
                              for n, z in PARITY])
def test_overlap_on_the_card_equals_fused_route_side_stream_pinned(
        cuda, name, zk, monkeypatch):
    """On the card: the overlap route's proof equals the fused route's
    and the JAX package's; each set's copy ran on the backend's side
    stream, not the current one, into pinned host memory, and its event
    completed."""
    want, _, _, vars_ = reference(name, zk)
    field = FIELDS[name]
    kw = {"zk_seed": ZK_SEED} if zk else {}
    lig = build(name, zk, device="cuda")
    spy = Spy(monkeypatch)
    got = lig.prove(vars_, test_sponge(field), **kw)
    handles = [h for _, h in spy.starts]
    assert len(handles) == 3
    current = torch.cuda.current_stream(cuda)
    for h in handles:
        assert h.err is None and h.stream is lig.backend.side_stream()
        assert h.stream != current
        assert h.host.is_pinned() and h.host.dtype == torch.int16
        assert h.event.query()
    fused(monkeypatch)
    got_fused = lig.prove(vars_, test_sponge(field), **kw)
    assert got.to_bytes(pf(field)) == want == got_fused.to_bytes(pf(field))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert lig.verify(got, test_sponge(field))
