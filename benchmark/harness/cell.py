"""One run of one cell: set-up, the measured window, the checks, the line.

Everything a cell is made of is found by name: its entry in
``BENCHMARK.json`` names a configuration (whose entry names its file) and
a traffic mix (``benchmark/traffic/<mix>.json``); each metric is a reader
of its own (``benchmark/metrics/<metric>.py``, a ``read(run)`` that returns
a number, or None where it finds nothing to read).  The program under test
is ``ligero_tpu_torch``; the reference (``benchmark/reference``) imports
nothing of it.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import random
import sys
import time
from dataclasses import dataclass, field as dfield

from reference.check import Instance, check_proof
from reference.field import Field

from . import generator
from .trace import Trace

BLOCKED = ("jax", "jaxlib", "flax", "ligero_tpu")


class CellError(RuntimeError):
    """A cell that cannot be run as the manifest states it."""


def blocked_modules(modules=None) -> list[str]:
    """Top-level names of loaded modules that no run may hold: JAX, its
    libraries and the JAX package (compared whole, so ``ligero_tpu_torch``
    passes)."""
    modules = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name, mod in modules.items()
                   if mod is not None and name.split(".")[0] in BLOCKED})


def log(msg: str) -> None:
    print(f"[bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """A workload of the manifest with its configuration, mix and metric
    entries."""

    root: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list

    @classmethod
    def find(cls, root: str, name: str) -> "Cell":
        man = load_json(os.path.join(root, "BENCHMARK.json"))
        work = [w for w in man["workloads"] if w["name"] == name]
        if not work:
            raise CellError(f"no workload {name!r} in BENCHMARK.json")
        work = work[0]
        conf = [c for c in man["configs"] if c["name"] == work["config"]][0]
        config = load_json(os.path.join(root, conf["file"]))
        traffic = load_json(os.path.join(root, "benchmark", "traffic",
                                         work["traffic"] + ".json"))

        def mine(metrics):
            return [m for m in metrics
                    if name in m.get("workloads", [name])]

        return cls(root, work, config, traffic, mine(man["end_to_end"]),
                   mine(man["per_layer"]))

    def reader(self, metric: str):
        path = os.path.join(self.root, "benchmark", "metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location(
            "bench_metric_" + metric.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


@dataclass
class Round:
    """One closed-loop round: B witnesses proved in one call, their proofs'
    bytes verified in one call."""

    witnesses: list
    proofs: list
    verdicts: list
    prove_s: float
    verify_s: float


@dataclass
class Run:
    """What a run measured, as the metric readers read it."""

    cell: Cell
    setup_s: float
    rounds: list
    window_s: float
    peak_bytes: int
    batch: int
    dims: dict
    limbs: int
    phases: dict = dfield(default_factory=dict)
    trace: Trace | None = None

    @property
    def proofs(self) -> int:
        """Proofs, and so verdicts, of the window."""
        return sum(len(r.verdicts) for r in self.rounds)

    def spans(self, call: str) -> list:
        """Host spans of every ``call`` ("prove" or "verify") of the
        window."""
        return self.trace.spans_named(f"bench.{call}/")

    def phase_s(self, *names) -> float | None:
        """Summed PhaseTimer seconds of ``names`` over the window, None
        where none ran."""
        if not any(n in self.phases for n in names):
            return None
        return sum(self.phases.get(n, 0.0) for n in names)

    def device_s(self, call: str, keep) -> float | None:
        """Device seconds, inside ``call``'s spans, of the event groups
        ``keep`` accepts (``trace.group``); None where there are none."""
        ns = self.trace.device_ns(self.spans(call), keep)
        return ns / 1e9 if ns else None

    def idle_pct(self, call: str) -> float | None:
        spans = self.spans(call)
        wall = sum(e - s for s, e in spans)
        if not wall or not self.trace.device:
            return None
        return 100.0 * (1.0 - self.trace.busy_ns(spans) / wall)


class Client:
    """The closed loop's one client: draws the witnesses of a round, hands
    them to the prover and the proofs' bytes to the verifier, waits for
    each."""

    def __init__(self, lig, cell: Cell, circuit, seed: int, traced: bool):
        import torch

        from ligero_tpu_torch.ligero.proof import LigeroProof
        from ligero_tpu_torch.sponge import test_sponge

        self.lig, self.circuit, self.seed = lig, circuit, seed
        self.field = lig.field
        self.sponge = test_sponge(self.field)
        self.batch = int(cell.traffic["batch"])
        self.proof_type = LigeroProof
        self.torch, self.traced = torch, traced
        self.cuda = lig.device.type == "cuda"

    def _sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def _span(self, name: str):
        if self.traced:
            return self.torch.profiler.record_function(name)
        return contextlib.nullcontext()

    def round(self, stream: str, index: int) -> Round:
        lig, f, B = self.lig, self.field, self.batch
        wits = [generator.witness(f.p, self.circuit, self.seed, stream,
                                  index * B + i) for i in range(B)]
        assigns = [sorted(w.items()) for w in wits]
        self._sync()
        t0 = time.perf_counter()
        with self._span(f"bench.prove/{index}"):
            if B == 1:
                proofs = [lig.prove(assigns[0], self.sponge.clone())]
            else:
                proofs = lig.prove_batch(assigns, self.sponge)
            with self._span(f"bench.to_bytes/{index}"):
                blobs = [pf.to_bytes(f) for pf in proofs]
            self._sync()
        t1 = time.perf_counter()
        with self._span(f"bench.verify/{index}"):
            with self._span(f"bench.from_bytes/{index}"):
                parsed = [self.proof_type.from_bytes(b, f) for b in blobs]
            if B == 1:
                verdicts = [lig.verify(parsed[0], self.sponge.clone())]
            else:
                verdicts = lig.verify_batch(parsed, self.sponge)
            self._sync()
        t2 = time.perf_counter()
        return Round(wits, blobs, [bool(v) for v in verdicts], t1 - t0,
                     t2 - t1)

    def tampered_verdicts(self, rnd: Round) -> list[bool]:
        """The round's proofs verified again, the first with its first
        interleaved coefficient raised by one: False, then True each."""
        f = self.field
        blob = bytearray(rnd.proofs[0])
        at = 8 + 32 + 8                      # past the root and lc's length
        size = (f.p.bit_length() + 7) // 8
        value = int.from_bytes(blob[at:at + size], "little")
        blob[at:at + size] = ((value + 1) % f.p).to_bytes(size, "little")
        parsed = [self.proof_type.from_bytes(bytes(blob), f)] + [
            self.proof_type.from_bytes(b, f) for b in rnd.proofs[1:]]
        if len(parsed) == 1:
            return [bool(self.lig.verify(parsed[0], self.sponge.clone()))]
        return [bool(v) for v in self.lig.verify_batch(parsed, self.sponge)]


def program_circuit(field, circ):
    """The generated DAG as the program's ``ArithmeticCircuit``, built
    through its own constructors; (circuit, outputs)."""
    from ligero_tpu_torch.circuit.arithmetic import ArithmeticCircuit
    from reference.check import ADD, CONST, MUL, VAR

    c = ArithmeticCircuit(field)
    kinds = circ.kinds.tolist()
    lefts, rights = circ.lefts.tolist(), circ.rights.tolist()
    for i, kind in enumerate(kinds):
        if kind == CONST:
            got = c.constant(circ.consts[i])
        elif kind == VAR:
            got = c.new_variable()
        elif kind == ADD:
            got = c.add(lefts[i], rights[i])
        elif kind == MUL:
            got = c.mul(lefts[i], rights[i])
        if got != i:
            raise CellError(f"node {i} landed at {got}")
    return c, list(circ.outputs)


def span_timer():
    """The program's PhaseTimer, enabled, each phase also a profiler span
    (so that the trace can say what the host did while the device
    idled)."""
    import torch

    from ligero_tpu_torch.utils.profiling import PhaseTimer

    class SpanTimer(PhaseTimer):
        @contextlib.contextmanager
        def phase(self, name: str):
            with torch.profiler.record_function(name), super().phase(name):
                yield

    return SpanTimer(enabled=True)


def run_cell(root: str, workload: str, seed: int, seconds: float,
             traced: bool, t_start: float, device: str = "cuda",
             lambda_: int | None = None) -> tuple[dict, list]:
    """One run: the result line's object and the compared numbers
    [(name, value, limit)].  ``lambda_`` replaces the configuration's
    soundness level in the program (the control; the reference keeps the
    configuration's)."""
    import torch

    from ligero_tpu_torch.fields import FIELDS
    from ligero_tpu_torch.ligero import LigeroCircuit

    cell = Cell.find(root, workload)
    cfg, mix = cell.config, cell.traffic
    if mix["loop"] != "closed" or mix["clients"] != 1 or cfg["zk"]:
        raise CellError("the harness drives one closed-loop client over "
                        "non-zk instances")
    field = FIELDS[cfg["field"]]
    circ = generator.make_circuit(cfg, seed)
    ac, outputs = program_circuit(field, circ)
    timer = span_timer() if traced else None
    lig = LigeroCircuit(ac, outputs, lambda_=lambda_ or cfg["lambda"],
                        rate_inv=cfg["rate_inv"], zk=False, device=device,
                        timer=timer)
    dims = {"m": lig.m, "k": lig.k, "n": lig.n, "t": lig.t}
    want = dict(cfg["expected"])
    if lambda_ is not None:
        want["t"] = dims["t"]
    if dims != want or lig.encode_mode != cfg["mode"]:
        raise CellError(f"instance {dims} in {lig.encode_mode} mode, the "
                        f"configuration states {cfg['expected']} in "
                        f"{cfg['mode']} mode")
    log(f"set-up: {lig.encode_mode} mode, {dims}")
    client = Client(lig, cell, circ, seed, traced)
    warm = client.round("warm", 0)
    log(f"warm round: prove {warm.prove_s:.3f} s, verify "
        f"{warm.verify_s:.3f} s")
    cuda = lig.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start

    prof = None
    if traced:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        timer.reset()
    # the rounds whose proofs are checked: ``check_rounds`` of the
    # window's, uniform over them, drawn from the seed as they complete
    # (a reservoir), so that only those rounds' proofs are held
    draw = random.Random(f"{seed}/check")
    want_rounds = int(mix["check_rounds"])
    rounds, picked = [], []
    t0 = time.perf_counter()
    with client._span("bench.window"):
        while time.perf_counter() - t0 < seconds:
            rnd = client.round("window", len(rounds))
            rounds.append(rnd)
            slot = (len(rounds) - 1 if len(rounds) <= want_rounds
                    else draw.randrange(len(rounds)))
            if slot < len(picked):
                picked[slot].proofs = picked[slot].witnesses = None
                picked[slot] = rnd
            elif slot < want_rounds:
                picked.append(rnd)
            else:
                rnd.proofs = rnd.witnesses = None
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    trace = None
    if traced:
        prof.stop()
        trace = Trace(prof)
        del prof
    log(f"window: {len(rounds)} rounds in {window_s:.3f} s; prove walls "
        f"{[round(r.prove_s, 4) for r in rounds]}, verify walls "
        f"{[round(r.verify_s, 4) for r in rounds]}")
    run = Run(cell, setup_s, rounds, window_s, peak, client.batch, dims,
              field.num_limbs,
              dict(timer.totals) if traced else {}, trace)

    # the checks: every verdict of the window and of the warm round; the
    # picked rounds' first proof tampered for the program's verifier and
    # every proof of theirs held against the reference once the program
    # is gone
    honest_rejected = sum(not v for r in [warm] + rounds for v in r.verdicts)
    tampered_accepted = 0
    for chosen in picked:
        verdicts = client.tampered_verdicts(chosen)
        tampered_accepted += int(verdicts[0])
        honest_rejected += sum(not v for v in verdicts[1:])
    samples = [(w, pf) for chosen in picked
               for w, pf in zip(chosen.witnesses, chosen.proofs)]
    del client, lig, warm
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    inst = Instance.build(Field.from_config(cfg["field_params"]), circ,
                          cfg["lambda"], cfg["rate_inv"])
    fails: dict = {}
    for j, (wit, blob) in enumerate(samples):
        t_ref = time.perf_counter()
        got = check_proof(inst, wit, blob, random.Random(f"{seed}/ref/{j}"),
                          device)
        log(f"reference: proof {j} checked in "
            f"{time.perf_counter() - t_ref:.3f} s")
        for name, count in got.items():
            fails[name] = fails.get(name, 0) + count
    checks = [("honest_rejected", honest_rejected, 0),
              ("tampered_accepted", tampered_accepted, 0),
              ("unchecked", want_rounds * run.batch - len(samples), 0)]
    checks += [(f"ref_{name}", count, 0) for name, count in fails.items()]
    return result(run, traced, checks, device), checks


def result(run: Run, traced: bool, checks: list, device: str) -> dict:
    """The result line's object; ``checks`` last."""
    import torch

    metrics = {}
    for m in (run.cell.per_layer if traced else run.cell.end_to_end):
        value = run.cell.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    cuda = device.startswith("cuda")
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(run.cell.workload["chips"]),
           "memory_peak_bytes": run.peak_bytes}
    out = {"correct": all(v <= lim for _, v, lim in checks),
           "attempted": run.proofs,
           "failed": sum(not v for r in run.rounds for v in r.verdicts),
           "metrics": metrics, "device": dev}
    if traced:
        window = run.trace.spans_named("bench.window")
        dev["busy_s"] = run.trace.busy_ns(window) / 1e9
        dev["window_s"] = run.window_s
        out["breakdown"] = {
            "device_ops": run.trace.top_device_ops(window),
            "idle_gaps": run.trace.idle_gaps(window[0]) if window else []}
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in checks}
    return out
