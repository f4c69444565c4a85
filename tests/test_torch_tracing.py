"""The port's tracing on device="cpu": the phase timer sets no barrier; its
phases and the program's own spans (proof serialisation, the transcript,
the conversions from the device, the verifier's stages) reach a
``torch.profiler`` trace with each proof's index where a batch runs a
phase once a proof, while ``totals`` and ``counts`` keep the bare names;
the host <-> device byte counters; a profiler that is off and a disabled
timer record nothing.  Input: the seeded 2^6-gate synthetic circuit."""

import contextlib

import pytest
import torch

from ligero_tpu_torch import BN254_FR, LigeroCircuit, test_sponge
from ligero_tpu_torch.ligero.proof import LigeroProof
from ligero_tpu_torch.synthetic import generate_random_circuit
from ligero_tpu_torch.utils.profiling import PhaseTimer, span

# one intra-op thread: the workers of the suite share the host's cores
torch.set_num_threads(1)


def circuit(timer=None) -> tuple[LigeroCircuit, list]:
    circ, outs, vars_ = generate_random_circuit(BN254_FR, 1 << 6, seed=6)
    return LigeroCircuit(circ, outs, device="cpu", timer=timer), vars_


def round_trip(lig, vars_, batch: int) -> list[bool]:
    """``prove_batch`` of ``batch`` witnesses, the proofs to bytes and
    back, ``verify_batch`` of them."""
    sponge = test_sponge(BN254_FR)
    blobs = [pf.to_bytes(BN254_FR)
             for pf in lig.prove_batch([vars_] * batch, sponge)]
    return lig.verify_batch([LigeroProof.from_bytes(b, BN254_FR)
                             for b in blobs], sponge)


def user_spans(prof) -> list[str]:
    return [ev.name() for ev in prof.profiler.kineto_results.events()
            if ev.is_user_annotation()]


@pytest.fixture(scope="module")
def traced():
    """(span names, timer) of a batch of two proved and verified under
    ``torch.profiler`` with an enabled timer."""
    timer = PhaseTimer(enabled=True)
    lig, vars_ = circuit(timer)
    with torch.profiler.profile() as prof:
        assert round_trip(lig, vars_, 2) == [True, True]
    return user_spans(prof), timer


def test_enabled_timer_never_synchronises(monkeypatch):
    """With a card that looks initialised, a timed prove and verify never
    reach the current stream or a device synchronisation."""
    def no_barrier(*args, **kwargs):
        raise AssertionError("the timer synchronised the device")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_stream", no_barrier)
    monkeypatch.setattr(torch.cuda, "synchronize", no_barrier)
    timer = PhaseTimer(enabled=True)
    with timer.phase("outer"), timer.phase("inner/3"):
        pass
    lig, vars_ = circuit(timer)
    sponge = test_sponge(BN254_FR)
    assert lig.verify(lig.prove(vars_, sponge.clone()), sponge.clone())
    assert timer.counts["outer"] == timer.counts["inner"] == 1
    assert timer.counts["open.to_ints"] == 3


@pytest.mark.parametrize("name", [
    "open.to_ints/0", "open.to_ints/1", "open.paths/1", "linear.polyprod/1",
    "witness+preenc/1", "proof.to_bytes", "proof.from_bytes",
    "columns.from_bytes", "columns.to_bytes", "v.reveal", "v.interleaved/1",
    "v.linear/1", "v.quadratic/1", "transcript.absorb", "transcript.squeeze",
    "ints.from_device"])
def test_batch_trace_holds_the_program_spans(traced, name):
    spans, _ = traced
    assert name in spans


def test_batch_totals_and_counts_take_bare_names(traced):
    """Per-proof phases are summed under the name before the slash: three
    index sets a proof, two proofs."""
    spans, timer = traced
    assert set(timer.totals) == set(timer.counts)
    assert not any("/" in name for name in timer.totals)
    assert timer.counts["open.to_ints"] == timer.counts["open.paths"] == 6
    assert timer.counts["v.interleaved"] == timer.counts["v.quadratic"] == 2
    # the batch's upload of the message rows beside each proof's witness
    assert timer.counts["witness+preenc"] == 3
    assert spans.count("proof.to_bytes") == 2
    assert spans.count("columns.to_bytes") == 6


def test_subclass_overriding_phase_still_fills_totals():
    """A timer that wraps each phase in a span of its own and calls the
    parent's ``phase(name)``, as the benchmark's does, keeps totals,
    counts and counters."""
    class Wrapped(PhaseTimer):
        @contextlib.contextmanager
        def phase(self, name: str):
            with torch.profiler.record_function(name), super().phase(name):
                yield

    timer = Wrapped(enabled=True)
    lig, vars_ = circuit(timer)
    lig.prove(vars_, test_sponge(BN254_FR))
    assert {"witness+preenc", "commit", "open.to_ints"} <= set(timer.totals)
    assert timer.counts["open.paths"] == 3
    assert timer.counters["h2d.bytes@witness+preenc"] > 0


def test_profiler_off_and_timer_disabled_record_nothing(monkeypatch):
    """No span is made (making one raises here) and the default timer
    keeps no total, count or counter through a whole round trip."""
    def no_span(name):
        raise AssertionError(f"a span {name!r} was made")

    monkeypatch.setattr(torch.profiler, "record_function", no_span)
    lig, vars_ = circuit()
    assert round_trip(lig, vars_, 2) == [True, True]
    assert not lig.timer.enabled
    assert not lig.timer.totals and not lig.timer.counts
    assert not lig.timer.counters
    assert isinstance(span("x"), contextlib.nullcontext)


def test_h2d_bytes_cover_the_message_rows():
    """One prove counts at least the 4m message rows' k limbs of L 16-bit
    words as uploaded in the witness phase, and the opened columns as
    read back in the openings."""
    timer = PhaseTimer(enabled=True)
    lig, vars_ = circuit(timer)
    lig.prove(vars_, test_sponge(BN254_FR))
    rows = 4 * lig.m * lig.k * lig.field.num_limbs * 2
    h2d = sum(v for k, v in timer.counters.items()
              if k.startswith("h2d.bytes"))
    assert h2d >= timer.counters["h2d.bytes@witness+preenc"] >= rows
    opened = 3 * lig.t * lig.num_rows * lig.field.num_limbs * 2
    assert timer.counters["d2h.bytes@open.gather"] == opened
