"""The readers of the program's serialisation spans on a hand-made trace:
exact names only (the nested ``columns.*`` spans and the benchmark's own
``bench.*`` spans left out), over the proofs; None without a device event
or without the spans."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from conftest import ROOT
from harness.cell import Cell
from harness.trace import Trace

CELLS = ["bn254-2p20.single", "bls12_377-2p20.batch3", "bn254-2p20.batch3"]
#: (metric, its span, the benchmark's span around the same call)
METRICS = [("to_bytes_ms.prove", "proof.to_bytes", "bench.to_bytes/0"),
           ("from_bytes_ms.verify", "proof.from_bytes", "bench.from_bytes/0")]


def trace(span: str, outer: str, device: bool = True) -> Trace:
    """Two proofs' spans of 3 and 5 ms with column spans nested in them,
    inside the benchmark's span of the same call."""
    kind = span.split(".")[1]                     # to_bytes / from_bytes
    t = Trace.__new__(Trace)
    t.device = ([("void ntt_pass_kernel<Fr>(PassArgs)", 0, 1_000_000)]
                if device else [])
    t._starts = [e[1] for e in t.device]
    t.spans = [(outer, 0, 10_000_000),
               (span, 1_000_000, 4_000_000),
               (f"columns.{kind}", 1_500_000, 2_000_000),
               (f"columns.{kind}", 2_000_000, 3_500_000),
               (span, 4_000_000, 9_000_000),
               (f"columns.{kind}", 4_500_000, 8_000_000),
               (span + "/x", 9_000_000, 9_500_000)]   # another name
    return t


def reader(name: str):
    return Cell.find(ROOT, CELLS[0]).reader(name)


@pytest.mark.parametrize("metric,span,outer", METRICS)
def test_reader_sums_its_exact_spans_over_the_proofs(metric, span, outer):
    run = SimpleNamespace(trace=trace(span, outer), proofs=2)
    assert reader(metric).read(run) == pytest.approx((3.0 + 5.0) / 2)


@pytest.mark.parametrize("metric,span,outer", METRICS)
def test_reader_finds_nothing_without_a_device_event_or_the_spans(
        metric, span, outer):
    run = SimpleNamespace(trace=trace(span, outer, device=False), proofs=2)
    assert reader(metric).read(run) is None
    bare = trace(span, outer)
    bare.spans = [s for s in bare.spans if s[0] != span]
    assert reader(metric).read(SimpleNamespace(trace=bare, proofs=2)) is None


@pytest.mark.parametrize("cell", CELLS)
def test_every_accepted_cell_reads_both(cell):
    found = Cell.find(ROOT, cell)
    names = {m["name"]: m for m in found.per_layer}
    for metric, _, _ in METRICS:
        entry = names[metric]
        assert entry["source"] == "program_span"
        assert entry["layer"] == "proof serialisation, host (ligero/proof.py)"
        assert found.reader(metric).MOVES == entry["moves"]
