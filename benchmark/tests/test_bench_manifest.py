"""BENCHMARK.json against the shapes its readers rely on; every file a
cell is made of found by name; a cell added from new files alone runs."""

from __future__ import annotations

import json
import os
import re

import pytest

from conftest import BENCH, ROOT, run_small

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def manifest() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_manifest_keys_names_and_units():
    man = manifest()
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(man["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in man["paths"])
    assert len(man["command"]) <= 32 and all(line(w) for w in man["command"])
    seconds = man["run_seconds"]
    assert isinstance(seconds, int) and 1 <= seconds <= 51
    names = []
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line(c["source"]) and line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    cells = []
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and line(w["why"])
        assert w["config"] in names and NAME.match(w["traffic"])
        cells.append(w["name"])
    assert 1 <= len(cells) <= 24
    pairs = {(w["config"], w["traffic"]) for w in man["workloads"]}
    assert len(pairs) == len(cells)
    assert {w["config"] for w in man["workloads"]} == set(names)
    e2e = []
    for m in man["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        e2e.append(m["name"])
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    for m in man["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES and line(m["layer"])
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= set(cells)
    for m in man["end_to_end"] + man["per_layer"]:
        assert m["better"] in ("lower", "higher") and UNIT.match(m["unit"])
    every = names + cells + e2e + [m["name"] for m in man["per_layer"]]
    assert all(NAME.match(n) for n in every)
    assert len(set(names)) == len(names) and len(set(cells)) == len(cells)
    assert len(set(every)) == len(every)


def test_every_file_found_by_name():
    man = manifest()
    for c in man["configs"]:
        assert c["file"].startswith("benchmark/")
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in man["workloads"]:
        with open(os.path.join(BENCH, "traffic", w["traffic"] + ".json")) as f:
            assert json.load(f)["name"] == w["traffic"]
    from harness.cell import Cell

    for w in man["workloads"]:
        cell = Cell.find(ROOT, w["name"])
        for m in cell.end_to_end + cell.per_layer:
            reader = cell.reader(m["name"])
            assert callable(reader.read)
            if m in cell.per_layer:
                assert reader.MOVES == m["moves"]


@pytest.mark.parametrize("name", ["bn254-2p20", "bls12_377-2p20"])
def test_configuration_states_its_instance(name):
    """m, k, n, t as the reference works them out from the circuit the
    configuration makes (generating the gates only: no evaluation)."""
    from harness.generator import make_circuit
    from reference.check import Instance
    from reference.field import Field

    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        cfg = json.load(f)
    inst = Instance.build(Field.from_config(cfg["field_params"]),
                          make_circuit(cfg, 5), cfg["lambda"], cfg["rate_inv"])
    dims = {"m": inst.m, "k": inst.k, "n": inst.n, "t": inst.t}
    assert dims == cfg["expected"]
    gates = len(inst.circuit.kinds) - 1 - cfg["num_vars"]
    assert gates == 2 ** cfg["log2_gates"]


def test_added_cell_runs(small_cell):
    """A cell made of a new configuration file, a new traffic file and
    appended entries runs through the harness unchanged, correct, with
    every end-to-end metric; the existing entries stay as they were."""
    root, cell = small_cell
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        grown = json.load(f)
    man = manifest()
    for key in man:
        if isinstance(man[key], list):
            assert grown[key][:len(man[key])] == man[key]
    assert len(grown["workloads"]) == len(man["workloads"]) + 1
    out, checks = run_small(root, cell)
    assert out["correct"], checks
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"prove_s", "verify_s", "setup_s"}
    assert list(out)[-1] == "checks"


def test_traced_run_reads_the_phase_timer(tree):
    """A traced run of a small cell on the CPU: the PhaseTimer's readers
    read, the device's find nothing (no card) and are left out."""
    from conftest import add_cell, small_config, traffic

    cell = add_cell(tree, small_config("bls12_377-2p20"), traffic("t1", 1),
                    "a small traced cell", per_layer=True)
    out, checks = run_small(tree, cell, traced=True)
    assert out["correct"], checks
    assert {"witness_ms.prove", "open_host_ms.prove",
            "verify_host_ms.verify"} == set(out["metrics"])
    assert out["device"]["busy_s"] == 0 and out["device"]["window_s"] > 0
    assert out["breakdown"]["device_ops"] == []
