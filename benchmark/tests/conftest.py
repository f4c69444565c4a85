"""Tests of the benchmark (CPU, small circuits; a test that needs the card
is marked ``cuda`` and skips here).  Run from the repository's root:

    python -m pytest benchmark/tests -q -n 4
"""

from __future__ import annotations

import json
import os
import shutil
import sys

import pytest
import torch

# one intra-op thread a worker: pytest-xdist's workers otherwise spin
# their thread pools against each other
torch.set_num_threads(1)

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for path in (BENCH, ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)

#: the small circuits of the CPU runs: 2^8 gates, m 18, k 32, n 256
SMALL_LOG2 = 8


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where torch.cuda is "
        "unavailable")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return "cuda"


def small_config(name: str, log2: int = SMALL_LOG2) -> dict:
    """A configuration of the manifest at 2^log2 gates: its file's
    content, the instance it states worked out again."""
    from harness.generator import make_circuit
    from reference.check import Instance
    from reference.field import Field

    with open(os.path.join(BENCH, "configs", name + ".json")) as f:
        cfg = json.load(f)
    cfg["name"] = name.replace("2p20", f"2p{log2}")
    cfg["log2_gates"] = log2
    inst = Instance.build(Field.from_config(cfg["field_params"]),
                          make_circuit(cfg, 1), cfg["lambda"],
                          cfg["rate_inv"])
    cfg["expected"] = {"m": inst.m, "k": inst.k, "n": inst.n, "t": inst.t}
    return cfg


def add_cell(root: str, cfg: dict, traffic: dict, why: str,
             per_layer: bool = False) -> str:
    """Add a cell to the benchmark tree at ``root`` the way a later change
    does: a new configuration file, a new traffic file, one configuration
    entry and one workload entry appended (``per_layer``: the cell also
    added to the per-layer metrics' lists)."""
    cfile = f"benchmark/configs/{cfg['name']}.json"
    with open(os.path.join(root, cfile), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "benchmark", "traffic",
                           traffic["name"] + ".json"), "w") as f:
        json.dump(traffic, f)
    man_path = os.path.join(root, "BENCHMARK.json")
    with open(man_path) as f:
        man = json.load(f)
    man["configs"].append({"name": cfg["name"], "source": cfg["source"],
                           "file": cfile, "reduced": [], "why": why})
    cell = f"{cfg['name']}.{traffic['name']}"
    man["workloads"].append({"name": cell, "config": cfg["name"],
                             "traffic": traffic["name"], "chips": 1,
                             "why": why})
    for metric in man["per_layer"] if per_layer else []:
        metric["workloads"].append(cell)
    with open(man_path, "w") as f:
        json.dump(man, f, indent=1)
    return cell


@pytest.fixture
def tree(tmp_path):
    """A copy of the benchmark (``BENCHMARK.json`` and ``benchmark/``)."""
    root = str(tmp_path / "checkout")
    os.makedirs(root)
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(BENCH, os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    return root


def traffic(name: str, batch: int, check_rounds: int = 1) -> dict:
    return {"name": name, "loop": "closed", "clients": 1, "batch": batch,
            "check_rounds": check_rounds, "what": "a test's mix"}


@pytest.fixture
def small_cell(tree):
    """(root, cell name): a 2^8-gate BN254 cell of one proof a round,
    added to the copy as a later change would."""
    return tree, add_cell(tree, small_config("bn254-2p20"),
                          traffic("t1", 1), "a small test cell")


@pytest.fixture
def small_batch_cell(tree):
    return tree, add_cell(tree, small_config("bn254-2p20"),
                          traffic("t3", 3), "a small batch cell")


def run_small(root: str, cell: str, seed: int = 2**31 + 17,
              seconds: float = 0.5, traced: bool = False, **kw):
    """One run of a small cell on the CPU (the harness's look for a card
    skipped): (result, checks)."""
    import time

    from harness.cell import run_cell

    return run_cell(root, cell, seed, seconds, traced, time.perf_counter(),
                    device="cpu", **kw)
