"""The run's guard against JAX and the JAX package, and its refusal to
run without the cards a cell asks for."""

from __future__ import annotations

import subprocess
import sys
import types

from conftest import ROOT
from harness.cell import blocked_modules


def test_blocked_modules_by_whole_top_level_name():
    mods = {"ligero_tpu_torch": types.ModuleType("x"),
            "ligero_tpu_torch.ligero": types.ModuleType("x"),
            "numpy": types.ModuleType("x"), "jax": None}
    assert blocked_modules(mods) == []
    mods.update({"jax.numpy": types.ModuleType("x"),
                 "ligero_tpu.core": types.ModuleType("x"),
                 "flax": types.ModuleType("x")})
    assert blocked_modules(mods) == ["flax", "jax", "ligero_tpu"]
    assert blocked_modules({"jaxlib": types.ModuleType("x")}) == ["jaxlib"]


def test_run_prints_no_result_when_a_jax_module_is_loaded(monkeypatch,
                                                          capsys):
    import torch

    import harness.cell
    import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness.cell, "run_cell",
                        lambda *a, **k: ({"correct": True}, []))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.main(["--workload", "bn254-2p20.single", "--seed", "1",
                     "--seconds", "1"]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "jax" in out.err
    monkeypatch.delitem(sys.modules, "jax")
    assert run.main(["--workload", "bn254-2p20.single", "--seed", "1",
                     "--seconds", "1"]) == 0
    assert capsys.readouterr().out.strip() == '{"correct": true}'


def test_run_without_a_card_prints_no_result():
    """Here there is no CUDA device: exit 1, nothing on standard output."""
    import torch

    if torch.cuda.is_available():
        return
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "bn254-2p20.single", "--seed", "5", "--seconds",
                          "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 1 and res.stdout == ""
