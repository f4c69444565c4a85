"""The comparison that decides ``correct``, shown to fail: whole runs of a
small cell (the look for a card skipped) with the timed path broken
underneath, and the control, the program at the soundness level one
below the configuration's (one column fewer a set)."""

from __future__ import annotations

import pytest

from conftest import run_small


def test_sound_run_is_correct(small_batch_cell):
    root, cell = small_batch_cell
    out, checks = run_small(root, cell)
    assert out["correct"], checks
    assert all(v == 0 for _, v, _ in checks)


def test_control_fails(small_cell):
    """The control: lambda 127 instead of the configuration's 128."""
    root, cell = small_cell
    out, checks = run_small(root, cell, lambda_=127)
    assert not out["correct"]
    got = dict((n, v) for n, v, _ in checks)
    assert got["ref_shape"] > 0 and got["ref_indices"] > 0
    assert got["honest_rejected"] == 0       # the program accepts its own


def test_state_left_unchanged_fails(small_cell, monkeypatch):
    """A step that returns its state unchanged: the transcript's absorb
    of the revealed polynomials does nothing.  The program's own verifier
    shares the fault and accepts; the reference does not."""
    from ligero_tpu_torch.sponge import PoseidonSponge

    root, cell = small_cell
    monkeypatch.setattr(PoseidonSponge, "absorb_field_elems",
                        lambda self, elems: None)
    out, checks = run_small(root, cell)
    got = dict((n, v) for n, v, _ in checks)
    assert not out["correct"] and got["honest_rejected"] == 0
    assert got["ref_indices"] > 0


def test_half_batch_left_out_fails(small_batch_cell, monkeypatch):
    """Half of the batch left out: the batch's later proofs are copies
    of what the first half proved."""
    from ligero_tpu_torch.ligero.core import LigeroCircuit

    root, cell = small_batch_cell
    real = LigeroCircuit._prove_many

    def half(self, assignments, sponges, seeds):
        keep = (len(assignments) + 1) // 2
        proofs = real(self, assignments[:keep], sponges[:keep], seeds[:keep])
        return proofs + proofs[:len(assignments) - keep]

    monkeypatch.setattr(LigeroCircuit, "_prove_many", half)
    out, checks = run_small(root, cell)
    got = dict((n, v) for n, v, _ in checks)
    assert not out["correct"] and got["ref_lc"] > 0


def test_altered_answer_fails(small_cell, monkeypatch):
    """An answer altered where it is produced: one opened column's first
    element, as the openings convert it to field elements."""
    from ligero_tpu_torch.ligero.core import LigeroCircuit

    root, cell = small_cell
    real = LigeroCircuit._opened_set

    def altered(self, cols, tree, idx):
        columns, paths = real(self, cols, tree, idx)
        columns[0][0] = (columns[0][0] + 1) % self.field.p
        return columns, paths

    monkeypatch.setattr(LigeroCircuit, "_opened_set", altered)
    out, checks = run_small(root, cell)
    got = dict((n, v) for n, v, _ in checks)
    assert not out["correct"] and got["ref_paths"] > 0


@pytest.mark.cuda
def test_cell_on_the_card(card):
    """One short run of the first cell on the card, correct: a window of
    10 s holds the two rounds that the cell's mix checks."""
    import subprocess
    import sys

    from conftest import ROOT

    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "bn254-2p20.single", "--seed", str(2**31 + 3), "--seconds", "10",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    assert '"correct": true' in res.stdout.splitlines()[-1]
