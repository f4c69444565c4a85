"""Milliseconds a proof of the openings' host work: the phases
``open.to_ints`` (the opened columns to field elements) and ``open.paths``
(their Merkle paths; ``ligero/core.py``, ``merkle.py``), over the proofs."""

MOVES = "prove_s"


def read(run):
    s = run.phase_s("open.to_ints", "open.paths")
    return None if s is None or not run.proofs else 1e3 * s / run.proofs
