"""Milliseconds a proof of host witness evaluation and upload: the
program's PhaseTimer phase ``witness+preenc`` (``ligero/witness.py``,
``native.py``) over the window, over the proofs."""

MOVES = "prove_s"


def read(run):
    s = run.phase_s("witness+preenc")
    return None if s is None or not run.proofs else 1e3 * s / run.proofs
