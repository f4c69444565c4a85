"""Milliseconds a verdict of the verifier's host column work: the phases
``v.col_digests`` (Blake2s leaves of the opened columns) and
``v.col_openings`` (their Merkle paths), over the verdicts."""

MOVES = "verify_s"


def read(run):
    s = run.phase_s("v.col_digests", "v.col_openings")
    return None if s is None or not run.proofs else 1e3 * s / run.proofs
