"""Milliseconds a verdict of the program's own ``proof.from_bytes`` spans
(``LigeroProof.from_bytes``, ``ligero/proof.py``: the shipped bytes parsed
and checked, its ``columns.from_bytes`` spans inside them), summed over
the window, over the verdicts.  Names are matched exactly.  None where the
trace holds no device event (no card), as the device readers, or no such
span (a program without them)."""

MOVES = "verify_s"
SPAN = "proof.from_bytes"


def read(run):
    if not run.trace.device or not run.proofs:
        return None
    ns = sum(e - s for name, s, e in run.trace.spans if name == SPAN)
    return ns / 1e6 / run.proofs if ns else None
