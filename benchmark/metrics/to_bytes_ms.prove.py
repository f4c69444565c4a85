"""Milliseconds a proof of the program's own ``proof.to_bytes`` spans
(``LigeroProof.to_bytes``, ``ligero/proof.py``: the proof's canonical
bytes, its ``columns.to_bytes`` spans inside them), summed over the window,
over the proofs.  Names are matched exactly.  None where the trace holds
no device event (no card), as the device readers, or no such span (a
program without them)."""

MOVES = "prove_s"
SPAN = "proof.to_bytes"


def read(run):
    if not run.trace.device or not run.proofs:
        return None
    ns = sum(e - s for name, s, e in run.trace.spans if name == SPAN)
    return ns / 1e6 / run.proofs if ns else None
