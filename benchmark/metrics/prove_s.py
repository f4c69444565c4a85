"""Seconds a proof: the host-clock walls of every prove call of the window
(the call to the proofs' bytes in hand, the device synchronised), summed,
over the proofs they returned."""


def read(run):
    if not run.rounds:
        return None
    return sum(r.prove_s for r in run.rounds) / run.proofs
