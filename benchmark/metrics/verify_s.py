"""Seconds a verdict: the host-clock walls of every verify call of the
window (the proofs' bytes parsed, the verdicts in hand, the device
synchronised), summed, over the verdicts they returned."""


def read(run):
    if not run.rounds:
        return None
    return sum(r.verify_s for r in run.rounds) / run.proofs
