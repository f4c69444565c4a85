"""Per cent of the prove calls' wall that no device kernel, copy or set
covers (the union of the device intervals inside the calls' spans)."""

MOVES = "prove_s"


def read(run):
    return run.idle_pct("prove")
