"""Per cent of the verify calls' wall that no device kernel, copy or set
covers."""

MOVES = "verify_s"


def read(run):
    return run.idle_pct("verify")
