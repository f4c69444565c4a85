"""Milliseconds a proof of device time, inside the prove calls, of kernels
not built from the program's ``csrc/`` (the torch glue of
``engine/backend.py``, ``devsampler.py``, ``fieldops.py``), copies and sets
left out."""

from harness.trace import PORT_KERNELS

MOVES = "prove_s"


def _glue(group):
    return group not in PORT_KERNELS and not group.startswith(("Memcpy",
                                                               "Memset"))


def read(run):
    s = run.device_s("prove", _glue)
    return None if s is None else 1e3 * s / run.proofs
