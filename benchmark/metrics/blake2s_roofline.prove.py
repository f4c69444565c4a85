"""Per cent: the least time the card could take for the column hash a
prove call needs (Blake2s-256 of every column of B matrices of 4m x n
elements, ``csrc/blake2s_cols.cu``), over the device time of the Blake2s
kernel inside the prove calls: the larger of its bytes at the memory rate
and its 968 operations a block at the issue rate (``harness/yardstick.py``)."""

from harness import yardstick as y

MOVES = "prove_s"


def read(run):
    s = run.device_s("prove", lambda g: g == "blake2s_kernel")
    if s is None:
        return None
    d = run.dims
    nbytes, ops = y.blake2s_work(run.limbs, 4 * d["m"], d["n"])
    one = y.bound_s(nbytes, ops, y.INT32_ISSUE_PER_S)
    return 100.0 * len(run.rounds) * run.batch * one / s
