"""Per cent: the least time the card could take for the NTT work a prove
call's shapes need, over the device time of the NTT kernels
(``csrc/ntt.cu``) inside the prove calls.  The work is counted from the
shapes (direct mode, no zk), whatever kernels carry it: the encode's
iNTT_k and NTT_n of all B proofs' 4m rows; per proof the iNTT_k of
r^T A's 4m rows, the NTT_2k of the u and r coefficient rows (4m each),
of the x, y, z rows (3m) and the two iNTT_2k of q and p0.  Each transform
is bounded by the larger of its bytes at the memory rate and its products'
operations at the 32-bit integer rate (``harness/yardstick.py``)."""

from harness import yardstick as y

MOVES = "prove_s"
KERNELS = ("ntt_pass_kernel", "ntt_stage_kernel")


def bound_s(limbs, m, k, n, batch):
    """The least seconds of one prove call's transforms."""
    rows = 4 * m
    calls = [(batch * rows, k, k, True), (batch * rows, k, n, True)]
    calls += batch * [(rows, k, k, True), (rows, k, 2 * k, False),
                      (rows, k, 2 * k, False), (1, 2 * k, 2 * k, True),
                      (3 * m, k, 2 * k, False), (1, 2 * k, 2 * k, True)]
    return sum(y.bound_s(*y.ntt_work(limbs, r, w, size, epi))
               for r, w, size, epi in calls)


def read(run):
    s = run.device_s("prove", lambda g: g in KERNELS)
    if s is None:
        return None
    d = run.dims
    calls = len(run.rounds)
    return 100.0 * calls * bound_s(run.limbs, d["m"], d["k"], d["n"],
                                   run.batch) / s
