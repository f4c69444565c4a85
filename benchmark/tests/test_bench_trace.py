"""The trace reader's arithmetic on a hand-made timeline."""

from __future__ import annotations

from harness.trace import Trace, group


def timeline() -> Trace:
    t = Trace.__new__(Trace)
    t.device = [("void ntt_pass_kernel<Fr>(PassArgs)", 0, 10),
                ("Memcpy HtoD (Pageable -> Device)", 5, 12),
                ("void at::native::elementwise_kernel<128>(int)", 50, 60),
                ("void blake2s_kernel<Fr, false>(HashArgs)", 100, 110)]
    t._starts = [e[1] for e in t.device]
    t.spans = [("bench.prove/0", 0, 55), ("bench.to_bytes/0", 20, 40),
               ("bench.verify/0", 56, 120), ("bench.from_bytes/0", 61, 90),
               ("bench.window", 0, 130)]
    return t


def test_groups():
    assert group("void ntt_pass_kernel<Fr>(PassArgs)") == "ntt_pass_kernel"
    assert group("Memcpy HtoD (Pageable -> Device)") == "Memcpy HtoD"
    assert group("void at::native::k<1>(int)") == "void at::native::k<1>"


def test_busy_device_time_and_idle_gaps():
    t = timeline()
    prove = t.spans_named("bench.prove/")
    assert prove == [(0, 55)]
    assert t.busy_ns(prove) == 12 + 5           # [0, 12] and [50, 55]
    assert t.device_ns(prove, lambda g: g == "ntt_pass_kernel") == 10
    assert t.device_ns(t.spans_named("bench.verify/"), lambda g: True) == 10
    gaps = dict(t.idle_gaps((0, 130)))
    assert gaps == {"bench.from_bytes": 29e-9, "bench.verify": 21e-9,
                    "bench.prove": 18e-9, "bench.to_bytes": 20e-9,
                    "bench.window": 10e-9}
    top = t.top_device_ops([(0, 130)])
    assert top[0] == ["ntt_pass_kernel", 10e-9]
