"""The frozen work counts against hand values."""

from __future__ import annotations

from harness import yardstick as y


def test_ntt_products_by_hand():
    # 2048 points: 1024 x 11 butterflies less the 2047 whose twiddle is one
    assert y.ntt_products(2048, 2048, True) == 9217 + 2048
    assert y.ntt_products(2048, 2048, False) == 9217
    # eight cosets of 2048 points, each twisted: NTT_n of the encode
    assert y.ntt_products(2048, 16384, True) == 8 * 9217 + 8 * 2048
    assert y.ntt_products(2048, 4096, False) == 2 * 9217 + 2048
    assert y.ntt_products(1000, 1024, True) == 512 * 10 - 1023 + 1000
    assert y.ntt_products(2, 2, True) == 0 + 2


def test_operation_counts_by_hand():
    assert y.mont_mul_ops(16) == 160 and y.mont_mul_ops(24) == 336
    assert y.BLAKE2S_BLOCK_OPS == 968
    nbytes, ops = y.blake2s_work(16, 4100, 16384)
    assert ops == 16384 * 2051 * 968
    assert nbytes == 4100 * 16384 * 64 + 16384 * 32
    nbytes, ops = y.ntt_work(16, 4100, 2048, 16384, True)
    assert ops == 4100 * (8 * 9217 + 8 * 2048) * 160
    assert nbytes == 4100 * (2048 + 16384) * 64 + 8192 * 32
    assert y.bound_s(3.35e12, 0) == 1.0
    assert y.bound_s(0, 33.5e12, y.INT32_ISSUE_PER_S) == 1.0
