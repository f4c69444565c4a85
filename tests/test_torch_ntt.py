"""The port's plain NTT (ligero_tpu_torch.engine.ntt.ntt_ref, the CPU path of
the NTT kernel's wrapper) and the plain twin of the kernel's decomposition
(ntt_structured: cosets, two passes, global stages, by ntt_plan's routes)
against the JAX package's DomainOps and the MXU kernel's numpy oracle
(mxu_ntt_numpy), bit for bit (exact field arithmetic, fully reduced
outputs: tolerance none)."""

import numpy as np
import pytest
import torch

from ligero_tpu.engine.fieldops import FieldKernel
from ligero_tpu.engine.mxu_ntt import mxu_ntt_numpy
from ligero_tpu.engine.ntt import DomainOps
from ligero_tpu.fields import BLS12_377_FQ, BN254_FR
from ligero_tpu_torch.engine import cuda_ntt, fieldops, ntt
from ligero_tpu_torch.fields import FIELDS as PORT_FIELDS

# the suite runs in several worker processes that share the host's cores, and
# these tests run many small tensor ops: one intra-op thread each, or the
# workers' thread pools spin against each other
torch.set_num_threads(1)


def pf(field):
    """The port's own FieldSpec for a JAX-package one."""
    return PORT_FIELDS[field.name]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def rand_mont(field, rng, shape):
    ints = [int.from_bytes(rng.bytes(field.num_limbs * 2), "little") % field.p
            for _ in range(int(np.prod(shape)))]
    return field.ints_to_mont_limbs(ints).reshape(*shape, field.num_limbs)


def t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.int32))


@pytest.mark.parametrize("n", [8, 64, 512, 1024, 2048])
def test_ntt_ref_matches_domainops(n):
    field = BN254_FR
    rng = np.random.default_rng(n)
    fk = FieldKernel(field, np)
    dom = DomainOps(fk, n)
    x = rand_mont(field, rng, (2, n))
    assert np.array_equal(ntt.ntt_ref(pf(field), t(x), n).numpy(), dom.fft(x))
    assert np.array_equal(ntt.ntt_ref(pf(field), t(x), n, inverse=True).numpy(),
                          dom.ifft(x))
    assert np.array_equal(
        ntt.ntt_ref(pf(field), t(x), n, inverse=True, canon_out=True).numpy(),
        fk.from_mont(dom.ifft(x)))
    short = x[:, :max(1, n // 8)]
    assert np.array_equal(
        ntt.ntt_ref(pf(field), t(short), n, canon_out=True).numpy(),
        fk.from_mont(dom.fft_padded(short)))


@pytest.mark.parametrize("n", [1024, 2048])
@pytest.mark.parametrize("inverse,canon_out", [(False, False), (True, False),
                                               (False, True), (True, True)])
def test_ntt_ref_matches_mxu_oracle(n, inverse, canon_out):
    field = BN254_FR
    rng = np.random.default_rng(7)
    x = rand_mont(field, rng, (2, n))
    want = mxu_ntt_numpy(field, x, n, inverse=inverse, canon_out=canon_out)
    got = ntt.ntt_ref(pf(field), t(x), n, inverse=inverse, canon_out=canon_out)
    assert np.array_equal(got.numpy(), want)


def test_ntt_ref_other_field_and_roundtrip():
    field = BLS12_377_FQ
    rng = np.random.default_rng(8)
    x = rand_mont(field, rng, (3, 32))
    fwd = ntt.ntt_ref(pf(field), t(x), 32)
    assert np.array_equal(fwd.numpy(), DomainOps(FieldKernel(field, np), 32).fft(x))
    assert np.array_equal(ntt.ntt_ref(pf(field), fwd, 32, inverse=True).numpy(), x)


def test_size_checks_and_epilogue_constants():
    f = BN254_FR
    with pytest.raises(ValueError):
        ntt.check_size(pf(f), 12)
    with pytest.raises(ValueError):
        ntt.check_size(pf(f), 1 << 29)
    n_inv = pow(64, -1, f.p)
    assert ntt.epilogue_const(pf(f), 64, False, False) is None
    assert ntt.epilogue_const(pf(f), 64, False, True) == 1
    assert ntt.epilogue_const(pf(f), 64, True, False) == n_inv * f.R % f.p
    assert ntt.epilogue_const(pf(f), 64, True, True) == n_inv
    with pytest.raises(ValueError):
        ntt.ntt_ref(pf(f), torch.zeros((1, 16, 16), dtype=torch.int32), 8)


def test_packed_twiddles_layout():
    limbs = ntt.twiddle_limbs(BN254_FR.name, 16, False)
    words = cuda_ntt.pack_words(limbs).view(np.uint32)
    ints = [sum(int(w) << (32 * i) for i, w in enumerate(row)) for row in words]
    assert ints == BN254_FR.limbs_to_ints(limbs)


FLAGS = [(False, False), (True, False), (False, True), (True, True)]
# (n, w, tile_log): every route and its edges at sizes the CPU runs fast
STRUCT_CASES = [
    # one pass: w = n
    (2, 2, 3), (8, 8, 3), (64, 64, 6), (1024, 1024, 12),
    # cosets: w = 1, w = s, w = s + 1, a width that is no power of two
    (2, 1, 3), (64, 1, 3), (64, 8, 3), (64, 9, 4), (256, 24, 5),
    (1024, 128, 12), (1024, 129, 12), (1024, 300, 12),
    # two passes: w = n, and with cosets
    (64, 64, 3), (64, 33, 4), (256, 256, 4), (1024, 1024, 5),
    (1024, 1024, 6), (1024, 130, 4), (512, 100, 4),
    # two passes joined by global stages
    (256, 256, 3), (1024, 1024, 3), (1024, 1024, 4), (1024, 200, 3),
    (512, 512, 2),
]


def jax_package_ntt(field, x, n, inverse, canon_out):
    """The same function by the JAX package's DomainOps on numpy."""
    fk = FieldKernel(field, np)
    dom = DomainOps(fk, n)
    if inverse:
        pad = np.zeros((x.shape[0], n - x.shape[1], x.shape[2]), dtype=x.dtype)
        y = dom.ifft(np.concatenate([x, pad], axis=1))
    else:
        y = dom.fft_padded(x) if x.shape[1] < n else dom.fft(x)
    return fk.from_mont(y) if canon_out else y


@pytest.mark.parametrize("n,w,tile_log", STRUCT_CASES)
def test_structured_twin_matches_plain_and_jax_package(n, w, tile_log):
    field = BN254_FR
    rng = np.random.default_rng(1000 * n + 10 * w + tile_log)
    x = rand_mont(field, rng, (2, w))
    for inverse, canon_out in FLAGS:
        got = ntt.ntt_structured(pf(field), t(x), n, inverse, canon_out,
                                 tile_log=tile_log)
        assert torch.equal(got, ntt.ntt_ref(pf(field), t(x), n, inverse,
                                            canon_out)), (inverse, canon_out)
        assert np.array_equal(got.numpy(), jax_package_ntt(
            field, x, n, inverse, canon_out)), (inverse, canon_out)


# BLS12-377 Fq at the edges of its routes: the tile limit (one pass of
# 4096 elements, the 198 KB tile), cosets, two passes, global stages
BLS_STRUCT_CASES = [(4096, 4096, 12), (4096, 2049, 12), (1024, 129, 12),
                    (512, 512, 4), (1024, 300, 4), (256, 256, 3),
                    # the 2048-element tile two blocks share an SM with: one
                    # pass, NTT_n's eight cosets, and the zk encode's split
                    # (l1 = 6, l2 = 7)
                    (2048, 2048, 12), (16384, 2048, 12), (8192, 8192, 7)]


@pytest.mark.parametrize("n,w,tile_log", BLS_STRUCT_CASES)
def test_structured_twin_matches_jax_package_bls12_377(n, w, tile_log):
    """pallas_ntt carries every BLS12-377 transform of the JAX package; its
    oracle here is DomainOps on numpy (Pallas does not run on the CPU)."""
    field = BLS12_377_FQ
    rng = np.random.default_rng(1000 * n + 10 * w + tile_log)
    x = rand_mont(field, rng, (1, w))
    for inverse, canon_out in FLAGS:
        got = ntt.ntt_structured(pf(field), t(x), n, inverse, canon_out,
                                 tile_log=tile_log)
        assert np.array_equal(got.numpy(), jax_package_ntt(
            field, x, n, inverse, canon_out)), (inverse, canon_out)


EDGE_VALUES = ("p-1", "zero", "alternating", "random")


def edge_values(field, kind, rows, w, rng):
    """(rows, w, L) limbs: every element p - 1 (the largest a kernel is
    given), 0, 0 and p - 1 in turns, or random Montgomery values."""
    if kind == "random":
        return rand_mont(field, rng, (rows, w))
    x = np.zeros((rows, w, field.num_limbs), dtype=np.uint32)
    top = field.ints_to_limbs([field.p - 1])[0]
    if kind == "p-1":
        x[:] = top
    elif kind == "alternating":
        x[:, 1::2] = top
    return x


# (n, w, tile_log): one pass, cosets, two passes, global stages
EDGE_ROUTES = [(64, 64, 6), (256, 24, 5), (1024, 130, 4), (256, 256, 3)]


@pytest.mark.parametrize("kind", EDGE_VALUES)
def test_structured_twin_edge_values_bls12_377(kind):
    """BLS12-377 inputs at the edges of the field through every route of
    the kernel's decomposition, against the JAX package's DomainOps."""
    field = BLS12_377_FQ
    for n, w, tile_log in EDGE_ROUTES:
        x = edge_values(field, kind, 2, w, np.random.default_rng(n + w))
        for inverse, canon_out in FLAGS:
            got = ntt.ntt_structured(pf(field), t(x), n, inverse, canon_out,
                                     tile_log=tile_log)
            assert np.array_equal(got.numpy(), jax_package_ntt(
                field, x, n, inverse, canon_out)), (n, w, inverse, canon_out)


@pytest.mark.parametrize("inverse,canon_out", FLAGS)
@pytest.mark.parametrize("w,tile_log", [(1024, 12), (1024, 5), (128, 12),
                                        (1024, 3)])
def test_structured_twin_matches_mxu_oracle(w, tile_log, inverse, canon_out):
    field, n = BN254_FR, 1024
    x = rand_mont(field, np.random.default_rng(w + tile_log), (2, w))
    full = np.concatenate(
        [x, np.zeros((2, n - w, x.shape[2]), dtype=x.dtype)], axis=1)
    want = mxu_ntt_numpy(field, full, n, inverse=inverse, canon_out=canon_out)
    got = ntt.ntt_structured(pf(field), t(x), n, inverse, canon_out,
                             tile_log=tile_log)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("s", [1, 2, 8, 64, 512])
def test_tile_transform_and_stage_major_twiddles(s):
    """The in-tile transform (stages from the widest down, stage-major
    twiddles, bit reversal on the way out) is the unscaled s-point NTT,
    and the stage-major table holds omega_{2h}^pos at [h + pos]."""
    field = BN254_FR
    x = t(rand_mont(field, np.random.default_rng(s), (3, s)))
    for inverse in (False, True):
        got = ntt._dif_tile(pf(field), x, inverse)
        if s == 1:
            assert torch.equal(got, x)
            continue
        want = ntt.ntt_ref(pf(field), x, s, inverse)
        if inverse:   # ntt_ref scales by 1/s: undo it
            s_mont = torch.from_numpy(field.ints_to_mont_limbs(
                [s]).astype(np.int32))
            want = fieldops.mont_mul(pf(field), want, s_mont[0])
        assert torch.equal(got, want)
        table = field.mont_limbs_to_ints(
            ntt.stage_twiddle_limbs(field.name, s, inverse))
        omega = field.root_of_unity(s)
        omega = pow(omega, -1, field.p) if inverse else omega
        h = 1
        while h < s:
            step = pow(omega, s // (2 * h), field.p)
            assert table[h:2 * h] == [pow(step, j, field.p) for j in range(h)]
            h *= 2
    small = ntt.stage_twiddle_limbs(field.name, max(s // 2, 1), False)
    assert np.array_equal(ntt.stage_twiddle_limbs(field.name, s, False)[
        :small.shape[0]][1:], small[1:])


def test_twist_table_folds_the_epilogue():
    field, n = BN254_FR, 16
    omega = field.root_of_unity(n)
    for inverse, canon_out in FLAGS:
        k = ntt.twist_const(pf(field), n, inverse, canon_out)
        c = ntt.epilogue_const(pf(field), n, inverse, canon_out)
        assert k == (field.R % field.p if c is None else c)
        w = pow(omega, -1, field.p) if inverse else omega
        assert field.limbs_to_ints(ntt.twist_limbs(field.name, n, inverse, k)) \
            == [pow(w, e, field.p) * k % field.p for e in range(n)]


# the NTT calls of one prove + verify at 2^20 gates (m = 1025, k = 2048,
# n = 16384; zk: b = 468, d2 = 8192): (rows, w, n) -> route and its split
MAIN_PATH_ROUTES = [
    ("iNTT_k", 4100, 2048, 2048, "one-pass", (0, 0, 0, 11)),
    ("NTT_n commit / ntt_columns", 4100, 2048, 16384, "coset", (3, 0, 0, 11)),
    ("NTT_2k linear", 4100, 2048, 4096, "coset", (1, 0, 0, 11)),
    ("NTT_2k quadratic", 3075, 2048, 4096, "coset", (1, 0, 0, 11)),
    # single rows: one tile would leave the card idle, so two passes of
    # small blocks
    ("iNTT_2k one row", 1, 4096, 4096, "two-pass", (0, 0, 6, 6)),
    ("verify row to 4096", 1, 2048, 4096, "two-pass", (1, 0, 5, 6)),
    ("verify row to 16384", 1, 4095, 16384, "two-pass", (2, 0, 6, 6)),
    ("five rows of 2048", 5, 2048, 2048, "one-pass", (0, 0, 0, 11)),
    ("one row, short", 1, 100, 128, "one-pass", (0, 0, 0, 7)),
    ("zk NTT_d2 of k + b", 4100, 2516, 8192, "coset", (1, 0, 0, 12)),
    ("zk NTT_d2 of k", 4100, 2048, 8192, "coset", (2, 0, 0, 11)),
    ("zk iNTT_d2 one row", 1, 8192, 8192, "two-pass", (0, 0, 6, 7)),
    ("zk encode", 4103, 8192, 16384, "two-pass", (1, 0, 6, 7)),
    ("n = 65536", 1, 65536, 65536, "two-pass", (0, 0, 8, 8)),
    ("n = 2^28", 1, 1 << 28, 1 << 28, "two-pass+stages", (0, 4, 12, 12)),
]


@pytest.mark.parametrize("field", [BN254_FR, BLS12_377_FQ],
                         ids=lambda f: f.name)
@pytest.mark.parametrize("label,rows,w,n,name,split", MAIN_PATH_ROUTES,
                         ids=[c[0] for c in MAIN_PATH_ROUTES])
def test_route_and_scratch_of_main_path_shapes(label, rows, w, n, name, split,
                                               field):
    """The routes count elements, so both fields take the same ones; the
    scratch is one packed element (32 or 48 bytes) per element."""
    rt = cuda_ntt.route(w, n, rows)
    tile_log = ntt.tile_log_for(rows, w, n)
    assert rt == ntt.ntt_plan(w, n, tile_log)
    assert rt.name == name
    assert (rt.lc, rt.l0, rt.l1, rt.l2) == split
    assert rt.lc + rt.l0 + rt.l1 + rt.l2 == rt.logn == n.bit_length() - 1
    assert w <= 1 << rt.ls and (rt.lc == 0 or w > 1 << (rt.ls - 1) or w == 1)
    # only a two-pass route allocates: one packed 4 W-byte intermediate
    elem = 2 * field.num_limbs
    want = rows * n * elem if name.startswith("two-pass") else 0
    assert cuda_ntt.scratch_bytes(pf(field), rows, w, n) == want
    # a block's tile never exceeds the kernel's limit, and short transforms
    # are taken side by side up to 2048 elements
    for sub, avail in ((rt.ls, rt.lc),) if not rt.l1 else ((rt.l2, rt.l1),
                                                          (rt.l1, rt.l2)):
        lg = rt.group_log(sub, avail, tile_log)
        assert 0 <= lg <= avail and sub + lg <= ntt.TILE_LOG
        assert lg == min(avail, max(0, min(tile_log, ntt.GROUP_TILE_LOG) - sub))
    if rows <= ntt.LONE_TILES and rt.l1:    # a lone row: one transform a block
        assert rt.group_log(rt.l2, rt.l1, tile_log) == 0


@pytest.mark.parametrize("label,rows,w,n,name,split", MAIN_PATH_ROUTES,
                         ids=[c[0] for c in MAIN_PATH_ROUTES])
def test_lazy_bound_model_main_path_routes(label, rows, w, n, name, split):
    """BLS12-377's lazy butterflies along every main-path route: every
    value below 2^384, every product's a < R and b < p, butterflies and
    products in [0, 2p), what is stored in [0, p); and each reduction the
    design keeps is one it needs (the model rejects the route without it).
    BN254's fully reduced butterflies stay in [0, p) and skip nothing."""
    bls, bn = pf(BLS12_377_FQ), pf(BN254_FR)
    rt = cuda_ntt.route(w, n, rows)
    top = cuda_ntt.lazy_bound_model(bls, rt)
    p, R = bls.p, 1 << bls.r_bits          # the bounds are exclusive
    assert max(top.values()) <= R
    assert top["product_a"] <= R and top["product_b"] == p
    assert top["butterfly"] == 2 * p and top["product"] <= 2 * p
    assert top["stored"] == p
    for skip in cuda_ntt.LAZY_REDUCTIONS:
        with pytest.raises(cuda_ntt.BoundError):
            cuda_ntt.lazy_bound_model(bls, rt, skip=skip)
    top = cuda_ntt.lazy_bound_model(bn, rt)   # a product's steps: < 2p
    assert top["butterfly"] == top["stored"] == bn.p
    assert top["product"] == 2 * bn.p
    with pytest.raises(ValueError):
        cuda_ntt.lazy_bound_model(bn, rt, skip="sum")


def test_lazy_bound_model_catches_a_bad_sequence():
    """The model's checks bite: a one-stage route of an untwisted input can
    afford an unreduced sum (it stays below 2p); a route with no stages has
    no sum to skip; an input of 2p or more fails the first butterfly."""
    bls = pf(BLS12_377_FQ)
    lone = ntt.ntt_plan(1, 2)             # one coset a point: no stages
    with pytest.raises(ValueError, match="no sum"):
        cuda_ntt.lazy_bound_model(bls, lone, skip="sum")
    with pytest.raises(cuda_ntt.BoundError):
        cuda_ntt.lazy_bound_model(bls, lone, skip="store")
    for rt in (ntt.ntt_plan(2, 2), ntt.ntt_plan(4, 4), ntt.ntt_plan(8, 8)):
        for skip in cuda_ntt.LAZY_REDUCTIONS:
            with pytest.raises(cuda_ntt.BoundError):
                cuda_ntt.lazy_bound_model(bls, rt, skip=skip)


def test_lazy_model_constants_match_the_source():
    """cuda_ntt mirrors csrc/ntt.cu: each field's RADIX_LOG, and lazy
    butterflies (NttArith::LAZY) for BLS12-377 only."""
    import os
    import re
    path = os.path.join(os.path.dirname(cuda_ntt.__file__), "..", "csrc",
                        "ntt.cu")
    with open(path) as f:
        src = f.read()
    shapes = dict(re.findall(
        r"struct NttShape(?:<(\w+)>)? \{\n  static constexpr int "
        r"RADIX_LOG = (\d+);", src))
    assert int(shapes[""]) == cuda_ntt.RADIX_LOG[BN254_FR.name]
    assert int(shapes["Bls12377Fq"]) == cuda_ntt.RADIX_LOG[BLS12_377_FQ.name]
    lazy = dict(re.findall(r"struct NttArith(?:<(\w+)>)? \{\n  static "
                           r"constexpr bool LAZY = (\w+);", src))
    assert lazy == {"": "false", "Bls12377Fq": "true"}
    assert cuda_ntt.LAZY_FIELDS == (BLS12_377_FQ.name,)


def test_plan_rejects_bad_shapes():
    for w, n in [(0, 8), (9, 8), (4, 12), (1, 1)]:
        with pytest.raises(ValueError):
            ntt.ntt_plan(w, n)
    with pytest.raises(ValueError):
        ntt.ntt_structured(pf(BN254_FR), torch.zeros((1, 16, 16),
                                                     dtype=torch.int32), 8)


def test_direct_fit_counts_scratch_by_route(monkeypatch):
    """check_direct_fits counts NTT scratch as the routes allocate it: none
    on the plain path, one packed intermediate of U's shape for the zk
    encode, none for the zk products.  The linear phase's transients are
    those of ``TorchBackend.direct_bytes``: at these shapes the fold of the
    sparse product's int64 sums."""
    from ligero_tpu_torch.engine.backend import (ESTIMATE_MARGIN,
                                                 DeviceMemoryError,
                                                 TorchBackend)
    be = TorchBackend(pf(BN254_FR), "cpu")
    rows, k, n, nnz, L = 4100, 2048, 16384, 9_443_331, 16
    u, msg = rows * n * L * 4, rows * k * L * 4
    fold = 12 * msg + msg // 4
    assert fold > 3 * msg + 3 * nnz * L * 4          # the segment sums
    linear = int((u + msg + nnz * (L * 4 + 16) + fold) * ESTIMATE_MARGIN)
    assert 2 * msg + u < linear       # the encode holds no scratch now
    assert be.direct_bytes(rows, k, n, nnz) == linear
    monkeypatch.setattr(be, "memory_budget", lambda: linear)
    be.check_direct_fits(rows, k, n, nnz)
    monkeypatch.setattr(be, "memory_budget", lambda: linear - 1)
    with pytest.raises(DeviceMemoryError):
        be.check_direct_fits(rows, k, n, nnz)
    # zk: the encode's two-pass intermediate is half of U, the products'
    # coset transforms hold none
    zrows, b, d2 = rows + 3, 468, 8192
    zu, zmsg, wide = (zrows * n * L * 4, zrows * k * L * 4,
                      zrows * d2 * L * 4)
    coeffs = zrows * (k + b) * L * 4
    assert cuda_ntt.scratch_bytes(pf(BN254_FR), zrows, d2, n) == zu // 2
    assert cuda_ntt.scratch_bytes(pf(BN254_FR), zrows, k + b, d2) == 0
    encode = nnz * (L * 4 + 16) + zmsg + coeffs + wide + zu + zu // 2
    zfold = 12 * zmsg + zmsg // 4
    zlinear = zu + coeffs + nnz * (L * 4 + 16) + max(zfold, zmsg + 2 * wide)
    need = int(max(encode, zlinear) * ESTIMATE_MARGIN)
    assert be.direct_bytes(zrows, k, n, nnz, blind_t=b, d2=d2) == need
    monkeypatch.setattr(be, "memory_budget", lambda: need - 1)
    with pytest.raises(DeviceMemoryError):
        be.check_direct_fits(zrows, k, n, nnz, blind_t=b, d2=d2)
    monkeypatch.setattr(be, "memory_budget", lambda: need)
    be.check_direct_fits(zrows, k, n, nnz, blind_t=b, d2=d2)
    monkeypatch.setattr(be, "memory_budget", lambda: need)
    be.check_direct_fits(zrows, k, n, nnz, blind_t=b, d2=d2)


# (w, n): the shapes of chip_smoke.py's route cases, at a small batch
KERNEL_CASES = [(2, 2), (1, 2), (1024, 1024), (100, 1024), (2048, 2048),
                (1500, 2048), (4096, 4096), (2049, 4096),
                (1, 16384), (2048, 16384), (2049, 16384), (1000, 16384),
                (8192, 8192), (65536, 65536), (1 << 17, 1 << 17),
                (5000, 1 << 17)]


@pytest.mark.cuda
@pytest.mark.parametrize("field", [BN254_FR, BLS12_377_FQ], ids=lambda f: f.name)
@pytest.mark.parametrize("w,n", KERNEL_CASES)
def test_ntt_kernel_routes_match_plain(cuda, w, n, field):
    rng = np.random.default_rng(n + w)
    batch = 5 if n <= 16384 else 1
    x = t(rand_mont(field, rng, (batch, w))).to(cuda)
    assert cuda_ntt.route(w, n, batch) == cuda_ntt.route(w, n)
    before = cuda_ntt.launches.count
    for inverse, canon in FLAGS:
        want = ntt.ntt_ref(pf(field), x, n, inverse, canon)
        got = cuda_ntt.ntt(pf(field), x, n, inverse, canon)
        assert torch.equal(got, want), (cuda_ntt.route(w, n), inverse, canon)
        # one row alone takes the small-batch route: the same bits
        assert torch.equal(cuda_ntt.ntt(pf(field), x[:1], n, inverse, canon),
                           want[:1]), (cuda_ntt.route(w, n, 1), inverse, canon)
    assert cuda_ntt.launches.count == before + 8


@pytest.mark.cuda
@pytest.mark.parametrize("field", [BN254_FR, BLS12_377_FQ], ids=lambda f: f.name)
@pytest.mark.parametrize("n,w,tile_log", STRUCT_CASES)
def test_ntt_kernel_small_tile_limits(cuda, n, w, tile_log, field):
    """Every route, the global stages included, at the CPU twin's sizes: the
    kernel is handed the route of a lowered tile limit."""
    x = t(rand_mont(field, np.random.default_rng(n + w), (3, w))).to(cuda)
    rt = ntt.ntt_plan(w, n, tile_log)
    for inverse, canon in FLAGS:
        got = cuda_ntt.ntt_routed(pf(field), x, n, inverse, canon, rt,
                                  tile_log=tile_log)
        assert torch.equal(got, ntt.ntt_ref(pf(field), x, n, inverse,
                                            canon)), (rt, inverse, canon)


# (n, w, tile_log): the kernel's routes for the edge-value twins: cosets
# (NTT_n's eight of 2048), one pass of the 2048-element tile, the 4096-element
# tile, two passes (the zk encode's split), global stages
EDGE_KERNEL_ROUTES = [(16384, 2048, 12), (2048, 2048, 12), (4096, 4096, 12),
                      (8192, 8192, 7), (1024, 1024, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", EDGE_VALUES)
def test_ntt_kernel_edge_values_bls12_377(cuda, kind):
    """BLS12-377's lazy butterflies at the edges of the field: every route,
    a lone row, inverse and canonical output, int32 and 16-bit storage in
    and out, bit-equal to the plain versions."""
    field = pf(BLS12_377_FQ)
    for n, w, tile_log in EDGE_KERNEL_ROUTES:
        x = t(edge_values(BLS12_377_FQ, kind, 3, w,
                          np.random.default_rng(n + w))).to(cuda)
        x16 = fieldops.narrow16(x)
        rt = ntt.ntt_plan(w, n, tile_log)
        for inverse, canon in FLAGS:
            want = ntt.ntt_ref(field, x, n, inverse, canon)
            got = cuda_ntt.ntt_routed(field, x, n, inverse, canon, rt,
                                      tile_log=tile_log)
            assert torch.equal(got, want), (rt, kind, inverse, canon)
            assert torch.equal(cuda_ntt.ntt(field, x[:1], n, inverse, canon),
                               want[:1]), (n, w, kind, inverse, canon)
            for xin, out16 in ((x16, True), (x16, False), (x, True)):
                got = cuda_ntt.ntt_routed(field, xin, n, inverse, canon, rt,
                                          tile_log=tile_log, out16=out16)
                assert torch.equal(got, cuda_ntt.ntt16_ref(
                    field, xin, n, inverse, canon, out16)), (
                        rt, kind, inverse, canon, xin.dtype, out16)


@pytest.mark.cuda
def test_ntt_kernel_rejects_bad_shapes(cuda):
    f = pf(BN254_FR)
    with pytest.raises(ValueError):
        cuda_ntt.ntt(f, torch.zeros((1, 9, 16), dtype=torch.int32,
                                    device=cuda), 8)
    with pytest.raises(ValueError):
        cuda_ntt.ntt(f, torch.zeros((1, 8, 15), dtype=torch.int32,
                                    device=cuda), 8)
    with pytest.raises(TypeError):
        cuda_ntt.ntt(f, torch.zeros((1, 8, 16), dtype=torch.int64,
                                    device=cuda), 8)
    with pytest.raises(ValueError):   # a route of another shape
        cuda_ntt.ntt_routed(f, torch.zeros((1, 8, 16), dtype=torch.int32,
                                           device=cuda), 8, False, False,
                            ntt.ntt_plan(4, 8))
    with pytest.raises(ValueError):   # BLS12-377 elements are 24 limbs
        cuda_ntt.ntt(pf(BLS12_377_FQ), torch.zeros((1, 8, 16),
                                                   dtype=torch.int32,
                                                   device=cuda), 8)


@pytest.mark.cuda
@pytest.mark.parametrize("field", [BN254_FR, BLS12_377_FQ], ids=lambda f: f.name)
@pytest.mark.parametrize("n", [2, 64, 1024, 4096])
def test_ntt_kernel_matches_plain(cuda, n, field):
    rng = np.random.default_rng(n)
    x = t(rand_mont(field, rng, (3, n)))
    for inverse in (False, True):
        for canon in (False, True):
            want = ntt.ntt_ref(pf(field), x, n, inverse, canon)
            got = cuda_ntt.ntt(pf(field), x.to(cuda), n, inverse, canon)
            assert torch.equal(got.cpu(), want)
    short = x[:, :max(1, n // 8)].contiguous()
    assert torch.equal(cuda_ntt.ntt(pf(field), short.to(cuda), n).cpu(),
                       ntt.ntt_ref(pf(field), short, n))
