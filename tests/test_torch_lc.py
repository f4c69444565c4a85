"""The port's plain row combination (ligero_tpu_torch.engine.cuda_lc.
row_combine_ref, the CPU path of the row_combine kernel's wrapper) against
the MXU kernel's numpy oracle (mxu_lc_numpy) and the numpy FieldKernel."""

import os
import random
import re

import numpy as np
import pytest
import torch

from ligero_tpu.engine.backend import Backend
from ligero_tpu.engine.fieldops import FieldKernel
from ligero_tpu.engine.mxu_lc import mxu_lc_numpy
from ligero_tpu.fields import BLS12_377_FQ, BN254_FR
from ligero_tpu_torch.engine import cuda_lc
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


def rand_mont(rng, shape, field=BN254_FR):
    ints = [int.from_bytes(rng.bytes(2 * field.num_limbs), "little") % field.p
            for _ in range(int(np.prod(shape)))]
    return field.ints_to_mont_limbs(ints).reshape(*shape, field.num_limbs)


def t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.int32))


@pytest.mark.parametrize("rows,k", [(1, 128), (136, 128), (300, 256)])
def test_row_combine_matches_mxu_oracle(rows, k):
    rng = np.random.default_rng(rows + k)
    mat, r = rand_mont(rng, (rows, k)), rand_mont(rng, (rows,))
    got = cuda_lc.row_combine(pf(BN254_FR), t(r), t(mat))
    assert np.array_equal(got.numpy(), mxu_lc_numpy(BN254_FR, mat, r))


def test_row_combine_per_element_matches_fieldkernel():
    rng = np.random.default_rng(21)
    fk = FieldKernel(BN254_FR, np)
    mat, r = rand_mont(rng, (50, 9)), rand_mont(rng, (50, 9))
    got = cuda_lc.row_combine(pf(BN254_FR), t(r), t(mat))
    assert np.array_equal(got.numpy(), fk.sum_mod(fk.mont_mul(r, mat), axis=0))


@pytest.mark.parametrize("rows,k", [(1, 8), (65, 16), (130, 40)])
def test_row_combine_matches_backend_bls12_377(rows, k):
    """BLS12-377 Fq, where the JAX package has no mxu_lc (16 limbs only) and
    combines rows with FieldKernel products and sum_mod: Backend.row_combine
    on numpy (one r per row), the FieldKernel for one r per element, and
    Backend.row_combine_batch."""
    field = BLS12_377_FQ
    rng = np.random.default_rng(rows + k)
    be, fk = Backend(field), FieldKernel(field, np)
    mat, r = rand_mont(rng, (rows, k), field), rand_mont(rng, (rows,), field)
    got = cuda_lc.row_combine(pf(field), t(r), t(mat))
    assert np.array_equal(got.numpy(), np.asarray(be.row_combine(r, mat)))
    r = rand_mont(rng, (rows, k), field)
    got = cuda_lc.row_combine(pf(field), t(r), t(mat))
    assert np.array_equal(got.numpy(), fk.sum_mod(fk.mont_mul(r, mat), axis=0))
    mats, rs = rand_mont(rng, (2, rows, k), field), rand_mont(rng, (2, rows), field)
    got = cuda_lc.row_combine_batch(pf(field), t(rs), t(mats))
    assert np.array_equal(got.numpy(),
                          np.asarray(be.row_combine_batch(rs, mats)))


def test_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(22)
    mat, r = t(rand_mont(rng, (4, 8))), t(rand_mont(rng, (4,)))
    before = cuda_lc.launches.count
    assert torch.equal(cuda_lc.row_combine(pf(BN254_FR), r, mat),
                       cuda_lc.row_combine_ref(pf(BN254_FR), r, mat))
    assert cuda_lc.launches.count == before


@pytest.mark.cuda
@pytest.mark.parametrize("field", [BN254_FR, BLS12_377_FQ], ids=lambda f: f.name)
@pytest.mark.parametrize("rows,k", [(1, 1), (65, 3), (4100, 64)])
def test_row_combine_kernel_matches_plain(cuda, rows, k, field):
    rng = np.random.default_rng(rows)
    mat = t(rand_mont(rng, (rows, k), field))
    for r in (t(rand_mont(rng, (rows,), field)),
              t(rand_mont(rng, (rows, k), field))):
        got = cuda_lc.row_combine(pf(field), r.to(cuda), mat.to(cuda))
        assert torch.equal(got.cpu(), cuda_lc.row_combine_ref(pf(field), r, mat))
    rs = t(rand_mont(rng, (3, rows), field))
    mats = torch.stack([mat, mat.flip(0), mat.flip(1)])
    got = cuda_lc.row_combine_batch(pf(field), rs.to(cuda), mats.to(cuda))
    assert torch.equal(got.cpu(),
                       cuda_lc.row_combine_batch_ref(pf(field), rs, mats))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,k", [(4099, 130), (1, 300), (127, 129)])
def test_row_combine_bls12_377_ragged_rows_match_plain(cuda, rows, k):
    """BLS12-377 at row counts the kernel's chunks (``cuda_lc.geometry``) do
    not divide and at a single row (each thread's last row has no next row to
    load ahead), single and batched, against the plain version."""
    field = BLS12_377_FQ
    rng = np.random.default_rng(rows + k)
    mat = t(rand_mont(rng, (rows, k), field))
    r = t(rand_mont(rng, (rows,), field))
    got = cuda_lc.row_combine(pf(field), r.to(cuda), mat.to(cuda))
    assert torch.equal(got.cpu(), cuda_lc.row_combine_ref(pf(field), r, mat))
    rs = torch.stack([r, r.flip(0)])
    mats = torch.stack([mat, mat.flip(1)])
    got = cuda_lc.row_combine_batch(pf(field), rs.to(cuda), mats.to(cuda))
    assert torch.equal(got.cpu(),
                       cuda_lc.row_combine_batch_ref(pf(field), rs, mats))


# ---------------------------------------------------------------------------
# The kernel's deferred reduction, its geometry and its constants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field", [BN254_FR, BLS12_377_FQ], ids=lambda f: f.name)
def test_deferred_sum_model_is_exact_at_the_bounds(field):
    """The kernel's arithmetic word by word (unreduced products into 2 W
    words with the carries kept aside, the fold into 2 W + 1, W + 1
    Montgomery steps, the product by 2^32 R mod p) gives
    (sum_i r_i M_i) R^-1 mod p: every operand at its contract's maximum
    (r = R - 1, M = p - 1) over the largest chunk, one row, random chunks;
    with one accumulator word fewer the largest chunk comes out wrong."""
    F = pf(field)
    W = field.num_limbs // 2
    p, R = field.p, 1 << (32 * W)
    r_inv = pow(R, -1, p)
    rnd = random.Random(W)
    n = cuda_lc.ROWS_PER_CHUNK_MAX
    cases = [([R - 1] * n, [p - 1] * n), ([R - 1], [p - 1]), ([0], [p - 1]),
             ([p - 1] * n, [p - 1] * n), ([1], [1])]
    cases += [([rnd.randrange(R) for _ in range(m)],
               [rnd.randrange(p) for _ in range(m)]) for m in (2, 17, n)]
    for rs, ms in cases:
        want = sum(a * b for a, b in zip(rs, ms)) * r_inv % p
        assert cuda_lc.deferred_sum_model(F, rs, ms) == want
    rs, ms = cases[0]
    want = sum(a * b for a, b in zip(rs, ms)) * r_inv % p
    assert cuda_lc.deferred_sum_model(F, rs, ms, acc_words=2 * W) != want


@pytest.mark.parametrize("batch", [1, 2, 3])
def test_row_combine_geometry_covers_every_row(batch):
    """Every row in exactly one chunk, each chunk within the accumulator's
    bound and the grid's limits, and at the main path's shapes several
    blocks an SM of a 132-SM card."""
    shapes = [(1, 1), (15, 3), (16, 128), (65, 3), (1024, 2048), (1024, 2516),
              (4100, 2048), (4103, 2516), (8196, 4096), (2052, 1024),
              (70000, 8), (300, 129)]
    for rows, k in shapes:
        chunks, rpc = cuda_lc.geometry(rows, k, batch, 132)
        assert 1 <= rpc <= cuda_lc.ROWS_PER_CHUNK_MAX
        assert (chunks - 1) * rpc < rows <= chunks * rpc, (rows, k)
        assert chunks <= cuda_lc.MAX_GRID
        if rows >= 1024 and k >= 2048:
            blocks = chunks * batch * -(-k // cuda_lc.BLOCK_COLUMNS)
            assert blocks >= 3 * 132, (rows, k, batch, blocks)
    with pytest.raises(ValueError):
        cuda_lc.geometry(cuda_lc.ROWS_PER_CHUNK_MAX * cuda_lc.MAX_GRID + 1, 1,
                         1, 132)


def test_row_combine_kernel_constants_and_shared_memory():
    """row_combine.cu's restore constants are 2^32 R mod p of each field;
    every instantiation's shared memory fits a block at the largest
    chunk."""
    from ligero_tpu_torch.engine import staging
    path = os.path.join(os.path.dirname(cuda_lc.__file__), "..", "csrc",
                        "row_combine.cu")
    with open(path) as f:
        src = f.read()
    tables = re.findall(r"restore_word<(\w+)>\(int j\) \{\s*constexpr uint32_t "
                        r"K\[\d+\] = \{([^}]*)\}", src)
    fields = {"Bn254Fr": BN254_FR, "Bls12377Fq": BLS12_377_FQ}
    assert sorted(name for name, _ in tables) == sorted(fields)
    for name, words in tables:
        field = fields[name]
        k = sum(int(w.strip().rstrip("u"), 16) << (32 * i)
                for i, w in enumerate(words.split(",")))
        assert k == (1 << (16 * field.num_limbs + 32)) % field.p, name
    assert re.search(r"RPC_MAX = (\d+);", src).group(1) == str(
        cuda_lc.ROWS_PER_CHUNK_MAX)
    for field in (BN254_FR, BLS12_377_FQ):
        for m16 in (False, True):
            for per_column in (False, True):
                assert staging.lc_smem_bytes(
                    field.num_limbs // 2, m16, per_column,
                    cuda_lc.ROWS_PER_CHUNK_MAX) <= staging.SMEM_MAX


@pytest.mark.cuda
@pytest.mark.parametrize("field", [BN254_FR, BLS12_377_FQ], ids=lambda f: f.name)
@pytest.mark.parametrize("rows,k", [(1, 1), (17, 5), (300, 129), (1024, 260),
                                    (4100, 130)])
def test_row_combine_kernel_16bit_per_column_batch_match_plain(cuda, rows, k,
                                                               field):
    """The one-launch kernel on every entry: the 16-bit matrix, r per row
    and per (row, column), a batch of three, operands at their maxima
    (r = R - 1 words, M = p - 1), against the plain version; then the same
    launch again (the tickets left at zero)."""
    from ligero_tpu_torch.engine import fieldops as fops
    F = pf(field)
    rng = np.random.default_rng(rows + k)
    mat = t(rand_mont(rng, (rows, k), field))
    for r in (t(rand_mont(rng, (rows,), field)),
              t(rand_mont(rng, (rows, k), field))):
        want = cuda_lc.row_combine_ref(F, r, mat)
        for m in (mat, fops.narrow16(mat)):
            for _ in range(2):
                got = cuda_lc.row_combine(F, r.to(cuda), m.to(cuda))
                assert torch.equal(got.cpu(), want), (m.dtype, r.dim())
    top = torch.full((rows, field.num_limbs), 0xFFFF, dtype=torch.int32)
    pm1 = t(field.ints_to_limbs([field.p - 1] * (rows * k)).reshape(
        rows, k, field.num_limbs))
    got = cuda_lc.row_combine(F, top.to(cuda), pm1.to(cuda))
    assert torch.equal(got.cpu(), cuda_lc.row_combine_ref(F, top, pm1))
    rs = t(rand_mont(rng, (3, rows), field))
    mats = torch.stack([mat, mat.flip(0), mat.flip(1)])
    want = cuda_lc.row_combine_batch_ref(F, rs, mats)
    got = cuda_lc.row_combine_batch(F, rs.to(cuda), fops.narrow16(mats).to(cuda))
    assert torch.equal(got.cpu(), want)
