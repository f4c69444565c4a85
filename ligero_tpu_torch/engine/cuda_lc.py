"""Row combination: the CUDA kernel ``csrc/row_combine.cu`` and its wrapper.

Replaces ``ligero_tpu/engine/mxu_lc.py:_mxu_lc_kernel_factory`` (``mxu_lc``),
the interleaved phase's lc = sum_i r_i preenc_i, for BN254 Fr and BLS12-377
Fq.  The pass reads one element of M a term (64 or 96 bytes, 32 or 48 in
16-bit limbs), and its least arithmetic is a W x W-word product a term, so
on this card memory bounds it.  The kernel sums each column's products of
a chunk of rows unreduced (the TPU kernel's deferred reduction) and
reduces once a chunk (:func:`deferred_sum_model` is its arithmetic word by
word, with the bounds that keep the accumulator exact); a block is four
warps of 32 columns and one chunk of rows, each warp streaming its
columns' rows through shared memory with cp.async; the chunks are sized
(:func:`geometry`) so that the grid holds several blocks an SM, and the
last block of a column group to finish adds the chunks' sums (an atomic
ticket), so a call is one launch.  The same kernel serves the
per-element form sum_i r_i[c] M_i[c] (linear phase, verifier spot sums).
:func:`row_combine_batch` runs B combinations of one shape in the same
launch (the batch on the grid's third axis).

The matrix may be 16-bit limbs (an int16 tensor, :func:`fieldops.narrow16`:
the resident and streaming modes' coefficient chunks), which the kernel
reads as they lie, half the bytes of the pass, the same sums
(:func:`row_combine16_ref` is that entry's plain version).

A tensor on the CPU takes the plain version (:func:`row_combine_ref`, or
:func:`row_combine16_ref`); a CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..fields import FieldSpec

from . import cuda_build, fieldops

#: kernel launches by :func:`row_combine` on an int32 matrix
launches = cuda_build.LaunchCounter()
#: launches of the 16-bit entry: an int16 matrix
launches16 = cuda_build.LaunchCounter()

#: a block's columns (four warps of 32; csrc/row_combine.cu THREADS)
BLOCK_COLUMNS = 128
#: rows a chunk at most: r's rows of a chunk are staged in shared memory
#: (csrc/row_combine.cu RPC_MAX), far inside the accumulator's bound
#: (:func:`deferred_sum_model`)
ROWS_PER_CHUNK_MAX = 256
#: rows a chunk at least, where the rows allow: a chunk's reduction costs
#: about two terms' arithmetic
ROWS_PER_CHUNK_MIN = 16
#: blocks an SM the chunking aims at
BLOCKS_PER_SM = 4
MAX_GRID = 65535  # the grid's second and third axes

_SMS: dict = {}
_TICKETS: dict = {}


def geometry(rows: int, k: int, batch: int, sms: int) -> tuple[int, int]:
    """(chunks, rows a chunk) of a launch over ``batch`` (rows, k)
    matrices on a card of ``sms`` SMs: enough chunks for BLOCKS_PER_SM
    blocks an SM over the ceil(k / 128) column groups and the batch, each
    of ROWS_PER_CHUNK_MIN rows at least (where there are so many) and
    ROWS_PER_CHUNK_MAX at most; every row in exactly one chunk, the last
    the short one."""
    if rows < 1 or k < 1 or not 1 <= batch <= MAX_GRID:
        raise ValueError(f"row_combine: no launch for {batch} x {rows} x {k}")
    groups = -(-k // BLOCK_COLUMNS)
    want = max(1, -(-BLOCKS_PER_SM * sms // (groups * batch)))
    rpc = min(ROWS_PER_CHUNK_MAX, max(ROWS_PER_CHUNK_MIN, -(-rows // want)))
    chunks = -(-rows // rpc)
    if chunks > MAX_GRID:
        raise ValueError(f"row_combine: {rows} rows need more than {MAX_GRID} "
                         f"chunks of {rpc}")
    return chunks, min(rpc, rows)


def deferred_sum_model(field: FieldSpec, rs, ms,
                       acc_words: int | None = None) -> int:
    """The kernel's arithmetic for one column and one chunk, word by word
    on Python ints: each term r_i M_i added unreduced by ``fe_mul_acc``'s
    chains (csrc/field.cuh: for each pair of words of r, four chains over
    M's even or odd words into the even-weighted words e or the
    odd-weighted words o, each chain's carry out of its top word counted
    aside in ce or co), the fold into S, ``acc_words`` words (the kernel's
    2 W + 1; fewer drops the words above), W + 1 Montgomery steps, then the
    product by K = 2^32 R mod p.  Returns (sum_i r_i M_i) R^-1 mod p as the
    kernel computes it.  The kernel's bounds (r < R, M < p, at most
    ROWS_PER_CHUNK_MAX rows) keep every word exact: a carry out of the
    last word, or a T of R or more, raises here."""
    W = field.num_limbs // 2
    acc_words = 2 * W + 1 if acc_words is None else acc_words
    m32, R, p = (1 << 32) - 1, 1 << (32 * W), field.p
    words = lambda v: [(v >> (32 * j)) & m32 for j in range(W)]  # noqa: E731
    e, o, ce, co = [0] * (2 * W), [0] * (2 * W - 2), [0] * (W + 1), [0] * W

    def chain(arr, first, carries, at, a, bs):
        # mad.lo.cc / madc.hi.cc over consecutive word pairs, then addc
        cc = 0
        for j, b in enumerate(bs):
            prod = a * b
            for k, part in ((2 * j, prod & m32), (2 * j + 1, prod >> 32)):
                v = arr[first + k] + part + cc
                arr[first + k], cc = v & m32, v >> 32
        carries[at] += cc

    for r, m in zip(rs, ms):
        a, b = words(r), words(m)
        for i in range(0, W, 2):
            chain(e, i, ce, i, a[i], b[0::2])
            chain(o, i, co, i, a[i], b[1::2])
            chain(e, i + 2, ce, i + 2, a[i + 1], b[1::2])
            chain(o, i, co, i, a[i + 1], b[0::2])
    if max(ce + co) > m32:
        raise OverflowError("row_combine: a kept carry word overflowed")
    s, carry = [], 0
    for x in range(2 * W + 1):
        v = carry + (e[x] if x < 2 * W else 0)
        v += o[x - 1] if 1 <= x <= 2 * W - 2 else 0
        v += ce[x - W] if x >= W else 0
        v += co[x - W - 1] if W + 1 <= x <= 2 * W - 1 else 0
        s.append(v & m32)
        carry = v >> 32
    if carry:
        raise OverflowError("row_combine: the sum passed 2 W + 1 words")
    s = s[:acc_words] + [0] * (2 * W + 1 - acc_words)
    np0 = (-pow(p, -1, 1 << 32)) & m32
    pw = words(p)
    for t in range(W + 1):
        mq, carry = (s[t] * np0) & m32, 0
        for j in range(W):
            v = mq * pw[j] + s[t + j] + carry
            s[t + j], carry = v & m32, v >> 32
        for j in range(t + W, 2 * W + 1):
            v = s[j] + carry
            s[j], carry = v & m32, v >> 32
        if carry:
            raise OverflowError("row_combine: a reduction step passed the "
                                "accumulator")
    T = sum(x << (32 * j) for j, x in enumerate(s[W + 1:]))
    if T >= R:
        raise OverflowError("row_combine: the reduced sum is R or more")
    K = (R << 32) % p
    return T * K * pow(R, -1, p) % p     # fe_mont_mul(T, K): T < R, K < p


def row_combine_ref(field: FieldSpec, r: torch.Tensor,
                    mat: torch.Tensor) -> torch.Tensor:
    """Plain version: sum over rows of REDC(r_i M_i) mod p."""
    rr = r[:, None, :] if r.dim() == 2 else r
    return fieldops.sum_mod(field, fieldops.mont_mul(field, rr, mat), 0)


def row_combine16_ref(field: FieldSpec, r: torch.Tensor,
                      mat: torch.Tensor) -> torch.Tensor:
    """Plain version of the 16-bit entry: the matrix widened to int32 limbs,
    then :func:`row_combine_ref`."""
    return row_combine_ref(field, r, fieldops.widen16(mat))


def row_combine_batch_ref(field: FieldSpec, r: torch.Tensor,
                          mats: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`row_combine_batch`: :func:`row_combine_ref`
    of each pair in turn."""
    return torch.stack([row_combine_ref(field, r[b], mats[b])
                        for b in range(mats.shape[0])])


def _sms(device) -> int:
    key = str(device)
    if key not in _SMS:
        _SMS[key] = torch.cuda.get_device_properties(device).multi_processor_count
    return _SMS[key]


def _tickets(device, stream: int, count: int) -> torch.Tensor:
    """The column groups' tickets of launches on one stream: zeroed once
    when allocated; each launch's last blocks set theirs back to 0."""
    key = (str(device), stream)
    tickets = _TICKETS.get(key)
    if tickets is None or tickets.numel() < count:
        tickets = torch.zeros(max(count, 4096), dtype=torch.int32,
                              device=device)
        _TICKETS[key] = tickets
    return tickets


def _launch(field: FieldSpec, name: str, r: torch.Tensor, mats: torch.Tensor,
            per_column: bool) -> torch.Tensor:
    """(B, rows, k, L) x r -> (B, k, L) on the kernel, counted once."""
    fid = cuda_build.kernel_field_id(field, name)
    batch, rows, k, L = mats.shape
    if rows == 0 or k == 0 or batch == 0:
        return torch.zeros((batch, k, L), dtype=torch.int32, device=mats.device)
    if batch > MAX_GRID:
        raise ValueError(f"{name}: at most {MAX_GRID} combinations a launch")
    r, mats = r.contiguous(), mats.contiguous()
    chunks, rows_per_chunk = geometry(rows, k, batch, _sms(mats.device))
    out = torch.empty((batch, k, L), dtype=torch.int32, device=mats.device)
    stream = cuda_build.stream_handle(mats.device)
    scratch = []
    if chunks > 1:
        scratch = [torch.empty((batch, chunks, k, L // 2), dtype=torch.int32,
                               device=mats.device),
                   _tickets(mats.device, stream,
                            batch * -(-k // BLOCK_COLUMNS))]
    m16 = mats.dtype == torch.int16
    cuda_build.require_cuda_tensors(name, r, out, *scratch, limbs16=(mats,))
    partial, tickets = ((t.data_ptr() for t in scratch) if scratch
                        else (None, None))
    lib = cuda_build.library()
    cuda_build.check(
        lib.lt_row_combine(fid, mats.data_ptr(), r.data_ptr(), partial,
                           tickets, out.data_ptr(), batch, rows, k, chunks,
                           rows_per_chunk, int(per_column), int(m16), stream),
        "lt_row_combine")
    (launches16 if m16 else launches).add()
    return out


def row_combine(field: FieldSpec, r: torch.Tensor, mat: torch.Tensor) -> torch.Tensor:
    """(rows, k, L) x r (rows, L) or (rows, k, L) -> (k, L) int32 limbs of
    sum_i REDC(r_i M_i) mod p (Montgomery when both are Montgomery,
    canonical when one is canonical); M in int32 limbs or 16-bit ones
    (int16)."""
    if r.device.type == "cpu" and mat.device.type == "cpu":
        return row_combine16_ref(field, r, mat)
    rows, k, L = mat.shape
    per_column = r.dim() == 3
    if r.shape != ((rows, k, L) if per_column else (rows, L)):
        raise ValueError(f"row_combine: r {tuple(r.shape)} vs M {tuple(mat.shape)}")
    return _launch(field, "row_combine", r[None], mat[None], per_column)[0]


def row_combine_batch(field: FieldSpec, r: torch.Tensor,
                      mats: torch.Tensor) -> torch.Tensor:
    """B combinations of one shape: (B, rows, k, L) x r (B, rows, L) ->
    (B, k, L), each as :func:`row_combine` gives it."""
    if r.device.type == "cpu" and mats.device.type == "cpu":
        return row_combine_batch_ref(field, r, mats)
    if mats.dim() != 4 or r.shape != mats.shape[:2] + mats.shape[3:]:
        raise ValueError(f"row_combine_batch: r {tuple(r.shape)} vs M "
                         f"{tuple(mats.shape)}")
    return _launch(field, "row_combine_batch", r, mats, False)
