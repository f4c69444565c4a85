"""Plain PyTorch Blake2s-256 column hashing and SHA-256 Merkle levels.

The counterpart of ``ligero_tpu/engine/hashops.py`` (``HashKernel``) and of
the commit helpers of ``ligero_tpu/engine/backend.py``
(``_column_leaves_device``, ``_tree_flat``, ``_digest_lists``).  32-bit
words live in int64 tensors (masked to 32 bits after every add and shift:
PyTorch's CPU build has no unsigned 32-bit arithmetic), and come back as
int32 bit patterns.

:func:`blake2s_columns_ref` is the plain version the CUDA column kernel
(``cuda_hash``) is held against, :func:`blake2s_absorb_ref` that of its
streamed entry (a column's rows absorbed chunk by chunk, the JAX package's
``HashKernel.blake2s_stream_*``), :func:`column_block_words` the kernel's
word map, :func:`tree_flat` the plain version of the
CUDA tree kernel (``cuda_tree``).  :func:`digest_lists` is host code: it
unpacks the flat tree transfer into byte lists.
"""

from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF

_IV = [0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
       0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19]

_SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
]

_SHA_K = [
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2]


def _rotr(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x >> r) | (x << (32 - r))) & M32


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 words < 2^32 -> int32 with the same bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def _words64(x: torch.Tensor) -> torch.Tensor:
    """int32 word bits -> int64 words in [0, 2^32)."""
    return x.to(torch.int64) & M32


# ---------------------------------------------------------------------------
# Blake2s-256
# ---------------------------------------------------------------------------

def _blake2s_g(a, b, c, d, x, y):
    a = (a + b + x) & M32
    d = _rotr(d ^ a, 16)
    c = (c + d) & M32
    b = _rotr(b ^ c, 12)
    a = (a + b + y) & M32
    d = _rotr(d ^ a, 8)
    c = (c + d) & M32
    b = _rotr(b ^ c, 7)
    return a, b, c, d


#: each round's message words in the order G takes them: the four columns'
#: x and y words, then the four diagonals'
_SCHEDULE = [i for s in _SIGMA
             for i in s[0:8:2] + s[1:8:2] + s[8:16:2] + s[9:16:2]]


def _blake2s_blocks(h: torch.Tensor, msg: torch.Tensor,
                    counters: list[tuple[int, bool]]) -> torch.Tensor:
    """h: (B, 8) chaining values, msg: (B, 16 len(counters)) int64 words,
    ``counters`` each block's (byte count t, last) -> the chaining values
    after the blocks.  The constants go to the device once a call, and a
    block's message schedule is one gather; G runs on the four columns
    (then the four diagonals) of the 4x4 state at once."""
    dev = h.device
    iv = torch.tensor(_IV, dtype=torch.int64, device=dev)
    sched = torch.tensor(_SCHEDULE, dtype=torch.int64, device=dev)
    lows = torch.tensor([[_IV[4] ^ (t & M32), _IV[5] ^ ((t >> 32) & M32),
                          _IV[6] ^ (M32 if last else 0), _IV[7]]
                         for t, last in counters], dtype=torch.int64,
                        device=dev)
    for blk in range(len(counters)):
        m = msg[:, 16 * blk:16 * blk + 16].index_select(1, sched).view(
            -1, 10, 4, 4)
        a, b = h[:, 0:4], h[:, 4:8]
        c = iv[0:4].expand_as(a)
        d = lows[blk].expand_as(a)
        for r in range(10):
            a, b, c, d = _blake2s_g(a, b, c, d, m[:, r, 0], m[:, r, 1])
            b, c, d = b.roll(-1, 1), c.roll(-2, 1), d.roll(-3, 1)
            a, b, c, d = _blake2s_g(a, b, c, d, m[:, r, 2], m[:, r, 3])
            b, c, d = b.roll(1, 1), c.roll(2, 1), d.roll(3, 1)
        h = h ^ torch.cat([a ^ c, b ^ d], dim=1)
    return h


def blake2s_columns_ref(u_canon: torch.Tensor) -> torch.Tensor:
    """(rows, n, L) canonical int32 limbs -> (n, 8) int32 LE digest words
    of each column's ark serialization (u64 LE row count, then 2 L-byte LE
    elements): ``hashes.column_hash`` of every column."""
    rows, n, L = u_canon.shape
    u = u_canon.to(torch.int64)
    packed = u[..., 0::2] | (u[..., 1::2] << 16)           # (rows, n, L/2)
    words = packed.permute(1, 0, 2).reshape(n, rows * (L // 2))
    byte_len = 8 + rows * L * 2
    nblocks = max(1, -(-byte_len // 64))
    msg = torch.zeros((n, nblocks * 16), dtype=torch.int64, device=u.device)
    msg[:, 0] = rows & M32
    msg[:, 1] = rows >> 32
    msg[:, 2:2 + words.shape[1]] = words
    h = torch.tensor(_IV, dtype=torch.int64, device=u.device).repeat(n, 1)
    h[:, 0] ^= 0x01010020
    counters = [(64 * (blk + 1), False) for blk in range(nblocks - 1)]
    return _to_i32(_blake2s_blocks(h, msg, counters + [(byte_len, True)]))


#: words of a streamed column state: the chaining value, then two carried
#: words (csrc/blake2s_cols.cu, ``blake2s_absorb_kernel``)
STATE_WORDS = 10


def period_rows(L: int) -> int:
    """Rows of the column word map's period (E: 2 BN254 rows, 4 BLS12-377
    rows): a chunk that is not a column's last has a multiple of these."""
    return 16 // math.gcd(16, L // 2)


def blake2s_stream_start(n: int, total_rows: int, device) -> torch.Tensor:
    """(n, 10) int32 states of n columns of ``total_rows`` rows before any
    row: the initial chaining value, and the u64 LE row count as the two
    carried words."""
    state = torch.zeros((n, STATE_WORDS), dtype=torch.int64, device=device)
    state[:, :8] = torch.tensor(_IV, dtype=torch.int64, device=device)
    state[:, 0] ^= 0x01010020
    state[:, 8] = total_rows & M32
    state[:, 9] = total_rows >> 32
    return _to_i32(state)


def blake2s_absorb_ref(chunk: torch.Tensor, rows: int, state: torch.Tensor,
                       block0: int, final: bool,
                       total_rows: int) -> torch.Tensor:
    """Plain version of the streamed absorb: rows [0, ``rows``) of the
    (>= rows, n, L) canonical chunk into the (n, 10) states after
    ``block0`` compressed blocks -> the new states.  Not ``final``:
    ``rows`` is a multiple of :func:`period_rows` and the chunk fills whole
    blocks after the two carried words, which leave as its last row's last
    two.  ``final``: the message ends here (``total_rows`` rows in all), the
    last block takes the full byte length, and words 0-7 are the digest."""
    n, L = chunk.shape[1], chunk.shape[2]
    u = chunk[:rows].to(torch.int64)
    packed = u[..., 0::2] | (u[..., 1::2] << 16)            # (rows, n, L/2)
    words = packed.permute(1, 0, 2).reshape(n, rows * (L // 2))
    s = _words64(state)
    msg = torch.cat([s[:, 8:], words], dim=1)
    nw = msg.shape[1]
    if final:
        nblocks = -(-nw // 16)
        msg = torch.cat([msg, msg.new_zeros((n, 16 * nblocks - nw))], dim=1)
    else:
        if rows % period_rows(L):
            raise ValueError(f"blake2s absorb: {rows} rows are not whole "
                             f"periods of {period_rows(L)}")
        nblocks = nw // 16
    byte_len = 8 + total_rows * L * 2
    counters = [(64 * (block0 + blk + 1), False) for blk in range(nblocks)]
    if final:
        counters[-1] = (byte_len, True)
    h = _blake2s_blocks(s[:, :8], msg, counters)
    carry = s[:, 8:] if final else msg[:, 16 * nblocks:]
    return _to_i32(torch.cat([h, carry], dim=1))


def column_block_words(words: int, block: int) -> list[tuple[int, int]]:
    """The column kernel's word map (csrc/blake2s_cols.cu): the 16 message
    words of 64-byte block ``block`` of a column whose elements are
    ``words`` 32-bit words, as (row, word) pairs; row -1 is the u64 row
    count (word 0 its low half).  The message repeats every P blocks of E
    elements (16 P = E W); a period's first two words are the last two of
    the element before it.  Rows past the column's end read as zeros."""
    g = math.gcd(16, words)
    period, elems = words // g, 16 // g
    q, bb = divmod(block, period)
    out = []
    for i in range(16):
        off = 16 * bb + i - 2          # word of the period's elements
        if off >= 0:
            out.append((q * elems + off // words, off % words))
        elif q:
            out.append((q * elems - 1, words + off))
        else:
            out.append((-1, off + 2))
    return out


# ---------------------------------------------------------------------------
# SHA-256 two-to-one and the Merkle levels
# ---------------------------------------------------------------------------

def _sha256_compress(state: torch.Tensor, w: list) -> torch.Tensor:
    """state: (B, 8) int64 words; w: the 64 schedule words, each (B,)
    tensors or ints."""
    a, b, c, d, e, f, g, h = state.unbind(1)
    for t in range(64):
        s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g & M32)
        t1 = (h + s1 + ch + _SHA_K[t] + w[t]) & M32
        s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (s0 + maj) & M32
        a, b, c, d, e, f, g, h = (t1 + t2) & M32, a, b, c, (d + t1) & M32, e, f, g
    return (state + torch.stack([a, b, c, d, e, f, g, h], dim=1)) & M32


def _sha256_schedule(block: list) -> list:
    w = list(block)
    for t in range(16, 64):
        x, y = w[t - 15], w[t - 2]
        if isinstance(x, int):
            s0 = (((x >> 7) | (x << 25)) ^ ((x >> 18) | (x << 14)) ^ (x >> 3)) & M32
            s1 = (((y >> 17) | (y << 15)) ^ ((y >> 19) | (y << 13)) ^ (y >> 10)) & M32
        else:
            s0 = _rotr(x, 7) ^ _rotr(x, 18) ^ (x >> 3)
            s1 = _rotr(y, 17) ^ _rotr(y, 19) ^ (y >> 10)
        w.append((w[t - 16] + s0 + w[t - 7] + s1) & M32)
    return w


#: schedule of the constant padding block of a 64-byte message
_PAD_SCHEDULE = _sha256_schedule([0x80000000] + [0] * 14 + [512])


def sha256_two_to_one(left: torch.Tensor, right: torch.Tensor) -> torch.Tensor:
    """SHA-256 of the 64-byte concatenations: (B, 8) big-endian int64
    words each -> (B, 8) big-endian int64 digest words."""
    B = left.shape[0]
    state = torch.tensor(_IV, dtype=torch.int64, device=left.device).repeat(B, 1)
    block = torch.cat([left, right], dim=1)
    state = _sha256_compress(state, _sha256_schedule(list(block.unbind(1))))
    return _sha256_compress(state, _PAD_SCHEDULE)


def _byteswap(x: torch.Tensor) -> torch.Tensor:
    return (((x & 0xFF) << 24) | ((x & 0xFF00) << 8)
            | ((x >> 8) & 0xFF00) | ((x >> 24) & 0xFF))


def byteswap_words(words: torch.Tensor) -> torch.Tensor:
    """int32 digest words, each one's four bytes reversed: a leaf's LE
    words <-> the BE words the tree hashes."""
    return _to_i32(_byteswap(_words64(words)))


def tree_flat(leaves_le: torch.Tensor) -> torch.Tensor:
    """(n, 8) LE leaf digest words -> one flat int32 vector: the leaves' LE
    words, then every SHA-256 level's BE words bottom-up (the layout of the
    JAX package's ``Backend._tree_flat``)."""
    lv = _words64(leaves_le)
    parts = [lv.reshape(-1)]
    level = _byteswap(lv)
    while level.shape[0] > 1:
        level = sha256_two_to_one(level[0::2], level[1::2])
        parts.append(level.reshape(-1))
    return _to_i32(torch.cat(parts))



def tree_root(leaves_le: torch.Tensor) -> torch.Tensor:
    """The Merkle root's 8 BE words as int32 bits."""
    return tree_flat(leaves_le)[-8:]


def digest_lists(flat: np.ndarray, n: int) -> tuple[list[bytes], list[list[bytes]]]:
    """:func:`tree_flat`'s vector on the host (uint32 words) -> ark-layout
    ``(leaves, inner levels bottom-up)`` byte lists, as the JAX package's
    ``Backend._digest_lists`` builds them."""
    flat = np.ascontiguousarray(flat).view(np.uint32)
    leaves_raw = flat[:n * 8].astype("<u4").tobytes()
    leaves = [leaves_raw[i * 32:(i + 1) * 32] for i in range(n)]
    inner_raw = flat[n * 8:].astype(">u4").tobytes()
    inner, off, size = [], 0, n // 2
    while size >= 1:
        inner.append([inner_raw[(off + i) * 32:(off + i + 1) * 32]
                      for i in range(size)])
        off += size
        size //= 2
    return leaves, inner
