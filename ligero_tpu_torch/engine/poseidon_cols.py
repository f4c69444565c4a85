"""Poseidon column digests and Merkle levels: the commitment of
``LigeroMTPoseidonParams``.

The port's counterpart of ``ligero_tpu/engine/poseidon_cols.py``.  A column
digest is the test sponge (``sponge.test_poseidon_config``) absorbing the
column's canonical elements and squeezing one element; the n columns of U
are n independent sponges.  The schedule is ark's duplex state machine
(``sponge.PoseidonSponge``), exactly:

* a fresh sponge adds the first pair into the rate slots 1 and 2, with no
  permutation before it; every later pair is permute-then-add;
* an odd height (zk columns are 4m + 3 high) leaves one tail element: it
  is added into rate slot 0 (state index 1, after the capacity) after the
  last pair's permutation, with no permutation of its own;
* one final permutation; the digest is ``from_mont(state[1])``.

A permutation is 4 full rounds, 31 partial rounds (the S-box on state[0]
only) and 4 full rounds; a round adds its three constants (Montgomery form),
applies x^17 (four squarings and a product) and the binary MDS
[[1,0,1],[1,1,0],[0,1,1]], three modular adds.

Poseidon ``two_to_one(l, r)`` is the digest of the 2-element column
[l, r] (digests are canonical elements and a level never needs padding:
its width is a power of two), so every inner level of the Merkle tree is
one call over a (2, w/2, L) view of the level below (:func:`tree_levels`).
Every call takes B matrices at once, (B, rows, N, L): a batch's B
commitments, or one level of B trees, go in one launch.

The streaming commit absorbs the columns a chunk of rows at a time
(:func:`poseidon_absorb_plain` and the kernel's chunked entry, through
``cuda_poseidon.PoseidonColumnStream``): every pair is add-then-permute,
so the state between chunks of even heights is the state after a
permutation, (n, 3, W) words a column set, and the chunk that ends the
column writes the digests.

:func:`poseidon_columns` is what the commitment calls: on a CUDA tensor the
hand-written sponge kernel (``cuda_poseidon``), on a CPU tensor the plain
version (:func:`poseidon_columns_plain`), nothing else.  Digests are 32-byte
little-endian elements, so only fields of at most 256 bits qualify
(:func:`check_config`): BN254 Fr.  The JAX package's params fail on
BLS12-377 Fq too, at ``to_bytes(32)``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import FieldSpec
from . import fieldops

#: the permutation the kernel implements: the test sponge's
FULL_ROUNDS, PARTIAL_ROUNDS, ALPHA = 8, 31, 17
MDS = [[1, 0, 1], [1, 1, 0], [0, 1, 1]]
DIGEST_BYTES = 32


def check_config(field: FieldSpec, cfg) -> None:
    """Raise ``ValueError`` unless ``cfg`` is the permutation implemented
    here over a field whose elements fit a 32-byte digest.  The round
    constants are the config's own, whatever their values."""
    if field.p.bit_length() > 8 * DIGEST_BYTES:
        raise ValueError(
            f"Poseidon Merkle digests are {DIGEST_BYTES}-byte field elements; "
            f"{field.name} elements are {field.p.bit_length()} bits")
    if cfg.field.p != field.p:
        raise ValueError(f"a {cfg.field.name} Poseidon config over "
                         f"{field.name} columns")
    if ((cfg.full_rounds, cfg.partial_rounds, cfg.alpha, cfg.rate,
         cfg.capacity) != (FULL_ROUNDS, PARTIAL_ROUNDS, ALPHA, 2, 1)
            or cfg.mds != MDS
            or [len(row) for row in cfg.ark] != [3] * (FULL_ROUNDS
                                                      + PARTIAL_ROUNDS)):
        raise ValueError("only the test sponge's Poseidon permutation is "
                         "implemented (8 + 31 rounds, alpha 17, rate 2, "
                         "binary MDS)")


def round_constants(field: FieldSpec, cfg) -> np.ndarray:
    """(rounds, 3, L) uint32 Montgomery limbs of ``cfg``'s round
    constants."""
    flat = [c % field.p for row in cfg.ark for c in row]
    return field.ints_to_mont_limbs(flat).reshape(len(cfg.ark), 3, -1)


def _permute(field: FieldSpec, ark: torch.Tensor, state: torch.Tensor):
    """One permutation of a (3, N, L) Montgomery state (values < p)."""
    mul = fieldops.mont_mul_vec
    add = fieldops.add_vec
    half = FULL_ROUNDS // 2

    def sbox(x):                            # x^17: four squarings, a product
        x16 = x
        for _ in range(4):
            x16 = mul(field, x16, x16)
        return mul(field, x16, x)

    for r in range(FULL_ROUNDS + PARTIAL_ROUNDS):
        state = add(field, state, ark[r][:, None, :])
        if half <= r < half + PARTIAL_ROUNDS:
            state = torch.cat([sbox(state[:1]), state[1:]])
        else:
            state = sbox(state)
        s0, s1, s2 = state
        state = add(field, torch.stack([s0, s0, s1]), torch.stack([s2, s1, s2]))
    return state


def _absorb(field: FieldSpec, ark: torch.Tensor, state: torch.Tensor,
            u: torch.Tensor, rows: int) -> torch.Tensor:
    """Rows [0, ``rows``) of ``u`` (>= rows, N, L) canonical limbs absorbed
    into a (3, N, L) Montgomery state: add a pair (or the odd tail alone,
    rate slot 0 only) into the rate, permute, until the rows run out
    (``rows`` = 0: one permutation).  The kernel's ``absorb_rows``."""
    mul = fieldops.mont_mul_vec
    for i in range(0, max(rows, 1), 2):
        elems = fieldops.to_mont(field, u[i:min(i + 2, rows)], mul=mul)
        if len(elems):
            rate = fieldops.add_vec(field, state[1:1 + len(elems)], elems)
            state = torch.cat([state[:1], rate, state[1 + len(elems):]])
        state = _permute(field, ark, state)
    return state


def _ark(field: FieldSpec, cfg, device) -> torch.Tensor:
    return torch.from_numpy(round_constants(field, cfg).astype(np.int32)).to(
        device)


def poseidon_columns_plain(field: FieldSpec, cfg, u: torch.Tensor) -> torch.Tensor:
    """Plain version: the digests of the N columns of ``u`` (rows, N, L),
    canonical int32 limbs (any strides), as (N, L) int32 canonical limbs,
    each row one 32-byte little-endian digest; of B matrices (B, rows, N,
    L), as (B, N, L).  The sponges run side by side on a (3, B N, L)
    Montgomery state, through fieldops products
    (:func:`fieldops.mont_mul_vec`, whose results are ``mont_mul``'s)."""
    check_config(field, cfg)
    if u.dim() == 4:
        batch, rows, n, L = u.shape
        side = u.permute(1, 0, 2, 3).reshape(rows, batch * n, L)
        return poseidon_columns_plain(field, cfg, side).reshape(batch, n, L)
    rows, n, L = u.shape
    # thousands of small tensor ops: inference mode trims each one's
    # dispatch; the result leaves it as an ordinary tensor (the clone)
    with torch.inference_mode():
        state = torch.zeros((3, n, L), dtype=torch.int32, device=u.device)
        state = _absorb(field, _ark(field, cfg, u.device), state, u, rows)
        digests = fieldops.from_mont(field, state[1], mul=fieldops.mont_mul_vec)
    return digests.clone()


def poseidon_stream_start(field: FieldSpec, n: int, device) -> torch.Tensor:
    """The (n, 3, W) int32 sponge states of n columns before their first
    row (zeros): W = L / 2 32-bit words an element, the layout of the
    chunked kernel entry."""
    return torch.zeros((n, 3, field.num_limbs // 2), dtype=torch.int32,
                       device=device)


def _limbs_to_words(limbs: torch.Tensor) -> torch.Tensor:
    """(..., L) 16-bit limbs -> (..., L / 2) int32 words (bit patterns)."""
    w = limbs[..., 0::2].to(torch.int64) | (limbs[..., 1::2].to(torch.int64)
                                            << 16)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def _words_to_limbs(words: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_limbs_to_words`."""
    lo, hi = words & 0xFFFF, (words >> 16) & 0xFFFF
    return torch.stack([lo, hi], dim=-1).reshape(*words.shape[:-1], -1)


def poseidon_absorb_plain(field: FieldSpec, cfg, chunk: torch.Tensor,
                          rows: int, state: torch.Tensor, first: bool,
                          last: bool) -> torch.Tensor:
    """Plain version of the chunked entry: rows [0, ``rows``) of a (>= rows,
    n, L) canonical chunk (int32 limbs, or 16-bit ones as int16: widened
    first) absorbed into the (n, 3, W) states
    (:func:`poseidon_stream_start`; zero where ``first``), a pair and a
    permutation at a time; returns the new states (canonical Montgomery
    words), or where ``last`` the (n, L) canonical digests.  Chunk after
    chunk, the digests of :func:`poseidon_columns_plain` on the whole
    column, where every chunk but the last has an even row count."""
    check_config(field, cfg)
    with torch.inference_mode():
        st = (torch.zeros((3,) + tuple(chunk.shape[1:]), dtype=torch.int32,
                          device=chunk.device) if first
              else _words_to_limbs(state.permute(1, 0, 2)))
        st = _absorb(field, _ark(field, cfg, chunk.device), st,
                     fieldops.widen16(chunk[:rows]), rows)
        if last:
            out = fieldops.from_mont(field, st[1], mul=fieldops.mont_mul_vec)
        else:
            out = _limbs_to_words(st).permute(1, 0, 2).contiguous()
    return out.clone()


def poseidon_columns(field: FieldSpec, cfg, u: torch.Tensor) -> torch.Tensor:
    """Column digests of ``u`` (rows, N, L) -> (N, L), or of B matrices
    (B, rows, N, L) -> (B, N, L), int32 canonical limbs: the CUDA kernel on
    a CUDA tensor, one launch (raises where it cannot launch), the plain
    version on a CPU tensor."""
    if u.device.type == "cpu":
        return poseidon_columns_plain(field, cfg, u)
    from . import cuda_poseidon
    return cuda_poseidon.poseidon_columns(field, cfg, u)


def tree_levels(field: FieldSpec, cfg, leaves: torch.Tensor) -> list:
    """The Merkle levels above ``leaves`` (n, L) (n a power of two >= 2):
    [(n/2, L), ..., (1, L)], each node the Poseidon two-to-one of its two
    children, one :func:`poseidon_columns` call a level; of B trees' leaves
    (B, n, L), [(B, n/2, L), ..., (B, 1, L)], still one call a level."""
    n = leaves.shape[-2]
    if n < 2 or n & (n - 1):
        raise ValueError(f"tree_levels: {n} leaves, not a power of two >= 2")
    levels, cur = [], leaves if leaves.dim() == 3 else leaves[None]
    while cur.shape[1] > 1:
        batch, w, L = cur.shape
        # column j of tree b's (2, w/2, L) view is [cur[b, 2j], cur[b, 2j + 1]]
        cur = poseidon_columns(field, cfg, cur.reshape(batch, w // 2, 2, L)
                               .transpose(1, 2))
        levels.append(cur if leaves.dim() == 3 else cur[0])
    return levels


def digests_to_bytes(limbs) -> list[bytes]:
    """(N, L) canonical limbs (tensor or array) -> N 32-byte LE digests."""
    if isinstance(limbs, torch.Tensor):
        limbs = limbs.cpu().numpy()
    data = np.ascontiguousarray(limbs, dtype="<u2").tobytes()
    return [data[i:i + DIGEST_BYTES] for i in range(0, len(data), DIGEST_BYTES)]


def bytes_to_digests(digests: list[bytes], num_limbs: int) -> np.ndarray:
    """N 32-byte LE digests -> (N, L) int32 canonical limbs."""
    data = np.frombuffer(b"".join(digests), dtype="<u2")
    return data.reshape(len(digests), num_limbs).astype(np.int32)
