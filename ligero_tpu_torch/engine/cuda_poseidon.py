"""Poseidon column digests: the CUDA kernel ``csrc/poseidon_cols.cu`` and
its wrapper.

Replaces the sponge rounds of ``ligero_tpu/engine/poseidon_cols.py``, which
the JAX package runs as one ``mont_mul_pallas`` launch
(``ligero_tpu/engine/pallas_kernels.py:_mont_mul_kernel_factory``) per
product per round.  The kernel runs every round of every absorb of a column
in registers, BN254 Fr only.  Each permutation is a chain of dependent
products, so the time is that of one column's chain, not of memory: the
three S-boxes of a full round run side by side (195 products deep a
permutation, not 275), the squarings take a squaring routine, and G = 1,
2, 4 or 8 lanes of a warp share a column, each holding 8 / G words of every
element, its products a CIOS distributed over the lanes by shuffles.
:func:`lanes_for` picks G from the number of columns of the launch: one
lane where the columns fill the card, eight where they leave it idle.  One
launch takes B stacked matrices (a batch's commitments, or a tree level of
B trees).

The chunked entry (:func:`poseidon_absorb`, :class:`PoseidonColumnStream`,
the counterpart of the JAX package's ``PoseidonColumns.digests`` on a
``StreamedCodewords``) hashes the same columns when their rows arrive chunk
by chunk, as the streaming commit re-encodes them: one launch a chunk,
each column's (3, 8) state words kept on the device between launches, the
last chunk's launch writing the digests.  Its digests equal
:func:`poseidon_columns`'s for every chunking whose chunks but the last
have even row counts.

A tensor on the CPU takes the plain version
(:func:`poseidon_cols.poseidon_columns_plain`,
:func:`poseidon_cols.poseidon_absorb_plain`); a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import BN254_FR, FieldSpec
from . import cuda_build, poseidon_cols

#: kernel launches by :func:`poseidon_columns`
launches = cuda_build.LaunchCounter()
#: launches of the chunked entry, by :func:`poseidon_absorb`
stream_launches = cuda_build.LaunchCounter()

#: the lane counts the kernel is compiled for
LANES = (1, 2, 4, 8)

_CONSTS: dict = {}


def lanes_for(columns: int) -> int:
    """Lanes a column for a launch over ``columns`` sponges.  Past 4096
    columns one lane a column keeps a warp on every scheduler and more
    lanes only add instructions (G = 1); at 2049-4096, four lanes; at up to
    2048, eight lanes a column fill the schedulers the columns alone leave
    idle and shorten each product's chain (the times behind the rule:
    ``PERF.md``, kernel table)."""
    if columns > 4096:
        return 1
    if columns > 2048:
        return 4
    return 8


def kernel_constants(field: FieldSpec, cfg, device) -> torch.Tensor:
    """(3 x 39 + 1, 8) int32 words on ``device``: ``cfg``'s round
    constants in Montgomery form, then R^2 mod p (the kernel's
    to-Montgomery factor).  Cached by the constants' values."""
    key = (field.name, str(device), tuple(c for row in cfg.ark for c in row))
    out = _CONSTS.get(key)
    if out is None:
        ark = poseidon_cols.round_constants(field, cfg)
        limbs = np.concatenate([ark.reshape(-1, field.num_limbs),
                                field.r2_limbs[None]]).astype(np.uint32)
        words = limbs[:, 0::2] | (limbs[:, 1::2] << 16)
        out = torch.from_numpy(words.view(np.int32).copy()).to(device)
        _CONSTS[key] = out
    return out


def poseidon_columns(field: FieldSpec, cfg, u: torch.Tensor,
                     lanes: int | None = None) -> torch.Tensor:
    """(rows, N, L) -> (N, L), or B matrices (B, rows, N, L) -> (B, N, L):
    int32 canonical limbs on a CUDA device, any strides whose limb axis is
    contiguous, to int32 canonical digests, in one launch at ``lanes``
    lanes a column (default :func:`lanes_for` of B N)."""
    poseidon_cols.check_config(field, cfg)
    if (field.name, field.p) != (BN254_FR.name, BN254_FR.p):
        raise NotImplementedError(
            f"poseidon_columns: the CUDA kernel is built for {BN254_FR.name} "
            f"only, not {field.name}")
    if u.dim() not in (3, 4):
        raise ValueError(f"poseidon_columns: expected (rows, N, L) or "
                         f"(B, rows, N, L), got {tuple(u.shape)}")
    mats = u if u.dim() == 4 else u[None]
    batch, rows, n, L = mats.shape
    if L != field.num_limbs:
        raise ValueError(f"poseidon_columns: {field.name} elements are "
                         f"{field.num_limbs} limbs, not {L}")
    if u.device.type != "cuda" or u.dtype != torch.int32:
        raise ValueError("poseidon_columns: expected int32 limbs on a CUDA "
                         f"device, got {u.dtype} on {u.device}")
    strides = (mats.stride(0) if batch > 1 else 0, mats.stride(1),
               mats.stride(2))
    if mats.stride(3) != 1 or any(s % 4 for s in strides) or (
            u.data_ptr() % 16):
        raise ValueError("poseidon_columns: each element's limbs must be "
                         "contiguous and 16-byte aligned")
    lanes = lanes_for(batch * n) if lanes is None else lanes
    if lanes not in LANES:
        raise ValueError(f"poseidon_columns: {lanes} lanes a column; the "
                         f"kernel is built for {LANES}")
    out = torch.empty((batch, n, L), dtype=torch.int32, device=u.device)
    consts = kernel_constants(field, cfg, u.device)
    lib = cuda_build.library()
    with torch.cuda.device(u.device):
        cuda_build.check(lib.lt_poseidon_cols(
            consts.data_ptr(), u.data_ptr(), rows, n, batch, strides[1],
            strides[2], strides[0], lanes, out.data_ptr(),
            cuda_build.stream_handle(u.device)), "lt_poseidon_cols")
    launches.add()
    return out if u.dim() == 4 else out[0]


def poseidon_absorb(field: FieldSpec, cfg, chunk: torch.Tensor, rows: int,
                    state: torch.Tensor, first: bool, last: bool,
                    lanes: int | None = None) -> torch.Tensor:
    """Rows [0, ``rows``) of a (>= rows, n, L) canonical chunk absorbed into
    the (n, 3, 8) int32 sponge states
    (:func:`poseidon_cols.poseidon_stream_start`; taken as zero where
    ``first``).  Returns the new states (on CUDA: ``state``, updated in
    place), or where ``last`` the (n, L) canonical digests.  A chunk that
    is not a column's last has an even, non-zero number of rows (an odd one
    raises: the pairs would shift).  One launch at ``lanes`` lanes a column
    (default :func:`lanes_for` of n); the plain version on a CPU tensor."""
    L = field.num_limbs
    if (chunk.dim() != 3 or chunk.shape[-1] != L
            or not 0 < rows <= chunk.shape[0]):
        raise ValueError(f"poseidon_absorb: bad chunk {tuple(chunk.shape)} "
                         f"for {rows} {field.name} rows")
    n = chunk.shape[1]
    if state.shape != (n, 3, L // 2) or state.dtype != torch.int32:
        raise ValueError(f"poseidon_absorb: states {tuple(state.shape)} "
                         f"{state.dtype} for {n} columns")
    if not last and rows % 2:
        raise ValueError(f"poseidon_absorb: an odd chunk of {rows} rows "
                         "before a column's last chunk would shift its pairs")
    if chunk.device.type == "cpu":
        return poseidon_cols.poseidon_absorb_plain(field, cfg, chunk, rows,
                                                   state, first, last)
    poseidon_cols.check_config(field, cfg)
    if (field.name, field.p) != (BN254_FR.name, BN254_FR.p):
        raise NotImplementedError(
            f"poseidon_absorb: the CUDA kernel is built for {BN254_FR.name} "
            f"only, not {field.name}")
    lanes = lanes_for(n) if lanes is None else lanes
    if lanes not in LANES:
        raise ValueError(f"poseidon_absorb: {lanes} lanes a column; the "
                         f"kernel is built for {LANES}")
    chunk = chunk.contiguous()
    cuda_build.require_cuda_tensors("poseidon_absorb", chunk, state)
    out = (torch.empty((n, L), dtype=torch.int32, device=chunk.device)
           if last else None)
    consts = kernel_constants(field, cfg, chunk.device)
    lib = cuda_build.library()
    with torch.cuda.device(chunk.device):
        cuda_build.check(lib.lt_poseidon_absorb(
            consts.data_ptr(), chunk.data_ptr(), rows, n, chunk.stride(0),
            chunk.stride(1), state.data_ptr(), int(first), int(last), lanes,
            None if out is None else out.data_ptr(),
            cuda_build.stream_handle(chunk.device)), "lt_poseidon_absorb")
    stream_launches.add()
    return state if out is None else out


class PoseidonColumnStream:
    """The Poseidon digests of n columns of ``total_rows`` rows, absorbed
    chunk by chunk in row order (:func:`poseidon_absorb`); the chunk that
    brings the count to ``total_rows`` writes the digests, after which
    :meth:`digests` gives the (n, L) canonical limbs
    :func:`poseidon_columns` gives for the whole matrix."""

    def __init__(self, field: FieldSpec, cfg, n: int, total_rows: int,
                 device):
        if total_rows < 1:
            raise ValueError("PoseidonColumnStream: no rows")
        self.field, self.cfg = field, cfg
        self.total_rows, self.done = total_rows, 0
        self.state = poseidon_cols.poseidon_stream_start(field, n, device)
        self.out = None

    def absorb(self, chunk: torch.Tensor, rows: int) -> None:
        """The next ``rows`` rows: rows [0, rows) of ``chunk``."""
        if self.done + rows > self.total_rows:
            raise ValueError(f"PoseidonColumnStream: {self.done} + {rows} "
                             f"rows exceed {self.total_rows}")
        last = self.done + rows == self.total_rows
        res = poseidon_absorb(self.field, self.cfg, chunk, rows, self.state,
                              self.done == 0, last)
        if last:
            self.out, self.state = res, None
        else:
            self.state = res
        self.done += rows

    def digests(self) -> torch.Tensor:
        if self.done != self.total_rows:
            raise ValueError(f"PoseidonColumnStream: {self.done} of "
                             f"{self.total_rows} rows absorbed")
        return self.out
