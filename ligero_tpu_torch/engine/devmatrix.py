"""Row-chunked matrices on one device: the resident and streaming modes'
handles.

The counterpart of ``ligero_tpu/engine/devmatrix.py``.  Past the direct
mode's reach (``LigeroCircuit.encode_mode`` "resident" or "streaming") the
n-wide codeword matrix U is never one tensor: its coefficient rows stay on
the device as a :class:`RowChunkedMatrix`, and the consumers of U take it a
chunk at a time (:class:`StreamedCodewords`): the commit absorbs each
codeword chunk into per-column Blake2s (or Poseidon) states, the openings
gather the opened columns of each.  In resident mode the codeword chunks
are held too, encoded once; in streaming mode a consumer re-encodes them
from the coefficient chunks.  The r^T A coefficient rows of the linear
phase are a :class:`RowChunkedMatrix` too, row-aligned with the codeword
chunks.
Over a mesh (``parallel.ShardedBackend``, streaming mode only) the chunks
of one matrix lie on several devices: chunk i on mesh device i mod D, the
block-cyclic layout of the JAX package's ``ShardedCoeffs`` (over a process
mesh, in rank i mod D's process).

The backend's bulk steps take either a tensor (direct mode) or one of these
handles, and dispatch on the type, as the JAX package does.
"""

from __future__ import annotations

import torch


class RowChunkedMatrix:
    """A logical ``(rows, w, L)`` matrix stored as chunks of ``chunk_rows``
    rows each: ``chunks[i]`` holds rows ``[i chunk_rows, (i + 1)
    chunk_rows)``.  Rows at and past ``rows`` in the last chunk are exact
    zeros (padding), so a sum or a transform over whole chunks is that of
    the real rows; or the last chunk holds its real rows only (the resident
    codeword chunks, whose padding would be n-wide rows).  Over a process
    mesh a chunk that another rank holds is None here (``width`` names the
    width where this rank holds none)."""

    def __init__(self, chunks: list, rows: int, chunk_rows: int,
                 width: int | None = None):
        held = [c for c in chunks if c is not None]
        if not chunks:
            raise ValueError("RowChunkedMatrix: no chunks")
        count = -(-rows // chunk_rows)
        last = rows - (count - 1) * chunk_rows
        if len(chunks) != count or any(
                c is not None and c.shape[0] != chunk_rows
                and (i != count - 1 or c.shape[0] != last)
                for i, c in enumerate(chunks)):
            raise ValueError(f"RowChunkedMatrix: {len(chunks)} chunks do not "
                             f"hold {rows} rows in chunks of {chunk_rows}")
        if not held and width is None:
            raise ValueError("RowChunkedMatrix: no chunk held here and no "
                             "width")
        self.chunks, self.rows, self.chunk_rows = chunks, rows, chunk_rows
        self.width = held[0].shape[1] if held else width
        self.L = held[0].shape[2] if held else None

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.rows, self.width, self.L)

    def real_rows(self, i: int) -> int:
        """Rows of chunk ``i`` that are not padding."""
        return min(self.chunk_rows, self.rows - i * self.chunk_rows)

    def row_block(self, r0: int, r1: int, device=None) -> torch.Tensor:
        """Rows ``[r0, r1)`` as one tensor, across chunk boundaries (on
        ``device``, where the chunks lie on several: a mesh's)."""
        parts, i = [], r0
        while i < r1:
            ci, off = divmod(i, self.chunk_rows)
            take = min(self.chunk_rows - off, r1 - i)
            part = self.chunks[ci][off:off + take]
            parts.append(part if device is None else part.to(device))
            i += take
        return parts[0] if len(parts) == 1 else torch.cat(parts)


class StreamedCodewords:
    """A logical ``(rows, n, L)`` canonical codeword matrix in row chunks:
    the coefficient rows ``coeffs`` (each zero-extended to n and
    transformed) and, under zk, the mask rows' coefficients ``tail`` (3,
    d2, L) below them.  In resident mode the codewords are held too,
    encoded once: ``canon``, a :class:`RowChunkedMatrix` of the chunks'
    canonical n-wide codewords (the last chunk its real rows only), and
    under zk ``tail_canon`` (3, n, L); in streaming mode (``canon`` None) a
    consumer re-encodes each part.  :meth:`parts` lists the parts in row
    order."""

    def __init__(self, coeffs: RowChunkedMatrix, n: int,
                 tail: torch.Tensor | None = None,
                 canon: RowChunkedMatrix | None = None,
                 tail_canon: torch.Tensor | None = None):
        if canon is not None and (
                (canon.rows, canon.chunk_rows) != (coeffs.rows,
                                                   coeffs.chunk_rows)
                or (tail is None) != (tail_canon is None)):
            raise ValueError("StreamedCodewords: the codewords are not "
                             "row-aligned with the coefficient rows")
        self.coeffs, self.n, self.tail = coeffs, n, tail
        self.canon, self.tail_canon = canon, tail_canon
        self.rows = coeffs.rows + (0 if tail is None else tail.shape[0])
        self.L = coeffs.L

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.rows, self.n, self.L)

    @property
    def resident(self) -> bool:
        """Whether the codewords are held (resident mode)."""
        return self.canon is not None

    def parts(self) -> list[tuple]:
        """``(coefficient block, real rows, codewords)`` in row order: every
        chunk of ``coeffs``, then the tail; ``codewords`` are the part's
        real rows' canonical codewords in resident mode, None in streaming
        mode."""
        held = (self.canon.chunks if self.resident
                else [None] * len(self.coeffs.chunks))
        out = [(c, self.coeffs.real_rows(i), h)
               for i, (c, h) in enumerate(zip(self.coeffs.chunks, held))]
        if self.tail is not None:
            out.append((self.tail, self.tail.shape[0], self.tail_canon))
        return out
