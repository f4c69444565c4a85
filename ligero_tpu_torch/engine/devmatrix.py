"""Row-chunked matrices on one device: the streaming mode's handles.

The counterpart of ``ligero_tpu/engine/devmatrix.py``.  In streaming mode
(``LigeroCircuit.encode_mode == "streaming"``, chosen where the direct
mode's live set does not fit the device) the n-wide codeword matrix U is
never held whole: only its coefficient rows (k/n of U's size) stay on the
device, as a :class:`RowChunkedMatrix`, and the consumers of U re-encode a
chunk at a time (:class:`StreamedCodewords`): the commit absorbs each
re-encoded chunk into per-column Blake2s states, the openings gather the
opened columns of each.  The r^T A coefficient rows of the linear phase are
a :class:`RowChunkedMatrix` too, row-aligned with the codeword chunks.
Over a mesh (``parallel.ShardedBackend``) the chunks of one matrix lie on
several devices: chunk i on mesh device i mod D, the block-cyclic layout of
the JAX package's ``ShardedCoeffs`` (over a process mesh, in rank i mod D's
process).

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
    the real rows.  Over a process mesh a chunk that another rank holds is
    None here (``width`` names the width where this rank holds none)."""

    def __init__(self, chunks: list, rows: int, chunk_rows: int,
                 width: int | None = None):
        held = [c for c in chunks if c is not None]
        if not chunks:
            raise ValueError("RowChunkedMatrix: no chunks")
        if len(chunks) != -(-rows // chunk_rows) or any(
                c.shape[0] != chunk_rows for c in held):
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
    """A logical ``(rows, n, L)`` canonical codeword matrix that is never
    materialised: the coefficient rows ``coeffs`` (each zero-extended to n
    and transformed) and, under zk, the mask rows' coefficients ``tail``
    (3, d2, L) below them.  :meth:`parts` lists what a consumer re-encodes,
    in row order."""

    def __init__(self, coeffs: RowChunkedMatrix, n: int,
                 tail: torch.Tensor | None = None):
        self.coeffs, self.n, self.tail = coeffs, n, tail
        self.rows = coeffs.rows + (0 if tail is None else tail.shape[0])
        self.L = coeffs.L

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.rows, self.n, self.L)

    def parts(self) -> list[tuple[torch.Tensor, int]]:
        """``(coefficient block, real rows)`` pairs in row order: every
        chunk of ``coeffs``, then the tail."""
        out = [(c, self.coeffs.real_rows(i))
               for i, c in enumerate(self.coeffs.chunks)]
        if self.tail is not None:
            out.append((self.tail, self.tail.shape[0]))
        return out
