"""Row-sharded execution over a mesh of devices: ``ShardedBackend``.

The port's counterpart of ``ligero_tpu/parallel/sharded_backend.py``.
``LigeroCircuit(circuit, outputs,
backend=ShardedBackend(field, RowMesh(devices)))`` distributes ``prove``,
``verify``, ``prove_batch`` and ``verify_batch`` over a 1-D mesh (the JAX
package's axis ``"rows"``) with no change to the protocol, and the proofs
are byte-identical to one device's.

Direct mode, where every device's estimate fits (:meth:`device_bytes`):

* **the encode, NTT, iNTT, NTT with the canonical epilogue and the zk
  blind**: row-sharded, no communication (transforms never cross rows);
* **the column commitment**: a row -> column re-shard (the all_to_all:
  device d receives columns [d c, (d + 1) c), c = ceil(n / D), of every
  row, from every device), after which each device hashes its whole
  columns, with Blake2s or the Poseidon sponge; the tree runs on the
  controller over the gathered leaves;
* **row combinations and the linear and quadratic products**: per-device
  partial sums, gathered on the controller and added mod p.  Mod-p addition
  is associative, so any grouping of the row sum gives the same field
  element and the same canonical limbs;
* **openings and the verifier's codewords at the opened columns**:
  per-device row blocks, concatenated in row order;
* **the sparse r^T A product and the ChaCha20 sampler**: on the controller
  (as in the JAX package, which inherits them from ``Backend``).

Streaming mode, where the direct estimate passes a device's memory and a
chunking fits (:meth:`stream_device_bytes`; a mesh never takes resident
mode, as in the JAX package): the coefficient rows in
chunks of c rows, chunk i on mesh device i mod D.  That is the block-cyclic
layout of the JAX package's ``ShardedCoeffs`` (``_to_cyclic``: global row g
on device (g mod c D) // c), and it is what makes every step of c D rows
keep all D devices at work.  ``TorchBackend``'s streaming methods run each
chunk where it lies: the encode and the zk blind (the blinding draws taken
on the controller in row order), the commit (each re-encoded chunk
re-sharded row -> column as it comes, every device absorbing its column
block into its own columns' Blake2s states with the streamed kernel entry,
rows in global order; the tree on the controller), the openings and the
verifier's r_i codewords at the opened columns (a chunk at a time, the
opened columns gathered on the controller), the linear product (the r^T A
chunks placed beside the coefficient chunks they pair with) and the
quadratic product (each block's y and z rows copied to its x rows'
device); partial sums are added mod p on the controller.  The Poseidon
commitment does not run in streaming mode over a mesh, as in the JAX
package (its ``PoseidonColumns`` reads one device's chunks): the mode
choice refuses it with ``ValueError`` before any launch.

Batches: B proofs of one circuit go as one :class:`ShardedRows` of batch
B, each block holding every proof's rows of the block, so that a bulk step
runs once a device for all of them (the JAX package's ``ntt_and_canon``,
``commit_columns_batch`` and ``gather_columns_batch`` on its mesh).

Over a :class:`RowMesh` the controller is one process that issues every
device's work and the copies between devices itself: the one-process model
of the JAX package's ``shard_map``.  A device may repeat in the mesh
(``["cpu"] * D`` in the tests, ``["cuda:0"] * D`` on a host with one card):
its shards then share its memory, and the estimates add up what they hold.
Rows that do not divide D are zero-padded: zero rows are exact under the
NTT and add zero to every sum.

Over a :class:`ProcessRowMesh` (``parallel.multihost.global_row_mesh``: one
device a process, joined by ``torch.distributed``) every rank runs the same
``prove`` / ``verify`` on the same inputs (SPMD: the host transcript, the
sampler and the sparse product are replicated, as on the JAX package's
multi-process mesh) and holds only block ``rank`` of a row-sharded matrix
(the other blocks are ``None``) and, in streaming mode, the chunks i with
i mod D = rank.  Each controller transfer becomes a collective of the
mesh's :class:`~.collectives.Collectives`: the re-shard an all_to_all, the
gathers of rows, columns, digests and partial sums an all_gather (partial
sums then added mod p in rank order on every rank), the quadratic
product's x, y and z rows an all_to_all of the rows each rank needs.
Results the protocol reads are replicated on every rank, so every rank
makes the same proof bytes, those of one device.  The estimates are per
rank.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from ..engine import (cuda_hash, cuda_lc, cuda_ntt, cuda_tree, fieldops,
                      hashops)
from ..engine.backend import (ESTIMATE_MARGIN, STREAM_MAX_CHUNK_ROWS,
                              TorchBackend, resolve_device)
from ..engine.devmatrix import RowChunkedMatrix, StreamedCodewords
from ..engine.hashops import STATE_WORDS
from ..fields import FieldSpec
from .collectives import Collectives

#: why :meth:`ShardedBackend.encode_mode` refuses the Poseidon commitment
#: past direct mode
POSEIDON_STREAMING = (
    "the Poseidon commitment does not run in streaming mode over a mesh "
    "(nor in the JAX package, whose PoseidonColumns reads the chunks of one "
    "device's matrix): this instance does not fit the mesh in direct mode; "
    "prove it on one device (streaming mode), or over more devices")


class RowMesh:
    """A 1-D mesh of torch devices (the JAX package's ``Mesh`` with one
    axis ``"rows"``), driven by one controller: ``devices[0]``.  A device
    may repeat; all are CPUs or all CUDA devices."""

    #: the collectives between processes (:class:`ProcessRowMesh`); None:
    #: one process drives every device of the mesh
    comm: Collectives | None = None

    def __init__(self, devices):
        self.devices = [resolve_device(d) for d in devices]
        if not self.devices:
            raise ValueError("RowMesh: no devices")
        if len({d.type for d in self.devices}) != 1:
            raise ValueError("RowMesh: mixes CPU and CUDA devices")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def physical(self) -> list[torch.device]:
        """The distinct devices, in mesh order."""
        return list(dict.fromkeys(self.devices))

    def holds(self, d: int) -> bool:
        """Whether this process holds mesh position ``d``'s blocks."""
        return True

    def __repr__(self) -> str:
        return f"RowMesh({[str(d) for d in self.devices]})"


class ProcessRowMesh(RowMesh):
    """A 1-D mesh of one device a process: position d is rank d of the
    process group behind ``comm`` (a :class:`~.collectives.Collectives`),
    and this process holds position ``comm.rank`` only, on ``device``.
    ``devices`` lists ``device`` at every position: this process's view of
    where each block it could hold would lie.  Made by
    ``parallel.multihost.global_row_mesh``."""

    def __init__(self, device, comm: Collectives):
        super().__init__([device] * comm.size)
        self.comm, self.rank = comm, comm.rank
        if comm.device != self.devices[0]:
            raise ValueError(f"ProcessRowMesh: device {self.devices[0]}, "
                             f"collectives on {comm.device}")

    def holds(self, d: int) -> bool:
        return d == self.rank

    def __repr__(self) -> str:
        return (f"ProcessRowMesh(rank {self.rank} of {self.size} on "
                f"{self.devices[0]}, {self.comm.backend})")


class ShardedRows:
    """A logical (rows, w, L) matrix, or ``batch`` of them stacked, in row
    blocks over a mesh: block d, on mesh device d, holds the next
    ``real[d]`` rows of each matrix, then zero rows, matrix after matrix
    (matrix b's part of the block at rows [b h, (b + 1) h) for a block of
    ``batch`` h rows); over a :class:`ProcessRowMesh` the blocks of the
    other ranks are None.  Only the backend opens it; the protocol layer
    passes it on."""

    def __init__(self, blocks: list, real: list[int], batch: int = 1):
        held = [b for b in blocks if b is not None]
        if len(blocks) != len(real) or not held or any(
                b.shape[0] % batch or not 0 <= r <= b.shape[0] // batch
                for b, r in zip(blocks, real) if b is not None):
            raise ValueError("ShardedRows: real row counts do not fit the "
                             "blocks")
        self.blocks, self.real, self.batch = blocks, list(real), batch
        self.starts = [int(v) for v in np.cumsum([0] + self.real[:-1])]
        self.rows = sum(self.real)
        self.width, self.L = held[0].shape[1], held[0].shape[2]

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.batch * self.rows, self.width, self.L)

    def part(self, d: int, b: int = 0) -> torch.Tensor | None:
        """Matrix ``b``'s rows of block ``d`` (real rows, then zeros);
        None where another process holds the block."""
        if self.blocks[d] is None:
            return None
        h = self.blocks[d].shape[0] // self.batch
        return self.blocks[d][b * h:(b + 1) * h]

    def proof(self, b: int) -> "ShardedRows":
        """Matrix ``b`` alone (views of the blocks)."""
        return ShardedRows([self.part(d, b) for d in range(len(self.blocks))],
                           self.real)


def on_device(device: torch.device):
    """Make ``device`` current for the kernels' launches, which go to the
    current CUDA device."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class ShardedBackend(TorchBackend):
    """A :class:`TorchBackend` whose bulk steps run per row block (direct
    mode) or per chunk (streaming mode) over ``mesh`` (a :class:`RowMesh`,
    a :class:`ProcessRowMesh` or a list of devices); the controller,
    ``mesh.devices[0]``, keeps the sampler, the sparse product, the trees
    and everything small (over a process mesh every rank is its own
    controller, on its own device)."""

    #: resident mode runs on one device only, as in the JAX package (its
    #: mesh sets ``resident_u_ok = False``): past direct mode a mesh streams
    RESIDENT = False

    def __init__(self, field: FieldSpec, mesh):
        mesh = mesh if isinstance(mesh, RowMesh) else RowMesh(mesh)
        super().__init__(field, mesh.devices[0])
        self.mesh, self.D, self.comm = mesh, mesh.size, mesh.comm
        # one single-device backend a physical device: the bulk steps of a
        # block or chunk run through the one that holds it
        self._backends = {dev: TorchBackend(field, dev)
                          for dev in mesh.physical}

    def _be(self, device: torch.device) -> TorchBackend:
        return self._backends[device]

    # ------------------------------------------------------------------
    # where the parts of a matrix lie (TorchBackend's placement hooks)
    # ------------------------------------------------------------------
    def _chunk_device(self, i: int) -> torch.device:
        """Chunk i of a streaming matrix lies on mesh device i mod D."""
        return self.mesh.devices[i % self.D]

    def holds_chunk(self, i: int) -> bool:
        return self.mesh.holds(i % self.D)

    @contextlib.contextmanager
    def _on(self, device):
        with on_device(device):
            yield self._be(device)

    def _column_split(self, n: int) -> list[tuple[torch.device, int, int]]:
        """Device d hashes columns [d c, (d + 1) c), c = ceil(n / D)."""
        c = -(-n // self.D)
        return [(dev, d * c, min(n, (d + 1) * c))
                for d, dev in enumerate(self.mesh.devices) if d * c < n]

    # ------------------------------------------------------------------
    # layout (direct mode)
    # ------------------------------------------------------------------
    def _split(self, rows: int) -> tuple[int, list[int]]:
        """Block height and real rows of each block for ``rows`` rows."""
        h = max(1, -(-rows // self.D))
        return h, [max(0, min(h, rows - d * h)) for d in range(self.D)]

    def _pad(self, blk: torch.Tensor, h: int) -> torch.Tensor:
        if blk.shape[0] == h:
            return blk
        return torch.cat([blk, blk.new_zeros((h - blk.shape[0],)
                                             + tuple(blk.shape[1:]))])

    def row_matrix(self, a) -> ShardedRows:
        """A (rows, w, L) tensor (any device) or host limb array -> row
        blocks, block d copied to mesh device d (host rows cross as they
        are, 16-bit limbs widened on the device); over a process mesh this
        rank's block only, with no communication."""
        h, real = self._split(a.shape[0])
        blocks = []
        for d, dev in enumerate(self.mesh.devices):
            if not self.mesh.holds(d):
                blocks.append(None)
                continue
            r0, r1 = d * h, d * h + real[d]
            blk = (a[r0:r1].to(device=dev, dtype=torch.int32)
                   if isinstance(a, torch.Tensor)
                   else self._be(dev)._rows_up(a, r0, r1))
            blocks.append(self._pad(blk, h))
        return ShardedRows(blocks, real)

    def _mine(self, sr: ShardedRows, rows: int, fn=None) -> torch.Tensor:
        """This rank's real rows of each matrix of ``sr`` (through ``fn``,
        which keeps rows), zero rows below them: (batch, rows, ...)."""
        d = self.mesh.rank
        parts = [sr.part(d, b)[:sr.real[d]] for b in range(sr.batch)]
        if fn is not None:
            parts = [fn(b, p) for b, p in enumerate(parts)]
        out = parts[0].new_zeros((sr.batch, rows) + tuple(parts[0].shape[1:]))
        for b, p in enumerate(parts):
            out[b, :p.shape[0]] = p
        return out

    def _gather_real(self, sr: ShardedRows, fn=None) -> torch.Tensor:
        """Over a process mesh: every rank's real rows of each matrix
        (through ``fn``), gathered on every rank -> (batch, rows, ...) in
        row order."""
        got = self.comm.all_gather(self._mine(sr, max(sr.real), fn))
        return torch.cat([g[:, :real] for g, real in zip(got, sr.real)],
                         dim=1)

    def gather_rows(self, sr: ShardedRows) -> torch.Tensor:
        """The logical matrix (of a batch: the matrices stacked) as one
        tensor on the controller (over a process mesh: on every rank)."""
        if self.comm is not None:
            return self._gather_real(sr).reshape(-1, sr.width, sr.L)
        return torch.cat([sr.part(d, b)[:real].to(self.device)
                          for b in range(sr.batch)
                          for d, real in enumerate(sr.real)])

    def _map(self, sr: ShardedRows, fn) -> ShardedRows:
        """``fn(local backend, block)`` on each block held here, on its
        device."""
        out = []
        for blk in sr.blocks:
            if blk is None:
                out.append(None)
                continue
            with on_device(blk.device):
                out.append(fn(self._be(blk.device), blk))
        return ShardedRows(out, sr.real, sr.batch)

    def _row_range(self, sr: ShardedRows, r0: int, r1: int,
                   device: torch.device) -> torch.Tensor:
        """Logical rows [r0, r1) of ``sr`` on ``device``, copied from the
        blocks that hold them."""
        parts = []
        for blk, start, real in zip(sr.blocks, sr.starts, sr.real):
            a, b = max(r0, start), min(r1, start + real)
            if a < b:
                parts.append(blk[a - start:b - start].to(device))
        return parts[0] if len(parts) == 1 else torch.cat(parts)

    def _fetch_rows(self, pieces, wants, width: int) -> torch.Tensor | None:
        """Over a process mesh, one all_to_all: rank e receives the
        logical rows of its ranges ``wants[e]`` (a list of ``(r0, r1)``,
        the same list on every rank), in range order, one tensor; None
        where it wants none.  ``pieces``: ``(first row, real rows, tensor
        or None, owner rank)`` in row order, the rows (``width`` wide) of a
        matrix wherever they lie."""
        me, D = self.mesh.rank, self.D

        def cuts(ranges, owner):
            for r0, r1 in ranges:
                for start, real, t, o in pieces:
                    a, b = max(r0, start), min(r1, start + real)
                    if o == owner and a < b:
                        yield t, a - start, b - start

        tail = (width, self.L)
        send = []
        for e in range(D):
            got = [t[a:b] for t, a, b in cuts(wants[e], me)]
            send.append(torch.cat(got) if got else torch.empty(
                (0,) + tail, dtype=torch.int32, device=self.device))
        shapes = [(sum(b - a for _, a, b in cuts(wants[me], o)),) + tail
                  for o in range(D)]
        recv = self.comm.all_to_all(send, shapes)
        del send
        out, offs = [], [0] * D
        for r0, r1 in wants[me]:
            for start, real, _, o in pieces:
                a, b = max(r0, start), min(r1, start + real)
                if a < b:
                    out.append(recv[o][offs[o]:offs[o] + b - a])
                    offs[o] += b - a
        return torch.cat(out) if out else None

    def _reduce(self, parts: dict, keys, shape) -> torch.Tensor:
        """Partial sums keyed by the block (or rank) that made them, the
        ``keys``' added mod p in key order on the controller.  Over a
        process mesh each rank holds its own (under its rank, or none:
        zeros of ``shape`` stand in, left out of the sum) and every rank
        gathers all of them."""
        if self.comm is None:
            seq = [parts[d] for d in keys]
        else:
            mine = parts.get(self.mesh.rank)
            if mine is None:
                mine = torch.zeros(shape, dtype=torch.int32,
                                   device=self.device)
            got = self.comm.all_gather(mine.to(self.device))
            seq = [got[d] for d in keys]
        total = None
        for part in seq:
            part = part.to(self.device)
            total = part if total is None else fieldops.add(self.field, total,
                                                            part)
        return total

    def _combine_ranks(self, total, count: int, shape):
        if self.comm is None:
            return total
        return self._reduce({} if total is None else {self.mesh.rank: total},
                            range(min(count, self.D)), shape)

    def _join_chunks(self, parts: dict, rcm: RowChunkedMatrix, inner: tuple,
                     device) -> torch.Tensor:
        if self.comm is None:
            return super()._join_chunks(parts, rcm, inner, device)
        count, D = len(rcm.chunks), self.D
        mine = torch.zeros((-(-count // D), rcm.chunk_rows) + tuple(inner),
                           dtype=torch.int32, device=self.device)
        for i, t in parts.items():
            mine[i // D, :t.shape[0]] = t
        got = self.comm.all_gather(mine)
        del mine
        return torch.cat([got[i % D][i // D, :rcm.real_rows(i)]
                          for i in range(count)]).to(device)

    def _join_columns(self, parts: list, n: int, dim: int) -> torch.Tensor:
        """Over a process mesh: this rank's digests of its column block
        (``parts``, one tensor, columns along ``dim``) -> every column's,
        in column order, on every rank."""
        split = self._column_split(n)
        if len(split) < self.D:
            raise ValueError(f"a process mesh of {self.D} ranks hashes "
                             f"{n} columns in fewer than {self.D} blocks")
        c = split[0][2] - split[0][1]
        mine = parts[0].to(self.device)
        if mine.shape[dim] < c:
            pad = list(mine.shape)
            pad[dim] = c - mine.shape[dim]
            mine = torch.cat([mine, mine.new_zeros(pad)], dim=dim)
        got = self.comm.all_gather(mine)
        return torch.cat([g.narrow(dim, 0, c1 - c0)
                          for g, (_, c0, c1) in zip(got, split)], dim=dim)

    def column_blocks(self, u_canon, batch: int = 1):
        """The row -> column re-shard of a :class:`ShardedRows` of
        ``batch`` matrices: device d gets columns [d c, (d + 1) c) of every
        real row from every block, as a (batch, rows, c, L) tensor; one
        destination at a time, so that a device holds one column block
        beside its rows (over a process mesh one all_to_all, and this
        rank's block only).  A tensor (the verifier's opened columns) is
        one block on the controller."""
        if not isinstance(u_canon, ShardedRows):
            yield from super().column_blocks(u_canon, batch)
            return
        if batch != u_canon.batch:
            raise ValueError(f"column_blocks: {u_canon.batch} matrices, "
                             f"not {batch}")
        split = self._column_split(u_canon.width)
        if self.comm is not None:
            me, w, L = self.mesh.rank, u_canon.width, self.L
            cols = [(c0, c1) for _, c0, c1 in split]
            cols += [(w, w)] * (self.D - len(cols))
            mine = u_canon.blocks[me].reshape(batch, -1, w, L)[
                :, :u_canon.real[me]]
            c0, c1 = cols[me]
            recv = self.comm.all_to_all(
                [mine[:, :, a:b] for a, b in cols],
                [(batch, real, c1 - c0, L) for real in u_canon.real])
            if c1 > c0:
                yield recv[0] if self.D == 1 else torch.cat(recv, dim=1)
            return
        for dev, c0, c1 in split:
            with on_device(dev):
                out = torch.empty((batch, u_canon.rows, c1 - c0, self.L),
                                  dtype=torch.int32, device=dev)
                for b in range(batch):
                    for d, (start, real) in enumerate(zip(u_canon.starts,
                                                          u_canon.real)):
                        out[b, start:start + real] = u_canon.part(d, b)[
                            :real, c0:c1]
                yield out

    def column_digests(self, u_canon, batch: int, digest) -> torch.Tensor:
        if self.comm is None or not isinstance(u_canon, ShardedRows):
            return super().column_digests(u_canon, batch, digest)
        parts = [digest(block) for block in self.column_blocks(u_canon,
                                                                batch)]
        return self._join_columns(parts, u_canon.width, 1)

    # ------------------------------------------------------------------
    # memory (per physical device; over a process mesh, this rank's)
    # ------------------------------------------------------------------
    def memory_budget(self) -> int:
        budget = min(be.memory_budget() for be in self._backends.values())
        return budget if self.comm is None else self.comm.min_int(budget)

    def _shard_heights(self, owners, heights, rank=None) -> dict:
        """``{str(physical device): [heights of the parts it holds]}``,
        part i at mesh position ``owners[i]`` (over a process mesh, the
        parts of ``rank``, by default this one)."""
        holds = self.mesh.holds if rank is None else rank.__eq__
        out = {str(dev): [] for dev in self.mesh.physical}
        for d, h in zip(owners, heights):
            if holds(d):
                out[str(self.mesh.devices[d])].append(h)
        return out

    def _ranks(self) -> list:
        """The ranks whose estimates a mode decision takes the largest of:
        every rank's over a process mesh (each rank computes them all
        alike, so all choose one mode and chunking), else this process's."""
        return [None] if self.comm is None else list(range(self.D))

    def device_bytes(self, rows: int, k: int, n: int, nnz: int,
                     blind_t: int = 0, d2: int | None = None,
                     verifier: bool = False, batch: int = 1,
                     rank: int | None = None) -> dict:
        """Estimate of the largest live set on each physical device (keyed
        by ``str(device)``) in direct mode, for ``batch`` proofs
        (``verifier``: verifies) of ``rows`` committed rows.  What the
        shards of a device hold is summed, but their transients are counted
        once, the largest shard's: the controller runs the shards of a
        repeated device one after another.  Per phase, as
        :meth:`TorchBackend.direct_bytes` counts one device's:

        * the encode: each shard's message, coefficient and codeword
          matrices (and zk row matrix), one shard's NTT scratch;
        * the commit: each shard's codeword and coefficient matrices (and
          without zk its message rows, which the interleaved combination
          takes later; under zk the message and row matrices are freed
          by then) and the re-shard's column block (batch x rows x c
          elements) with the one before it, not yet freed;
        * the later phases: each shard's codewords and coefficients, and
          beside them either every shard's r^T A coefficient rows with one
          shard's products on the d2 domain, or on the controller one
          proof's linear transients over all 4m k entries (the sampler,
          the sparse product and its fold) with the r^T A rows before they
          are sharded;
        * the verifier: each proof's r^T A coefficient blocks, beside one
          block's n-point transform or, on the controller, the linear
          transients and the r^T A rows.

        A's COO (between proofs) on the controller.  Over a process mesh
        every rank is a controller and holds its own block: the estimate
        is ``rank``'s (by default this process's)."""
        E = self.L * 4
        data = rows - 3 if blind_t else rows
        h = self._split(data)[0]
        heights = [h] * self.D
        if blind_t:
            heights[-1] += 3
        scratch = functools.partial(cuda_ntt.scratch_bytes, self.field)
        linear = self._linear_transients(data, k, nnz) + data * k * E
        coo = nnz * (E + 16)
        out = {}
        for key, hs in self._shard_heights(range(self.D), heights,
                                           rank).items():
            ctrl = key == str(self.device)
            if verifier:
                need = batch * sum(s * k * E for s in hs) + max(
                    max((s * n * E + scratch(s, k, n) for s in hs),
                        default=0), linear if ctrl else 0)
            else:
                phases = [self._direct_phases(s, k, n, blind_t, d2, batch)
                          for s in hs]
                enc = sum(p[0] for p in phases)
                commit = sum(p[4] for p in phases) + (
                    2 * batch * rows * -(-n // self.D) * E)
                later = sum(p[2] for p in phases) + max(
                    sum(s * k * E for s in hs) + max(p[3] for p in phases),
                    linear if ctrl else 0)
                need = max(enc + max(p[1] for p in phases), commit, later)
            out[key] = int((need + (coo if ctrl else 0)) * ESTIMATE_MARGIN)
        return out

    def direct_bytes(self, rows: int, k: int, n: int, nnz: int,
                     blind_t: int = 0, d2: int | None = None,
                     batch: int = 1) -> int:
        """The largest of :meth:`device_bytes` over the physical devices
        (over a process mesh, over the ranks)."""
        return max(max(self.device_bytes(rows, k, n, nnz, blind_t, d2,
                                         batch=batch, rank=q).values())
                   for q in self._ranks())

    def verify_bytes(self, rows: int, k: int, n: int, nnz: int,
                     batch: int = 1) -> int:
        return max(max(self.device_bytes(rows, k, n, nnz, verifier=True,
                                         batch=batch, rank=q).values())
                   for q in self._ranks())

    def stream_device_bytes(self, rows: int, k: int, n: int, nnz: int,
                            blind_t: int = 0, d2: int | None = None,
                            chunk_rows: int = STREAM_MAX_CHUNK_ROWS,
                            verifier: bool = False, batch: int = 1,
                            rank: int | None = None) -> dict:
        """Estimate of the largest live set on each physical device in
        streaming mode, chunks of ``chunk_rows`` rows dealt over the mesh
        (chunk i on device i mod D): the pieces of
        :meth:`TorchBackend.streaming_bytes` (``_stream_parts``) with the
        chunks a device holds in place of all of them.  The prover: the
        device's coefficient chunks beside the largest of a chunk's encode,
        its re-encode (with one column slice of the re-shard and the
        device's column states; over a process mesh the re-encoded chunk's
        send buffer and the D slices received), the device's r^T A chunks
        with a chunk pair on the d2 domain, or a block of the quadratic
        product; on the controller also A's COO, the zk mask rows, A's
        upload and the linear phase's challenge vector with a sampler
        segment or a sparse block.  The verifier (``batch`` proofs): each
        proof's r^T A chunks on the device, beside a chunk's n-point
        transform or, on the controller, the upload and the linear phase.
        Over a process mesh the estimate is ``rank``'s (by default this
        process's)."""
        d2 = 2 * k if d2 is None else d2
        b = 0 if verifier else blind_t
        p = self._stream_parts(rows, k, n, nnz, b, d2, chunk_rows)
        E, cr = self.L * 4, chunk_rows
        data = rows - 3 if b else rows
        count = -(-data // cr)
        held = self._shard_heights([i % self.D for i in range(count)],
                                   [cr] * count, rank)
        holds = self.mesh.holds if rank is None else rank.__eq__
        cn = -(-n // self.D)
        reshard = cr * cn * E if self.comm is None else 2 * cr * n * E
        out = {}
        for key, hs in held.items():
            ctrl = key == str(self.device)
            share = sum(hs)
            r_coeffs = share * k * E
            if verifier:
                linear = max(p["upload"], p["r"] + max(p["sampler"],
                                                       p["block"]))
                need = batch * r_coeffs + max(p["reencode"],
                                              linear if ctrl else 0)
            else:
                states = sum(1 for d, (dev, _, _) in
                             enumerate(self._column_split(n))
                             if holds(d) and str(dev) == key
                             ) * cn * STATE_WORDS * 4
                linear = max(p["upload"], p["r"] + max(
                    p["sampler"], r_coeffs + p["block"]))
                need = share * (k + b) * E + max(
                    p["encode"], p["reencode"] + reshard + states,
                    r_coeffs + p["pair"], p["quad"], linear if ctrl else 0)
                if ctrl and b:
                    need += 3 * d2 * E              # the zk mask rows
            out[key] = int((need + (p["coo"] if ctrl else 0))
                           * ESTIMATE_MARGIN)
        return out

    def streaming_bytes(self, rows: int, k: int, n: int, nnz: int,
                        blind_t: int = 0, d2: int | None = None,
                        chunk_rows: int = STREAM_MAX_CHUNK_ROWS,
                        poseidon: bool = False) -> int:
        """The largest of :meth:`stream_device_bytes` over the physical
        devices.  ``poseidon`` raises ``ValueError``: the Poseidon commitment
        has no streaming mode over the mesh, so :meth:`encode_mode` refuses
        it past direct mode, before any launch."""
        if poseidon:
            raise ValueError(POSEIDON_STREAMING)
        return max(max(self.stream_device_bytes(
            rows, k, n, nnz, blind_t, d2, chunk_rows, rank=q).values())
            for q in self._ranks())

    def streaming_verify_bytes(self, rows: int, k: int, n: int, nnz: int,
                               chunk_rows: int, batch: int = 1) -> int:
        return max(max(self.stream_device_bytes(
            rows, k, n, nnz, chunk_rows=chunk_rows, verifier=True,
            batch=batch, rank=q).values()) for q in self._ranks())

    # ------------------------------------------------------------------
    # the committed matrices (direct mode, B proofs)
    # ------------------------------------------------------------------
    def upload_messages(self, preenc: list) -> ShardedRows:
        """B host (4m, k, L) message matrices -> one :class:`ShardedRows`
        of batch B."""
        h, real = self._split(preenc[0].shape[0])
        blocks = []
        for d, dev in enumerate(self.mesh.devices):
            if not self.mesh.holds(d):
                blocks.append(None)
                continue
            be, r0 = self._be(dev), d * h
            parts = [self._pad(be._rows_up(a, r0, r0 + real[d]), h)
                     for a in preenc]
            blocks.append(parts[0] if len(parts) == 1 else torch.cat(parts))
        return ShardedRows(blocks, real, len(preenc))

    def rs_encode_batch(self, msgs: ShardedRows, k: int, n: int):
        """:meth:`upload_messages`'s batch -> ``([coeffs of each proof],
        canonical codewords of all)``: one iNTT_k and one NTT_n a device
        for the batch."""
        coeffs = self._map(msgs, lambda be, b: be.intt(b, k))
        return ([coeffs.proof(b) for b in range(coeffs.batch)],
                self.ntt_and_canon(coeffs, n))

    def zk_blind_batch(self, msgs: ShardedRows, rows_seeds: list,
                       blind_t: int, d2: int, mask3s: list):
        """:meth:`TorchBackend.zk_blind_rows` on each block of each proof:
        its message rows' iNTT_k and their s draws (taken on the controller
        from the proof's one ``rows_seed`` stream, in row order, and sent
        to the block's device) -> ``([coeffs (4m, k + b) of each proof],
        committed rows (4m + 3, d2) of all)``, each proof's three mask rows
        after its last block's data rows."""
        b, L, B, last = blind_t, self.L, msgs.batch, self.D - 1
        rows = [None if blk is None else torch.zeros(
            (B * (msgs.part(d).shape[0] + 3 * (d == last)), d2, L),
            dtype=torch.int32, device=blk.device)
            for d, blk in enumerate(msgs.blocks)]
        coeffs = []
        for p in range(B):
            s_all = self.rand_field_mont(msgs.rows * b, rows_seeds[p]).reshape(
                msgs.rows, b, L)
            mine = []
            for d, (start, real) in enumerate(zip(msgs.starts, msgs.real)):
                blk = msgs.part(d, p)
                if blk is None:
                    mine.append(None)
                    continue
                dev, h, k = blk.device, blk.shape[0], blk.shape[1]
                be = self._be(dev)
                with on_device(dev):
                    s = blk.new_zeros((h, b, L))
                    s[:real] = s_all[start:start + real].to(dev)
                    c = torch.cat([be.intt(blk, k), s], dim=1)
                    # the regions [0, b) and [k, k + b) overlap when b > k
                    c[:, :b] = be.sub(c[:, :b], s)
                    del s
                    hd = h + 3 * (d == last)
                    r = rows[d][p * hd:(p + 1) * hd]
                    r[:real, :k + b] = c[:real]
                    if d == last:
                        r[real:real + 3] = be.asarray(mask3s[p])
                mine.append(c)
            del s_all
            coeffs.append(ShardedRows(mine, msgs.real))
        real = list(msgs.real)
        real[-1] += 3
        return coeffs, ShardedRows(rows, real, B)

    # ------------------------------------------------------------------
    # transforms
    # ------------------------------------------------------------------
    def ntt(self, coeffs, n: int):
        if isinstance(coeffs, ShardedRows):
            return self._map(coeffs, lambda be, b: be.ntt(b, n))
        return super().ntt(coeffs, n)

    def intt(self, evals, n: int):
        if isinstance(evals, ShardedRows):
            return self._map(evals, lambda be, b: be.intt(b, n))
        return super().intt(evals, n)

    def ntt_and_canon(self, coeffs, n: int):
        if isinstance(coeffs, ShardedRows):
            return self._map(coeffs, lambda be, b: be.ntt_and_canon(b, n))
        return super().ntt_and_canon(coeffs, n)

    def ntt_columns(self, coeffs, n: int, js) -> torch.Tensor:
        """Each block's n-point NTTs at the columns ``js``, its real rows
        gathered on the controller in row order (a chunked matrix: a chunk
        at a time where it lies)."""
        if not isinstance(coeffs, ShardedRows):
            return super().ntt_columns(coeffs, n, js)
        js = torch.from_numpy(np.asarray(js, dtype=np.int64))
        return self.gather_rows(self._map(coeffs, lambda be, b: be.ntt(
            b, n).index_select(1, js.to(b.device))))

    # ------------------------------------------------------------------
    # openings
    # ------------------------------------------------------------------
    def gather_columns_batch(self, u_canon, idx) -> np.ndarray:
        """Per proof b, the columns ``idx[b]`` of each block's real rows,
        in row order -> (B, rows, t, L) host uint32."""
        if not isinstance(u_canon, ShardedRows):
            return super().gather_columns_batch(u_canon, idx)
        idx = torch.from_numpy(np.asarray(idx, dtype=np.int64))
        if self.comm is not None:
            return self.to_numpy(self._gather_real(
                u_canon, lambda b, rows: rows.index_select(
                    1, idx[b].to(rows.device))))
        return np.stack([np.concatenate([
            self.to_numpy(u_canon.part(d, b)[:real].index_select(
                1, idx[b].to(u_canon.blocks[d].device)))
            for d, real in enumerate(u_canon.real)])
            for b in range(idx.shape[0])])

    # ------------------------------------------------------------------
    # partial sums
    # ------------------------------------------------------------------
    def row_combine(self, r, mat):
        """sum_i r_i M_i: each block's rows against its slice of ``r``
        (sent to its device), the partials added on the controller."""
        if not isinstance(mat, ShardedRows):
            return super().row_combine(r, mat)
        r = self.asarray(r)
        parts = {}
        for d, (blk, start, real) in enumerate(zip(mat.blocks, mat.starts,
                                                   mat.real)):
            if real and blk is not None:
                with on_device(blk.device):
                    parts[d] = self._be(blk.device).row_combine(
                        r[start:start + real].to(blk.device), blk[:real])
        return self._reduce(parts, [d for d, real in enumerate(mat.real)
                                    if real], (mat.width, self.L))

    def row_combine_batch(self, r, mats):
        """Per-proof combinations: a :class:`ShardedRows` of batch B (one
        launch a block for all B, each proof's slice of ``r`` sent to the
        block's device), a list of one proof's blocks each, or a chunked
        handle (streaming)."""
        if isinstance(mats, (list, tuple)):
            return torch.stack([self.row_combine(r[b], mat)
                                for b, mat in enumerate(mats)])
        if not isinstance(mats, ShardedRows):
            return super().row_combine_batch(r, mats)
        r, B = self.asarray(r), mats.batch
        parts = {}
        for d, (blk, start, real) in enumerate(zip(mats.blocks, mats.starts,
                                                   mats.real)):
            if real and blk is not None:
                h = blk.shape[0] // B
                with on_device(blk.device):
                    rb = blk.new_zeros((B, h, self.L))
                    rb[:, :real] = r[:, start:start + real].to(blk.device)
                    parts[d] = cuda_lc.row_combine_batch(
                        self.field, rb, blk.reshape(B, h, *blk.shape[1:]))
        return self._reduce(parts, [d for d, real in enumerate(mats.real)
                                    if real], (B, mats.width, self.L))

    def linear_combination_poly(self, u_coeffs, r_coeffs, d2: int):
        """Each device's two blocks on the d2 domain and their row
        combination; the partials added on the controller, one iNTT
        there (chunked matrices: a chunk pair at a time where it lies)."""
        if not isinstance(u_coeffs, ShardedRows):
            return super().linear_combination_poly(u_coeffs, r_coeffs, d2)
        if (not isinstance(r_coeffs, ShardedRows)
                or r_coeffs.real != u_coeffs.real):
            raise ValueError("linear_combination_poly: u and r blocks are "
                             "not row-aligned")
        parts = {}
        for d, (ub, rb) in enumerate(zip(u_coeffs.blocks, r_coeffs.blocks)):
            if ub is None:
                continue
            with on_device(ub.device):
                be = self._be(ub.device)
                eu, er = be.ntt(ub, d2), be.ntt(rb, d2)
                parts[d] = cuda_lc.row_combine(self.field, er, eu)
                del eu, er
        return self.intt(self._reduce(parts, range(self.D),
                                      (d2, self.L))[None], d2)[0]

    def quadratic_combination_poly(self, xyz_coeffs, r_quad, d2: int,
                                   m: int | None = None):
        """The x, y and z rows are m rows apart, so no row block holds a
        row's three: device d gathers rows [d c, (d + 1) c) of each region
        (c = ceil(m / D); copies from the blocks that hold them, over a
        process mesh an all_to_all), takes their products on the d2 domain
        and its partial sum; the partials are added on the controller, one
        iNTT there (a chunked matrix: in blocks where the x rows lie)."""
        if isinstance(xyz_coeffs, RowChunkedMatrix) and self.comm is not None:
            return self._quadratic_chunks(xyz_coeffs, r_quad, d2, m)
        if not isinstance(xyz_coeffs, ShardedRows):
            return super().quadratic_combination_poly(xyz_coeffs, r_quad,
                                                      d2, m)
        m = xyz_coeffs.rows // 3 if m is None else m
        r_quad = self.asarray(r_quad)
        c = -(-m // self.D)
        spans = [(d * c, min(m, (d + 1) * c)) for d in range(self.D)]
        keys = [d for d, (i0, i1) in enumerate(spans) if i0 < i1]
        if self.comm is not None:
            me = self.mesh.rank
            pieces = [(start, real, blk, d) for d, (blk, start, real) in
                      enumerate(zip(xyz_coeffs.blocks, xyz_coeffs.starts,
                                    xyz_coeffs.real))]
            rows = self._fetch_rows(pieces, [
                [(base + i0, base + i1) for base in (0, m, 2 * m)]
                if i0 < i1 else [] for i0, i1 in spans], xyz_coeffs.width)
            parts = {}
            if rows is not None:
                i0, i1 = spans[me]
                parts[me] = self._quadratic_part(rows, i1 - i0,
                                                 r_quad[i0:i1], d2)
            return self.intt(self._reduce(parts, keys, (d2, self.L))[None],
                             d2)[0]
        parts = {}
        for d in keys:
            i0, i1 = spans[d]
            dev = self.mesh.devices[d]
            with on_device(dev):
                be = self._be(dev)
                ex, ey, ez = (be.ntt(self._row_range(
                    xyz_coeffs, base + i0, base + i1, dev), d2)
                    for base in (0, m, 2 * m))
                term = be.sub(be.mont_mul(ex, ey), ez)
                del ex, ey, ez
                parts[d] = be.row_combine(r_quad[i0:i1].to(dev), term)
                del term
        return self.intt(self._reduce(parts, keys, (d2, self.L))[None],
                         d2)[0]

    def _quadratic_part(self, rows, count: int, r_quad, d2: int):
        """sum_i r_i (x_i y_i - z_i) on the d2 domain of ``rows`` (on the
        controller): count x rows, then count y rows, then count z rows."""
        ex = self.ntt(rows[:count], d2)
        ey = self.ntt(rows[count:2 * count], d2)
        term = self.mont_mul(ex, ey)
        del ex, ey
        term = self.sub(term, self.ntt(rows[2 * count:], d2))
        return self.row_combine(r_quad, term)

    # ------------------------------------------------------------------
    # streaming mode over a process mesh
    # ------------------------------------------------------------------
    def _chunk_pieces(self, rcm: RowChunkedMatrix) -> list:
        return [(i * rcm.chunk_rows, rcm.real_rows(i), c, i % self.D)
                for i, c in enumerate(rcm.chunks)]

    def _quadratic_chunks(self, rcm: RowChunkedMatrix, r_quad, d2: int,
                          m: int):
        """The chunked quadratic product over a process mesh: block j of
        the x rows (a chunk's rows, cut at m) on the rank of chunk j, a
        step of D blocks at a time; each step one all_to_all brings every
        rank its block's y and z rows (and x rows) from the ranks that hold
        them."""
        qb, D, me = rcm.chunk_rows, self.D, self.mesh.rank
        r_quad = self.asarray(r_quad)
        count = -(-m // qb)
        pieces = self._chunk_pieces(rcm)
        total = None
        for step in range(-(-count // D)):
            spans = [(j * qb, min((j + 1) * qb, m)) if j < count else None
                     for j in range(step * D, step * D + D)]
            rows = self._fetch_rows(pieces, [
                [] if s is None else [(base + s[0], base + s[1])
                                      for base in (0, m, 2 * m)]
                for s in spans], rcm.width)
            if rows is None:
                continue
            i0, i1 = spans[me]
            part = self._quadratic_part(rows, i1 - i0, r_quad[i0:i1], d2)
            del rows
            total = part if total is None else fieldops.add(self.field,
                                                            total, part)
        return self.intt(self._combine_ranks(total, count, (d2, self.L))[None],
                         d2)[0]

    def commit_columns_streaming(self, sc: StreamedCodewords):
        """The streaming commit over a process mesh: a step of D chunks at
        a time, each rank re-encodes its chunk of the step and one
        all_to_all hands rank e the column slice [e c, (e + 1) c) of every
        chunk of the step, which it absorbs into its columns' Blake2s
        states in row order (the zk mask rows, which every rank holds,
        last); the leaves are gathered, and every rank builds the tree."""
        if self.comm is None:
            return super().commit_columns_streaming(sc)
        n, D, me, L = sc.n, self.D, self.mesh.rank, self.L
        split = self._column_split(n)
        if len(split) < D:
            raise ValueError(f"a process mesh of {D} ranks hashes {n} "
                             f"columns in fewer than {D} blocks")
        c0, c1 = split[me][1:]
        hs = cuda_hash.ColumnHashStream(self.field, c1 - c0, sc.rows,
                                        self.device)
        chunks, count = sc.coeffs.chunks, len(sc.coeffs.chunks)
        for step in range(-(-count // D)):
            ids, canon = list(range(step * D, step * D + D)), None
            i = ids[me]
            if i < count:
                canon = self.ntt_and_canon(chunks[i], n)[
                    :sc.coeffs.real_rows(i)]
                send = [canon[:, a:b] for _, a, b in split]
            else:
                send = [torch.empty((0, b - a, L), dtype=torch.int32,
                                    device=self.device) for _, a, b in split]
            recv = self.comm.all_to_all(send, [
                (sc.coeffs.real_rows(j) if j < count else 0, c1 - c0, L)
                for j in ids])
            del send, canon
            for j, part in zip(ids, recv):
                if j < count:
                    hs.absorb(part, sc.coeffs.real_rows(j))
            del recv
        if sc.tail is not None:
            hs.absorb(self.ntt_and_canon(sc.tail, n)[:, c0:c1],
                      sc.tail.shape[0])
        leaves = self._join_columns([hs.digests()], n, 0)
        flat = self.to_numpy(cuda_tree.forest_flat(leaves[None]))
        return hashops.digest_lists(flat[0], n)
