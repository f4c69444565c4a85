"""Row-sharded execution over a mesh of devices: ``ShardedBackend``.

The port's counterpart of ``ligero_tpu/parallel/sharded_backend.py`` (its
direct mode).  ``LigeroCircuit(circuit, outputs,
backend=ShardedBackend(field, RowMesh(devices)))`` distributes ``prove`` and
``verify`` over a 1-D mesh (the JAX package's axis ``"rows"``) with no
change to the protocol, and the proofs are byte-identical to one device's:

* **the encode, NTT, iNTT, NTT with the canonical epilogue and the zk
  blind**: row-sharded, no communication (transforms never cross rows);
* **the column commitment**: a row -> column re-shard (the all_to_all:
  device d receives columns [d n/D, (d + 1) n/D) of every row, from every
  device), after which each device hashes its whole columns, with Blake2s
  or the Poseidon sponge; the tree runs on the controller over the
  gathered leaves;
* **row combinations and the linear and quadratic products**: per-device
  partial sums, gathered on the controller and added mod p.  Mod-p addition
  is associative, so any grouping of the row sum gives the same field
  element and the same canonical limbs;
* **openings and the verifier's codewords at the opened columns**:
  per-device row blocks, concatenated in row order;
* **the sparse r^T A product and the ChaCha20 sampler**: on the controller
  (as in the JAX package, which inherits them from ``Backend``).

The controller is one process that issues every device's work and the
copies between devices itself: the one-process model of the JAX package's
``shard_map``.  A device may repeat in the mesh (``["cpu"] * D`` in the
tests, ``["cuda:0"] * D`` on a host with one card): its shards then share
its memory, and :meth:`ShardedBackend.device_bytes` adds them up.  Rows
that do not divide D are zero-padded: zero rows are exact under the NTT
and add zero to every sum.

Not ported yet (each raises, naming its ``ROADMAP.md`` item): streaming
mode over the mesh (the JAX package's ``ShardedCoeffs``, block-cyclic) and
batches (``prove_batch`` / ``verify_batch``).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..engine import cuda_lc, fieldops
from ..engine.backend import (ESTIMATE_MARGIN, DeviceMemoryError,
                              TorchBackend, resolve_device)
from ..fields import FieldSpec


class RowMesh:
    """A 1-D mesh of torch devices (the JAX package's ``Mesh`` with one
    axis ``"rows"``), driven by one controller: ``devices[0]``.  A device
    may repeat; all are CPUs or all CUDA devices."""

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

    def __repr__(self) -> str:
        return f"RowMesh({[str(d) for d in self.devices]})"


class ShardedRows:
    """A logical (rows, w, L) matrix in row blocks over a mesh: block d,
    on mesh device d, holds the next ``real[d]`` rows of the matrix, then
    zero rows.  Only the backend opens it; the protocol layer passes it
    on."""

    def __init__(self, blocks: list[torch.Tensor], real: list[int]):
        if len(blocks) != len(real) or any(
                not 0 <= r <= b.shape[0] for b, r in zip(blocks, real)):
            raise ValueError("ShardedRows: real row counts do not fit the "
                             "blocks")
        self.blocks, self.real = blocks, list(real)
        self.starts = [int(v) for v in np.cumsum([0] + self.real[:-1])]
        self.rows = sum(self.real)
        self.width, self.L = blocks[0].shape[1], blocks[0].shape[2]

    @property
    def shape(self) -> tuple[int, int, int]:
        return (self.rows, self.width, self.L)


def _on(device: torch.device):
    """Make ``device`` current for the kernels' launches, which go to the
    current CUDA device."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class ShardedBackend(TorchBackend):
    """A :class:`TorchBackend` whose bulk steps run per row block over
    ``mesh`` (a :class:`RowMesh` or a list of devices); the controller,
    ``mesh.devices[0]``, keeps the sampler, the sparse product, the trees
    and everything small.  Direct mode, one proof a call."""

    def __init__(self, field: FieldSpec, mesh):
        mesh = mesh if isinstance(mesh, RowMesh) else RowMesh(mesh)
        super().__init__(field, mesh.devices[0])
        self.mesh, self.D = mesh, mesh.size
        # one single-device backend a physical device: the bulk steps of a
        # block run through the one that holds it
        self._local = {dev: TorchBackend(field, dev) for dev in mesh.physical}

    def _be(self, device: torch.device) -> TorchBackend:
        return self._local[device]

    # ------------------------------------------------------------------
    # layout
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
        are, 16-bit limbs widened on the device)."""
        h, real = self._split(a.shape[0])
        blocks = []
        for d, dev in enumerate(self.mesh.devices):
            r0, r1 = d * h, d * h + real[d]
            blk = (a[r0:r1].to(device=dev, dtype=torch.int32)
                   if isinstance(a, torch.Tensor)
                   else self._be(dev)._rows_up(a, r0, r1))
            blocks.append(self._pad(blk, h))
        return ShardedRows(blocks, real)

    def gather_rows(self, sr: ShardedRows) -> torch.Tensor:
        """The logical matrix as one tensor on the controller."""
        return torch.cat([b[:r].to(self.device)
                          for b, r in zip(sr.blocks, sr.real)])

    def _map(self, sr: ShardedRows, fn) -> ShardedRows:
        """``fn(local backend, block)`` on each block, on its device."""
        out = []
        for blk in sr.blocks:
            with _on(blk.device):
                out.append(fn(self._be(blk.device), blk))
        return ShardedRows(out, sr.real)

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

    def _reduce(self, parts) -> torch.Tensor:
        """Partial sums from the devices, added mod p on the controller in
        mesh order."""
        total = None
        for part in parts:
            part = part.to(self.device)
            total = part if total is None else fieldops.add(self.field, total,
                                                            part)
        return total

    def column_blocks(self, u_canon, batch: int = 1):
        """The row -> column re-shard of a :class:`ShardedRows`: device d
        gets columns [d c, (d + 1) c) (c = ceil(n / D)) of every real row
        from every block, as a (1, rows, c, L) tensor; one destination at a
        time, so that a device holds one column block beside its rows.
        A tensor (the verifier's opened columns) is one block on the
        controller."""
        if not isinstance(u_canon, ShardedRows):
            yield from super().column_blocks(u_canon, batch)
            return
        if batch != 1:
            raise ValueError("the mesh commits one proof at a time")
        n = u_canon.width
        c = -(-n // self.D)
        for d, dev in enumerate(self.mesh.devices):
            c0, c1 = min(n, d * c), min(n, (d + 1) * c)
            if c0 == c1:
                continue
            with _on(dev):
                yield torch.cat([blk[:real, c0:c1].to(dev) for blk, real
                                 in zip(u_canon.blocks, u_canon.real)])[None]

    # ------------------------------------------------------------------
    # memory (per physical device)
    # ------------------------------------------------------------------
    def memory_budget(self) -> int:
        return min(be.memory_budget() for be in self._local.values())

    def device_bytes(self, rows: int, k: int, n: int, nnz: int,
                     blind_t: int = 0, d2: int | None = None,
                     verifier: bool = False) -> dict:
        """Estimate of the largest live set on each physical device (keyed
        by ``str(device)``), for one proof (``verifier``: one verify) of
        ``rows`` committed rows: every shard the device holds, counted as
        :meth:`TorchBackend.direct_bytes` (``verify_bytes``) counts one
        device's proof of the shard's rows without A; on the controller A's
        COO, the challenge sampler and sparse product over all 4m k entries
        (``_linear_transients``) and the r^T A rows before they are sharded;
        and, for the prover, on every device the re-shard's column block
        and the pieces it is cut from (2 rows n / D elements).  An upper
        bound: shards on one device are counted side by side, though they
        take their turns."""
        E = self.L * 4
        data = rows - 3 if blind_t else rows
        h = self._split(data)[0]
        if verifier:
            shard = TorchBackend.verify_bytes(self, h, k, n, 0)
        else:
            shard = TorchBackend.direct_bytes(self, h + (3 if blind_t else 0),
                                              k, n, 0, blind_t, d2)
        out: dict = {}
        for dev in self.mesh.devices:
            out[str(dev)] = out.get(str(dev), 0) + shard
        if not verifier:
            reshard = 2 * rows * -(-n // self.D) * E * ESTIMATE_MARGIN
            for dev in self.mesh.physical:
                out[str(dev)] += int(reshard)
        controller = (nnz * (E + 16) + self._linear_transients(data, k, nnz)
                      + data * k * E)
        out[str(self.device)] += int(controller * ESTIMATE_MARGIN)
        return out

    def direct_bytes(self, rows: int, k: int, n: int, nnz: int,
                     blind_t: int = 0, d2: int | None = None,
                     batch: int = 1) -> int:
        """The largest of :meth:`device_bytes` over the physical devices."""
        if batch != 1:
            raise ValueError("the mesh proves one proof at a time")
        return max(self.device_bytes(rows, k, n, nnz, blind_t, d2).values())

    def verify_bytes(self, rows: int, k: int, n: int, nnz: int,
                     batch: int = 1) -> int:
        if batch != 1:
            raise ValueError("the mesh verifies one proof at a time")
        return max(self.device_bytes(rows, k, n, nnz, verifier=True).values())

    def encode_mode(self, rows: int, k: int, n: int, nnz: int,
                    blind_t: int = 0, d2: int | None = None,
                    poseidon: bool = False) -> tuple[str, int]:
        """Direct mode where every device's estimate fits its memory; else
        :class:`DeviceMemoryError`: streaming mode over the mesh is not
        ported."""
        need = self.direct_bytes(rows, k, n, nnz, blind_t, d2)
        budget = self.memory_budget()
        if need > budget:
            raise DeviceMemoryError(
                f"instance needs ~{need / 2**30:.1f} GiB on a device of "
                f"{self.mesh} in direct mode (budget {budget / 2**30:.1f} "
                "GiB); streaming under the mesh is not ported yet "
                "(ROADMAP.md queue 1, the mesh's streaming)")
        return "direct", 0

    # ------------------------------------------------------------------
    # the committed matrices (one proof)
    # ------------------------------------------------------------------
    def upload_messages(self, preenc: list) -> list:
        """One host (4m, k, L) message matrix -> ``[ShardedRows]``."""
        if len(preenc) != 1:
            raise ValueError("the mesh proves one proof at a time")
        return [self.row_matrix(preenc[0])]

    def rs_encode_batch(self, msgs, k: int, n: int):
        coeffs = self._map(msgs[0], lambda be, b: be.intt(b, k))
        return [coeffs], self.ntt_and_canon(coeffs, n)

    def zk_blind_batch(self, msgs, rows_seeds: list, blind_t: int, d2: int,
                       mask3s: list):
        """:meth:`TorchBackend.zk_blind_rows` on each block: its message
        rows' iNTT_k and their s draws (taken on the controller from the
        one ``rows_seed`` stream, in row order, and sent to the block's
        device) -> ``([coeffs (4m, k + b)], committed rows (4m + 3, d2))``,
        the three mask rows after the last block's data rows."""
        sr, b, L = msgs[0], blind_t, self.L
        s_all = self.rand_field_mont(sr.rows * b, rows_seeds[0]).reshape(
            sr.rows, b, L)
        coeffs, rows = [], []
        for d, (blk, start, real) in enumerate(zip(sr.blocks, sr.starts,
                                                   sr.real)):
            dev, h, k = blk.device, blk.shape[0], blk.shape[1]
            be = self._be(dev)
            with _on(dev):
                s = blk.new_zeros((h, b, L))
                s[:real] = s_all[start:start + real].to(dev)
                c = torch.cat([be.intt(blk, k), s], dim=1)
                # the regions [0, b) and [k, k + b) overlap when b > k
                c[:, :b] = be.sub(c[:, :b], s)
                del s
                last = d == self.D - 1
                r = blk.new_zeros((h + (3 if last else 0), d2, L))
                r[:real, :k + b] = c[:real]
                if last:
                    r[real:real + 3] = be.asarray(mask3s[0])
            coeffs.append(c)
            rows.append(r)
        del s_all
        real = list(sr.real)
        real[-1] += 3
        return [ShardedRows(coeffs, sr.real)], ShardedRows(rows, real)

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
        return self._map(coeffs, lambda be, b: be.ntt_and_canon(b, n))

    def ntt_columns(self, coeffs, n: int, js) -> torch.Tensor:
        """Each block's n-point NTTs at the columns ``js``, its real rows
        gathered on the controller in row order."""
        js = np.asarray(js, dtype=np.int64)
        parts = self._map(coeffs, lambda be, b: be.ntt(b, n).index_select(
            1, torch.from_numpy(js).to(b.device)))
        return self.gather_rows(parts)

    # ------------------------------------------------------------------
    # commitment and openings
    # ------------------------------------------------------------------
    def gather_columns_batch(self, u_canon, idx) -> np.ndarray:
        idx = np.asarray(idx, dtype=np.int64)
        if idx.shape[0] != 1:
            raise ValueError("the mesh opens one proof at a time")
        return np.concatenate([
            self.to_numpy(blk.index_select(1, torch.from_numpy(idx[0]).to(
                blk.device))[:real])
            for blk, real in zip(u_canon.blocks, u_canon.real)])[None]

    # ------------------------------------------------------------------
    # partial sums
    # ------------------------------------------------------------------
    def row_combine(self, r, mat):
        """sum_i r_i M_i: each block's rows against its slice of ``r``
        (sent to its device), the partials added on the controller."""
        if not isinstance(mat, ShardedRows):
            return super().row_combine(r, mat)
        r = self.asarray(r)
        parts = []
        for blk, start, real in zip(mat.blocks, mat.starts, mat.real):
            if real:
                with _on(blk.device):
                    parts.append(self._be(blk.device).row_combine(
                        r[start:start + real].to(blk.device), blk[:real]))
        return self._reduce(parts)

    def row_combine_batch(self, r, mats):
        return torch.stack([self.row_combine(r[b], mats[b])
                            for b in range(len(mats))])

    def linear_combination_poly(self, u_coeffs, r_coeffs, d2: int):
        """Each device's two blocks on the d2 domain and their row
        combination; the partials added on the controller, one iNTT
        there."""
        if (not isinstance(r_coeffs, ShardedRows)
                or r_coeffs.real != u_coeffs.real):
            raise ValueError("linear_combination_poly: u and r blocks are "
                             "not row-aligned")
        parts = []
        for ub, rb in zip(u_coeffs.blocks, r_coeffs.blocks):
            with _on(ub.device):
                be = self._be(ub.device)
                eu, er = be.ntt(ub, d2), be.ntt(rb, d2)
                parts.append(cuda_lc.row_combine(self.field, er, eu))
                del eu, er
        return self.intt(self._reduce(parts)[None], d2)[0]

    def quadratic_combination_poly(self, xyz_coeffs, r_quad, d2: int,
                                   m: int | None = None):
        """The x, y and z rows are m rows apart, so no row block holds a
        row's three: device d gathers rows [d c, (d + 1) c) of each region
        (c = ceil(m / D); copies from the blocks that hold them), takes
        their products on the d2 domain and its partial sum; the partials
        are added on the controller, one iNTT there."""
        m = xyz_coeffs.rows // 3 if m is None else m
        r_quad = self.asarray(r_quad)
        c = -(-m // self.D)
        parts = []
        for d, dev in enumerate(self.mesh.devices):
            i0, i1 = d * c, min(m, (d + 1) * c)
            if i0 >= i1:
                continue
            with _on(dev):
                be = self._be(dev)
                ex, ey, ez = (be.ntt(self._row_range(
                    xyz_coeffs, base + i0, base + i1, dev), d2)
                    for base in (0, m, 2 * m))
                term = be.sub(be.mont_mul(ex, ey), ez)
                del ex, ey, ez
                parts.append(be.row_combine(r_quad[i0:i1].to(dev), term))
                del term
        return self.intt(self._reduce(parts)[None], d2)[0]
