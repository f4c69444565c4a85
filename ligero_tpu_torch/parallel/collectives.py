"""The process mesh's collectives: the one place where the ranks of a
multi-process mesh exchange tensors.

``parallel.multihost`` joins the processes into one ``torch.distributed``
process group; a :class:`~.sharded_backend.ProcessRowMesh` over that group
holds a :class:`Collectives`, and the sharded backend and the sharded core
reach the other ranks only through it:

* :meth:`Collectives.all_gather`: every rank's tensor of one shape, in
  rank order (roots, partial sums, gathered rows, opened columns, digests);
* :meth:`Collectives.all_to_all`: rank d's d-th send tensor arrives at
  rank e as its d-th receive tensor; shapes may differ from pair to pair
  (the row -> column re-shard, the streaming commit's column slices, the
  quadratic product's row exchange).  One ``all_to_all_single`` over flat
  buffers with per-rank split sizes, which both NCCL and gloo run.

16-bit limbs (int16 tensors: the streaming mode's chunks, the opened
columns) travel as their int32 view, two limbs a word (every such tensor
ends in an even limb axis): neither NCCL nor gloo carries int16, and the
view moves the same bytes, where a widened copy would move twice as many.

NCCL carries CUDA tensors and gloo carries host tensors.  Gloo over CUDA
tensors (``initialize(backend="gloo")`` with the ranks on the card, the one
way to run two ranks on one GPU: NCCL refuses two ranks on one device) is
staged here: every tensor goes to host memory, through gloo, and back to
the rank's device, and :attr:`Collectives.staged_bytes` counts what
crossed.  Nothing else in the port stages, and nothing falls back from one
backend to another.
"""

from __future__ import annotations

import math

import torch


class Collectives:
    """The collectives of one rank of a process group.  ``device`` is the
    rank's device; ``backend`` is the group's (``"nccl"`` or ``"gloo"``).
    Every method must be called by every rank of the group, in the same
    order (the ranks run the same program on the same inputs)."""

    def __init__(self, group, rank: int, size: int, backend: str,
                 device: torch.device):
        if backend not in ("nccl", "gloo"):
            raise ValueError(f"collectives: backend {backend!r} is not nccl "
                             "or gloo")
        if backend == "nccl" and device.type != "cuda":
            raise ValueError("collectives: NCCL carries CUDA tensors only; "
                             f"this rank's device is {device}")
        self.group, self.rank, self.size = group, rank, size
        self.backend, self.device = backend, device
        #: gloo over CUDA tensors: stage through host memory
        self.staged = backend == "gloo" and device.type == "cuda"
        #: bytes copied between the device and the host for gloo (both
        #: directions, this rank)
        self.staged_bytes = 0

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where the backend takes it: the host under staging."""
        if self.staged:
            self.staged_bytes += t.numel() * t.element_size()
            return t.cpu()
        return t

    def _back(self, t: torch.Tensor) -> torch.Tensor:
        """A received tensor on the rank's device."""
        if self.staged:
            self.staged_bytes += t.numel() * t.element_size()
            return t.to(self.device)
        return t

    def _empty(self, shape, dtype) -> torch.Tensor:
        return torch.empty(shape, dtype=dtype,
                           device="cpu" if self.staged else self.device)

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``t`` (one shape and type on every rank), in rank
        order, on this rank's device."""
        import torch.distributed as dist

        if t.dtype == torch.int16:
            return [o.view(torch.int16) for o in
                    self.all_gather(t.contiguous().view(torch.int32))]
        t = self._wire(t.contiguous())
        out = [self._empty(t.shape, t.dtype) for _ in range(self.size)]
        dist.all_gather(out, t, group=self.group)
        return [self._back(o) for o in out]

    def all_to_all(self, send: list[torch.Tensor],
                   shapes: list[tuple]) -> list[torch.Tensor]:
        """``send[e]`` to rank e; returns what each rank d sent here, as a
        tensor of ``shapes[d]`` (the caller knows every pair's shape: the
        ranks share the layout).  All of one type; any tensor may be empty."""
        import torch.distributed as dist

        if len(send) != self.size or len(shapes) != self.size:
            raise ValueError(f"all_to_all: {len(send)} sends and "
                             f"{len(shapes)} shapes for {self.size} ranks")
        dtype = send[0].dtype
        if dtype == torch.int16:
            got = self.all_to_all([t.view(torch.int32) for t in send],
                                  [tuple(s[:-1]) + (s[-1] // 2,)
                                   for s in shapes])
            return [g.view(torch.int16) for g in got]
        ins = [t.numel() for t in send]
        outs = [math.prod(s) for s in shapes]
        # one flat send buffer, each piece copied in once (the pieces may
        # be strided views: a column slice of a row block)
        buf = torch.empty(sum(ins), dtype=dtype, device=self.device)
        off = 0
        for t, c in zip(send, ins):
            buf[off:off + c].view(t.shape).copy_(t)
            off += c
        buf = self._wire(buf)
        recv = self._empty(sum(outs), dtype)
        dist.all_to_all_single(recv, buf, outs, ins, group=self.group)
        del buf
        recv = self._back(recv)
        views, off = [], 0
        for s, c in zip(shapes, outs):
            views.append(recv[off:off + c].view(s))
            off += c
        return views

    def min_int(self, value: int) -> int:
        """The least of every rank's ``value`` (the ranks' memory budgets
        agree on one mode and chunking)."""
        got = self.all_gather(torch.tensor([value], dtype=torch.int64,
                                           device=self.device))
        return int(min(int(g[0]) for g in got))
