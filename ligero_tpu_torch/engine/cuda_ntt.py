"""Batched NTT: the CUDA kernel ``csrc/ntt.cu`` and its wrapper.

Replaces ``ligero_tpu/engine/mxu_ntt.py:_mxu_kernel_factory`` (every BN254
transform at 2^20 gates on the TPU: iNTT_k, the split NTT_n and the 2k
products) and ``ligero_tpu/engine/pallas_ntt.py:_ntt_kernel_factory`` (the
k <= 512 sizes).  On this card the transform is bound by operations: a row
of the commit is ~100k Montgomery products against 1.2 MB moved, ~7 times
as long in arithmetic as in bytes.  So the kernel does as few products as
it can, moves every byte once and runs every butterfly stage in shared
memory: a zero-extended input becomes n / s cosets of s-point transforms
(no work on zeros, the output constant folded into the twist table), each
one shared-memory pass where s <= 4096 and two passes with one packed
intermediate above; see the head of ``csrc/ntt.cu``.  :func:`ntt.ntt_plan`
chooses the route from (w, n) and the tile limit alone (a lone row gets a
lower limit, so that it spreads over the card), and this wrapper allocates
scratch only for a route that needs it.

A tensor on the CPU takes the plain version (:func:`ntt.ntt_ref`); a CUDA
tensor launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import FieldSpec

from . import cuda_build
from .cuda_mont import require_bn254
from .ntt import (TILE_LOG, NttRoute, check_size, ntt_plan, ntt_ref,
                  stage_twiddle_limbs, tile_log_for, twist_const, twist_limbs)

#: kernel launches by :func:`ntt` (one per call; a call runs one kernel per
#: pass of its route, back to back)
launches = cuda_build.LaunchCounter()

_MODE_COSET, _MODE_PASS1, _MODE_PASS2 = 0, 1, 2
_TABLES: dict = {}


def pack_words(limbs: np.ndarray) -> np.ndarray:
    """(..., L) 16-bit limbs -> (..., L/2) 32-bit words as int32 bits."""
    limbs = np.asarray(limbs, dtype=np.uint32)
    return (limbs[..., 0::2] | (limbs[..., 1::2] << np.uint32(16))).view(np.int32)


def _table(key, make, device) -> torch.Tensor:
    key = key + (str(device),)
    t = _TABLES.get(key)
    if t is None:
        t = torch.from_numpy(np.ascontiguousarray(pack_words(make()))).to(device)
        _TABLES[key] = t
    return t


def _stage_twiddles(field: FieldSpec, size: int, inverse: bool, device):
    return _table(("tws", field.name, size, inverse),
                  lambda: stage_twiddle_limbs(field.name, size, inverse), device)


def _twists(field: FieldSpec, n: int, inverse: bool, k: int, device):
    return _table(("pw", field.name, n, inverse, k),
                  lambda: twist_limbs(field.name, n, inverse, k), device)


def route(w: int, n: int, rows: int | None = None) -> NttRoute:
    """The route :func:`ntt` takes for ``rows`` w-wide rows and an n-point
    transform (``rows`` unknown: a batch that fills the card)."""
    return ntt_plan(w, n, tile_log_for(rows, w, n))


def scratch_bytes(rows: int, w: int, n: int) -> int:
    """Bytes of scratch :func:`ntt` allocates for ``rows`` w-wide rows."""
    return route(w, n, rows).scratch_elements(rows) * 32


def ntt(field: FieldSpec, x: torch.Tensor, n: int, inverse: bool = False,
        canon_out: bool = False) -> torch.Tensor:
    """(..., w, L) Montgomery limbs, w <= n, zero-extended -> (..., n, L);
    ``inverse`` for omega^-1 with 1/n, ``canon_out`` for canonical output."""
    if x.device.type == "cpu":
        return ntt_ref(field, x, n, inverse, canon_out)
    check_size(field, n)
    w = x.shape[-2]
    if x.dim() < 2 or not 1 <= w <= n:
        raise ValueError(f"ntt: bad input shape {tuple(x.shape)} for n = {n}")
    rows = x.numel() // (w * x.shape[-1])
    tile_log = tile_log_for(rows, w, n)
    return ntt_routed(field, x, n, inverse, canon_out,
                      ntt_plan(w, n, tile_log), tile_log)


def ntt_routed(field: FieldSpec, x: torch.Tensor, n: int, inverse: bool,
               canon_out: bool, rt: NttRoute,
               tile_log: int = TILE_LOG) -> torch.Tensor:
    """:func:`ntt` on a CUDA tensor by a given route (``ntt_plan(w, n,
    tile_log)``; a tile limit below the kernel's own drives every route at
    small sizes)."""
    require_bn254(field, "ntt")
    logn = check_size(field, n)
    L = field.num_limbs
    lead, w = x.shape[:-2], x.shape[-2]
    if x.shape[-1] != L or rt.logn != logn or w > 1 << rt.ls:
        raise ValueError(f"ntt: bad input shape {tuple(x.shape)} for n = {n} "
                         f"by route {rt}")
    x = x.reshape(-1, w, L).contiguous()
    B, dev = x.shape[0], x.device
    out = torch.empty((B, n, L), dtype=torch.int32, device=dev)
    if B == 0:
        return out.reshape(*lead, n, L)
    two_pass = rt.l1 > 0
    k_epi = twist_const(field, n, inverse, canon_out)
    k_one = field.R % field.p
    tws = _stage_twiddles(field, 1 << (rt.ls if rt.l0 else max(rt.l1, rt.l2)),
                          inverse, dev)
    # with one pass the coset twist carries the output constant; with two
    # the second pass's twiddle does; a lone coset needs no twist of its own
    k_first = k_one if two_pass else k_epi
    pw_first = (_twists(field, n, inverse, k_first, dev)
                if rt.lc or k_first != k_one else None)
    tensors = [x, out, tws] + ([] if pw_first is None else [pw_first])
    scratch = pw_second = None
    if two_pass:
        scratch = torch.empty((rt.scratch_elements(B), L // 2),
                              dtype=torch.int32, device=dev)
        pw_second = _twists(field, n, inverse, k_epi, dev)
        tensors += [scratch, pw_second]
    cuda_build.require_cuda_tensors("ntt", *tensors)
    lib = cuda_build.library()
    stream = cuda_build.stream_handle(dev)

    def run_pass(mode, pw, sub_log, avail_log):
        cuda_build.check(lib.lt_ntt_pass(
            mode, x.data_ptr(), None if scratch is None else scratch.data_ptr(),
            out.data_ptr(), tws.data_ptr(),
            None if pw is None else pw.data_ptr(), w, B, logn, rt.lc, rt.l0,
            rt.l1, rt.l2, rt.group_log(sub_log, avail_log, tile_log),
            int(k_first == k_one), stream), "lt_ntt_pass")

    if not two_pass:
        run_pass(_MODE_COSET, pw_first, rt.ls, rt.lc)
    else:
        run_pass(_MODE_PASS1, pw_first, rt.l2, rt.l1)
        run_pass(_MODE_PASS2, pw_second, rt.l1, rt.l2)
        for st in range(rt.l1 + rt.l2, rt.ls):
            cuda_build.check(lib.lt_ntt_stage(
                scratch.data_ptr(), out.data_ptr(), tws.data_ptr(), B, logn,
                rt.lc, st, int(st == rt.ls - 1), stream), "lt_ntt_stage")
    launches.add()
    return out.reshape(*lead, n, L)
