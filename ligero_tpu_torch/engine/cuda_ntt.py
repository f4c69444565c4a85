"""Batched NTT: the CUDA kernel ``csrc/ntt.cu`` and its wrapper.

Replaces ``ligero_tpu/engine/mxu_ntt.py:_mxu_kernel_factory`` (every BN254
transform at 2^20 gates on the TPU: iNTT_k, the split NTT_n and the 2k
products) and ``ligero_tpu/engine/pallas_ntt.py:_ntt_kernel_factory`` (the
BN254 k <= 512 sizes, and every BLS12-377 transform: ``mxu_ntt`` takes
16-limb fields only).  The kernel is built for both fields, with the same
routes.  On this card the transform is bound by operations: a row
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

Input and output may each be 16-bit limbs (int16 tensors,
:func:`fieldops.narrow16`): the resident and streaming modes hold their
chunks so (the JAX package's ``narrow16``), and the kernel reads and writes
them as they lie, half the bytes, the same bits (:func:`ntt16_ref` is that
entry's plain version: widen, :func:`ntt.ntt_ref`, narrow).

A tensor on the CPU takes the plain version (:func:`ntt16_ref`, which is
:func:`ntt.ntt_ref` on int32 limbs); a CUDA tensor launches the kernel or
raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..fields import BLS12_377_FQ, BN254_FR, FieldSpec

from . import cuda_build, fieldops
from .ntt import (TILE_LOG, NttRoute, check_size, ntt_plan, ntt_ref,
                  stage_twiddle_limbs, tile_log_for, twist_const, twist_limbs)

#: kernel launches by :func:`ntt` on int32 limbs in and out (one per call;
#: a call runs one kernel per pass of its route, back to back)
launches = cuda_build.LaunchCounter()
#: launches of the 16-bit entry: an int16 input or ``out16``
launches16 = cuda_build.LaunchCounter()

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


def scratch_bytes(field: FieldSpec, rows: int, w: int, n: int) -> int:
    """Bytes of scratch :func:`ntt` allocates for ``rows`` w-wide rows: one
    packed element (2 L bytes) per element of a two-pass route's
    intermediate."""
    return route(w, n, rows).scratch_elements(rows) * 2 * field.num_limbs


#: the stages a thread of the kernel does between barriers (csrc/ntt.cu
#: NttShape::RADIX_LOG), and the fields whose butterflies are lazy (NttArith)
RADIX_LOG = {BN254_FR.name: 3, BLS12_377_FQ.name: 2}
LAZY_FIELDS = (BLS12_377_FQ.name,)
#: the reductions :func:`lazy_bound_model` can be told to leave out
LAZY_REDUCTIONS = ("sum", "diff", "store")


class BoundError(ValueError):
    """A value past its bound in :func:`lazy_bound_model`."""


def lazy_bound_model(field: FieldSpec, rt: NttRoute,
                     skip: str | None = None) -> dict:
    """The bounds of the kernel's arithmetic along route ``rt``, on Python
    ints: every pass's load (the twist product, or none), its stages in
    the kernel's groups of ``RADIX_LOG`` (a lone top stage where their
    count is 1 mod ``RADIX_LOG``; a butterfly whose twiddle is one makes
    no product: every butterfly of the last stage, and those at position
    0 in the lowest group), its store, and the global stages.

    Each operation checks the input range its csrc/field.cuh comment
    states and gives the exclusive bound its output can reach: for a lazy
    field (:data:`LAZY_FIELDS`) ``fe_add_2p`` / ``fe_sub_2p`` take a, b < 2p
    to [0, 2p), ``fe_sub_4p`` takes a, b < 2p to (0, 4p), a product REDC(a
    b) takes a < R and b < p to below a b / R + p, ``fe_reduce_p`` takes a
    < 2p to [0, p); the fully reduced forms take and give [0, p).  What is
    written to memory must be below p.  ``skip`` leaves one reduction out
    (:data:`LAZY_REDUCTIONS`: the sum's conditional subtraction and
    the difference's where the twiddle is one, both at the first pass's last
    stage, or the first pass's store), which a sound sequence cannot
    afford; a route with no such reduction raises ``ValueError``.

    Returns the largest bound each kind of value reached: ``butterfly`` (a
    butterfly's inputs and outputs), ``product_a`` / ``product_b`` (the
    walked and the vector operand of every product), ``product`` (its
    result), ``stored``.  Raises :class:`BoundError` where a bound fails: a
    value of 2^384 or more, a product with a >= R or b >= p, an operation
    given inputs outside its range, a stored value of p or more."""
    p, R = field.p, 1 << field.r_bits
    W = field.num_limbs // 2
    lazy = field.name in LAZY_FIELDS
    if skip is not None and (not lazy or skip not in LAZY_REDUCTIONS):
        raise ValueError(f"lazy_bound_model: no reduction {skip!r} to skip")
    radix = RADIX_LOG[field.name]
    top = {"butterfly": 0, "product_a": 0, "product_b": 0, "product": 0,
           "stored": 0}
    skipped = {"sum": False, "diff": False, "store": False}

    def note(key, bound):
        if bound > 1 << (32 * W):
            raise BoundError(f"{key}: a value of 2^{32 * W} or more")
        top[key] = max(top[key], bound)
        return bound

    def need(what, *bounds, limit):
        for b in bounds:
            if b > limit:
                raise BoundError(f"{what}: an input of up to {b - 1} where "
                                 f"it takes below {limit}")

    def skips(name):
        if skip == name and not skipped[name]:
            skipped[name] = True
            return True
        return False

    def product(a, b):                      # REDC(a b): a < R, b < p
        note("product_a", a)
        note("product_b", b)
        need("a product's walked operand", a, limit=R)
        need("a product's vector operand", b, limit=p)
        # the steps' sum stays below b + p; the result below a b / R + p
        note("product", b + p)
        out = ((a - 1) * (b - 1) + (R - 1) * p) // R + 1
        return note("product", out if lazy else p)

    def cond_sub(x, m):                     # x - m where x >= m
        return max(min(x, m), x - m)

    def butterfly(x, kinds, last):
        """A stage's butterflies on inputs below x: those of ``kinds``
        ("one": no product, "product": one); ``last`` is the first pass's
        last stage, where a skipped sum or difference reduction falls."""
        note("butterfly", x)
        if not lazy:
            need("fe_add / fe_sub", x, limit=p)
            outs = [p] + ([product(p, p)] if "product" in kinds else [])
            return note("butterfly", max(outs))
        need("fe_add_2p / fe_sub_2p / fe_sub_4p", x, limit=2 * p)
        raw = 2 * x - 1                      # x + y, both below x
        outs = [raw if last and skips("sum") else cond_sub(raw, 2 * p)]
        if "one" in kinds:
            # fe_sub_2p; skipped, fe_sub_4p's x - y + 2p, below x + 2p
            outs.append(x + 2 * p if last and skips("diff") else 2 * p)
        if "product" in kinds:
            outs.append(product(x + 2 * p, p))   # fe_sub_4p into REDC
        return note("butterfly", max(outs))

    def groups(lt):
        """The kernel's groups of an lt-stage tile from the top, as (base,
        stages): RADIX_LOG at a time, the rest at the bottom; where lt is 1
        mod RADIX_LOG (and above 1) the top stage alone, on the way in."""
        sizes = []
        b = lt
        if lt > 1 and lt % radix == 1:
            sizes.append(1)
            b -= 1
        while b > 0:
            sizes.append(min(radix, b))
            b -= sizes[-1]
        b = lt
        for lr in sizes:
            b -= lr
            yield b, lr

    def tile(x, lt, first_pass):
        """The kernel's stages of an lt-stage tile."""
        for b, lr in groups(lt):
            for hb in range(b + lr - 1, b - 1, -1):
                kinds = (("one",) if hb == 0 or b == 0 else ()) \
                    + (("product",) if hb > 0 else ())
                x = butterfly(x, kinds, first_pass and hb == 0)
        return x

    def store(x):
        if lazy and not skips("store"):
            need("fe_reduce_p", x, limit=2 * p)
            x = p
        if x > p:
            raise BoundError(f"stored: a value of up to {x - 1}, not below p")
        return note("stored", x)

    def load(x, twisted):
        return max(x, product(x, p)) if twisted else x

    if rt.l1 == 0:
        store(tile(load(p, True), rt.ls, True))
    else:
        z = store(tile(load(p, rt.lc > 0), rt.l2, True))    # pass 1
        z = store(tile(load(z, True), rt.l1, False))        # pass 2
        for _ in range(rt.l0):    # global stages: field.cuh's full forms
            need("a global stage's fe_add / fe_sub", z, limit=p)
            need("a global stage's product", z, limit=R)
            z = note("stored", p)
    if skip is not None and not skipped[skip]:
        raise ValueError(f"lazy_bound_model: route {rt} has no {skip} "
                         f"reduction to skip")
    return top


def ntt16_ref(field: FieldSpec, x: torch.Tensor, n: int,
              inverse: bool = False, canon_out: bool = False,
              out16: bool = False) -> torch.Tensor:
    """Plain version of the 16-bit entry: ``x`` widened to int32 limbs,
    :func:`ntt.ntt_ref`, the output narrowed to int16 where ``out16``."""
    y = ntt_ref(field, fieldops.widen16(x), n, inverse, canon_out)
    return fieldops.narrow16(y) if out16 else y


def ntt(field: FieldSpec, x: torch.Tensor, n: int, inverse: bool = False,
        canon_out: bool = False, out16: bool = False) -> torch.Tensor:
    """(..., w, L) Montgomery limbs, w <= n, zero-extended -> (..., n, L);
    ``inverse`` for omega^-1 with 1/n, ``canon_out`` for canonical output.
    ``x`` holds int32 limbs or 16-bit ones (int16); the output is int32
    limbs, or 16-bit ones where ``out16``."""
    if x.device.type == "cpu":
        return ntt16_ref(field, x, n, inverse, canon_out, out16)
    check_size(field, n)
    w = x.shape[-2]
    if x.dim() < 2 or not 1 <= w <= n:
        raise ValueError(f"ntt: bad input shape {tuple(x.shape)} for n = {n}")
    rows = x.numel() // (w * x.shape[-1])
    tile_log = tile_log_for(rows, w, n)
    return ntt_routed(field, x, n, inverse, canon_out,
                      ntt_plan(w, n, tile_log), tile_log, out16)


def ntt_routed(field: FieldSpec, x: torch.Tensor, n: int, inverse: bool,
               canon_out: bool, rt: NttRoute,
               tile_log: int = TILE_LOG, out16: bool = False) -> torch.Tensor:
    """:func:`ntt` on a CUDA tensor by a given route (``ntt_plan(w, n,
    tile_log)``; a tile limit below the kernel's own drives every route at
    small sizes)."""
    fid = cuda_build.kernel_field_id(field, "ntt")
    logn = check_size(field, n)
    L = field.num_limbs
    lead, w = x.shape[:-2], x.shape[-2]
    if x.shape[-1] != L or rt.logn != logn or w > 1 << rt.ls:
        raise ValueError(f"ntt: bad input shape {tuple(x.shape)} for n = {n} "
                         f"by route {rt}")
    x = x.reshape(-1, w, L).contiguous()
    B, dev = x.shape[0], x.device
    in16 = x.dtype == torch.int16
    out = torch.empty((B, n, L), dtype=torch.int16 if out16 else torch.int32,
                      device=dev)
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
    tensors = [tws] + ([] if pw_first is None else [pw_first])
    scratch = pw_second = None
    if two_pass:
        scratch = torch.empty((rt.scratch_elements(B), L // 2),
                              dtype=torch.int32, device=dev)
        pw_second = _twists(field, n, inverse, k_epi, dev)
        tensors += [scratch, pw_second]
    cuda_build.require_cuda_tensors("ntt", *tensors, limbs16=(x, out))
    lib = cuda_build.library()
    stream = cuda_build.stream_handle(dev)

    def run_pass(mode, pw, sub_log, avail_log):
        cuda_build.check(lib.lt_ntt_pass(
            fid, mode, x.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            out.data_ptr(), tws.data_ptr(),
            None if pw is None else pw.data_ptr(), w, B, logn, rt.lc, rt.l0,
            rt.l1, rt.l2, rt.group_log(sub_log, avail_log, tile_log),
            int(k_first == k_one), int(in16), int(out16), stream),
            "lt_ntt_pass")

    if not two_pass:
        run_pass(_MODE_COSET, pw_first, rt.ls, rt.lc)
    else:
        run_pass(_MODE_PASS1, pw_first, rt.l2, rt.l1)
        run_pass(_MODE_PASS2, pw_second, rt.l1, rt.l2)
        for st in range(rt.l1 + rt.l2, rt.ls):
            cuda_build.check(lib.lt_ntt_stage(
                fid, scratch.data_ptr(), out.data_ptr(), tws.data_ptr(), B,
                logn, rt.lc, st, int(st == rt.ls - 1), int(out16), stream),
                "lt_ntt_stage")
    (launches16 if in16 or out16 else launches).add()
    return out.reshape(*lead, n, L)
