#!/usr/bin/env python3
"""Time the port's CUDA kernels against an earlier commit's, on one card.

    git archive <commit> ligero_tpu_torch/csrc | tar -x -C _parent_tree
    python3 scripts/compare_kernels_with_parent.py \
        --parent-csrc _parent_tree/ligero_tpu_torch/csrc [--out FILE]

Builds the sources under ``--parent-csrc`` into a second library (next to
the port's own, in ``ligero_tpu_torch/_build/``) and times both at the full
shapes of the 2^20-gate paths (m = 1025, k = 2048, n = 16384; zk: b = 468,
d2 = 8192), in turns on the same inputs: parent, current, current, parent,
CUDA events over ``--iters`` launches after a warm-up each.  The two
libraries' outputs must be bit-equal.  The parent's NTT and tree are called
through the C interface they had before the shared-memory redesign
(``lt_ntt`` with a (rows, n, 8) scratch allocated per call, as its wrapper
did, and ``lt_sha256_tree`` without counters); the kernels whose interface
did not change go through the port's own wrappers with the library swapped.

Prints one JSON object (also written to ``--out``) with the card's name and
power limit.  Neither JAX nor the JAX package is imported.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import json
import os
import subprocess
import sys

sys.modules["jax"] = None
sys.modules["ligero_tpu"] = None
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

M, K, N, NNZ = 1025, 2048, 16384, 9_443_331
BLIND, D2 = 468, 8192
_vp, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
PARENT_SIGNATURES = {
    "lt_mont_mul": [_vp, _vp, _vp, _ll, _i, _vp],
    "lt_ntt": [_vp, _i, _vp, _vp, _vp, _ll, _i, _vp, _i, _vp],
    "lt_blake2s_cols": [_vp, _ll, _ll, _vp, _vp],
    "lt_row_combine": [_vp, _vp, _vp, _vp, _ll, _ll, _ll, _ll, _i, _vp],
    "lt_sha256_tree": [_vp, _ll, _vp, _vp],
}


def build_parent(csrc: str, cuda_build) -> ctypes.CDLL:
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    nvcc = cuda_build._nvcc()
    sources = sorted(glob.glob(os.path.join(csrc, "*.cu")))
    if not sources:
        raise SystemExit(f"no .cu sources under {csrc}")
    objs = [os.path.join(cuda_build.BUILD_DIR,
                         "parent_" + os.path.basename(p) + ".o") for p in sources]
    procs = [subprocess.Popen([nvcc, *cuda_build.NVCC_FLAGS, "-I", csrc, "-c",
                               "-o", obj, src], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for src, obj in zip(sources, objs)]
    for proc, src in zip(procs, sources):
        _, err = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {src}:\n{err[-3000:]}")
    path = os.path.join(cuda_build.BUILD_DIR, "libligero_cuda_parent.so")
    subprocess.run([nvcc, "-shared", "-o", path, *objs], check=True)
    lib = ctypes.CDLL(path)
    for name, argtypes in PARENT_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-csrc", required=True)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import numpy as np
    import torch

    from ligero_tpu_torch import BN254_FR as field
    from ligero_tpu_torch.engine import (cuda_build, cuda_hash, cuda_lc,
                                         cuda_mont, cuda_ntt, cuda_tree, ntt)

    if not torch.cuda.is_available():
        print("compare_kernels_with_parent: no CUDA device", file=sys.stderr)
        return 1
    current = cuda_build.library()
    parent = build_parent(args.parent_csrc, cuda_build)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    stream = torch.cuda.current_stream().cuda_stream

    def elems(*shape):
        limbs = torch.randint(0, 1 << 16, shape + (16,), generator=gen,
                              dtype=torch.int32, device="cuda")
        limbs[..., 15] = torch.remainder(limbs[..., 15], field.p >> 240)
        return limbs

    def timed(fn) -> float:
        fn()
        torch.cuda.synchronize()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(args.iters):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / args.iters

    def parent_ntt(x, n, inverse=False, canon_out=False):
        B, w, L = x.shape
        out = torch.empty((B, n, L), dtype=torch.int32, device=x.device)
        scratch = torch.empty((B, n, L // 2), dtype=torch.int32, device=x.device)
        key = ("tw", n, inverse)
        if key not in tables:
            tables[key] = torch.from_numpy(np.ascontiguousarray(cuda_ntt.pack_words(
                ntt.twiddle_limbs(field.name, n, inverse)))).cuda()
        c = ntt.epilogue_const(field, n, inverse, canon_out)
        words = (ctypes.c_uint32 * 8)(*[((c or 0) >> (32 * i)) & 0xFFFFFFFF
                                        for i in range(8)])
        cuda_build.check(parent.lt_ntt(
            x.data_ptr(), w, out.data_ptr(), scratch.data_ptr(),
            tables[key].data_ptr(), B, n.bit_length() - 1,
            ctypes.addressof(words), int(c is not None), stream), "lt_ntt")
        return out

    def parent_tree(leaves):
        n = leaves.shape[0]
        out = torch.empty(8 * (2 * n - 1), dtype=torch.int32, device=leaves.device)
        cuda_build.check(parent.lt_sha256_tree(leaves.data_ptr(), n,
                                               out.data_ptr(), stream),
                         "lt_sha256_tree")
        return out

    def with_library(lib, fn):
        def call(*a):
            cuda_build._lib = lib
            try:
                return fn(*a)
            finally:
                cuda_build._lib = current
        return call

    tables: dict = {}
    rows = 4 * M
    leaves = torch.randint(-2**31, 2**31, (N, 8), generator=gen,
                           dtype=torch.int64, device="cuda").to(torch.int32)
    mm = lambda a, b: cuda_mont.mont_mul(field, a, b)           # noqa: E731
    rc = lambda r, m: cuda_lc.row_combine(field, r, m)          # noqa: E731
    cases = [
        # (label, inputs, parent call, current call)
        ("NTT_n canon_out 4100 x 2048 -> 16384", lambda: (elems(rows, K),),
         lambda x: parent_ntt(x, N, canon_out=True),
         lambda x: cuda_ntt.ntt(field, x, N, canon_out=True)),
        ("NTT_2k 4100 x 2048 -> 4096", lambda: (elems(rows, K),),
         lambda x: parent_ntt(x, 2 * K),
         lambda x: cuda_ntt.ntt(field, x, 2 * K)),
        ("iNTT_k 4100 x 2048", lambda: (elems(rows, K),),
         lambda x: parent_ntt(x, K, inverse=True),
         lambda x: cuda_ntt.ntt(field, x, K, inverse=True)),
        ("iNTT_2k 1 x 4096", lambda: (elems(1, 2 * K),),
         lambda x: parent_ntt(x, 2 * K, inverse=True),
         lambda x: cuda_ntt.ntt(field, x, 2 * K, inverse=True)),
        ("zk NTT_d2 4100 x 2516 -> 8192", lambda: (elems(rows, K + BLIND),),
         lambda x: parent_ntt(x, D2), lambda x: cuda_ntt.ntt(field, x, D2)),
        ("zk NTT_d2 4100 x 2048 -> 8192", lambda: (elems(rows, K),),
         lambda x: parent_ntt(x, D2), lambda x: cuda_ntt.ntt(field, x, D2)),
        ("zk encode canon_out 4103 x 8192 -> 16384",
         lambda: (elems(rows + 3, D2),),
         lambda x: parent_ntt(x, N, canon_out=True),
         lambda x: cuda_ntt.ntt(field, x, N, canon_out=True)),
        ("SHA-256 tree n = 16384", lambda: (leaves,),
         parent_tree, cuda_tree.tree_flat),
        ("mont_mul 9,443,331 elements", lambda: (elems(NNZ), elems(NNZ)),
         with_library(parent, mm), mm),
        ("row_combine 4100 x 2048", lambda: (elems(rows), elems(rows, K)),
         with_library(parent, rc), rc),
        ("Blake2s columns 4100 x 16384", lambda: (elems(rows, N),),
         with_library(parent, cuda_hash.blake2s_columns),
         cuda_hash.blake2s_columns),
    ]
    record = {"nvidia_smi": smi, "device": torch.cuda.get_device_name(0),
              "iters": args.iters, "cases": []}
    for label, make, old, new in cases:
        inp = make()
        same = torch.equal(old(*inp), new(*inp))
        torch.cuda.empty_cache()
        ms = [timed(lambda f=f: f(*inp)) for f in (old, new, new, old)]
        entry = {"case": label, "bit_equal": same,
                 "parent_ms": [ms[0], ms[3]], "current_ms": [ms[1], ms[2]]}
        record["cases"].append(entry)
        print(json.dumps(entry), flush=True)
        del inp
        torch.cuda.empty_cache()
    text = json.dumps(record, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(smi)
    return 0 if all(c["bit_equal"] for c in record["cases"]) else 1


if __name__ == "__main__":
    sys.exit(main())
