#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

It runs every phase, in order; any failure exits non-zero:

1. device   -- require CUDA; print the card's nvidia-smi name and power limit.
2. build    -- build the kernels of ``ligero_tpu_torch/csrc`` with nvcc.
3. kernels  -- each kernel against its plain PyTorch version on the card, at
               the 2^20-gate shapes of both paths (plain and zk); bit-equal
               (tolerance 0: exact integer arithmetic), both times printed,
               and the least time the card could take for the same work
               (bytes over the memory rate, or integer operations over the
               instruction rate) beside them.  Then the NTT at the edges of
               every route (one pass, cosets, two passes; each with inverse
               and canon_out on and off, the route printed), the tree at
               the sizes around its 64-node groups and 100 times on one
               input, and the tree's chain floor from a timed chain of
               dependent hashes.
4. parity   -- port proofs on the card byte-equal to the port's proofs on
               the CPU (plain versions) and to SHA-256 digests of the JAX
               package's proofs kept in ``testdata/golden_proofs.json``:
               x^3, 2^8 and 2^10 gates, and 2^8 and 2^10 gates with zk.
5. main     -- the 2^20-gate synthetic circuit through ``LigeroCircuit``'s
               ``prove`` and ``verify``, first plain, then with ``zk=True``:
               two byte-identical proofs, verify True, tampered witness and
               flipped byte rejected, every kernel launched on each path.

The last two stdout lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``.  Neither JAX nor the JAX package
``ligero_tpu`` is ever imported.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
import warnings

# the port must run without JAX and without the JAX package: make any import
# of either fail
sys.modules["jax"] = None
sys.modules["ligero_tpu"] = None

LOG2_GATES, SEED = 20, 0  # BASELINE.json config #5, the repo's headline size
ZK_SEED = bytes(range(32))
# NVIDIA H100 SXM data sheet: device memory rate; 32-bit integer rate taken
# as a quarter of the 67 TFLOP/s float32 figure (that one counts two
# operations per FMA on 128 lanes per SM; integer has 64 lanes, one each)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 16.75e12
# 32-bit integer operations: one 8-word CIOS Montgomery product (64 products
# and 64 reduction multiply-adds with their carries); one Blake2s block
# (10 rounds x 8 G x 14 operations, plus state set-up); one SHA-256
# two-to-one (128 rounds x ~24, plus 48 schedule words x 13)
MONT_MUL_OPS, BLAKE2S_BLOCK_OPS, SHA256_NODE_OPS = 160, 1160, 3700
ELEM = 64  # bytes of one field element as 16 int32 limbs
KERNELS = {
    # name: (wrapper module, source, TPU kernel replaced)
    "ntt": ("cuda_ntt", "ligero_tpu_torch/csrc/ntt.cu",
            "ligero_tpu/engine/mxu_ntt.py:535"),
    "mont_mul": ("cuda_mont", "ligero_tpu_torch/csrc/mont_mul.cu",
                 "ligero_tpu/engine/pallas_kernels.py:30"),
    "blake2s_cols": ("cuda_hash", "ligero_tpu_torch/csrc/blake2s_cols.cu",
                     "ligero_tpu/engine/pallas_hash.py:39"),
    "row_combine": ("cuda_lc", "ligero_tpu_torch/csrc/row_combine.cu",
                    "ligero_tpu/engine/mxu_lc.py:137"),
    "sha256_tree": ("cuda_tree", "ligero_tpu_torch/csrc/sha256_tree.cu",
                    "ligero_tpu/engine/pallas_tree.py:77"),
}


class SmokeFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    require(res.returncode == 0 and res.stdout.strip(),
            f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def wrappers():
    from ligero_tpu_torch.engine import (cuda_hash, cuda_lc, cuda_mont,
                                         cuda_ntt, cuda_tree)
    mods = {"cuda_ntt": cuda_ntt, "cuda_mont": cuda_mont,
            "cuda_hash": cuda_hash, "cuda_lc": cuda_lc,
            "cuda_tree": cuda_tree}
    return {name: mods[spec[0]] for name, spec in KERNELS.items()}


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _rand_elems(torch, gen, shape, field, below_r=False):
    """Random limbs < 2^16: below R, or reduced below p (top limb cut)."""
    limbs = torch.randint(0, 1 << 16, tuple(shape) + (16,), generator=gen,
                          dtype=torch.int32, device="cuda")
    if not below_r:
        top = field.p >> (16 * 15)
        limbs[..., 15] = torch.remainder(limbs[..., 15], top)
    return limbs


def _time_cuda(torch, fn, iters: int) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _time_once(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """(least ms the card could take, what bounds it) for work that must
    move ``nbytes`` and do ``ops`` 32-bit integer operations."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / INT32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def ntt_work(rows: int, w: int, n: int, epilogue: bool):
    """Bytes and operations of a batched NTT: w-wide rows and the twiddles
    in, n-wide rows out; n/2 log2 n butterflies a row, one product each."""
    products = rows * ((n // 2) * (n.bit_length() - 1) + (n if epilogue else 0))
    return (rows * (w + n) * ELEM + (n // 2) * ELEM // 2,
            products * MONT_MUL_OPS)


def blake2s_work(rows: int, cols: int):
    blocks = -(-(8 + 32 * rows) // 64)
    return rows * cols * ELEM + cols * 32, cols * blocks * BLAKE2S_BLOCK_OPS


def row_combine_work(rows: int, k: int):
    return (rows * k + rows + k) * ELEM, rows * k * (MONT_MUL_OPS + 10)


def tree_work(n: int):
    return n * 32 + (2 * n - 1) * 32, (n - 1) * SHA256_NODE_OPS


def phase_kernels(torch, field, dims, zk_dims) -> dict:
    """Each kernel on the card vs its plain version, same inputs, at the
    shapes of both main paths (dims = m, k, n, nnz of A; zk_dims = b, d2).
    Returns per-kernel results; the first case of a kernel gives its
    reported times and bound."""
    from ligero_tpu_torch.engine import (cuda_hash, cuda_lc, cuda_mont,
                                         cuda_ntt, cuda_tree, fieldops,
                                         hashops, ntt)
    m, k, n, nnz = dims
    b, d2 = zk_dims
    rows, kb = 4 * m, k + b
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20)
    mm = lambda a, b: cuda_mont.mont_mul(field, a, b)  # noqa: E731

    def elems(*shape, below_r=False):
        return lambda: _rand_elems(torch, gen, shape, field, below_r)

    def pair(f, g):
        return lambda: (f(), g())

    def leaves(count):
        return lambda: torch.randint(-2**31, 2**31, (count, 8), generator=gen,
                                     dtype=torch.int64,
                                     device="cuda").to(torch.int32)

    def ntt_case(label, batch, w, size, inverse=False, canon=False):
        return ("ntt", f"{label}, {batch} x {w} -> {size} "
                f"[route {route_text(cuda_ntt.route(w, size, batch))}]",
                elems(batch, w),
                lambda x: cuda_ntt.ntt(field, x, size, inverse, canon),
                lambda x: ntt.ntt_ref(field, x, size, inverse, canon),
                ntt_work(batch, w, size, inverse or canon))

    cases = [
        # (kernel, label, input maker, kernel call, plain call, (bytes, ops))
        ntt_case(f"NTT_n n={n} canon_out", 256, k, n, canon=True),
        ntt_case(f"iNTT_k k={k}", rows, k, k, inverse=True),
        ntt_case(f"NTT_2k 2k={2 * k}", rows, k, 2 * k),
        ntt_case(f"iNTT_2k 2k={2 * k}", 1, 2 * k, 2 * k, inverse=True),
        # zk shapes: the encode from d2-wide rows, a width that is not a
        # power of two, the products' d2 domain
        ntt_case(f"zk NTT_n n={n} canon_out", 256, d2, n, canon=True),
        ntt_case(f"zk NTT_n n={n} canon_out, w = k + b", 256, kb, n, canon=True),
        ntt_case(f"zk NTT_d2 d2={d2} of k + b", rows, kb, d2),
        ntt_case(f"zk NTT_d2 d2={d2} of k", rows, k, d2),
        ntt_case(f"zk iNTT_d2 d2={d2}", 1, d2, d2, inverse=True),
        ("mont_mul", f"mont_mul a<R x b<p, nnz={nnz}",
         pair(elems(nnz, below_r=True), elems(nnz)),
         lambda ab: mm(*ab), lambda ab: fieldops.mont_mul(field, *ab),
         (3 * nnz * ELEM, nnz * MONT_MUL_OPS)),
        ("blake2s_cols", f"Blake2s columns {rows} x 1024", elems(rows, 1024),
         cuda_hash.blake2s_columns, hashops.blake2s_columns_ref,
         blake2s_work(rows, 1024)),
        ("blake2s_cols", f"zk Blake2s columns {rows + 3} x 256 (odd row count)",
         elems(rows + 3, 256),
         cuda_hash.blake2s_columns, hashops.blake2s_columns_ref,
         blake2s_work(rows + 3, 256)),
        ("row_combine", f"row_combine {rows} x {k}",
         pair(elems(rows), elems(rows, k)),
         lambda rm: cuda_lc.row_combine(field, *rm),
         lambda rm: cuda_lc.row_combine_ref(field, *rm),
         row_combine_work(rows, k)),
        ("row_combine", f"zk row_combine {rows} x {kb}",
         pair(elems(rows), elems(rows, kb)),
         lambda rm: cuda_lc.row_combine(field, *rm),
         lambda rm: cuda_lc.row_combine_ref(field, *rm),
         row_combine_work(rows, kb)),
        ("sha256_tree", f"SHA-256 tree n={n}", leaves(n),
         cuda_tree.tree_flat, hashops.tree_flat, tree_work(n)),
    ]
    results: dict = {}
    for name, label, make, kern, plain, work in cases:
        inp = make()
        got, _ = _time_once(torch, lambda: kern(inp))
        want, plain_ms = _time_once(torch, lambda: plain(inp))
        require(got.shape == want.shape and got.dtype == want.dtype,
                f"{label}: shape/dtype {tuple(got.shape)} {got.dtype} vs "
                f"{tuple(want.shape)} {want.dtype}")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        ms = _time_cuda(torch, lambda: kern(inp), iters=5)
        bound_ms, bound_by = bound(*work)
        log(f"kernel {label}: max_abs_err={err} kernel {ms:.4f} ms, "
            f"plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by}")
        require(err == 0, f"{label}: kernel disagrees with its plain version")
        res = results.setdefault(name, {
            "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by})
        res["max_abs_err"] = max(res["max_abs_err"], err)
        del got, want, inp
        torch.cuda.empty_cache()
    results["ntt"]["max_abs_err"] = max(
        results["ntt"]["max_abs_err"], ntt_route_cases(torch, field, gen))
    tree_bit_equality(torch, gen)
    results["sha256_tree"]["chain_floor_ms"] = tree_chain_floor(torch, n)
    # the commit's full-width NTT_n, column hash and tree (all rows, all n
    # columns; zk: 4m + 3 rows from d2-wide coefficients), kernel only
    for label, nrows, w in (("", rows, k), ("zk ", rows + 3, d2)):
        x = _rand_elems(torch, gen, (nrows, w), field)
        ms = _time_cuda(torch, lambda: cuda_ntt.ntt(field, x, n, canon_out=True),
                        iters=3)
        log(f"kernel {label}NTT_n n={n} canon_out, full {nrows} x {w} -> {n}: "
            f"{ms:.3f} ms, bound "
            "%.3f ms by %s" % bound(*ntt_work(nrows, w, n, True)))
        u = cuda_ntt.ntt(field, x, n, canon_out=True)
        del x
        ms = _time_cuda(torch, lambda: cuda_hash.blake2s_columns(u), iters=3)
        log(f"kernel {label}Blake2s columns, full {nrows} x {n}: {ms:.3f} ms, "
            "bound %.3f ms by %s" % bound(*blake2s_work(nrows, n)))
        del u
        torch.cuda.empty_cache()
    # context only: the host's hashlib over the same n - 1 two-to-one hashes
    digests = [os.urandom(32) for _ in range(n)]
    t0 = time.perf_counter()
    while len(digests) > 1:
        digests = [hashlib.sha256(digests[i] + digests[i + 1]).digest()
                   for i in range(0, len(digests), 2)]
    log(f"context: host hashlib, {n - 1} SHA-256 two-to-one hashes: "
        f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
    return results


def route_text(rt) -> str:
    """An NTT route in a few words: its name, cosets and sub-transforms."""
    split = " x ".join(str(1 << l) for l in (rt.l0, rt.l1, rt.l2) if l)
    return f"{rt.name}, {1 << rt.lc} coset(s) of {split or 1}"


def ntt_route_cases(torch, field, gen) -> int:
    """The NTT kernel against its plain version where its routes meet: w = n
    and w < n at n = 2, 1024, 2048, 4096 (one pass, cosets); w = 1, w = s,
    w = s + 1 and a width that is no power of two at n = 16384 (cosets);
    n = 8192, 65536 and 2^17 (two passes), alone and under cosets; single
    rows, which take two passes at any size.  Small batches, every
    combination of inverse and canon_out.  Returns the
    largest absolute difference seen (0 or the run fails)."""
    from ligero_tpu_torch.engine import cuda_ntt, ntt
    shapes = [(5, 2, 2), (5, 1, 2), (5, 1024, 1024), (5, 100, 1024),
              (5, 2048, 2048), (5, 1500, 2048), (5, 4096, 4096),
              (5, 2049, 4096), (5, 1, 16384), (5, 2048, 16384),
              (5, 2049, 16384), (5, 1000, 16384), (2, 8192, 8192),
              (2, 5000, 16384), (2, 65536, 65536), (1, 1 << 17, 1 << 17),
              (1, 40000, 1 << 17),
              # single rows: split in two passes so that they fill the card
              (1, 2048, 2048), (1, 2048, 4096), (1, 4095, 16384)]
    worst = 0
    for batch, w, size in shapes:
        x = _rand_elems(torch, gen, (batch, w), field)
        errs = []
        for inverse in (False, True):
            for canon in (False, True):
                got = cuda_ntt.ntt(field, x, size, inverse, canon)
                want = ntt.ntt_ref(field, x, size, inverse, canon)
                errs.append(int((got.to(torch.int64)
                                 - want.to(torch.int64)).abs().max()))
        worst = max(worst, *errs)
        log(f"kernel NTT {batch} x {w} -> {size}, inverse x canon_out: "
            f"max_abs_err={max(errs)} [route "
            f"{route_text(cuda_ntt.route(w, size, batch))}]")
        require(max(errs) == 0, f"NTT {batch} x {w} -> {size}: kernel "
                "disagrees with its plain version")
    return worst


def tree_chain_floor(torch, n: int) -> float:
    """The least a tree of n leaves can take on this card, in ms: its
    log2 n levels are a chain of dependent two-to-one hashes, timed here
    as one warp hashing its own output over and over (the difference of a
    long and a short chain, so that the launch cancels)."""
    from ligero_tpu_torch.engine import cuda_tree
    dev = torch.device("cuda")
    short, long_ = 16, 272
    per_hash = (min(cuda_tree.chain_probe_ms(long_, dev) for _ in range(3))
                - min(cuda_tree.chain_probe_ms(short, dev) for _ in range(3))
                ) / (long_ - short)
    levels = n.bit_length() - 1
    log(f"kernel SHA-256 tree n={n}: chain floor {levels * per_hash:.4f} ms "
        f"({levels} levels x {per_hash * 1e3:.3f} us a dependent two-to-one "
        f"hash, {per_hash * 1e6 / 128:.2f} ns a round)")
    return levels * per_hash


def tree_bit_equality(torch, gen) -> None:
    """The tree kernel against the plain SHA-256 levels at small, split and
    large n and around its 64-node groups, 20 fresh inputs each, then 100
    times on one input at n = 16384 (a wrong last-block handshake would
    show as a rare stale read).  The plain levels run over the 20 trees
    side by side (pairs never cross a tree: n is a power of two)."""
    from ligero_tpu_torch.engine import cuda_tree, hashops
    reps = 20
    for n in (2, 4, 32, 64, 128, 512, 1024, 2048, 4096, 8192, 65536):
        forest = torch.randint(-2**31, 2**31, (reps, n, 8), generator=gen,
                               dtype=torch.int64, device="cuda").to(torch.int32)
        got = [cuda_tree.tree_flat(forest[r]) for r in range(reps)]
        level = hashops._byteswap(hashops._words64(forest.reshape(-1, 8)))
        off, width = 8 * n, n
        for r in range(reps):
            require(torch.equal(got[r][:off], forest[r].reshape(-1)),
                    f"sha256_tree n={n}: leaves not copied (input {r})")
        while width > 1:
            level = hashops.sha256_two_to_one(level[0::2], level[1::2])
            width //= 2
            want = hashops._to_i32(level).reshape(reps, width * 8)
            for r in range(reps):
                require(torch.equal(got[r][off:off + 8 * width], want[r]),
                        f"sha256_tree n={n}: level of {width} nodes differs "
                        f"(input {r})")
            off += 8 * width
        log(f"kernel SHA-256 tree n={n}: bit-equal on {reps} fresh inputs "
            f"({len(cuda_tree.tree_steps(n))} step(s) in one launch)")
    n = 16384
    leaves = torch.randint(-2**31, 2**31, (n, 8), generator=gen,
                           dtype=torch.int64, device="cuda").to(torch.int32)
    want = hashops.tree_flat(leaves)
    for rep in range(100):
        require(torch.equal(cuda_tree.tree_flat(leaves), want),
                f"sha256_tree n={n}: run {rep} of 100 on one input differs")
    log(f"kernel SHA-256 tree n={n}: 100 runs on one input all bit-equal to "
        "the plain version")


# ---------------------------------------------------------------------------
# phase 4: byte parity: card = CPU = the JAX package's recorded digests
# ---------------------------------------------------------------------------

def golden_circuit(field, entry):
    """(circuit, outputs, prove call) of one ``golden_proofs.json`` entry."""
    from ligero_tpu_torch import ArithmeticCircuit
    from ligero_tpu_torch.synthetic import generate_random_circuit
    kw = {"zk_seed": bytes.fromhex(entry["zk_seed"])} if entry["zk"] else {}
    if entry["circuit"] == "cube":
        c = ArithmeticCircuit(field)
        x = c.new_variable_with_label("x")
        c.add(c.pow(x, 3), c.constant(-26))
        return c, [c.last()], lambda lig, sp: lig.prove_with_labels(
            [("x", 3)], sp, **kw)
    circ, outs, vars_ = generate_random_circuit(
        field, entry["gates"], num_vars=entry["num_vars"], seed=entry["seed"])
    return circ, outs, lambda lig, sp: lig.prove(vars_, sp, **kw)


def phase_parity(field) -> None:
    from ligero_tpu_torch import LigeroCircuit, test_sponge

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "ligero_tpu_torch", "testdata", "golden_proofs.json")
    with open(path) as f:
        entries = json.load(f)["proofs"]
    require(len(entries) >= 5, "golden_proofs.json holds too few cases")
    sponge = test_sponge(field)
    for entry in entries:
        circ, outs, prove = golden_circuit(field, entry)
        kw = dict(lambda_=entry["lambda"], zk=entry["zk"])
        on_card = LigeroCircuit(circ, outs, device="cuda", **kw)
        on_cpu = LigeroCircuit(circ, outs, device="cpu", **kw)
        got = prove(on_card, sponge.clone())
        data = got.to_bytes(field)
        same = data == prove(on_cpu, sponge.clone()).to_bytes(field)
        golden = (len(data) == entry["length"]
                  and hashlib.sha256(data).hexdigest() == entry["sha256"])
        ok_cpu = on_cpu.verify(got, sponge.clone())
        ok_card = on_card.verify(got, sponge.clone())
        log(f"parity {entry['name']}: card bytes = CPU bytes: {same}, = the "
            f"JAX package's digest: {golden}, CPU verifies: {ok_cpu}, card "
            f"verifies: {ok_card}")
        require(same and golden and ok_cpu and ok_card,
                f"parity failed: {entry['name']}")


# ---------------------------------------------------------------------------
# phase 5: the main paths at 2^20 gates
# ---------------------------------------------------------------------------

def make_circuit(field, log2_gates: int, seed: int):
    from ligero_tpu_torch.synthetic import generate_random_circuit
    t0 = time.perf_counter()
    circ, outs, vars_ = generate_random_circuit(field, 1 << log2_gates,
                                                seed=seed)
    log(f"circuit 2^{log2_gates} gates generated "
        f"({time.perf_counter() - t0:.1f} s, {circ.num_nodes()} nodes)")
    return circ, outs, vars_


def build_instance(circ, outs, zk: bool):
    """A main path's instance: the synthetic circuit compiled for the card
    (no ``device`` given: the card is the default)."""
    from ligero_tpu_torch import LigeroCircuit
    from ligero_tpu_torch.utils.profiling import PhaseTimer

    t0 = time.perf_counter()
    lig = LigeroCircuit(circ, outs, zk=zk, timer=PhaseTimer(enabled=True))
    require(lig.device.type == "cuda", "the default device is not the card")
    log(f"LigeroCircuit(zk={zk}) built ({time.perf_counter() - t0:.1f} s): "
        f"m={lig.m} k={lig.k} n={lig.n} t={lig.t} b={lig.blind_t} "
        f"d2={lig.d2}, U is {lig.num_rows} x {lig.n}, "
        f"nnz(A)={len(lig.state.a_vals)}")
    return lig


def phase_main(torch, field, lig, vars_) -> dict:
    """Drive one main path (plain or zk, as ``lig`` was compiled); returns
    the kernels' launch counts of its first prove + verify."""
    from ligero_tpu_torch import LigeroProof, test_sponge

    timer = lig.timer
    sponge = test_sponge(field)
    wraps = wrappers()
    tag = "zk " if lig.zk else ""
    kw = {"zk_seed": ZK_SEED} if lig.zk else {}

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    timer.reset()
    for mod in wraps.values():
        mod.launches.reset()
    t0 = time.perf_counter()
    proof = lig.prove(vars_, sponge.clone(), **kw)
    prove_s = time.perf_counter() - t0
    prove_phases = dict(timer.totals)
    timer.reset()
    t0 = time.perf_counter()
    ok = lig.verify(proof, sponge.clone())
    verify_s = time.perf_counter() - t0
    launches = {name: mod.launches.count for name, mod in wraps.items()}
    verify_phases = dict(timer.totals)
    peak = torch.cuda.max_memory_allocated()
    log(f"{tag}prove #1: {prove_s:.3f} s; verify: {ok} ({verify_s:.3f} s); "
        f"peak device memory {peak / 2**30:.2f} GiB")
    for name, secs in sorted(prove_phases.items(), key=lambda kv: -kv[1]):
        log(f"  {tag}prove  {name:22s} {secs * 1e3:10.1f} ms")
    for name, secs in sorted(verify_phases.items(), key=lambda kv: -kv[1]):
        log(f"  {tag}verify {name:22s} {secs * 1e3:10.1f} ms")
    log(f"kernel launches on the {tag}main path: {launches}")
    require(ok, "verify rejected the honest proof")
    require(all(v > 0 for v in launches.values()),
            f"a kernel was not launched on the {tag}main path: {launches}")

    timer.reset()
    t0 = time.perf_counter()
    proof2 = lig.prove(vars_, sponge.clone(), **kw)
    log(f"{tag}prove #2: {time.perf_counter() - t0:.3f} s")
    for name, secs in sorted(timer.totals.items(), key=lambda kv: -kv[1]):
        log(f"  {tag}prove #2 {name:20s} {secs * 1e3:10.1f} ms")
    data = proof.to_bytes(field)
    require(proof2.to_bytes(field) == data, "two proofs differ")
    log(f"two {tag}proofs byte-identical ({len(data)} bytes)")
    del proof2

    bad_vars = [(vars_[0][0], (vars_[0][1] + 1) % field.p)] + vars_[1:]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        bad = lig.prove(bad_vars, sponge.clone(), **kw)
    bad_ok = lig.verify(bad, sponge.clone())
    log(f"{tag}tampered witness: verify={bad_ok} (expect False)")
    require(not bad_ok, "a proof of a tampered witness verified")
    del bad

    flipped = bytearray(data)
    flipped[8 + 32 + 8] ^= 1  # low byte of the first interleaved lc element
    try:
        flip_ok = lig.verify(LigeroProof.from_bytes(bytes(flipped), field),
                             sponge.clone())
    except ValueError as e:
        log(f"{tag}flipped byte: deserializer rejects ({e})")
        flip_ok = False
    log(f"{tag}flipped byte: verify={flip_ok} (expect False)")
    require(not flip_ok, "a proof with a flipped byte verified")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ligero_tpu_torch import BN254_FR
    from ligero_tpu_torch.engine import cuda_build

    field = BN254_FR
    smi = nvidia_smi_line()
    log(f"device: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi: {smi}")

    t0 = time.perf_counter()
    cuda_build.library()
    log(f"kernels built from {cuda_build.CSRC} in "
        f"{time.perf_counter() - t0:.1f} s")
    if os.path.exists(cuda_build.LOG_PATH):
        with open(cuda_build.LOG_PATH) as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    log("ptxas: " + line.strip())

    circ, outs, vars_ = make_circuit(field, LOG2_GATES, SEED)
    lig = build_instance(circ, outs, zk=False)
    zk_dims = (3 * lig.t, max(2 * lig.k, 1 << (
        2 * (lig.k + 3 * lig.t) - 2).bit_length()))
    results = phase_kernels(torch, field, (lig.m, lig.k, lig.n,
                                           len(lig.state.a_vals)), zk_dims)
    phase_parity(field)
    launches = phase_main(torch, field, lig, vars_)
    del lig
    torch.cuda.empty_cache()
    lig = build_instance(circ, outs, zk=True)
    require((lig.blind_t, lig.d2) == zk_dims, "zk kernel shapes were not the "
            f"zk path's: {zk_dims} vs {(lig.blind_t, lig.d2)}")
    zk_launches = phase_main(torch, field, lig, vars_)
    for mod in ("jax", "ligero_tpu"):
        require(sys.modules.get(mod) is None, f"{mod} was imported")

    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name] + zk_launches[name],
         "launches_by_path": {"plain": launches[name], "zk": zk_launches[name]},
         "max_abs_err": results[name]["max_abs_err"],
         "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"],
         "bound_ms": results[name]["bound_ms"],
         "bound_by": results[name]["bound_by"],
         # no single PyTorch call computes any of these functions
         "library_ms": None,
         **({"chain_floor_ms": results[name]["chain_floor_ms"]}
            if "chain_floor_ms" in results[name] else {})}
        for name, (_, src, rep) in KERNELS.items()]}
    print(smi, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
