"""Plain PyTorch field arithmetic of the port (ligero_tpu_torch.engine.fieldops,
the CPU path of the mont_mul kernel's wrapper) against the JAX package's
numpy FieldKernel, bit for bit (tolerance 0: exact field arithmetic)."""

import os
import re

import numpy as np
import pytest
import torch

from ligero_tpu.engine.fieldops import FieldKernel
from ligero_tpu.fields import BLS12_377_FQ, BN254_FR
from ligero_tpu_torch.engine import cuda_build, cuda_mont, fieldops
from ligero_tpu_torch.fields import FIELDS as PORT_FIELDS

# the suite runs in several worker processes that share the host's cores, and
# these tests run many small tensor ops: one intra-op thread each, or the
# workers' thread pools spin against each other
torch.set_num_threads(1)


def pf(field):
    """The port's own FieldSpec for a JAX-package one."""
    return PORT_FIELDS[field.name]

FIELDS = [BN254_FR, BLS12_377_FQ]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def rand_reduced(field, rng, shape):
    """Limbs of uniformly random elements below p."""
    ints = [int.from_bytes(rng.bytes(field.num_limbs * 2), "little") % field.p
            for _ in range(int(np.prod(shape)))]
    return field.ints_to_limbs(ints).reshape(*shape, field.num_limbs)


def t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.int32))


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_mont_mul_add_sub_match_fieldkernel(field):
    rng = np.random.default_rng(1)
    fk = FieldKernel(field, np)
    a, b = rand_reduced(field, rng, (40, 3)), rand_reduced(field, rng, (40, 3))
    assert np.array_equal(fieldops.mont_mul(pf(field), t(a), t(b)).numpy(),
                          fk.mont_mul(a, b))
    assert np.array_equal(fieldops.add(pf(field), t(a), t(b)).numpy(), fk.add(a, b))
    assert np.array_equal(fieldops.sub(pf(field), t(a), t(b)).numpy(), fk.sub(a, b))
    assert np.array_equal(fieldops.sub(pf(field), t(b), t(a)).numpy(), fk.sub(b, a))


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_mont_mul_a_below_r(field):
    """The sparse r^T A fold feeds a < R (any 16-bit limbs) with b < p; the
    product must still come out fully reduced."""
    rng = np.random.default_rng(2)
    fk = FieldKernel(field, np)
    a = rng.integers(0, 1 << 16, size=(64, field.num_limbs)).astype(np.uint32)
    a[0] = 0xFFFF  # R - 1
    b = rand_reduced(field, rng, (64,))
    got = fieldops.mont_mul(pf(field), t(a), t(b)).numpy()
    assert np.array_equal(got, fk.mont_mul(a, b))
    vals = field.limbs_to_ints(got.astype(np.uint32))
    assert all(v < field.p for v in vals)


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_sum_mod_and_montgomery_conversions(field):
    rng = np.random.default_rng(3)
    fk = FieldKernel(field, np)
    a = rand_reduced(field, rng, (37, 5))
    assert np.array_equal(fieldops.sum_mod(pf(field), t(a), 0).numpy(),
                          fk.sum_mod(a, axis=0))
    assert np.array_equal(fieldops.sum_mod(pf(field), t(a), 1).numpy(),
                          fk.sum_mod(a, axis=1))
    assert np.array_equal(fieldops.to_mont(pf(field), t(a)).numpy(), fk.to_mont(a))
    assert np.array_equal(fieldops.from_mont(pf(field), t(a)).numpy(),
                          fk.from_mont(a))


@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_fold_wide_reduces_int64_limb_sums(field):
    rng = np.random.default_rng(4)
    s = rng.integers(0, 1 << 48, size=(20, field.num_limbs), dtype=np.int64)
    got = field.limbs_to_ints(
        fieldops.fold_wide(pf(field), torch.from_numpy(s)).numpy().astype(np.uint32))
    want = [sum(int(v) << (16 * j) for j, v in enumerate(row)) % field.p
            for row in s]
    assert got == want


def test_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(5)
    a, b = rand_reduced(BN254_FR, rng, (8,)), rand_reduced(BN254_FR, rng, (8,))
    before = cuda_mont.launches.count
    got = cuda_mont.mont_mul(pf(BN254_FR), t(a), t(b))
    assert cuda_mont.launches.count == before
    assert torch.equal(got, fieldops.mont_mul(pf(BN254_FR), t(a), t(b)))


def test_field_header_constants_match_bn254():
    """csrc/field.cuh hard-codes p and -p^-1 mod 2^32 for its CIOS."""
    path = os.path.join(os.path.dirname(cuda_mont.__file__), "..", "csrc",
                        "field.cuh")
    with open(path) as f:
        src = f.read()
    words = re.search(r"constexpr uint32_t P\[W\] = \{([^}]*)\}", src).group(1)
    p_words = [int(w.strip().rstrip("u"), 16) for w in words.split(",")]
    assert sum(w << (32 * i) for i, w in enumerate(p_words)) == BN254_FR.p
    np0 = int(re.search(r"NP0 = (0x[0-9a-fA-F]+)u", src).group(1), 16)
    assert np0 == (-pow(BN254_FR.p, -1, 1 << 32)) % (1 << 32)


# ---------------------------------------------------------------------------
# csrc/field.cuh's PTX carry chains, parsed from the source and run here
# ---------------------------------------------------------------------------

M32 = (1 << 32) - 1


def _operands(part: str) -> list[str]:
    """The C expressions of an asm operand list: "constraint"(expr), ..."""
    exprs, i = [], 0
    while (i := part.find('"(', i)) >= 0:
        depth, j = 1, i + 2
        while depth:
            depth += {"(": 1, ")": -1}.get(part[j], 0)
            j += 1
        exprs.append(part[i + 2:j - 1])
        i = j
    return exprs


def field_header_asm():
    """{function: [(instructions, output exprs, input exprs), ...]} for every
    asm statement of csrc/field.cuh, in source order."""
    path = os.path.join(os.path.dirname(cuda_mont.__file__), "..", "csrc",
                        "field.cuh")
    with open(path) as f:
        src = f.read()
    out = {}
    for fn in re.finditer(r"__forceinline__ [\w ]+?(\w+)\(", src):
        end = src.find("\n}\n", fn.end())
        body = src[fn.end():end]
        stmts = []
        for m in re.finditer(r"asm\((.*?)\);", body, re.S):
            # the instruction strings hold no colon: code : outputs : inputs
            code, outs, ins = (m.group(1).split(":") + [""])[:3]
            instrs = [i.strip() for line in re.findall(r'"(.*?)"', code)
                      for i in line.replace("\\n\\t", "").split(";") if i.strip()]
            stmts.append((instrs, _operands(outs), _operands(ins)))
        if stmts:
            out[fn.group(1)] = stmts
    return out


def run_asm(stmt, env, wraps=False):
    """Execute one parsed asm statement; ``env`` maps operand expressions to
    [container, key] (mutable) or an int; outputs are written through it.
    A carry out of an instruction that does not keep it fails the test,
    unless the statement ``wraps`` mod 2^256 by design."""
    instrs, outs, ins = stmt
    exprs = outs + ins

    def get(tok):
        if tok.startswith("%"):
            ref = env(exprs[int(tok[1:])])
            return ref if isinstance(ref, int) else ref[0][ref[1]]
        return int(tok, 0)

    def put(tok, val):
        ref = env(exprs[int(tok[1:])])
        ref[0][ref[1]] = val & M32

    cc = 0
    for ins_text in instrs:
        op, rest = ins_text.split(None, 1)
        args = [a.strip() for a in rest.split(",")]
        parts = op.split(".")
        name, sets_cc = parts[0], "cc" in parts
        carry_in = cc if name in ("addc", "subc", "madc") else 0
        if name in ("add", "addc"):
            v = get(args[1]) + get(args[2]) + carry_in
            put(args[0], v)
            new_cc = v >> 32
        elif name in ("sub", "subc"):
            v = get(args[1]) - get(args[2]) - carry_in
            put(args[0], v)
            new_cc = int(v < 0)
        else:
            assert name in ("mad", "madc"), op
            prod = get(args[1]) * get(args[2])
            v = ((prod & M32) if "lo" in parts else prod >> 32) \
                + get(args[3]) + carry_in
            put(args[0], v)
            new_cc = v >> 32
        if sets_cc:
            cc = new_cc
        else:
            assert new_cc == 0 or wraps or name == "subc", ("carry lost",
                                                            ins_text)


def emulated_field_ops():
    """fe_mont_mul, fe_add, fe_sub of field.cuh on Python ints: the asm
    statements as parsed, the C++ around them mirrored here."""
    asm = field_header_asm()
    P = [(BN254_FR.p >> (32 * j)) & M32 for j in range(8)]
    np0 = (-pow(BN254_FR.p, -1, 1 << 32)) & M32
    words = lambda v: [(v >> (32 * j)) & M32 for j in range(8)]  # noqa: E731
    value = lambda w: sum(x << (32 * j) for j, x in enumerate(w))  # noqa: E731

    def resolver(**names):
        def env(expr):
            expr = expr.strip()
            m = re.fullmatch(r"p_word\((\d)\) & (\w+)", expr)
            if m:
                return P[int(m.group(1))] & names[m.group(2)][0]
            m = re.fullmatch(r"(\w+)(?:\.w)?\[(\d+)\]", expr)
            if m:
                return [names[m.group(1)], int(m.group(2))]
            return [names[expr], 0]
        return env

    def sub_p(t):
        d, borrow = [0] * 8, [0]
        run_asm(asm["sub_p"][0], resolver(d=d, t=t, borrow=borrow))
        return borrow[0] == 0, d

    def add(a, b):
        s = [0] * 8
        run_asm(asm["fe_add"][0], resolver(s=s, a=words(a), b=words(b)))
        ge, d = sub_p(s)
        return value(d if ge else s)

    def sub(a, b):
        d, borrow = [0] * 8, [0]
        env = resolver(d=d, a=words(a), b=words(b), borrow=borrow)
        run_asm(asm["fe_sub"][0], env)
        run_asm(asm["fe_sub"][1], env, wraps=True)   # a - b + 2^256 + p
        return value(d)

    def step(e, o, v, b):
        env = resolver(e=e, o=o, v=v, b=[b])
        for stmt in asm["cios_step"]:
            run_asm(stmt, env)

    def reduce(e, o):
        env = resolver(e=e, o=o, m=[(e[0] * np0) & M32])
        for stmt in asm["cios_reduce"]:
            run_asm(stmt, env)

    def mont_mul(a, b):
        aw, bw = words(a), words(b)
        x, y = [0] * 8, [0] * 8
        for j in range(0, 8, 2):
            ev, od = bw[j] * aw[0], bw[j + 1] * aw[0]
            x[j], x[j + 1], y[j], y[j + 1] = ev & M32, ev >> 32, od & M32, od >> 32
        reduce(x, y)
        for i in range(1, 8, 2):
            step(y, x, bw, aw[i])
            reduce(y, x)
            if i + 1 < 8:
                step(x, y, bw, aw[i + 1])
                reduce(x, y)
        r, top = [0] * 8, [0]
        run_asm(asm["fe_mont_mul"][0], resolver(r=r, top=top, x=x, y=y))
        ge, d = sub_p(r)
        return value(d if (top[0] or ge) else r)

    return mont_mul, add, sub


def test_field_header_carry_chains_emulated():
    """The PTX of csrc/field.cuh, instruction for instruction, gives REDC(a b)
    fully reduced for a < R and b < p (no carry lost, at the extremes too),
    and a +- b mod p."""
    import random
    mont_mul, add, sub = emulated_field_ops()
    p, R = BN254_FR.p, 1 << 256
    r_inv = pow(R, -1, p)
    rnd = random.Random(11)
    pairs = [(R - 1, p - 1), (p - 1, p - 1), (0, 0), (1, 1), (R - 1, 1),
             (R - 1, 1 << 253), (p, p - 1), (0, p - 1), (R - 1, 0)]
    pairs += [(rnd.randrange(R), rnd.randrange(p)) for _ in range(300)]
    pairs += [(R - 1 - rnd.randrange(1 << 40), p - 1 - rnd.randrange(1 << 40))
              for _ in range(100)]
    for a, b in pairs:
        assert mont_mul(a, b) == a * b * r_inv % p, (hex(a), hex(b))
    sums = [(p - 1, p - 1), (0, 0), (p - 1, 1), (0, p - 1), (1, p - 1)]
    sums += [(rnd.randrange(p), rnd.randrange(p)) for _ in range(300)]
    for a, b in sums:
        assert add(a, b) == (a + b) % p, (hex(a), hex(b))
        assert sub(a, b) == (a - b) % p, (hex(a), hex(b))


def test_field_header_chains_use_the_modulus_words():
    """Every word of p stands as an immediate in the reduction chains: the
    odd words feed o, the even words e, all eight the subtraction."""
    asm = field_header_asm()
    P = [(BN254_FR.p >> (32 * j)) & M32 for j in range(8)]

    def immediates(stmt):
        return [int(x, 16) for i in stmt[0] for x in re.findall(r"0x[0-9a-f]{8}", i)]

    odd, even = asm["cios_reduce"]
    assert immediates(odd) == [w for w in P[1::2] for _ in range(2)]
    assert immediates(even) == [w for w in P[0::2] for _ in range(2)]
    assert immediates(asm["sub_p"][0]) == P


@pytest.mark.cuda
def test_mont_mul_kernel_matches_plain(cuda):
    rng = np.random.default_rng(6)
    a = rng.integers(0, 1 << 16, size=(5000, 16)).astype(np.int32)
    b = rand_reduced(BN254_FR, rng, (5000,))
    want = fieldops.mont_mul(pf(BN254_FR), t(a), t(b))
    got = cuda_mont.mont_mul(pf(BN254_FR), t(a).to(cuda), t(b).to(cuda))
    assert torch.equal(got.cpu(), want)
    got_b = cuda_mont.mont_mul(pf(BN254_FR), t(a).to(cuda), t(b[0]).to(cuda))
    assert torch.equal(got_b.cpu(), fieldops.mont_mul(pf(BN254_FR), t(a), t(b[0])))


@pytest.mark.cuda
@pytest.mark.parametrize("count", [1, 31, 32, 33, 255, 256, 257, 8191])
def test_mont_mul_kernel_partial_warps(cuda, count):
    """The kernel stores a warp's results as one run: counts that end inside
    a warp or a block write their own elements and nothing past them."""
    rng = np.random.default_rng(count)
    a = t(rng.integers(0, 1 << 16, size=(count + 2, 16)).astype(np.int32))
    b = t(rand_reduced(BN254_FR, rng, (count + 2,)))
    want = fieldops.mont_mul(pf(BN254_FR), a[:count], b[:count])
    assert torch.equal(
        cuda_mont.mont_mul(pf(BN254_FR), a[:count].to(cuda), b[:count].to(cuda)).cpu(),
        want)
    # the C entry point on a longer output: the two rows past count stay
    out = torch.full((count + 2, 16), -1, dtype=torch.int32, device=cuda)
    ad, bd = a.to(cuda), b.to(cuda)
    cuda_build.check(cuda_build.library().lt_mont_mul(
        ad.data_ptr(), bd.data_ptr(), out.data_ptr(), count, 0,
        cuda_build.stream_handle(out.device)), "lt_mont_mul")
    assert torch.equal(out[:count].cpu(), want)
    assert bool((out[count:] == -1).all())


@pytest.mark.cuda
def test_mont_mul_kernel_edge_operands(cuda):
    """a up to R - 1 against b up to p - 1: where a lost carry would show."""
    f = BN254_FR
    R = 1 << 256
    a_vals = [R - 1, R - 2, f.p, f.p - 1, 0, 1, (1 << 255) + 12345, R - (1 << 32)]
    b_vals = [f.p - 1, f.p - 2, 1, 0, 1 << 253, (1 << 32) - 1, f.p - (1 << 32)]
    pairs = [(a, b) for a in a_vals for b in b_vals]
    to_limbs = lambda vs: np.array(  # noqa: E731
        [[(v >> (16 * j)) & 0xFFFF for j in range(16)] for v in vs], dtype=np.int32)
    a = t(to_limbs([x for x, _ in pairs]))
    b = t(to_limbs([y for _, y in pairs]))
    want = fieldops.mont_mul(pf(f), a, b)
    r_inv = pow(R, -1, f.p)
    assert f.limbs_to_ints(want.numpy().astype(np.uint32)) == [
        x * y * r_inv % f.p for x, y in pairs]
    got = cuda_mont.mont_mul(pf(f), a.to(cuda), b.to(cuda))
    assert torch.equal(got.cpu(), want)
