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
from ligero_tpu_torch.engine import cuda_build, cuda_hash, cuda_mont, fieldops
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


# the fields of csrc/field.cuh: (namespace, field)
HEADER_FIELDS = [("fr", BN254_FR), ("fq", BLS12_377_FQ)]


def field_header_asm(namespace: str = "fr"):
    """{function: [(instructions, output exprs, input exprs), ...]} for every
    asm statement of one field's namespace of csrc/field.cuh, in source
    order."""
    path = os.path.join(os.path.dirname(cuda_mont.__file__), "..", "csrc",
                        "field.cuh")
    with open(path) as f:
        src = f.read()
    src = re.search(r"namespace %s \{\n(.*?)\n\}  // namespace %s"
                    % (namespace, namespace), src, re.S).group(1)
    out = {}
    for fn in re.finditer(r"^__device__ __forceinline__ [\w ]+?(\w+)\(",
                          src, re.M):
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
    unless the statement ``wraps`` mod 2^(32 W) by design."""
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


def emulated_field_ops(namespace: str, field):
    """fe_mont_mul, fe_add, fe_sub of one namespace of field.cuh on Python
    ints: the asm statements as parsed, the C++ around them mirrored here
    (fr forms sums and differences into fresh words, fq in place in a copy
    of the first operand)."""
    asm = field_header_asm(namespace)
    W = field.num_limbs // 2
    P = [(field.p >> (32 * j)) & M32 for j in range(W)]
    np0 = (-pow(field.p, -1, 1 << 32)) & M32
    words = lambda v: [(v >> (32 * j)) & M32 for j in range(W)]  # noqa: E731
    value = lambda w: sum(x << (32 * j) for j, x in enumerate(w))  # noqa: E731
    in_place = namespace == "fq"

    def resolver(**names):
        def env(expr):
            expr = expr.strip()
            m = re.fullmatch(r"p_word\((\d+)\) & (\w+)", expr)
            if m:
                return P[int(m.group(1))] & names[m.group(2)][0]
            m = re.fullmatch(r"(\w+)(?:\.w)?\[(\d+)\]", expr)
            if m:
                return [names[m.group(1)], int(m.group(2))]
            return [names[expr], 0]
        return env

    def sub_p(t):
        d, borrow = [0] * W, [0]
        run_asm(asm["sub_p"][0], resolver(d=d, t=t, borrow=borrow))
        return borrow[0] == 0, d

    def add(a, b):
        s = words(a) if in_place else [0] * W
        run_asm(asm["fe_add"][0], resolver(s=s, a=words(a), b=words(b)))
        ge, d = sub_p(s)
        return value(d if ge else s)

    def sub(a, b):
        d, borrow = (words(a) if in_place else [0] * W), [0]
        env = resolver(d=d, a=words(a), b=words(b), borrow=borrow)
        run_asm(asm["fe_sub"][0], env)
        run_asm(asm["fe_sub"][1], env, wraps=True)   # a - b + 2^(32 W) + p
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
        x, y = [0] * W, [0] * W
        for j in range(0, W, 2):
            ev, od = bw[j] * aw[0], bw[j + 1] * aw[0]
            x[j], x[j + 1], y[j], y[j + 1] = ev & M32, ev >> 32, od & M32, od >> 32
        reduce(x, y)
        for i in range(1, W, 2):
            step(y, x, bw, aw[i])
            reduce(y, x)
            if i + 1 < W:
                step(x, y, bw, aw[i + 1])
                reduce(x, y)
        r, top = (list(x) if in_place else [0] * W), [0]
        run_asm(asm["fe_mont_mul"][0], resolver(r=r, top=top, x=x, y=y))
        ge, d = sub_p(r)
        return value(d if (top[0] or ge) else r)

    return mont_mul, add, sub


def emulated_mul_acc(namespace: str, field):
    """fe_mul_acc of one namespace of field.cuh on Python ints: its four
    asm chains a pair of words of a, as parsed, over the accumulator's
    arrays e (2 W words), o (2 W - 2) and the kept carries ce (W + 1), co
    (W), all updated in place.  Returns mul_acc and value(e, o, ce, co)."""
    asm = field_header_asm(namespace)["fe_mul_acc"]
    W = field.num_limbs // 2
    words = lambda v: [(v >> (32 * j)) & M32 for j in range(W)]  # noqa: E731

    def mul_acc(e, o, ce, co, a, b):
        names = {"e": e, "o": o, "ce": ce, "co": co, "a": words(a),
                 "b": words(b)}
        for i in range(0, W, 2):
            def env(expr, i=i):
                m = re.fullmatch(r"(\w+)(?:\.w)?\[(i)?(?: \+ )?(\d*)\]",
                                 expr.strip())
                return [names[m.group(1)],
                        (i if m.group(2) else 0) + int(m.group(3) or 0)]
            for stmt in asm:
                run_asm(stmt, env)

    def value(e, o, ce, co):
        return (sum(x << (32 * j) for j, x in enumerate(e))
                + sum(x << (32 * (j + 1)) for j, x in enumerate(o))
                + sum(x << (32 * (W + j)) for j, x in enumerate(ce))
                + sum(x << (32 * (W + j + 1)) for j, x in enumerate(co)))
    return mul_acc, value


@pytest.mark.parametrize("namespace,field", HEADER_FIELDS,
                         ids=[ns for ns, _ in HEADER_FIELDS])
def test_field_header_carry_chains_emulated(namespace, field):
    """The PTX of csrc/field.cuh, instruction for instruction, gives REDC(a b)
    fully reduced for a < R and b < p (no carry lost, at the extremes too),
    and a +- b mod p."""
    import random
    mont_mul, add, sub = emulated_field_ops(namespace, field)
    p, R = field.p, 1 << (16 * field.num_limbs)
    r_inv = pow(R, -1, p)
    rnd = random.Random(11)
    pairs = [(R - 1, p - 1), (p - 1, p - 1), (0, 0), (1, 1), (R - 1, 1),
             (R - 1, 1 << (p.bit_length() - 1)), (p, p - 1), (0, p - 1),
             (R - 1, 0)]
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
    # fe_mul_acc: products added unreduced into the even- and odd-weighted
    # words, every carry out of a chain's top kept aside; the pairs run in
    # one accumulator, the largest products first
    W = field.num_limbs // 2
    mul_acc, acc_value = emulated_mul_acc(namespace, field)
    acc = ([0] * (2 * W), [0] * (2 * W - 2), [0] * (W + 1), [0] * W)
    total = 0
    for a, b in [(R - 1, R - 1)] * 3 + pairs:
        mul_acc(*acc, a, b)
        total += a * b
        assert acc_value(*acc) == total, (hex(a), hex(b))


@pytest.mark.parametrize("namespace,field", HEADER_FIELDS,
                         ids=[ns for ns, _ in HEADER_FIELDS])
def test_field_header_chains_use_the_modulus_words(namespace, field):
    """Every word of p stands as an immediate in the reduction chains: the
    odd words feed o, the even words e, all W the subtraction."""
    asm = field_header_asm(namespace)
    P = [(field.p >> (32 * j)) & M32 for j in range(field.num_limbs // 2)]

    def immediates(stmt):
        return [int(x, 16) for i in stmt[0] for x in re.findall(r"0x[0-9a-f]{8}", i)]

    odd, even = asm["cios_reduce"]
    assert immediates(odd) == [w for w in P[1::2] for _ in range(2)]
    assert immediates(even) == [w for w in P[0::2] for _ in range(2)]
    assert immediates(asm["sub_p"][0]) == P


def emulated_mont_sqr(a: int) -> tuple[int, int]:
    """fr::fe_mont_sqr of csrc/field.cuh on a Python int: its asm statements
    as parsed (the cross-product rows, the doubling, the squares, the two
    reduction chains of each of the eight steps, the final sum), the C++
    around them mirrored here.  Returns (result, the carry word past the
    sixteenth, which the header's bound says stays 0)."""
    asm = field_header_asm("fr")["fe_mont_sqr"]
    W = 8
    np0 = (-pow(BN254_FR.p, -1, 1 << 32)) & M32
    aw = [(a >> (32 * j)) & M32 for j in range(W)]
    s, c = [0] * (2 * W), [0] * (W + 1)
    names = {"s": s, "c": c, "a": aw}

    def env(i=0, **extra):
        def resolve(expr):
            expr = expr.strip()
            m = re.fullmatch(r"(\w+)(?:\.w)?\[(i)?(?: \+ )?(\d*)\]", expr)
            if m:
                key = (i if m.group(2) else 0) + int(m.group(3) or 0)
                return [names[m.group(1)], key]
            return [extra[expr], 0]
        return resolve

    cross, rest = asm[:13], asm[13:]
    for stmt in cross + rest[:2]:           # rows, doubling, squares
        run_asm(stmt, env())
    for i in range(W):
        m = [(s[i] * np0) & M32]
        run_asm(rest[2], env(i, m=m))
        run_asm(rest[3], env(i, m=m))
        assert s[i] == 0
    r = [0] * W
    names["r"] = r
    run_asm(rest[4], env())
    value = sum(x << (32 * j) for j, x in enumerate(r))
    return (value - BN254_FR.p if value >= BN254_FR.p else value), c[W]


def test_field_header_mont_sqr_emulated():
    """The squaring's PTX, instruction for instruction, gives REDC(a a) fully
    reduced for every a < p: no carry lost (the rows' top words, the
    doubling, the squares, the final sum), the carry word past the
    sixteenth stays 0, and the result equals the product's."""
    import random
    mont_mul, _, _ = emulated_field_ops("fr", BN254_FR)
    p, R = BN254_FR.p, 1 << 256
    r_inv = pow(R, -1, p)
    rnd = random.Random(17)
    xs = [0, 1, 2, p - 1, p - 2, (p - 1) // 2, (p + 1) // 2, 1 << 253,
          (1 << 253) - 1, R % p, (R * R) % p, M32, (1 << 224) - 1]
    xs += [rnd.randrange(p) for _ in range(400)]
    xs += [p - 1 - rnd.randrange(1 << 64) for _ in range(50)]
    for x in xs:
        got, spill = emulated_mont_sqr(x)
        assert spill == 0, hex(x)
        assert got == x * x * r_inv % p == mont_mul(x, x), hex(x)
    # no more statements than the sum needs: 13 cross rows, 1 doubling, 1
    # squares, 2 reduction chains, 1 final sum
    assert len(field_header_asm("fr")["fe_mont_sqr"]) == 18


def emulated_lazy_ops():
    """The lazy forms of namespace fq (the NTT's butterflies) on Python
    ints: fe_mont_mul_2p (its steps with cios_reduce_p1, no conditional
    subtraction), fe_add_2p, fe_sub_2p, fe_sub_4p and fe_reduce_p, the asm
    statements as parsed, the C++ around them mirrored here."""
    asm = field_header_asm("fq")
    W = 12
    words = lambda v: [(v >> (32 * j)) & M32 for j in range(W)]  # noqa: E731
    value = lambda w: sum(x << (32 * j) for j, x in enumerate(w))  # noqa: E731

    def resolver(**names):
        def env(expr):
            expr = expr.strip()
            m = re.fullmatch(r"(0x[0-9a-f]{8})u & (\w+)", expr)
            if m:
                return int(m.group(1), 16) & names[m.group(2)][0]
            m = re.fullmatch(r"(\w+)(?:\.w)?\[(\d+)\]", expr)
            if m:
                return [names[m.group(1)], int(m.group(2))]
            return [names[expr], 0]
        return env

    def cond_sub(fn, t):                    # sub_p / sub_2p
        d, borrow = [0] * W, [0]
        run_asm(asm[fn][0], resolver(d=d, t=t, borrow=borrow))
        return d if borrow[0] == 0 else t

    def add_2p(a, b):
        s = words(a)
        run_asm(asm["fe_add_2p"][0], resolver(s=s, b=words(b)))
        return value(cond_sub("sub_2p", s))

    def sub_2p(a, b):
        d, borrow = words(a), [0]
        env = resolver(d=d, b=words(b), borrow=borrow)
        run_asm(asm["fe_sub_2p"][0], env)
        run_asm(asm["fe_sub_2p"][1], env, wraps=True)  # a - b + 2^384 + 2p
        return value(d)

    def sub_4p(a, b):
        d = words(a)
        env = resolver(d=d, b=words(b))
        for stmt in asm["fe_sub_4p"]:
            run_asm(stmt, env)
        return value(d)

    def reduce_p(a):
        return value(cond_sub("sub_p", words(a)))

    def mul_2p(a, b):
        aw, bw = words(a), words(b)
        x, y = [0] * W, [0] * W
        for j in range(0, W, 2):
            ev, od = bw[j] * aw[0], bw[j + 1] * aw[0]
            x[j], x[j + 1], y[j], y[j + 1] = ev & M32, ev >> 32, od & M32, od >> 32

        def step(e, o, v, bb):
            env = resolver(e=e, o=o, v=v, b=[bb])
            for stmt in asm["cios_step"]:
                run_asm(stmt, env)

        def reduce(e, o):
            env = resolver(e=e, o=o, m=[(-e[0]) & M32])
            for stmt in asm["cios_reduce_p1"]:
                run_asm(stmt, env)
            assert e[0] == 0

        reduce(x, y)
        for i in range(1, W, 2):
            step(y, x, bw, aw[i])
            reduce(y, x)
            if i + 1 < W:
                step(x, y, bw, aw[i + 1])
                reduce(x, y)
        r = list(x)
        run_asm(asm["fe_mont_mul_2p"][0], resolver(r=r, y=y))
        return value(r)

    return mul_2p, add_2p, sub_2p, sub_4p, reduce_p


def test_field_header_lazy_forms_emulated():
    """BLS12-377's lazy forms, instruction for instruction, at their
    stated bounds and their extremes: REDC(a b) in [0, 2p) for a < R and b
    < p with no carry lost (a up to fe_sub_4p's 4p and past it); a + b and
    a - b in [0, 2p), and a - b + 2p exactly, for a, b < 2p; a mod p for a
    < 2p.  cios_reduce_p1 takes p's words as cios_reduce does, less the
    lowest (1), and the 2p forms take 2p's words."""
    import random
    mul_2p, add_2p, sub_2p, sub_4p, reduce_p = emulated_lazy_ops()
    p, R = BLS12_377_FQ.p, 1 << 384
    r_inv = pow(R, -1, p)
    rnd = random.Random(23)
    edges_a = [0, 1, p - 1, p, 2 * p - 1, 2 * p, 4 * p - 1, R - 1]
    edges_b = [0, 1, p - 1, (p - 1) // 2, R % p]
    pairs = [(a, b) for a in edges_a for b in edges_b]
    pairs += [(rnd.randrange(4 * p), rnd.randrange(p)) for _ in range(300)]
    pairs += [(rnd.randrange(R), p - 1 - rnd.randrange(1 << 40))
              for _ in range(100)]
    for a, b in pairs:
        got = mul_2p(a, b)
        assert got < 2 * p and got % p == a * b * r_inv % p, (hex(a), hex(b))
    lazy = [0, 1, p - 1, p, p + 1, 2 * p - 1]
    sums = [(a, b) for a in lazy for b in lazy]
    sums += [(rnd.randrange(2 * p), rnd.randrange(2 * p)) for _ in range(300)]
    for a, b in sums:
        s, d = add_2p(a, b), sub_2p(a, b)
        assert s < 2 * p and s % p == (a + b) % p, (hex(a), hex(b))
        assert d < 2 * p and d % p == (a - b) % p, (hex(a), hex(b))
        assert sub_4p(a, b) == a - b + 2 * p, (hex(a), hex(b))
        assert reduce_p(a) == a % p, hex(a)
    asm = field_header_asm("fq")
    P = [(p >> (32 * j)) & M32 for j in range(12)]
    P2 = [(2 * p >> (32 * j)) & M32 for j in range(12)]

    def immediates(stmt):
        return [int(x, 16) for i in stmt[0]
                for x in re.findall(r"0x[0-9a-f]{8}", i)]

    odd, even = asm["cios_reduce_p1"]
    assert P[0] == 1
    assert immediates(odd) == [w for w in P[1::2] for _ in range(2)]
    assert immediates(even) == [w for w in P[2::2] for _ in range(2)]
    assert immediates(asm["sub_2p"][0]) == P2
    assert immediates(asm["fe_sub_4p"][0]) == P2
    masked = [int(m, 16) for m in re.findall(
        r"(0x[0-9a-f]{8})u & borrow", " ".join(asm["fe_sub_2p"][1][2]))]
    assert masked == P2


def test_field_header_constants_match_bls12_377():
    """The fq namespace's p words, -p^-1 mod 2^32 and widths."""
    path = os.path.join(os.path.dirname(cuda_mont.__file__), "..", "csrc",
                        "field.cuh")
    with open(path) as f:
        src = f.read()
    fq = re.search(r"namespace fq \{\n(.*?)\n\}  // namespace fq", src,
                   re.S).group(1)
    words = re.search(r"constexpr uint32_t P\[W\] = \{([^}]*)\}", fq).group(1)
    p_words = [int(w.strip().rstrip("u"), 16) for w in words.split(",")]
    assert sum(w << (32 * i) for i, w in enumerate(p_words)) == BLS12_377_FQ.p
    np0 = int(re.search(r"NP0 = (0x[0-9a-fA-F]+)u", fq).group(1), 16)
    assert np0 == (-pow(BLS12_377_FQ.p, -1, 1 << 32)) % (1 << 32) == M32
    assert re.search(r"constexpr int W = (\d+);", fq).group(1) == "12"
    assert re.search(r"constexpr int L = (\d+);", fq).group(1) == "24"


def test_kernels_refuse_a_field_they_lack():
    """The field kernels take BN254 Fr and BLS12-377 Fq by id; anything else
    raises before a launch."""
    from ligero_tpu_torch.fields import FieldSpec
    assert [cuda_build.kernel_field_id(pf(f), "t") for f in FIELDS] == [0, 1]
    other = FieldSpec(name="goldilocks", p=(1 << 64) - (1 << 32) + 1,
                      generator=7, two_adicity=32)
    with pytest.raises(NotImplementedError, match="goldilocks"):
        cuda_build.kernel_field_id(other, "mont_mul")
    # a field of a kernel field's name but another modulus is refused too
    fake = FieldSpec(name="bn254_fr", p=other.p, generator=7, two_adicity=32)
    with pytest.raises(NotImplementedError):
        cuda_build.kernel_field_id(fake, "ntt")
    # the column hash takes the field too, and elements of its width only
    u = torch.zeros((2, 3, 16), dtype=torch.int32)
    with pytest.raises(ValueError, match="24 limbs"):
        cuda_hash.blake2s_columns(pf(BLS12_377_FQ), u)


def mont_mul_piece_slot(pieces: int):
    """``piece_slot<PIECES>`` of csrc/mont_mul.cu, read from the source: the
    branch of its ``PIECES == 4 ? ... : ...`` for ``pieces``, evaluated as
    Python (the C operators it uses mean the same there)."""
    path = os.path.join(os.path.dirname(cuda_mont.__file__), "..", "csrc",
                        "mont_mul.cu")
    with open(path) as f:
        src = f.read()
    four, six = re.search(r"int piece_slot\(int idx\) \{.*?return PIECES == 4 "
                          r"\? (.*?) : (.*?);\n", src, re.S).groups()
    expr = compile(four if pieces == 4 else six, "piece_slot", "eval")
    return lambda idx: eval(expr, {"__builtins__": {}}, {"idx": idx})


@pytest.mark.parametrize("pieces", [4, 6])
def test_mont_mul_staging_swizzle_is_free_of_bank_conflicts(pieces):
    """piece_slot (csrc/mont_mul.cu) permutes a warp's 32 pieces-wide row;
    each quarter warp's eight 16-byte accesses, the writes in element order
    (lane l, piece q at pieces l + q) and the reads in run order (j 32 +
    lane), land in eight distinct bank groups."""
    slot = mont_mul_piece_slot(pieces)
    size = 32 * pieces
    assert sorted(slot(i) for i in range(size)) == list(range(size))
    for quarter in range(4):
        lanes = range(8 * quarter, 8 * quarter + 8)
        for q in range(pieces):
            assert len({slot(pieces * l + q) % 8 for l in lanes}) == 8
            assert len({slot(32 * q + l) % 8 for l in lanes}) == 8


@pytest.mark.cuda
@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_mont_mul_kernel_matches_plain(cuda, field):
    rng = np.random.default_rng(6)
    L = field.num_limbs
    a = rng.integers(0, 1 << 16, size=(5000, L)).astype(np.int32)
    b = rand_reduced(field, rng, (5000,))
    want = fieldops.mont_mul(pf(field), t(a), t(b))
    got = cuda_mont.mont_mul(pf(field), t(a).to(cuda), t(b).to(cuda))
    assert torch.equal(got.cpu(), want)
    got_b = cuda_mont.mont_mul(pf(field), t(a).to(cuda), t(b[0]).to(cuda))
    assert torch.equal(got_b.cpu(), fieldops.mont_mul(pf(field), t(a), t(b[0])))


@pytest.mark.cuda
@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
@pytest.mark.parametrize("count", [1, 31, 32, 33, 255, 256, 257, 8191])
def test_mont_mul_kernel_partial_warps(cuda, count, field):
    """The kernel stores a warp's results as one run: counts that end inside
    a warp or a block write their own elements and nothing past them."""
    rng = np.random.default_rng(count)
    L = field.num_limbs
    a = t(rng.integers(0, 1 << 16, size=(count + 2, L)).astype(np.int32))
    b = t(rand_reduced(field, rng, (count + 2,)))
    want = fieldops.mont_mul(pf(field), a[:count], b[:count])
    assert torch.equal(
        cuda_mont.mont_mul(pf(field), a[:count].to(cuda), b[:count].to(cuda)).cpu(),
        want)
    # the C entry point on a longer output: the two rows past count stay
    out = torch.full((count + 2, L), -1, dtype=torch.int32, device=cuda)
    ad, bd = a.to(cuda), b.to(cuda)
    cuda_build.check(cuda_build.library().lt_mont_mul(
        cuda_build.kernel_field_id(pf(field), "t"), ad.data_ptr(),
        bd.data_ptr(), out.data_ptr(), count, 0,
        cuda_build.stream_handle(out.device)), "lt_mont_mul")
    assert torch.equal(out[:count].cpu(), want)
    assert bool((out[count:] == -1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_mont_mul_kernel_edge_operands(cuda, field):
    """a up to R - 1 against b up to p - 1: where a lost carry would show."""
    f, L = field, field.num_limbs
    R = 1 << (16 * L)
    top = f.p.bit_length()
    a_vals = [R - 1, R - 2, f.p, f.p - 1, 0, 1, (1 << (16 * L - 1)) + 12345,
              R - (1 << 32)]
    b_vals = [f.p - 1, f.p - 2, 1, 0, 1 << (top - 1), (1 << 32) - 1,
              f.p - (1 << 32)]
    pairs = [(a, b) for a in a_vals for b in b_vals]
    to_limbs = lambda vs: np.array(  # noqa: E731
        [[(v >> (16 * j)) & 0xFFFF for j in range(L)] for v in vs], dtype=np.int32)
    a = t(to_limbs([x for x, _ in pairs]))
    b = t(to_limbs([y for _, y in pairs]))
    want = fieldops.mont_mul(pf(f), a, b)
    r_inv = pow(R, -1, f.p)
    assert f.limbs_to_ints(want.numpy().astype(np.uint32)) == [
        x * y * r_inv % f.p for x, y in pairs]
    got = cuda_mont.mont_mul(pf(f), a.to(cuda), b.to(cuda))
    assert torch.equal(got.cpu(), want)
