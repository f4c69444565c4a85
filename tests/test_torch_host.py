"""The port's own copies of the host modules against their originals in the
JAX package: the same inputs, made from a numpy seed, go through both, and
the results must be equal exactly.  Each case is a function of a namespace
of modules, run once on ``ligero_tpu`` and once on ``ligero_tpu_torch``."""

import importlib
import types
import warnings

import numpy as np
import pytest
import torch

from torch_columns import as_ints

# the suite runs in several worker processes that share the host's cores, and
# these tests run many small tensor ops: one intra-op thread each, or the
# workers' thread pools spin against each other
torch.set_num_threads(1)

MODULES = ["fields", "chacha", "sampling", "hashes", "merkle", "sponge",
           "native", "matrices", "synthetic", "wasm_interp",
           "circuit", "circuit.arithmetic", "circuit.expression",
           "circuit.witness", "circuit.r1cs", "ligero.proof", "ligero.types"]


def namespace(pkg: str) -> types.SimpleNamespace:
    return types.SimpleNamespace(pkg=pkg, **{
        name.replace(".", "_"): importlib.import_module(f"{pkg}.{name}")
        for name in MODULES})


REF = namespace("ligero_tpu")
PORT = namespace("ligero_tpu_torch")
FIELD_NAMES = sorted(REF.fields.FIELDS)


def plain(x):
    """Results as plain comparable data (arrays -> dtype, shape, bytes)."""
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.shape, x.tobytes())
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    return x


def rand_ints(seed: int, count: int, below: int) -> list[int]:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(48), "little") % below
            for _ in range(count)]


def seed_bytes(seed: int) -> bytes:
    return np.random.default_rng(seed).bytes(32)


# ---------------------------------------------------------------------------
# the cases: each takes (namespace, field name) and returns plain data
# ---------------------------------------------------------------------------

def case_field_constants(ns, fname):
    f = ns.fields.FIELDS[fname]
    return [f.name, f.p, f.generator, f.two_adicity, f.modulus_bit_size,
            f.num_u64_limbs, f.num_limbs, f.r_bits, f.R, f.R2, f.R_inv,
            f.n16, f.two_adic_root, f.serialized_size, f.sponge_usable_bytes,
            f.p_limbs, f.r2_limbs, f.one_mont_limbs,
            [f.root_of_unity(1 << s) for s in (1, 4, 10)]]


def case_field_limb_conversions(ns, fname):
    f = ns.fields.FIELDS[fname]
    xs = rand_ints(1, 40, f.p) + [0, 1, f.p - 1]
    limbs, mont = f.ints_to_limbs(xs), f.ints_to_mont_limbs(xs)
    return [limbs, mont, f.limbs_to_ints(limbs), f.mont_limbs_to_ints(mont),
            f.int_to_limbs(xs[0]), f.limbs_to_int(limbs[1]),
            [f.to_mont(x) for x in xs[:5]], [f.from_mont(x) for x in xs[:5]]]


def case_chacha_blocks_and_rng(ns, fname):
    seed = seed_bytes(2)
    key = ns.chacha.key_words_from_seed(seed)
    rng = ns.chacha.ChaChaRng(seed)
    draws = [rng.next_u32() for _ in range(3)]
    draws += [rng.next_u64() for _ in range(70)]
    test_rng = ns.chacha.ark_std_test_rng()
    return [key, ns.chacha.chacha_blocks(key, 0, 5),
            ns.chacha.chacha_blocks(key, 7, 2, rounds=8),
            ns.chacha.word_stream(seed, 100), ns.chacha.u64_stream(seed, 33),
            draws, [test_rng.next_u64() for _ in range(4)]]


def case_rand_field_elements(ns, fname):
    f = ns.fields.FIELDS[fname]
    seed = seed_bytes(3)
    return [ns.sampling.rand_field_elements_limbs(f, 300, seed),
            ns.sampling.rand_field_elements(f, 17, seed),
            ns.sampling.rand_field_elements_u64(f, 50, seed),
            ns.sampling.rand_field_elements_limbs(f, 0, seed),
            ns.sampling.rand_field_element_scalar(
                f, ns.chacha.ChaChaRng(seed))]


def case_distinct_indices(ns, fname):
    out = []
    for n, t, s in ((256, 26, 4), (128, 100, 5), (16384, 156, 6)):
        out.append(ns.sampling.get_distinct_indices_from_prng(n, t, seed_bytes(s)))
    for n, t, stride, s in ((256, 26, 8, 7), (512, 60, 8, 8), (128, 25, 8, 9)):
        out.append(ns.sampling.get_distinct_indices_excluding(
            n, t, seed_bytes(s), stride))
    with pytest.raises(ValueError):
        ns.sampling.get_distinct_indices_excluding(16, 15, seed_bytes(1), 8)
    return out


def case_column_hash(ns, fname):
    f = ns.fields.FIELDS[fname]
    col = rand_ints(10, 37, f.p)
    return [ns.hashes.serialize_field_vec(f, col), ns.hashes.column_hash(f, col),
            ns.hashes.column_hash(f, []),
            ns.hashes.sha256_compress(b"\x01" * 32, b"\x02" * 32),
            ns.hashes.column_hashes_from_matrix(f, [col[:5], col[5:9]])]


def case_merkle_tree(ns, fname):
    rng = np.random.default_rng(11)
    leaves = [rng.bytes(32) for _ in range(16)]
    tree = ns.merkle.MerkleTree(leaves)
    again = ns.merkle.MerkleTree(leaves, inner_levels=tree.levels)
    out = [tree.root, tree.levels, again.root]
    for j in (0, 5, 15):
        path = again.generate_proof(j)
        out.append([path.leaf_index, path.leaf_sibling_hash, path.auth_path,
                    path.verify(tree.root, leaves[j]),
                    path.verify(tree.root, leaves[j ^ 1])])
    out.append(ns.merkle.create_merkle_tree(leaves[:5]).root)
    return out


def case_sponge_transcript(ns, fname):
    f = ns.fields.FIELDS[fname]
    cfg = ns.sponge.test_poseidon_config(f)
    sp = ns.sponge.test_sponge(f)
    out = [cfg.full_rounds, cfg.partial_rounds, cfg.alpha, cfg.rate,
           cfg.capacity, cfg.mds, cfg.ark[:2]]
    sp.absorb_bytes(seed_bytes(12))
    out.append(sp.squeeze_bytes(32))
    sp.absorb_field_elems(rand_ints(13, 5, f.p))
    fork = sp.clone()
    # longer than the native-absorb threshold: the g++ path when it builds
    sp.absorb_field_elems(rand_ints(14, 70, f.p))
    out.append(sp.squeeze_native_field_elements(3))
    out.append(sp.squeeze_bytes(80))
    out.append(fork.squeeze_bytes(32))
    return out


def case_sponge_transcript_python(ns, fname):
    saved = ns.native.available
    ns.native.available = lambda: False
    try:
        return case_sponge_transcript(ns, fname)
    finally:
        ns.native.available = saved


def case_rand_field_elements_python(ns, fname):
    saved = ns.native.available
    ns.native.available = lambda: False
    try:
        return case_rand_field_elements(ns, fname)
    finally:
        ns.native.available = saved


def case_synthetic_circuit(ns, fname):
    f = ns.fields.FIELDS[fname]
    out = []
    for gates, nv, seed in ((96, 4, 3), (256, 64, 8), (1024, 64, 10)):
        c, outs, vars_ = ns.synthetic.generate_random_circuit(
            f, gates, num_vars=nv, seed=seed)
        out.append([c.nodes, c.constants, c.variables, outs, vars_,
                    c.evaluate_multioutput(vars_, outs)])
    return out


def case_sparse_matrices(ns, fname):
    f = ns.fields.FIELDS[fname]
    M = ns.matrices
    vals = rand_ints(15, 12, f.p)
    a = M.SparseMatrix(f, 4)
    a.push_row([(vals[0], 0), (vals[1], 3)])
    a.push_empty_row()
    a.push_row([(vals[2], 1)])
    b = M.SparseMatrix.from_rows(f, [[(vals[3], 0)], [], [(vals[4], 2),
                                                          (vals[5], 3)]], 4)
    both = a.h_stack(b).v_stack(M.SparseMatrix.identity(f, 8))
    neg = -(a.v_stack(b))
    rows, cols, v = both.to_coo()
    coo = M.CooMatrix(f, both.num_rows(), both.num_cols, rows, cols, v)
    vec = rand_ints(16, both.num_rows(), f.p)
    dense = M.DenseMatrix(f, [vals[:4], vals[4:8], vals[8:12]])
    return [both.rows, both.num_rows(), both.num_cols, neg.rows,
            rows, cols, v, both.row_mul(vec), coo.row_mul(vec),
            list(coo.to_coo()[2]), M.SparseMatrix.zero(f, 2, 3).rows,
            dense.row_mul(vec[:3]), dense.columns(), dense.column(1),
            dense.num_columns(), both == both, both == a]


def case_arithmetic_circuit(ns, fname):
    f = ns.fields.FIELDS[fname]
    c = ns.circuit.ArithmeticCircuit(f)
    x, y = c.new_variable_with_label("x"), c.new_variable()
    zs = c.new_variables(2)
    s = c.add(c.mul(x, y), c.constant(-5))
    pw = c.pow(s, 5)
    ind = c.indicator(zs[0])
    dot = c.scalar_product([x, y], zs)
    top = c.add_nodes([pw, ind, c.minus(dot), c.mul_nodes([x, y, zs[1]])])
    vars_ = [(x, 3), (y, 7), (zs[0], 0), (zs[1], f.p - 2)]
    kept, remap = ns.circuit_arithmetic.filter_constants(c.nodes)
    return [c.nodes, c.constants, c.variables, c.num_nodes(), c.num_gates(),
            c.num_constants(), c.num_variables(), c.last() == top,
            c.evaluate(vars_), c.evaluation_trace(vars_, top),
            c.evaluate_multioutput(vars_, [pw, top]),
            c.evaluate_node_with_labels([("x", 4)], x), kept, remap,
            [ns.circuit_arithmetic.node_str(n) for n in c.nodes[:6]]]


def case_expression_front_end(ns, fname):
    f = ns.fields.FIELDS[fname]
    E = ns.circuit.Expression
    x, y = E.variable("x", f), E.variable("y", f)
    three = E.constant(3, f)
    e = (x * y + three) * (x - y) + x.pow(4) - y * 2 + 7
    e = e + E.sum([x, y, three]) * E.product([x, y]) \
        + E.scalar_product([x, y], [y, three]) \
        + E.sparse_scalar_product([(5, 0), (6, 1)], [x, y])
    c = e.to_arithmetic_circuit()
    return [c.nodes, c.constants, c.variables,
            c.evaluate_with_labels([("x", 11), ("y", 13)])]


def case_proof_serialization(ns, fname):
    """The same proof object, built from plain data, through to_bytes and
    from_bytes.  The port holds a column set as one (ncols, rows, L) <u2
    limb array, the JAX package as lists of ints: the columns go in and
    come out as ints in both."""
    f = ns.fields.FIELDS[fname]
    P = ns.ligero_proof
    rng = np.random.default_rng(17)
    port = ns.pkg == "ligero_tpu_torch"

    def sub(cls, npoly):
        cols = [rand_ints(int(rng.integers(1 << 30)), 7, f.p) for _ in range(3)]
        if port:
            cols = np.stack([f.ints_to_limbs(c) for c in cols]).astype("<u2")
        paths = [ns.merkle.MerklePath(j, rng.bytes(32),
                                      [rng.bytes(32) for _ in range(4)])
                 for j in (1, 9, 30)]
        return cls(rand_ints(int(rng.integers(1 << 30)), npoly, f.p), cols, paths)

    proof = P.LigeroProof(rng.bytes(32), sub(P.InterleavedProof, 8),
                          sub(P.LinearConstraintsProof, 15),
                          sub(P.QuadraticConstraintsProof, 0))
    data = proof.to_bytes(f)
    back = P.LigeroProof.from_bytes(data, f)
    rejects = []
    for bad in (data[:-1], data + b"\x00", data[:40]):
        try:
            P.LigeroProof.from_bytes(bad, f)
            rejects.append(False)
        except ValueError:
            rejects.append(True)
    return [data, back.to_bytes(f) == data, back.u_root,
            back.interleaved.preenc_u_lc,
            as_ints(f, back.linear.columns) if port else back.linear.columns,
            [(p.leaf_index, p.leaf_sibling_hash, p.auth_path)
             for p in back.quadratic.paths], rejects]


def case_mt_params(ns, fname):
    f = ns.fields.FIELDS[fname]
    T = ns.ligero_types
    col = rand_ints(18, 9, f.p)
    default, poseidon = T.LigeroMTTestParams(), T.LigeroMTPoseidonParams(f)
    left = poseidon.col_hash(f, col)
    return [default.col_hash(f, col), default.two_to_one(b"a" * 32, b"b" * 32),
            default.leaf_hash(b"leaf"), left,
            poseidon.two_to_one(left, poseidon.col_hash(f, col[:3])),
            T.is_default_mt_params(default), T.is_default_mt_params(poseidon)]


def case_native_kernels(ns, fname):
    f = ns.fields.FIELDS[fname]
    N = ns.native
    if not N.available() or not N.pylong_available():
        pytest.skip("g++ host kernels did not build")
    nl = f.num_u64_limbs
    xs = rand_ints(19, 24, f.p)
    a = N.ints_to_u64_limbs(xs, nl)
    mont = a.copy()
    N.to_mont_inplace(f, mont)
    back = mont.copy()
    N.from_mont_inplace(f, back)
    a3, b3 = mont.reshape(4, 6, nl), a.reshape(4, 6, nl)
    rows = np.asarray([0, 1, 1, 3, 2], dtype=np.int32)
    cols = np.asarray([2, 0, 2, 1, 1], dtype=np.int32)
    width = f.serialized_size
    raw = N.le_bytes_from_longs(xs, width)
    return [mont, back, N.u64_to_u16_limbs(a, f.num_limbs),
            N.u64_to_u16_view(a, f.num_limbs),
            N.u16_to_u64_limbs(f.ints_to_limbs(xs)),
            N.mul_sum_rows_mont(f, a3, b3),
            N.quad_spot_mont(f, b3, b3[::-1].copy(), b3, mont[:4]),
            N.sparse_row_mul_mont(f, rows, cols, mont[:5], mont[5:9], 3),
            N.chacha_fr_sample(f, 40, seed_bytes(20)), raw,
            N.longs_from_le_bytes(raw, len(xs), width)]


ADD_WASM = bytes.fromhex(
    "0061736d01000000" "0107016002" "7f7f017f" "03020100"
    "070701036164640000" "0a09010700200020016a0b")


def case_wasm_interpreter(ns, fname):
    mod = ns.wasm_interp.WasmModule(ADD_WASM, {})
    return [mod.invoke("add", 2, 3), mod.invoke("add", 0xFFFFFFFF, 2),
            ns.circuit_witness._fnv1a_64("in"), ns.circuit_witness._fnv1a_64("")]


def case_r1cs_files(ns, fname):
    """An ``.r1cs`` that needs normalising, a ``.wtns`` and a witness
    ``.json``, written here, through each package's readers."""
    import os
    import tempfile

    from torch_circom_files import r1cs_bytes, wtns_bytes
    f = ns.fields.FIELDS[fname]
    rows = dict(num_instance=2, num_witness=3,
                a=[[(5, 3), (2, 1), (7, 3)], [(1, 2), (f.p - 1, 2), (3, 4)]],
                b=[[(1, 0)], [(f.p - 1, 4), (3, 0)]],
                c=[[(4, 2)], [(1, 1), (1, 1)]])
    values = rand_ints(12, 5, f.p)
    out = []
    with tempfile.TemporaryDirectory() as tmp:
        paths = {ext: os.path.join(tmp, "f." + ext)
                 for ext in ("r1cs", "wtns", "json")}
        with open(paths["r1cs"], "wb") as fh:
            fh.write(r1cs_bytes(f.p, **rows))
        with open(paths["wtns"], "wb") as fh:
            fh.write(wtns_bytes(f.p, values))
        with open(paths["json"], "w") as fh:
            fh.write(str([str(v + f.p) for v in values]).replace("'", '"'))
        cs = ns.circuit_r1cs.parse_r1cs(paths["r1cs"], f)
        out += [cs.num_instance, cs.num_witness, cs.num_constraints,
                cs.a, cs.b, cs.c,
                ns.circuit_r1cs.load_witness_wtns(paths["wtns"], f),
                ns.circuit_r1cs.load_witness_json(paths["json"], f)]
        circ, outs = ns.circuit_arithmetic.ArithmeticCircuit.\
            from_constraint_system(cs, f)
        out += [circ.nodes, outs]
        for bad in (b"", b"r1cs" + b"\x00" * 9):
            with open(paths["r1cs"], "wb") as fh:
                fh.write(bad)
            with pytest.raises(ValueError):
                ns.circuit_r1cs.parse_r1cs(paths["r1cs"], f)
    return out


def case_r1cs_repeated_squaring(ns, fname):
    f = ns.fields.FIELDS[fname]
    out = []
    for squarings in (1, 3, 10):
        cs = ns.circuit_r1cs.repeated_squaring_constraint_system(f, squarings)
        out += [cs.num_instance, cs.num_witness, cs.a, cs.b, cs.c,
                ns.circuit_r1cs.repeated_squaring_witness(f, 5, squarings)]
    return out


CASES = {name[5:]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}
#: cases whose inputs do not depend on the field run on BN254 only
FIELD_FREE = {"chacha_blocks_and_rng", "distinct_indices", "merkle_tree",
              "wasm_interpreter"}
#: Poseidon digests are 32-byte field elements: BN254 only
BN254_ONLY = FIELD_FREE | {"mt_params"}
PARAMS = [(case, fname) for case in CASES for fname in FIELD_NAMES
          if case not in BN254_ONLY or fname == "bn254_fr"]


@pytest.mark.parametrize("case,fname", PARAMS)
def test_copy_matches_jax_package(case, fname):
    want = plain(CASES[case](REF, fname))
    got = plain(CASES[case](PORT, fname))
    assert got == want


def test_copies_are_the_ports_own_modules():
    for name in MODULES:
        mod = getattr(PORT, name.replace(".", "_"))
        assert mod.__name__ == f"ligero_tpu_torch.{name}"
        assert "ligero_tpu_torch" in mod.__file__
    assert PORT.native._BUILD_DIR.endswith("ligero_tpu_torch/_build")
    assert PORT.native._BUILD_DIR != REF.native._BUILD_DIR
    assert PORT.native._SRC == REF.native._SRC  # the one g++ source, unchanged


def test_package_exports_match():
    import ligero_tpu
    import ligero_tpu_torch
    assert sorted(ligero_tpu_torch.__all__) == sorted(ligero_tpu.__all__)
    for name in ligero_tpu_torch.__all__:
        obj = getattr(ligero_tpu_torch, name)
        assert getattr(obj, "__module__", "ligero_tpu_torch").startswith(
            "ligero_tpu_torch")


# ---------------------------------------------------------------------------
# compile and witness: the port's own against the JAX package's
# ---------------------------------------------------------------------------

COMPILE_PARAMS = {
    "cube": dict(kind="cube"),
    "cube_rate4": dict(kind="cube", rate_inv=4),
    "synthetic_96": dict(gates=96, num_vars=4, seed=3),
    "synthetic_2e8": dict(gates=256, num_vars=64, seed=8),
    "synthetic_96_zk": dict(gates=96, num_vars=4, seed=3, lambda_=10, zk=True),
    "synthetic_2e8_zk": dict(gates=256, num_vars=64, seed=8, lambda_=20,
                             zk=True),
    "synthetic_2e10_zk_rate16": dict(gates=1024, num_vars=64, seed=10,
                                     lambda_=40, zk=True, rate_inv=16),
}


def reference_instance(spec):
    from ligero_tpu.circuit import ArithmeticCircuit
    from ligero_tpu.engine.backend import Backend
    from ligero_tpu.fields import BN254_FR as F
    from ligero_tpu.ligero import LigeroCircuit as RefCircuit
    from ligero_tpu.synthetic import generate_random_circuit
    spec = dict(spec)
    if spec.pop("kind", None) == "cube":
        c = ArithmeticCircuit(F)
        x = c.new_variable_with_label("x")
        one = c.constant(1)           # a constant 1 that is not node 0
        c.add(c.mul(c.pow(x, 3), one), c.constant(-26))
        circ, outs, vars_ = c, [c.last()], [(x, 3)]
    else:
        circ, outs, vars_ = generate_random_circuit(
            F, spec.pop("gates"), num_vars=spec.pop("num_vars"),
            seed=spec.pop("seed"))
    ref = RefCircuit(circ, outs, backend=Backend(F), **spec)
    return circ, outs, vars_, ref, spec


@pytest.mark.parametrize("name", list(COMPILE_PARAMS))
def test_compile_matches_from_reference(name):
    """The port's own compile of a circuit equals the instance carried
    across from the JAX package, field by field and array by array."""
    from ligero_tpu_torch import convert
    from ligero_tpu_torch.ligero import compile_circuit
    circ, outs, _, ref, kw = reference_instance(COMPILE_PARAMS[name])
    carried = convert.compiled_state(ref)
    own = compile_circuit(convert.circuit_from_reference(circ), outs, **kw)
    for attr in ("m", "k", "n", "t", "zk", "blind_t", "d2", "rate_inv",
                 "one_index", "one_found", "outputs", "a_vals", "blind_len",
                 "num_rows", "lin_bound", "quad_bound"):
        assert getattr(own, attr) == getattr(carried, attr), attr
        if hasattr(ref, attr):
            assert getattr(own, attr) == getattr(ref, attr), attr
    assert own.field is carried.field
    assert own.circuit.nodes == carried.circuit.nodes == ref.circuit.nodes
    assert own.circuit.constants == carried.circuit.constants
    assert own.circuit.variables == carried.circuit.variables
    assert own.a_rows.dtype == carried.a_rows.dtype == np.int64
    assert np.array_equal(own.a_rows, carried.a_rows)
    assert np.array_equal(own.a_cols, carried.a_cols)
    for i in (0, 1, 5, 1000):
        assert own.bump_index(i) == ref._bump_index(i)


@pytest.mark.parametrize("lam,rate_inv,k", [(128, 8, 2048), (128, 2, 64),
                                             (10, 8, 16), (80, 16, 512)])
def test_calculate_t_matches(lam, rate_inv, k):
    from ligero_tpu.ligero import calculate_t as ref_t
    from ligero_tpu_torch.ligero import calculate_t
    n = rate_inv * k
    for fname in FIELD_NAMES:
        assert (calculate_t(PORT.fields.FIELDS[fname], lam, (n - k + 1, n), n)
                == ref_t(REF.fields.FIELDS[fname], lam, (n - k + 1, n), n))


@pytest.mark.parametrize("evaluator,name", [
    ("native", "cube"), ("native", "synthetic_96"), ("native", "synthetic_2e8"),
    ("python", "cube"), ("python", "cube_rate4")])
def test_witness_evaluator_matches(monkeypatch, name, evaluator):
    """The port's witness evaluator (g++ kernels and Python) against the
    JAX package's, on a good and on a wrong witness."""
    from ligero_tpu_torch import convert
    from ligero_tpu_torch.ligero.witness import WitnessEvaluator
    _, _, vars_, ref, _ = reference_instance(COMPILE_PARAMS[name])
    if evaluator == "python":
        monkeypatch.setattr(PORT.native, "available", lambda: False)
    elif not PORT.native.available():
        pytest.skip("g++ host kernels did not build")
    st = convert.compiled_state(ref)
    ev = WitnessEvaluator(st)
    bumped = [(st.bump_index(i), v) for i, v in vars_]
    want = np.asarray(ref._build_preenc(bumped), dtype=np.uint32)
    got = np.asarray(ev.preenc(bumped), dtype=np.uint32)
    assert got.shape == (4 * st.m, st.k, st.field.num_limbs)
    assert np.array_equal(got, want)
    wrong = [(i, v + 1) for i, v in bumped]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want_bad = np.asarray(ref._build_preenc(wrong), dtype=np.uint32)
        got_bad = np.asarray(ev.preenc(wrong), dtype=np.uint32)
    assert np.array_equal(got_bad, want_bad)
    assert not np.array_equal(got_bad, got)
    if name.startswith("cube"):
        with pytest.warns(UserWarning, match="does not satisfy"):
            ev.preenc(wrong)
    with pytest.raises(ValueError):
        ev.preenc([(0, 1)])   # node 0 is the constant 1, not a variable


def test_python_evaluator_refuses_unreachable_nodes_like_the_jax_package(
        monkeypatch):
    """The Python evaluator traces back from the outputs: a circuit with
    gates no output depends on raises in both packages (the g++ evaluator
    runs a full forward pass and accepts it)."""
    from ligero_tpu import native as ref_native
    from ligero_tpu_torch import convert
    from ligero_tpu_torch.ligero.witness import WitnessEvaluator
    _, _, vars_, ref, _ = reference_instance(COMPILE_PARAMS["synthetic_96"])
    st = convert.compiled_state(ref)
    bumped = [(st.bump_index(i), v) for i, v in vars_]
    monkeypatch.setattr(PORT.native, "available", lambda: False)
    monkeypatch.setattr(ref_native, "available", lambda: False)
    with pytest.raises(ValueError, match="Uninitialised node"):
        ref._build_preenc(bumped)
    with pytest.raises(ValueError, match="Uninitialised node"):
        WitnessEvaluator(st).preenc(bumped)
