"""The generator's circuits and witnesses, and the reference's reading of
the circuit, against the program's own compile and witness layout (the
tests, unlike the reference, may import the program)."""

from __future__ import annotations

import numpy as np
import pytest

from conftest import small_config
from harness.generator import make_circuit, witness
from reference.check import ADD, Instance
from reference.field import Field

SEEDS = [0, 7, 2**31 + 5, 3**40]


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", ["bn254-2p20", "bls12_377-2p20"])
def test_witnesses_satisfy_and_differ(name, seed):
    cfg = small_config(name, 12)
    fld = Field.from_config(cfg["field_params"])
    circ = make_circuit(cfg, seed)
    inst = Instance.build(fld, circ, cfg["lambda"], cfg["rate_inv"])
    draws = [witness(fld.p, circ, seed, "window", i) for i in range(40)]
    assert len({tuple(sorted(d.items())) for d in draws}) == len(draws)
    for d in draws[:3]:
        vals = inst.evaluate(d)
        assert [vals[o] for o in circ.outputs] == [1]
    assert circ.kinds[circ.outputs[0]] == ADD


def test_circuit_follows_the_seed():
    cfg = small_config("bn254-2p20", 10)
    a, b, c = (make_circuit(cfg, s) for s in (3, 3, 4))
    assert np.array_equal(a.lefts, b.lefts)
    assert np.array_equal(a.kinds, b.kinds)
    assert not np.array_equal(a.lefts, c.lefts)
    first = 1 + cfg["num_vars"]
    ids = np.arange(len(a.kinds))[first:-1]
    ops = np.concatenate([a.lefts[first:-1], a.rights[first:-1]])
    assert (ops >= 1).all()
    assert (a.lefts[first:-1] < ids).all() and (a.rights[first:-1] < ids).all()
    assert (ids - a.lefts[first:-1] <= cfg["fan_in_window"]).all()


@pytest.mark.parametrize("name", ["bn254-2p20", "bls12_377-2p20"])
def test_reference_layout_matches_the_program(name):
    """The reference's m, k, n, t, message rows and constraint matrix
    equal what the program compiles from the same circuit."""
    from harness.cell import program_circuit
    from ligero_tpu_torch.fields import FIELDS
    from ligero_tpu_torch.ligero.compile import compile_circuit
    from ligero_tpu_torch.ligero.witness import WitnessEvaluator

    cfg = small_config(name, 9)
    F = FIELDS[cfg["field"]]
    fld = Field.from_config(cfg["field_params"])
    circ = make_circuit(cfg, 11)
    ac, outs = program_circuit(F, circ)
    st = compile_circuit(ac, outs, cfg["lambda"], cfg["rate_inv"])
    inst = Instance.build(fld, circ, cfg["lambda"], cfg["rate_inv"])
    assert (st.m, st.k, st.n, st.t) == (inst.m, inst.k, inst.n, inst.t)
    wit = witness(fld.p, circ, 11, "window", 0)
    pre = WitnessEvaluator(st).preenc(sorted(wit.items()))
    mine = inst.messages(inst.evaluate(wit))
    canon = F.mont_limbs_to_ints(pre.reshape(-1, F.num_limbs))
    ours = [int.from_bytes(r.tobytes(), "little")
            for r in mine.reshape(-1, fld.limbs)]
    assert canon == ours
    rows, cols, signs, other = inst.constraint_entries()
    got = {}
    for r, c, s in zip(rows.tolist(), cols.tolist(), signs.tolist()):
        got[(r, c)] = (got.get((r, c), 0) + s) % fld.p
    for r, c, v in other:
        got[(r, c)] = (got.get((r, c), 0) + v) % fld.p
    want = {}
    for r, c, v in zip(st.a_rows.tolist(), st.a_cols.tolist(), st.a_vals):
        want[(r, c)] = (want.get((r, c), 0) + v) % fld.p
    strip = lambda d: {key: v for key, v in d.items() if v}  # noqa: E731
    assert strip(got) == strip(want)
