"""The port's circom ingestion (``circuit/r1cs.py``) against the JAX
package's on files the test writes itself (``tests/torch_circom_files.py``):
both parsers return equal constraint systems and witnesses, and both reject
the same malformed files with ``ValueError``."""

import random
import struct

import pytest
import torch

from ligero_tpu.circuit import r1cs as ref_r1cs
from ligero_tpu.circuit.arithmetic import ArithmeticCircuit as RefArithmetic
from ligero_tpu.fields import FIELDS as REF_FIELDS
from ligero_tpu_torch.circuit import r1cs as port_r1cs
from ligero_tpu_torch.circuit.arithmetic import ArithmeticCircuit
from ligero_tpu_torch.fields import FIELDS as PORT_FIELDS
from torch_circom_files import (multiplication, r1cs_bytes, write_cs,
                                write_witness_json, write_wtns, wtns_bytes)

# the suite runs in several worker processes that share the host's cores:
# one intra-op thread each
torch.set_num_threads(1)

BN, BLS = "bn254_fr", "bls12_377_fq"
PAIRS = [(ref_r1cs, REF_FIELDS), (port_r1cs, PORT_FIELDS)]


def as_data(cs):
    return (cs.field.name, cs.num_instance, cs.num_witness, cs.num_constraints,
            cs.a, cs.b, cs.c)


def messy_rows(p: int):
    """Rows that need the parser's normalisation: unsorted wires, a wire
    twice, coefficients that sum to zero, p - 1."""
    a = [[(5, 3), (2, 1), (7, 3)], [(1, 2), (p - 1, 2)], []]
    b = [[(1, 0)], [(p - 1, 4), (3, 0)], [(9, 4)]]
    c = [[(4, 2)], [], [(1, 1), (1, 1), (1, 1)]]
    return dict(num_instance=2, num_witness=3, a=a, b=b, c=c)


@pytest.mark.parametrize("fname", [BN, BLS])
@pytest.mark.parametrize("rows", [multiplication, messy_rows])
def test_parsers_return_equal_constraint_systems(tmp_path, fname, rows):
    p = REF_FIELDS[fname].p
    path = tmp_path / "c.r1cs"
    path.write_bytes(r1cs_bytes(p, **rows(p)))
    want = ref_r1cs.parse_r1cs(str(path), REF_FIELDS[fname])
    got = port_r1cs.parse_r1cs(str(path), PORT_FIELDS[fname])
    assert as_data(got) == as_data(want)
    assert got.num_constraints == len(rows(p)["a"])
    assert type(got).__module__ == "ligero_tpu_torch.circuit.r1cs"
    assert as_data(port_r1cs.read_constraint_system(
        str(path), PORT_FIELDS[fname])) == as_data(want)
    cs, compute = port_r1cs.read_constraint_system(
        str(path), PORT_FIELDS[fname], wasm_path=str(tmp_path / "none.wasm"))
    assert as_data(cs) == as_data(want) and callable(compute)


@pytest.mark.parametrize("squarings", [1, 2, 10])
def test_repeated_squaring_round_trips_through_a_file(tmp_path, squarings):
    ref_cs = ref_r1cs.repeated_squaring_constraint_system(REF_FIELDS[BN],
                                                          squarings)
    port_cs = port_r1cs.repeated_squaring_constraint_system(PORT_FIELDS[BN],
                                                            squarings)
    assert as_data(port_cs) == as_data(ref_cs)
    path = write_cs(tmp_path / "sq.r1cs", port_cs)
    assert as_data(port_r1cs.parse_r1cs(path, PORT_FIELDS[BN])) == as_data(ref_cs)
    assert as_data(ref_r1cs.parse_r1cs(path, REF_FIELDS[BN])) == as_data(ref_cs)
    wit = port_r1cs.repeated_squaring_witness(PORT_FIELDS[BN], 3, squarings)
    assert wit == ref_r1cs.repeated_squaring_witness(REF_FIELDS[BN], 3, squarings)
    assert wit[1] == pow(3, 2 ** squarings, PORT_FIELDS[BN].p)
    # the same circuit comes out of both packages' constraint systems
    circ, outs = ArithmeticCircuit.from_constraint_system(port_cs,
                                                          PORT_FIELDS[BN])
    ref_circ, ref_outs = RefArithmetic.from_constraint_system(ref_cs,
                                                              REF_FIELDS[BN])
    assert (circ.nodes, outs) == (ref_circ.nodes, ref_outs)


@pytest.mark.parametrize("fname", [BN, BLS])
def test_witness_loaders_return_equal_witnesses(tmp_path, fname):
    p = REF_FIELDS[fname].p
    values = [1, 15, 3, 5, p - 1, 0, p + 7]      # p + 7 reduces in the json
    wtns = write_wtns(tmp_path / "w.wtns", p, values)
    js = write_witness_json(tmp_path / "w.json", values)
    for load in ("load_witness_wtns", "load_witness_json"):
        path = wtns if load.endswith("wtns") else js
        want = getattr(ref_r1cs, load)(path, REF_FIELDS[fname])
        assert getattr(port_r1cs, load)(path, PORT_FIELDS[fname]) == want
        assert want == [v % p for v in values]


def good_r1cs() -> bytes:
    p = REF_FIELDS[BN].p
    return r1cs_bytes(p, **multiplication(p))


# the mangles of tests/test_r1cs_fuzz.py
MANGLES = [
    lambda g: b"",
    lambda g: b"XXXX" + g[4:],                                # bad magic
    lambda g: g[:20],                                         # truncated
    lambda g: g[:len(g) // 2],                                # mid-truncated
    lambda g: bytes(random.Random(1).randbytes(200)),         # garbage
    lambda g: g[:8] + struct.pack("<I", 2**31) + g[12:],      # huge count
]


@pytest.mark.parametrize("mangle", range(len(MANGLES)))
def test_malformed_r1cs_raises_valueerror_in_both(tmp_path, mangle):
    path = tmp_path / "f.r1cs"
    path.write_bytes(MANGLES[mangle](good_r1cs()))
    for mod, fields in PAIRS:
        with pytest.raises(ValueError):
            mod.parse_r1cs(str(path), fields[BN])


def test_wrong_field_raises_valueerror_in_both(tmp_path):
    path = tmp_path / "f.r1cs"
    path.write_bytes(good_r1cs())
    for mod, fields in PAIRS:
        with pytest.raises(ValueError, match="prime"):
            mod.parse_r1cs(str(path), fields[BLS])


def test_bit_flips_parse_alike_or_raise_valueerror_in_both(tmp_path):
    """Every single-bit flip parses to the same system in both packages or
    raises ValueError in both; nothing else escapes."""
    good = good_r1cs()
    rng = random.Random(2)
    for _ in range(80):
        data = bytearray(good)
        data[rng.randrange(len(data))] ^= 1 << rng.randrange(8)
        path = tmp_path / "f.r1cs"
        path.write_bytes(bytes(data))
        results = []
        for mod, fields in PAIRS:
            try:
                results.append(as_data(mod.parse_r1cs(str(path), fields[BN])))
            except ValueError as e:
                results.append(str(e))
        assert results[0] == results[1]


def test_malformed_wtns_raises_valueerror_in_both(tmp_path):
    good = wtns_bytes(REF_FIELDS[BN].p, [1, 15, 3, 5])
    for data in (b"", b"XXXX", b"wtns" + b"\x00" * 4,
                 b"wtns" + struct.pack("<II", 2, 1) + b"\x01" * 6,
                 good[:30], good[:12] + good[12 + 48:]):
        path = tmp_path / "w.wtns"
        path.write_bytes(data)
        for mod, fields in PAIRS:
            with pytest.raises(ValueError):
                mod.load_witness_wtns(str(path), fields[BN])


def test_malformed_wasm_raises_valueerror_in_both(tmp_path):
    """``compute_witness_wasm`` maps interpreter failures to ValueError."""
    add_wasm = bytes.fromhex(
        "0061736d01000000" "0107016002" "7f7f017f" "03020100"
        "070701036164640000" "0a09010700200020016a0b")   # valid, not circom's
    for data in (b"", b"XXXX" + add_wasm[4:], add_wasm[:20], add_wasm,
                 bytes(random.Random(3).randbytes(300))):
        path = tmp_path / "w.wasm"
        path.write_bytes(data)
        for mod, fields in PAIRS:
            with pytest.raises(ValueError):
                mod.compute_witness_wasm(str(path), {"s1": 3, "s2": 5},
                                         fields[BN])
