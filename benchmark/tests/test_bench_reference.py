"""The plain reference's pieces against hashlib, against the program's own
transcript modules and plain arithmetic, and the whole check against the
program's proofs, honest and altered."""

from __future__ import annotations

import hashlib
import random
import subprocess
import sys

import numpy as np
import pytest

from conftest import BENCH, small_config
from harness.generator import make_circuit, witness
from reference import transcript
from reference.check import Instance, _path_ok, check_proof, parse_proof
from reference.field import (Field, bytes_to_limbs, exact_dot, horner, intt,
                             ints_to_limbs, lagrange_at, normalize_limbs, ntt)

FIELDS = ["bn254_fr", "bls12_377_fq"]


def field_pair(name):
    from ligero_tpu_torch.fields import FIELDS as PF
    F = PF[name]
    return F, Field(F.p, F.generator, F.two_adicity)


def test_merkle_path_against_hashlib():
    rnd = random.Random(3)
    leaves = [hashlib.blake2s(bytes([i]) * 40).digest() for i in range(16)]
    levels = [leaves]
    while len(levels[-1]) > 1:
        lv = levels[-1]
        levels.append([hashlib.sha256(lv[2 * i] + lv[2 * i + 1]).digest()
                       for i in range(len(lv) // 2)])
    root = levels[-1][0]
    for index in rnd.sample(range(16), 5):
        auth, idx = [], index >> 1
        for lv in levels[1:-1]:
            auth.append(lv[idx ^ 1])
            idx >>= 1
        auth.reverse()
        args = (leaves[index ^ 1], auth, 4)
        assert _path_ok(root, leaves[index], index, *args)
        assert not _path_ok(root, leaves[index ^ 1], index, *args)
        assert not _path_ok(root, leaves[index], index, leaves[index ^ 1],
                            auth[:-1], 4)


@pytest.mark.parametrize("name", FIELDS)
def test_transcript_matches_the_program(name):
    from ligero_tpu_torch import sampling, sponge

    F, f = field_pair(name)
    seed = bytes(range(32))
    assert np.array_equal(transcript.rand_raw16(f, 3000, seed, "cpu").numpy(),
                          sampling.rand_field_elements_limbs(F, 3000, seed)
                          .astype(np.int64))
    for n, t in ((16384, 156), (256, 155), (512, 10)):
        assert (transcript.column_indices(n, t, seed)
                == sampling.get_distinct_indices_from_prng(n, t, seed))
    theirs, ours = sponge.test_sponge(F), transcript.Sponge(f)
    rnd = random.Random(1)
    for count in (1, 3, 2, 7, 100, 2047):
        elems = [rnd.randrange(F.p) for _ in range(count)]
        theirs.absorb_field_elems(elems)
        ours.absorb(elems)
        assert theirs.squeeze_bytes(32) == ours.squeeze_bytes(32)
        assert theirs.squeeze_bytes(32) == ours.squeeze_bytes(32)
    theirs.absorb_bytes(b"\x07" * 32)
    ours.absorb_bytes(b"\x07" * 32)
    assert theirs.squeeze_native_field_elements(3) == ours.squeeze(3)


@pytest.mark.parametrize("name", FIELDS)
def test_field_pieces(name):
    F, f = field_pair(name)
    rnd = random.Random(2)
    assert f.root_of_unity(1024) == F.root_of_unity(1024)
    co = [rnd.randrange(f.p) for _ in range(10)]
    w = f.root_of_unity(32)
    assert ntt(f, co, 32) == [horner(f, co, pow(w, j, f.p)) for j in range(32)]
    assert intt(f, ntt(f, co, 16), 16) == co + [0] * 6
    vals = [rnd.randrange(f.p) for _ in range(16)]
    z = rnd.randrange(f.p)
    assert (sum(a * b for a, b in zip(vals, lagrange_at(f, 16, z))) % f.p
            == horner(f, intt(f, vals, 16), z))
    a = [[rnd.randrange(f.p) for _ in range(70)] for _ in range(3)]
    b = [[rnd.randrange(f.p) for _ in range(5)] for _ in range(70)]
    a16 = np.stack([ints_to_limbs(f, r) for r in a])
    b16 = np.stack([ints_to_limbs(f, r) for r in b])
    assert exact_dot(a16, b16, "cpu") == [
        [sum(a[i][k] * b[k][j] for k in range(70)) for j in range(5)]
        for i in range(3)]
    data = b"".join(v.to_bytes(f.byte_size, "little") for v in vals)
    assert np.array_equal(bytes_to_limbs(f, data, 16), ints_to_limbs(f, vals))
    import torch
    sums = torch.tensor([[0xFFFF * 9, 0xFFFF * 7, 3]], dtype=torch.int64)
    norm = normalize_limbs(sums)
    got = sum(int(v) << (16 * i) for i, v in enumerate(norm[0].tolist()))
    assert got == 0xFFFF * 9 + (0xFFFF * 7 << 16) + (3 << 32)
    assert (norm < 1 << 16).all()


def test_reference_imports_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import reference.check, reference.field, reference.transcript; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'ligero_tpu_torch', 'ligero_tpu', 'jax', 'jaxlib', 'flax'}); "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code, BENCH],
                         capture_output=True, text=True, cwd="/")
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.fixture(scope="module", params=["bn254-2p20", "bls12_377-2p20"])
def proved(request):
    """(instance, witness, proof bytes) of the program at 2^8 gates."""
    from harness.cell import program_circuit
    from ligero_tpu_torch.fields import FIELDS as PF
    from ligero_tpu_torch.ligero import LigeroCircuit
    from ligero_tpu_torch.sponge import test_sponge

    cfg = small_config(request.param)
    F = PF[cfg["field"]]
    circ = make_circuit(cfg, 21)
    ac, outs = program_circuit(F, circ)
    lig = LigeroCircuit(ac, outs, device="cpu")
    wit = witness(F.p, circ, 21, "window", 0)
    proof = lig.prove(sorted(wit.items()), test_sponge(F)).to_bytes(F)
    inst = Instance.build(Field.from_config(cfg["field_params"]), circ,
                          cfg["lambda"], cfg["rate_inv"])
    return inst, wit, proof


def test_honest_proof_passes(proved):
    inst, wit, proof = proved
    fails = check_proof(inst, wit, proof, random.Random(0), "cpu")
    assert not any(fails.values()), fails


def _element_at(inst, proof, which):
    """Byte offset of an element of the proof: "lc" its first interleaved
    coefficient, "column" the first element of the first opened column,
    "q" the linear polynomial's first coefficient."""
    size = inst.field.byte_size
    at = 8 + 32 + 8
    if which == "lc":
        return at
    at += inst.k * size + 8          # past lc, at the column count
    if which == "column":
        return at + 8
    at += inst.t * (8 + inst.num_rows * size)
    pf = parse_proof(inst.field, proof, inst.num_rows)
    paths = pf.sets[0][2]
    at += 8 + sum(8 + 8 + len(s) + 8 + sum(8 + len(a) for a in auth)
                  for _, s, auth in paths)
    return at + 8


@pytest.mark.parametrize("which,expect", [("lc", "lc"), ("column", "paths"),
                                          ("q", "linear")])
def test_altered_proof_fails(proved, which, expect):
    inst, wit, proof = proved
    blob = bytearray(proof)
    at = _element_at(inst, proof, which)
    size = inst.field.byte_size
    v = int.from_bytes(blob[at:at + size], "little")
    blob[at:at + size] = ((v + 1) % inst.field.p).to_bytes(size, "little")
    fails = check_proof(inst, wit, bytes(blob), random.Random(0), "cpu")
    assert fails[expect] > 0, fails


def test_other_witness_fails(proved):
    inst, wit, proof = proved
    other = dict(wit)
    node = inst.circuit.var_nodes[1]
    other[node] = (other[node] + 1) % inst.field.p
    fails = check_proof(inst, other, proof, random.Random(0), "cpu")
    assert fails["lc"] and fails["columns"] and fails["linear"], fails


def test_truncated_proof_fails(proved):
    inst, wit, proof = proved
    fails = check_proof(inst, wit, proof[:-1], random.Random(0), "cpu")
    assert fails["parse"] == 1
