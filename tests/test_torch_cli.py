"""The port's command line (``python -m ligero_tpu_torch``) with ``--cpu``,
on files the test writes itself: round trip, rejected and malformed proofs,
bad arguments, warmup, and proof bytes equal to the JAX package's CLI for
the same ``.r1cs`` and witness."""

import json
import os
import subprocess
import sys

import pytest
import torch

from ligero_tpu.cli import main as ref_main
from ligero_tpu_torch.circuit.r1cs import (repeated_squaring_constraint_system,
                                           repeated_squaring_witness)
from ligero_tpu_torch.cli import main
from ligero_tpu_torch.fields import BN254_FR as PF
from torch_circom_files import (multiplication, multiplication_witness,
                                r1cs_bytes, write_cs, write_witness_json,
                                write_wtns)

# the suite runs in several worker processes that share the host's cores:
# one intra-op thread each
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def files(tmp_path):
    """(.r1cs, witness .json, witness .wtns) of the multiplication circuit."""
    r1cs = tmp_path / "mult.r1cs"
    r1cs.write_bytes(r1cs_bytes(PF.p, **multiplication(PF.p)))
    wit = multiplication_witness()
    return (str(r1cs), write_witness_json(tmp_path / "w.json", wit),
            write_wtns(tmp_path / "w.wtns", PF.p, wit))


def test_cli_info(files, capsys):
    assert main(["info", "--r1cs", files[0], "--cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["constraints"] == 1 and out["wires"] == 4
    assert out["device"] == "cpu" and out["zk"] is False
    assert ref_main(["info", "--r1cs", files[0]]) == 0
    ref = json.loads(capsys.readouterr().out)
    for key in ("m", "k", "n", "t", "nodes", "rate", "committed_matrix"):
        assert out[key] == ref[key]


def test_cli_round_trip_and_bytes_equal_the_jax_package(files, tmp_path, capsys):
    r1cs, wjson, wtns = files
    proofs = {}
    for name, wit in (("json", wjson), ("wtns", wtns)):
        out = tmp_path / f"p_{name}.bin"
        assert main(["prove", "--r1cs", r1cs, "--witness", wit, "--cpu",
                     "--out", str(out)]) == 0
        meta = json.loads(capsys.readouterr().out)
        assert meta["bytes"] == out.stat().st_size and meta["device"] == "cpu"
        proofs[name] = out.read_bytes()
    assert proofs["json"] == proofs["wtns"]
    ref_out = tmp_path / "ref.bin"
    assert ref_main(["prove", "--r1cs", r1cs, "--witness", wtns,
                     "--out", str(ref_out)]) == 0
    capsys.readouterr()
    assert ref_out.read_bytes() == proofs["wtns"]
    assert main(["verify", "--r1cs", r1cs, "--cpu",
                 "--proof", str(tmp_path / "p_wtns.bin")]) == 0
    assert json.loads(capsys.readouterr().out)["verified"] is True
    assert ref_main(["verify", "--r1cs", r1cs,
                     "--proof", str(tmp_path / "p_wtns.bin")]) == 0
    capsys.readouterr()


def test_cli_bls12_377_field_bytes_equal_the_jax_package(tmp_path, capsys):
    """``--field bls12_377_fq``: a .r1cs of 48-byte elements, the port's
    proof equal to the JAX package's CLI, verified, a flipped byte
    rejected."""
    from ligero_tpu_torch.fields import BLS12_377_FQ
    p = BLS12_377_FQ.p
    r1cs = tmp_path / "mult_bls.r1cs"
    r1cs.write_bytes(r1cs_bytes(p, **multiplication(p)))
    wtns = write_wtns(tmp_path / "w.wtns", p, multiplication_witness(2))
    field = ["--field", "bls12_377_fq"]
    out, ref_out = tmp_path / "p.bin", tmp_path / "ref.bin"
    assert main(["prove", "--r1cs", str(r1cs), "--witness", wtns, "--cpu",
                 "--out", str(out), *field]) == 0
    assert json.loads(capsys.readouterr().out)["bytes"] == out.stat().st_size
    assert ref_main(["prove", "--r1cs", str(r1cs), "--witness", wtns,
                     "--out", str(ref_out), *field]) == 0
    capsys.readouterr()
    assert out.read_bytes() == ref_out.read_bytes()
    assert main(["verify", "--r1cs", str(r1cs), "--cpu", "--proof", str(out),
                 *field]) == 0
    assert json.loads(capsys.readouterr().out)["verified"] is True
    data = bytearray(out.read_bytes())
    data[8 + 32 + 8] ^= 1
    out.write_bytes(bytes(data))
    assert main(["verify", "--r1cs", str(r1cs), "--cpu", "--proof", str(out),
                 *field]) == 1
    capsys.readouterr()


def test_cli_verify_rejects_tampered_malformed_and_wrong_witness(
        files, tmp_path, capsys):
    r1cs, _, wtns = files
    proof = tmp_path / "proof.bin"
    assert main(["prove", "--r1cs", r1cs, "--witness", wtns, "--cpu",
                 "--out", str(proof)]) == 0
    capsys.readouterr()
    blob = bytearray(proof.read_bytes())
    blob[50] ^= 1
    bad = tmp_path / "bad.bin"
    bad.write_bytes(bytes(blob))
    assert main(["verify", "--r1cs", r1cs, "--cpu", "--proof", str(bad)]) == 1
    assert json.loads(capsys.readouterr().out)["verified"] is False
    trunc = tmp_path / "trunc.bin"
    trunc.write_bytes(proof.read_bytes()[:40])
    assert main(["verify", "--r1cs", r1cs, "--cpu", "--proof", str(trunc)]) == 1
    out = json.loads(capsys.readouterr().out)
    assert out["verified"] is False and "malformed" in out["error"]
    wrong = write_wtns(tmp_path / "wrong.wtns", PF.p, [1, 16, 3, 5])
    lied = tmp_path / "lied.bin"
    with pytest.warns(UserWarning, match="does not satisfy"):
        assert main(["prove", "--r1cs", r1cs, "--witness", wrong, "--cpu",
                     "--out", str(lied)]) == 0
    capsys.readouterr()
    assert main(["verify", "--r1cs", r1cs, "--cpu", "--proof", str(lied)]) == 1
    capsys.readouterr()


def test_cli_zk_with_a_pinned_seed(tmp_path, capsys):
    cs = repeated_squaring_constraint_system(PF, 64)
    r1cs = write_cs(tmp_path / "sq.r1cs", cs)
    wtns = write_wtns(tmp_path / "sq.wtns", PF.p,
                      repeated_squaring_witness(PF, 3, 64))
    common = ["--r1cs", r1cs, "--cpu", "--zk", "--security", "10"]
    outs = []
    for name in ("a", "b"):
        out = tmp_path / f"{name}.bin"
        assert main(["prove", *common, "--witness", wtns, "--out", str(out),
                     "--zk-seed", "07" * 32]) == 0
        capsys.readouterr()
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]
    ref_out = tmp_path / "ref.bin"
    assert ref_main(["prove", "--r1cs", r1cs, "--zk", "--security", "10",
                     "--witness", wtns, "--out", str(ref_out),
                     "--zk-seed", "07" * 32]) == 0
    capsys.readouterr()
    assert ref_out.read_bytes() == outs[0]
    assert main(["verify", *common, "--proof", str(tmp_path / "a.bin")]) == 0
    assert json.loads(capsys.readouterr().out)["verified"] is True
    assert main(["info", *common]) == 0
    assert json.loads(capsys.readouterr().out)["zk"] is True


def test_cli_warmup(files, capsys):
    assert main(["warmup", "--r1cs", files[0], "--cpu"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["warmed"] == files[0] and out["device"] == "cpu"
    assert "prove_s" in out and "verify_s" in out


def test_cli_bad_arguments(files, tmp_path):
    r1cs = files[0]
    with pytest.raises(SystemExit):
        main(["prove", "--r1cs", r1cs, "--cpu"])        # no witness source
    with pytest.raises(SystemExit):
        main(["info", "--r1cs", r1cs, "--cpu", "--field", "nope"])
    with pytest.raises(SystemExit):
        main(["info", "--r1cs", r1cs, "--jax"])         # no such option here
    with pytest.raises(SystemExit):
        main(["frobnicate"])
    garbage = tmp_path / "garbage.r1cs"
    garbage.write_bytes(b"r1cs" + b"\x00" * 30)
    with pytest.raises(ValueError):
        main(["info", "--r1cs", str(garbage), "--cpu"])


def test_cli_runs_on_the_card_unless_asked_for_the_cpu(files):
    """With no ``--cpu`` every verb takes the CUDA device, and raises where
    there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for verb in (["info"], ["warmup"], ["verify", "--proof", files[1]],
                 ["prove", "--witness", files[1]]):
        with pytest.raises(RuntimeError, match="cuda"):
            main([*verb, "--r1cs", files[0]])
    with pytest.raises(RuntimeError, match="cuda"):
        main(["serve", "--port", "0"])


def test_module_entry_point_runs_as_a_subprocess(files):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, "-m", "ligero_tpu_torch", "info", "--r1cs", files[0],
         "--cpu"], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout)["constraints"] == 1


@pytest.mark.cuda
def test_cli_on_the_card_equals_cpu(files, tmp_path, capsys):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r1cs, _, wtns = files
    on_card, on_cpu = tmp_path / "card.bin", tmp_path / "cpu.bin"
    assert main(["prove", "--r1cs", r1cs, "--witness", wtns,
                 "--out", str(on_card)]) == 0
    assert json.loads(capsys.readouterr().out)["device"].startswith("cuda")
    assert main(["prove", "--r1cs", r1cs, "--witness", wtns, "--cpu",
                 "--out", str(on_cpu)]) == 0
    capsys.readouterr()
    assert on_card.read_bytes() == on_cpu.read_bytes()
    assert main(["verify", "--r1cs", r1cs, "--proof", str(on_card)]) == 0
