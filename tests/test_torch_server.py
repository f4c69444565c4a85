"""The port's HTTP prover service (``ligero_tpu_torch/server.py``) with
``device="cpu"``, started in a thread on an ephemeral port, on files the
test writes itself: round trip, batch endpoints, warmup, rejected and
malformed proofs, errors, and proof bytes equal to the JAX package's
service for the same ``.r1cs`` and witness."""

import json
import threading
import urllib.error
import urllib.request
from http.server import HTTPServer

import pytest
import torch

from ligero_tpu.server import ProverService as RefService
from ligero_tpu_torch.fields import BN254_FR as PF
from ligero_tpu_torch.server import ProverService, make_handler
from torch_circom_files import (multiplication, multiplication_witness,
                                r1cs_bytes)

# the suite runs in several worker processes that share the host's cores:
# one intra-op thread each
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def r1cs(tmp_path_factory):
    path = tmp_path_factory.mktemp("srv") / "mult.r1cs"
    path.write_bytes(r1cs_bytes(PF.p, **multiplication(PF.p)))
    return str(path)


@pytest.fixture(scope="module")
def server_url():
    httpd = HTTPServer(("127.0.0.1", 0),
                       make_handler(ProverService(device="cpu")))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=10)


def post(url, path, obj):
    req = urllib.request.Request(url + path, json.dumps(obj).encode(),
                                 {"Content-Type": "application/json"})
    with urllib.request.urlopen(req) as r:
        return json.loads(r.read())


def get(url, path):
    with urllib.request.urlopen(url + path) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def registered(server_url, r1cs):
    info = post(server_url, "/circuits", {"name": "mult", "r1cs": r1cs})
    assert info["constraints"] == 1 and info["zk"] is False
    return server_url


def test_service_health_and_register(registered):
    health = get(registered, "/health")
    assert health["status"] == "ok" and health["device"] == "cpu"
    assert health["field"] == "bn254_fr" and "mult" in health["circuits"]


def test_service_round_trip_and_bytes_equal_the_jax_package(registered, r1cs):
    wit = [str(v) for v in multiplication_witness()]
    res = post(registered, "/prove", {"name": "mult", "witness": wit})
    assert res["bytes"] == len(bytes.fromhex(res["proof"]))
    assert post(registered, "/verify",
                {"name": "mult", "proof": res["proof"]})["verified"] is True
    ref = RefService()
    ref.register("mult", r1cs)
    assert ref.prove("mult", witness=wit)["proof"] == res["proof"]
    assert ref.verify("mult", res["proof"])["verified"] is True


def test_service_rejects_tampered_and_malformed_proofs(registered):
    res = post(registered, "/prove",
               {"name": "mult", "witness": multiplication_witness(1)})
    bad = bytearray(bytes.fromhex(res["proof"]))
    bad[50] ^= 1
    assert post(registered, "/verify", {
        "name": "mult", "proof": bytes(bad).hex()})["verified"] is False
    out = post(registered, "/verify", {"name": "mult", "proof": "deadbeef"})
    assert out["verified"] is False and "malformed" in out["error"]


def test_service_batch_endpoints(registered):
    witnesses = [multiplication_witness(i) for i in range(3)]
    batch = post(registered, "/prove", {"name": "mult", "witnesses": witnesses})
    assert len(batch["proofs"]) == 3 and batch["proofs_per_s"] > 0
    singles = [post(registered, "/prove", {"name": "mult", "witness": w})["proof"]
               for w in witnesses]
    assert batch["proofs"] == singles
    flipped = bytearray(bytes.fromhex(singles[1]))
    flipped[50] ^= 1
    out = post(registered, "/verify", {"name": "mult", "proofs": [
        singles[0], bytes(flipped).hex(), "deadbeef", singles[2]]})
    assert out["verified"] == [True, False, False, True]
    assert post(registered, "/verify",
                {"name": "mult", "proofs": []})["verified"] == []
    assert post(registered, "/prove",
                {"name": "mult", "witnesses": []})["proofs"] == []


def test_service_warmup(registered):
    out = post(registered, "/warmup", {"name": "mult"})
    assert out["warmed"] == "mult" and "prove_s" in out and "verify_s" in out


def test_service_refuses_zk_for_a_circuit_too_small_for_it(registered, r1cs):
    # one constraint cannot carry the blinding at the default security level
    with pytest.raises(urllib.error.HTTPError) as e:
        post(registered, "/circuits", {"name": "z", "r1cs": r1cs, "zk": True})
    assert e.value.code == 400
    assert "z" not in get(registered, "/health")["circuits"]


def test_service_errors(registered):
    for path, body in (
            ("/prove", {"name": "nope", "witness": [1, 2]}),
            ("/circuits", {"name": "x", "r1cs": "/no/such.r1cs"}),
            ("/prove", {"name": "mult"}),                 # no witness source
            ("/verify", {"name": "mult"}),                # no proof
            ("/prove", {"name": "mult", "witness": 5}),   # not a list
            ("/verify", {"name": "mult", "proof": 5}),    # not hex text
            ("/warmup", {"name": "nope"})):
        with pytest.raises(urllib.error.HTTPError) as e:
            post(registered, path, body)
        assert e.value.code == 400
    for call in (lambda: post(registered, "/nowhere", {}),
                 lambda: get(registered, "/nowhere")):
        with pytest.raises(urllib.error.HTTPError) as e:
            call()
        assert e.value.code == 404


def test_service_takes_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ProverService()
    assert ProverService(device="cpu").health()["device"] == "cpu"


@pytest.mark.cuda
def test_service_on_the_card_equals_cpu(r1cs):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    on_card, on_cpu = ProverService(), ProverService(device="cpu")
    assert on_card.health()["device"].startswith("cuda")
    witnesses = [multiplication_witness(i) for i in range(2)]
    for svc in (on_card, on_cpu):
        svc.register("mult", r1cs)
    got = on_card.prove_batch("mult", witnesses)["proofs"]
    assert got == on_cpu.prove_batch("mult", witnesses)["proofs"]
    assert on_card.verify_batch("mult", got)["verified"] == [True, True]
