"""The port's benchmark (``python -m ligero_tpu_torch.bench``) on the CPU
at the ``small`` scale: one JSON line under 2000 characters after a canary
that holds the prover core's outputs against its kernels' plain versions
and the device sampler against the host one; a canary that finds a
difference exits non-zero with no number.  The core's unit of work is the
JAX bench's, so its outputs at that scale equal the JAX package's host
golden (``Backend(F)``, ``column_hash``, ``MerkleTree``) on the same
seeded inputs; the tolerance is none (exact integer arithmetic)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ligero_tpu.engine.backend import Backend
from ligero_tpu.fields import BN254_FR
from ligero_tpu.hashes import column_hash
from ligero_tpu.merkle import MerkleTree
from ligero_tpu_torch import bench
from ligero_tpu_torch.fields import FIELDS as PORT_FIELDS

# one intra-op thread: the workers of the suite share the host's cores
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_bench_prints_one_short_json_line_after_the_canary():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
               LIGERO_BENCH_SCALE="small")
    res = subprocess.run([sys.executable, "-m", "ligero_tpu_torch.bench",
                          "--device", "cpu"], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1 and len(lines[0]) < 2000
    line = json.loads(lines[0])
    assert line["metric"] == bench.METRIC and line["unit"] == "field elems/s"
    four_m, k = bench.SCALES["small"]
    cfg = line["config"]
    assert (cfg["rows_4m"], cfg["k"], cfg["n"]) == (four_m, k, 8 * k)
    assert cfg["device"] == "cpu" and cfg["card"] is None
    assert cfg["canary"].startswith("ok ")
    assert not any(json.loads(cfg["canary"][3:]).values())
    assert line["value"] == pytest.approx(four_m * 8 * k / cfg["step_s"],
                                          rel=1e-3)


def test_a_canary_difference_exits_nonzero_with_no_number(monkeypatch,
                                                          capsys):
    from ligero_tpu_torch import parallel

    real = parallel.make_prover_core

    def corrupt(*args, **kw):
        fn = real(*args, **kw)

        def bad(preenc, r):
            u, leaves, root, lc = fn(preenc, r)
            u = u.clone()
            u[0, 0, 0] ^= 1
            return u, leaves, root, lc
        return bad

    monkeypatch.setattr(parallel, "make_prover_core", corrupt)
    assert bench.main(["--device", "cpu", "--scale", "small"]) == 1
    out = capsys.readouterr()
    assert out.out == ""
    failed = json.loads(out.err)
    assert failed["metric"] == "CANARY FAILED"
    assert failed["canary"]["u_rows"] == 1
    assert "value" not in failed


def test_bench_core_equals_the_jax_host_golden():
    """The timed function at the small scale, on seeded inputs, against the
    JAX package's numpy host path: U, the leaves, the root and lc."""
    from ligero_tpu_torch.parallel import make_prover_core

    four_m, k = bench.SCALES["small"]
    n = 8 * k
    rng = np.random.default_rng(5)
    preenc = BN254_FR.ints_to_mont_limbs(
        [int(x) for x in rng.integers(0, 2 ** 62, four_m * k)]
    ).reshape(four_m, k, -1)
    r = BN254_FR.ints_to_mont_limbs(
        [int(x) for x in rng.integers(0, 2 ** 62, four_m)])
    u, leaves, root, lc = make_prover_core(
        PORT_FIELDS[BN254_FR.name], four_m, k, n, device="cpu")(preenc, r)
    be = Backend(BN254_FR)
    _, evals = be.rs_encode_rows(preenc, k, n)
    u_h = be.to_numpy(be.from_mont(evals))
    assert np.array_equal(u.numpy().view(np.uint32), u_h)
    host_leaves = [column_hash(BN254_FR, BN254_FR.limbs_to_ints(u_h[:, j]))
                   for j in range(n)]
    got = leaves.numpy().view(np.uint32).astype("<u4")
    assert [got[j].tobytes() for j in range(n)] == host_leaves
    assert (root.numpy().view(np.uint32).astype(">u4").tobytes()
            == MerkleTree(host_leaves).root)
    assert np.array_equal(lc.numpy().view(np.uint32),
                          be.to_numpy(be.row_combine(r, preenc)))
