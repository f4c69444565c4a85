"""The graft entry points of the port: the counterpart of the top-level
``__graft_entry__.py`` (the JAX package's, which it leaves as it is).

``entry()`` returns the prover's compute core and example inputs;
``dryrun_multichip(n)`` runs the sharded core and a full proof over a mesh
of n devices, in direct and in streaming mode, each proof byte-equal to one
device's.  Both run on the card unless the caller names ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np

from .engine.backend import TorchBackend, resolve_device
from .fields import BN254_FR

#: the card's example core: the bench-validated shape of the JAX entry
CARD_SHAPE = (256, 512, 4096)
#: the full proofs' circuit: generate_random_circuit(F, 600, num_vars=8,
#: seed=11), the JAX entry's
PROOF_GATES, PROOF_VARS, PROOF_SEED = 600, 8, 11


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {what}")


def _example_shapes(n_devices: int = 1) -> tuple[int, int, int]:
    """(4m, k, n) of the JAX entry's CPU shapes: 16 rows a device, k = 16,
    n = 8 k."""
    four_m, k = 16 * max(1, n_devices), 16
    return four_m, k, 8 * k


def _inputs(field, four_m: int, k: int):
    """The JAX entry's inputs: ``default_rng(0)``, 62-bit values, as host
    Montgomery limb arrays."""
    rng = np.random.default_rng(0)
    preenc = field.ints_to_mont_limbs(
        [int(x) for x in rng.integers(0, 2 ** 62, four_m * k)]
    ).reshape(four_m, k, field.num_limbs)
    r = field.ints_to_mont_limbs(
        [int(x) for x in rng.integers(0, 2 ** 62, four_m)])
    return preenc, r


def entry(device=None):
    """``(fn, (preenc, r))``: the single-device prover core over BN254 Fr
    (``parallel.make_prover_core``) and inputs for it on the device: 256 x
    512 -> 4096 on the card, :func:`_example_shapes` on the CPU."""
    from .parallel import make_prover_core

    dev = resolve_device(device)
    four_m, k, n = CARD_SHAPE if dev.type == "cuda" else _example_shapes()
    be = TorchBackend(BN254_FR, dev)
    preenc, r = _inputs(BN254_FR, four_m, k)
    return (make_prover_core(BN254_FR, four_m, k, n, device=dev),
            (be.asarray(preenc), be.asarray(r)))


def mesh_devices(n_devices: int, device=None) -> list[str]:
    """n devices: ``device`` repeated where given (``"cpu"``), else the
    cards, as many distinct ones as the host has (the one card repeated on
    a one-card host)."""
    import torch

    if device is not None:
        return [str(resolve_device(device))] * n_devices
    resolve_device(None)                     # raises without a card
    count = torch.cuda.device_count()
    return [f"cuda:{i % count}" for i in range(n_devices)]


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run over a mesh of ``n_devices`` (:func:`mesh_devices`; a device may
    repeat): (1) the sharded core at :func:`_example_shapes`, its output
    shapes checked and its outputs equal to the single core's; (2) a full
    ``ShardedBackend`` prove and verify of the JAX entry's 600-gate
    circuit, the proof byte-equal to one device's; (3) the same in
    streaming mode over the mesh, forced by a memory budget at the mesh's
    streaming estimate (chunks of a quarter of a device's rows, at least
    one step of every device), byte-equal again.  Returns the proof bytes,
    the committed rows and the streaming chunk rows; any difference
    raises."""
    import torch

    from .ligero import LigeroCircuit
    from .parallel import (RowMesh, ShardedBackend, make_prover_core,
                           make_sharded_prover_core)
    from .sponge import test_sponge
    from .synthetic import generate_random_circuit

    field = BN254_FR
    mesh = RowMesh(mesh_devices(n_devices, device))
    ctrl = mesh.devices[0]
    four_m, k, n = _example_shapes(n_devices)
    preenc, r = _inputs(field, four_m, k)
    u_blocks, leaves, root, lc = make_sharded_prover_core(
        field, mesh, four_m, k, n)(preenc, r)
    u = torch.cat([b.to(ctrl) for b in u_blocks])
    leaves = torch.cat([lv.to(ctrl) for lv in leaves])
    L = field.num_limbs
    _require(tuple(u.shape) == (four_m, n, L)
             and tuple(leaves.shape) == (n, 8) and tuple(root.shape) == (8,)
             and tuple(lc.shape) == (k, L),
             f"core output shapes {tuple(u.shape)}, {tuple(leaves.shape)}, "
             f"{tuple(root.shape)}, {tuple(lc.shape)}")
    one = make_prover_core(field, four_m, k, n, device=ctrl)(preenc, r)
    _require(all(torch.equal(got, want) for got, want
                 in zip((u, leaves, root, lc), one)),
             "the sharded core differs from the single core")

    circ, outs, vars_ = generate_random_circuit(field, PROOF_GATES,
                                                num_vars=PROOF_VARS,
                                                seed=PROOF_SEED)
    sp = test_sponge(field)
    single = LigeroCircuit(circ, outs, device=ctrl).prove(
        vars_, sp.clone()).to_bytes(field)
    be = ShardedBackend(field, mesh)
    lig = LigeroCircuit(circ, outs, backend=be)
    proof = lig.prove(vars_, sp.clone())
    _require(lig.verify(proof, sp.clone()), "the sharded proof does not "
             "verify")
    _require(proof.to_bytes(field) == single, "the sharded proof differs "
             "from one device's")

    dims = (lig.num_rows, lig.k, lig.n, len(lig.state.a_vals), lig.blind_t,
            lig.d2)
    chunk = max(4, -(-lig.num_rows // (4 * mesh.size)) // 4 * 4)
    budget = be.streaming_bytes(*dims, chunk_rows=chunk)
    _require(budget < be.direct_bytes(*dims), "the streaming estimate does "
             "not lie under the direct one")
    card = TorchBackend.memory_budget
    TorchBackend.memory_budget = lambda self: budget
    try:
        lig_s = LigeroCircuit(circ, outs, backend=ShardedBackend(field, mesh))
    finally:
        TorchBackend.memory_budget = card
    _require(lig_s.encode_mode == "streaming", f"{lig_s.encode_mode} mode "
             "under the streaming budget")
    proof_s = lig_s.prove(vars_, sp.clone())
    _require(lig_s.verify(proof_s, sp.clone()), "the mesh-streaming proof "
             "does not verify")
    _require(proof_s.to_bytes(field) == single, "the mesh-streaming proof "
             "differs from one device's")
    return {"proof": single, "rows": lig.num_rows,
            "chunk_rows": lig_s.chunk_rows,
            "devices": [str(d) for d in mesh.devices]}
