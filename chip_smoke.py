#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

It runs every phase, in order; any failure exits non-zero:

1. device   -- require CUDA; print the card's nvidia-smi name and power limit.
2. build    -- build the kernels of ``ligero_tpu_torch/csrc`` with nvcc (both
               fields' instantiations; ptxas's register and spill lines,
               the Blake2s, row_combine and NTT instantiations by name,
               failing where a BLS12-377 NTT instantiation spills); where
               row_combine's row loop stands its cp.async copies and its
               wide multiply-adds, and the Blake2s compression loop's
               instructions by pipe against its bound (SASS).
3. kernels  -- each kernel against its plain PyTorch version on the card, at
               the 2^20-gate shapes of both paths (plain and zk); bit-equal
               (tolerance 0: exact integer arithmetic), both times printed,
               and the least time the card could take for the same work
               (bytes over the memory rate, or integer operations over the
               instruction rate) beside them, and each kernel's device
               time (torch.profiler) beside its call's CUDA-event time.
               The Blake2s column hash, both entries (whole-column and
               streamed 16-bit), at the commit's full shape, against one
               plain run.  Then the NTT at the edges of
               every route (one pass, cosets, two passes; each with inverse
               and canon_out on and off, the route printed), for
               BLS12-377 rows of p - 1, of 0, of both in turns and random
               through every route, a lone row and both storages (its
               lazy butterflies' edges), and the
               full-width commit kernels; the 16-bit entries (the
               resident and streaming modes' chunks in 16-bit limbs: the
               NTT reading and writing them, row_combine reading them) at
               a 1024-row chunk, the NTT's plain version on its first 128
               rows.  For BN254 Fr: the tree at the
               sizes around its 64-node groups and 100 times on one input,
               the tree's chain floor from a timed chain of dependent
               hashes; the serving path's pieces: the batched Blake2s and
               row_combine launches (B = 3) against their per-proof plain
               versions, three trees on one stream; the spot evaluation
               (``engine/spot.py``, which the verifier does not call yet)
               against the NTT kernel and its plain version; the Poseidon
               sponge (``csrc/poseidon_cols.cu``) at every compiled lane
               count at full width and 32 / 35 rows, its first 128 columns
               against its plain version, against the host sponge at the commit's full heights
               and at the verifier's launch (3t columns), each lane count
               timed there and at a tree level and the root, its tree
               levels against the host tree with their bound, three full
               matrices in one launch against three, its chain floor; the
               kernel shapes of the 2^22-gate
               instance (256-row launches, plain versions on their first
               128 rows, full size against the 256-row launches and
               hashlib).  The same
               kernel cases run again for BLS12-377 Fq at its instance's
               shapes, with Blake2s at row counts of every residue mod
               12 (the message's 4-row period, the kernel's ring of three
               2-row stages), three full matrices in one launch, and row_combine over
               two matrices in one launch (the bls batch path's).  The
               streaming commit's Blake2s entry (``blake2s_absorb``, a
               column's rows a chunk at a time, on 16-bit chunks as the
               paths give it) in both fields: against
               its plain version and the whole-column kernel at rows of
               every residue mod 4 and the zk path's odd count, chunked
               raggedly, at the paths' own chunk patterns (cut in
               depth, see STREAM_PLAIN_CASES), timed at the 2^20
               shapes (4m x n in 1024-row chunks, against the whole-column
               kernel) and at the 2^22 shapes (8196 x 32768).  The Poseidon streaming commit's
               chunked entry (``poseidon_absorb``, on 16-bit chunks):
               against its plain
               version, every state between chunks and the digests, at the
               paths' own chunkings (4100 / 4103 x 256 in 1024-row chunks,
               2052 / 2055 in 536 / 528) at one lane a column (the path's)
               and at eight, the plain version run by 16-row segments side
               by side from the kernel's states (it takes ~0.19 s a pair of
               rows on the card); at the same patterns cut in depth (36 /
               39 rows in 16-row chunks, 28 in 12) at the full width of
               16384 columns, its first 128 against the plain version row
               after row; against the whole-column
               kernel and the host sponge on sampled columns; timed at
               4100 x 16384 in 1024-row chunks beside the whole-column
               kernel.  The prover core (``parallel.core_step``) in both
               fields at the JAX bench's 2048 x 512 -> 4096 and the
               headline 4100 x 2048 -> 16384: bit-equal to the backend
               path on the same card tensors, its RS-encode + Merkle-commit
               elements a second beside the card; the sharded core at
               2048 x 512 -> 4096 over two and four shards, every stage,
               bit-equal to the single core; the same core over a
               process group of one rank on NCCL
               (``parallel.multihost``), every stage bit-equal.
4. parity   -- port proofs on the card byte-equal to the port's proofs on
               the CPU (plain versions) and to SHA-256 digests of the JAX
               package's proofs kept in ``testdata/golden_proofs.json``:
               x^3, 2^8 and 2^10 gates, and 2^8 and 2^10 gates with zk, over
               BN254 Fr; 2^8 and 2^10 gates, plain and zk, over BLS12-377;
               2^8 gates, plain and zk, under the Poseidon commitment (the
               CPU verifies the default-committed proofs only); each card
               proof through the opening overlap (three sets started and
               finished).
5. main     -- the 2^20-gate synthetic circuit through ``LigeroCircuit``'s
               ``prove`` and ``verify``, first plain, then with ``zk=True``:
               verify True, tampered witness and flipped byte rejected,
               every kernel launched on each path; the first prove of every
               direct-mode path through the opening overlap (each set's
               gather and 16-bit copy on the backend's side stream into
               pinned host memory; set 1's copy done before the linear
               phase's work is), and for BN254 plain and zk and BLS12-377
               plain a prove on the fused gather byte-equal to it; BN254
               plain: both routes' walls in turns (fused, overlap, overlap,
               fused; the timer off) and one timed call each (``open``,
               ``open.gather``, ``open.to_ints``, ``open.paths``); plain: a
               second proof, byte-identical; then the same instance over a mesh of two
               shards (``parallel.ShardedBackend``; distinct cards where
               the host has two, else the card twice): proof byte-equal to
               the single-device proof, verify True, tampering rejected,
               warm walls beside one device's, each physical device's
               peaks under the mesh's estimates; again in streaming mode
               over the two shards, forced by the budget into 1024-row
               chunks (peaks under ``stream_device_bytes``).  The same two paths
               under the Poseidon commitment: the sponge kernel launched,
               Blake2s and the SHA-256 tree not (the default paths: the
               reverse); each then
               in streaming mode forced by the budget into 1024-row chunks
               (the chunked sponge entry: proof byte-equal to the direct
               one, rejections, peaks under ``streaming_bytes``).  Then the
               batch path at 2^18 gates (B = 3
               plain, B = 2 zk, B = 2 under the Poseidon commitment: one
               sponge launch for both proofs' columns, one a tree level for
               both trees): ``prove_batch`` byte-equal to sequential
               ``prove`` calls with their walls, ``verify_batch`` over
               honest, tampered, flipped and truncated proofs, and the peak
               device memory against the prover's and the verifier's
               estimates; before each, its batched Blake2s launch at its
               own shape against single launches and, on each matrix's
               first 128 columns at full depth, the plain version, and its
               batched row_combine against its plain version; the same B = 3 and zk B = 2 batches over two
               shards (the mesh's batches: equal to sequential calls);
               the 2^18 zk instance over three shards, direct and in
               streaming mode (512-row chunks), and the Poseidon one over
               two, as the mesh above.  Then the
               2^20-gate circuit over BLS12-377 Fq: plain (and a batch of
               2, honest and tampered, against sequential proves) and zk;
               its 2^18 instance over two shards, direct and in streaming
               mode.  Streaming mode: the 2^18-gate
               circuit in both fields, plain and zk, built under a memory
               budget at its streaming estimate for 512-row chunks (below
               the direct one): proof bytes equal to the direct-mode proof,
               verify True, flipped byte and tampered witness rejected,
               every kernel but the whole-column Blake2s and the sponge
               launched, each peak under its streaming estimate; then
               BLS12-377 at 2^23 gates, which direct mode refuses on an
               80 GB card (~99 GiB): resident mode by the card's own
               budget, one prove and verify (True), a flipped byte
               rejected, the peaks beside the estimates, a warm prove and
               verify; then the same compiled instance in streaming mode
               under a budget at its streaming estimate: proof byte-equal
               to the resident one, both modes' warm walls, ``rs_encode``,
               ``commit`` and ``open.gather`` beside each other.
               Resident mode (every RS-encoded chunk held, coefficients
               and codewords) forced by the budget at its estimate for
               1024-row chunks: BN254 2^20 plain and zk (against the main
               paths' direct proofs), the Poseidon commitment at 2^18,
               BLS12-377 at 2^18: proof byte-equal to direct mode's,
               verify True, a flipped byte and a tampered witness
               rejected, peaks under ``resident_bytes`` and
               ``streaming_verify_bytes``, no whole-column Blake2s, the
               streamed absorb at least once a part, no NTT in the
               ``open`` phase (streaming mode: one a part), the chunks'
               dtype (16-bit limbs) and the openings' bytes copied to the
               host printed, those bytes measured on the int16 host
               tensors that left the card (two a limb required); no direct
               path launches a 16-bit entry.
               Each phase's
               seconds are printed; the kernels phase holds each NTT case
               against its plain version on the first 128 rows of the
               kernel's launch, and the Blake2s columns and the Poseidon
               sponge at full width on the first 128 columns of theirs,
               at full depth.
6. serve    -- a repeated-squaring ``.r1cs`` (2^14 squarings) and its
               witness written here; the port's HTTP service in a thread on
               an ephemeral port with no device named (it must take the
               card): /health, /circuits, /warmup, /prove (one and three
               witnesses), /verify (one and a batch with a corrupted
               proof); then ``python -m ligero_tpu_torch prove`` and
               ``verify`` as subprocesses on the same files, proof bytes
               equal to the service's.  Then a BLS12-377 service in a
               thread: /circuits, /prove, /verify on a 2^10-squarings
               ``.r1cs`` over that field.
7. ranks    -- (run before BLS12-377's main path, after BN254's 2^18 one)
               two ranks of ``scripts/torch_multihost_worker.py`` on the
               one card over gloo, asked for by name (NCCL refuses two
               ranks on one GPU), started once the kernels are built: the
               sharded core at the headline shape in both fields (root and
               lc equal to the single core's), a BN254 2^20-gate plain
               prove -> verify in direct mode and a 2^18-gate one in
               streaming mode forced by the budget, each byte-equal to this
               run's single-device proof, verified on both ranks; each
               rank's walls, peaks against its estimates (a peak above
               fails), launches and the bytes staged through the host.  On
               one card this is the cost of the staged collectives, not
               scaling.  Then ``python -m ligero_tpu_torch.bench`` at the
               ``large`` scale in both fields (canary, one JSON line),
               ``graft_entry.entry()`` on the card and
               ``graft_entry.dryrun_multichip(2)`` with both mesh devices on
               the card.

The last two stdout lines are the kernels' JSON record (BN254 Fr's numbers
in each entry, BLS12-377 Fq's under its ``bls12_377_fq`` key; the Poseidon
sponge has BN254's only; beside them the resident, streaming and sharded
paths' walls and peaks, the prover core's times and rates, the process
mesh's ranks, the bench's values, each phase's and the run's total
seconds) and
``{"ok": true, "device": {...}}``.  Neither JAX nor the JAX package
``ligero_tpu`` is ever imported.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import warnings

# the port must run without JAX and without the JAX package: make any import
# of either fail
sys.modules["jax"] = None
sys.modules["ligero_tpu"] = None

LOG2_GATES, SEED = 20, 0  # BASELINE.json config #5, the repo's headline size
# BN254's batch phases run a smaller instance of the same circuit, to keep
# the run well inside its time limit; their batched launches are held
# against the plain versions at the 2^20 shapes in the kernels phase and
# at their own shapes before each batch path
BATCH_LOG2_GATES = 18
ZK_SEED = bytes(range(32))
# NVIDIA H100 SXM data sheet: device memory rate; 32-bit integer rate taken
# as a quarter of the 67 TFLOP/s float32 figure (that one counts two
# operations per FMA on 128 lanes per SM; integer has 64 lanes, one each):
# the rate of the products' multiply-adds, which only the FMA pipe's
# integer half runs.  The issue rate is half the figure: the four
# schedulers of an SM issue one warp instruction a cycle each, 128 lanes,
# which the 64 integer lanes and the FMA pipe's 64 share; it bounds work of
# adds, logic and shifts alone (the hashes), whose adds ptxas puts on
# either pipe (IADD3 or IMAD).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 16.75e12
INT32_ISSUE_PER_S = 33.5e12
# 32-bit integer operations as the card issues them at the least (a
# three-input add is one IADD3, a three-input XOR one LOP3, a rotation one
# SHF.W, or one PRMT by 16 or 8 bits): one Blake2s block is 10 rounds x 8 G
# x 12 (two IADD3, two adds, four XORs, four rotations) and 8 LOP3s that
# fold the state into h, the counter and flag words folded into the first
# round's XORs; one SHA-256 two-to-one is two compressions of 64 rounds x
# 14 (six rotations, four LOP3s for the two sigmas' XORs, Ch and Maj, four
# adds) and 8 adds, the first with 48 schedule words x 10 (six rotations
# or shifts, two LOP3s, two IADD3s), the second, a constant padding block,
# with none.  Loads, addresses and loop control are not
# counted.  A Montgomery product: mont_mul_ops.
BLAKE2S_BLOCK_OPS = 10 * 8 * 12 + 8
SHA256_NODE_OPS = 2 * (64 * 14 + 8) + 48 * 10
# a Poseidon permutation of the test sponge: 8 full rounds of three S-boxes
# and 31 partial rounds of one, an S-box x^17 five products; 39 rounds of
# three constant adds and three MDS adds
POSEIDON_PRODUCTS, POSEIDON_ADDS = 8 * 3 * 5 + 31 * 5, 39 * 6
INT8_OPS_PER_S = 1.979e15  # the data sheet's dense int8 tensor-core rate
BATCH, ZK_BATCH = 3, 2     # proofs a batch on the plain and the zk path
LOG2_SQUARINGS = 14        # the serve phase's repeated-squaring circuit
# the largest size the port runs in direct mode: its kernel shapes (m, k, n)
# are held here, its paths in scripts/profile_torch_port.py
LOG2_GATES_22, DIMS_22 = 22, (2049, 4096, 32768)
BLS_LOG2_SQUARINGS = 10    # the BLS12-377 service's circuit
KERNELS = {
    # name: (wrapper module, source, TPU kernel replaced)
    "ntt": ("cuda_ntt", "ligero_tpu_torch/csrc/ntt.cu",
            "ligero_tpu/engine/mxu_ntt.py:535"),
    "mont_mul": ("cuda_mont", "ligero_tpu_torch/csrc/mont_mul.cu",
                 "ligero_tpu/engine/pallas_kernels.py:30"),
    "blake2s_cols": ("cuda_hash", "ligero_tpu_torch/csrc/blake2s_cols.cu",
                     "ligero_tpu/engine/pallas_hash.py:39"),
    "row_combine": ("cuda_lc", "ligero_tpu_torch/csrc/row_combine.cu",
                    "ligero_tpu/engine/mxu_lc.py:137"),
    "sha256_tree": ("cuda_tree", "ligero_tpu_torch/csrc/sha256_tree.cu",
                    "ligero_tpu/engine/pallas_tree.py:77"),
    # the JAX package's Poseidon column sponges run every product of every
    # round as a mont_mul_pallas launch (ligero_tpu/engine/poseidon_cols.py:71)
    "poseidon_cols": ("cuda_poseidon", "ligero_tpu_torch/csrc/poseidon_cols.cu",
                      "ligero_tpu/engine/pallas_kernels.py:30"),
    # the streaming commit's per-chunk absorb: an entry of blake2s_cols.cu
    # (the JAX package's streamed form is XLA code around the same hash,
    # ligero_tpu/engine/hashops.py:184-214)
    "blake2s_stream": ("cuda_hash", "ligero_tpu_torch/csrc/blake2s_cols.cu",
                       "ligero_tpu/engine/pallas_hash.py:39"),
    # the Poseidon streaming commit's per-chunk absorb: an entry of
    # poseidon_cols.cu (the JAX package's streamed sponge runs its products
    # as mont_mul_pallas launches, ligero_tpu/engine/poseidon_cols.py:208-251)
    "poseidon_stream": ("cuda_poseidon",
                        "ligero_tpu_torch/csrc/poseidon_cols.cu",
                        "ligero_tpu/engine/pallas_kernels.py:30"),
    # the 16-bit entries of ntt.cu and row_combine.cu: the resident and
    # streaming modes' chunks in 16-bit limbs (the JAX package's narrow16,
    # ligero_tpu/engine/backend.py:657), read and written as they lie
    "ntt16": ("cuda_ntt", "ligero_tpu_torch/csrc/ntt.cu",
              "ligero_tpu/engine/mxu_ntt.py:535"),
    "row_combine16": ("cuda_lc", "ligero_tpu_torch/csrc/row_combine.cu",
                      "ligero_tpu/engine/mxu_lc.py:137"),
}
#: the wrapper's launch counter of a kernel, where it is not ``launches``
COUNTERS = {"blake2s_stream": "stream_launches",
            "poseidon_stream": "stream_launches",
            "ntt16": "launches16", "row_combine16": "launches16"}
#: the 16-bit entries, which only the chunked (resident, streaming) paths
#: launch
ENTRIES16 = ("ntt16", "row_combine16")
#: the kernels a path of each commitment and mode never launches
NOT_ON_DEFAULT = ("poseidon_cols", "blake2s_stream",
                  "poseidon_stream") + ENTRIES16
NOT_ON_POSEIDON = ("blake2s_cols", "sha256_tree", "blake2s_stream",
                   "poseidon_stream") + ENTRIES16
NOT_ON_STREAMING = ("poseidon_cols", "blake2s_cols", "poseidon_stream")
NOT_ON_POSEIDON_STREAMING = ("blake2s_cols", "sha256_tree", "blake2s_stream")
#: streaming mode: the paths forced by the budget run at BATCH_LOG2_GATES
#: (4m = 2052 rows) in chunks of at most this many rows; the one direct
#: mode refuses is BLS12-377 at 2^23 gates, with the card's own budget
FORCED_CHUNK_ROWS, STREAM_LOG2_GATES = 512, 23
#: the part of a kernel case that its plain version computes: the NTT
#: cases (and the spot evaluation's) at full width on their first
#: PLAIN_ROWS rows (256 until the opening overlap's phases needed room: the
#: rows of a transform are independent, and the launch stays at the whole
#: shape), the column hashes (Blake2s, the Poseidon sponge) at full depth
#: on PLAIN_COLUMNS columns, half of them at each end of the matrix
#: (:func:`plain_columns`; the first 256 until the BLS12-377 NTT's
#: edge-value cases needed room: every column kernel hashes its columns
#: independently, and a block takes 128 of them, so the two ends lie in
#: different blocks); the kernel is launched (and timed) at the whole
#: shape, and the same part of its result is held against the plain
#: version's
PLAIN_ROWS, PLAIN_COLUMNS = 128, 128
#: the heights of the Poseidon sponge's lane-count cases (16384 columns,
#: PLAIN_COLUMNS of them against the plain version, which takes ~0.2 s a
#: row there): an even one, and an odd one, as a zk column's tail (64 and
#: 67 until the opening overlap's phases needed room)
POSEIDON_LANE_ROWS = (32, 35)
#: chunk rows of the streamed absorb's kernel cases (the streaming mode's
#: largest chunk, backend.STREAM_MAX_CHUNK_ROWS)
STREAM_CHUNK = 1024
#: the rows of each absorb at which the streamed absorb is held against its
#: plain version (one small step a 64-byte block, ~3.5 ms a BN254 pair of
#: rows): the 2^20 commit's pattern (4m = 4100 rows in 1024-row chunks, a
#: last chunk of 4; over a mesh each device's columns take the same) cut 32x
#: in depth, and under zk with the three mask rows' part after it (also
#: the mesh zk path's 512-row pattern); the forced 2^18 paths' own
#: chunkings (4m = 2052 in 536-row chunks, 3 x 536 + 444; under zk in 528,
#: 3 x 528 + 468, then the mask rows) cut to 32 rows an absorb and a last
#: of 28, which keeps the run inside its time limit (8x and 4x until the
#: opening overlap's phases needed room).  The cuts keep every absorb's
#: block phase: a column is the 8-byte row count, then 2 L bytes a row, so
#: an absorb starts at byte 8 + 2 L r0 of the column and its offset in a
#: 64-byte block depends only on r0 mod hashops.period_rows (2 BN254 rows,
#: 4 BLS12-377 rows).  32, 28 and 1024 are multiples of 4 (as are 536, 444,
#: 528, 468), so each cut absorb, and the short last ones after it, start
#: and end at the offsets of their full-depth counterparts; only the count
#: of whole blocks inside an absorb (the kernel's loop: 16 a BN254 absorb
#: of 32 rows, 24 a BLS12-377 one) is smaller.
STREAM_PLAIN_CASES = ((32,) * 4 + (4,), (32,) * 4 + (4, 3),
                      (32,) * 3 + (28,), (32,) * 3 + (28, 3))
#: the Poseidon chunked absorb against its plain version at the streaming
#: paths' row counts and chunkings: the 2^20 commit's 4m and 4m + 3 rows in
#: STREAM_CHUNK-row chunks (a last chunk of 4, an odd one of 7) and the
#: forced 2^18 counts in the chunks their budgets give (4m = 2052 in
#: 536-row chunks, 4m + 3 = 2055 in 528-row ones); the two counts of a
#: depth share one matrix of POSEIDON_DEEP_COLS columns.  The plain version
#: takes thousands of small tensor ops a pair of rows (~0.19 s on the card
#: at 256 columns): run row after row, 4100 rows would take 6.5 min.  So
#: the kernel also runs the same rows in chunks of
#: POSEIDON_SEGMENT rows (cut at every chunk edge of the cases), and the
#: plain version takes every such segment from the kernel's state at its
#: start, all segments side by side as columns of one call; each kernel
#: state, each chunked run's states and its digests must equal the plain
#: segment that ends there, so by induction from the zero state every
#: output equals the plain version's run over the whole column.
POSEIDON_STREAM_CASES = (((4100, STREAM_CHUNK), (4103, STREAM_CHUNK)),
                         ((2052, 536), (2055, 528)))
POSEIDON_DEEP_COLS, POSEIDON_SEGMENT = 256, 16
#: the same chunk patterns cut in depth, the kernel at the commit's full
#: width (n = 16384, so the path's lanes a column), PLAIN_COLUMNS of its
#: columns held against the plain version row after row: 36 rows in 16-row
#: chunks (two full, a last of 4), 39 (a last of 7, odd), 28 in 12-row
#: chunks (two full, a last of 4) (68, 71 and 40 rows, four and three full
#: chunks, until the opening overlap's phases needed room)
POSEIDON_PLAIN_CASES = ((36, 16), (39, 16), (28, 12))


#: the prover core's shapes (4m, k, n): the JAX package's bench step
#: (bench.py: 2048 x 512 -> 4096) and the headline 2^20-gate commit
CORE_SHAPES = ((2048, 512, 4096), (4100, 2048, 16384))
#: every this-many-th column of the core's first shape has its Blake2s leaf
#: held against the plain hash (~3 us an element on the card: 256 columns
#: of 2048 rows take ~1.6 s BN254, ~2.5 s BLS12-377)
CORE_PLAIN_COL_STEP = 16
#: the kernels the prover core never launches (its transforms' twists are
#: inside the NTT kernel; no streaming, no Poseidon)
NOT_ON_CORE = ("mont_mul", "poseidon_cols", "blake2s_stream",
               "poseidon_stream") + ENTRIES16


#: the process mesh's phase: ranks of scripts/torch_multihost_worker.py on
#: the one card over gloo (NCCL refuses two ranks on one GPU), started once
#: the kernels are built, and the most their run may take
REPO = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join("scripts", "torch_multihost_worker.py")
PROCESS_RANKS, WORKER_TIMEOUT_S = 2, 420


#: the TPU kernel each BLS12-377 instantiation replaces, where it differs:
#: the JAX package runs every BLS12-377 transform through pallas_ntt
BLS_REPLACES = {"ntt": "ligero_tpu/engine/pallas_ntt.py:69",
                "ntt16": "ligero_tpu/engine/pallas_ntt.py:69"}


def elem_bytes(field) -> int:
    """Bytes of one element at the boundary: L int32 limbs (64 or 96)."""
    return 4 * field.num_limbs


def mont_mul_ops(field) -> int:
    """32-bit integer operations of one W-word CIOS Montgomery product: W^2
    word products and W^2 reduction multiply-adds, each with its carry
    (2 W^2), plus ~4 W for the quotient digits, the final add and the
    conditional subtraction: 160 for BN254 (W = 8), 336 for BLS12-377
    (W = 12), 2.1 times as many."""
    W = field.num_limbs // 2
    return 2 * W * W + 4 * W


class SmokeFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    require(res.returncode == 0 and res.stdout.strip(),
            f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


#: the NTT wrapper's launches on a path by shape (PERF.md's sub-rows of
#: the NTT's kernel rows), counted where cuda_ntt counts them
NTT_SHAPES: dict = {}


def tally_ntt_shapes() -> None:
    """Count every launch of ``cuda_ntt.ntt_routed`` (which ``ntt`` calls)
    in :data:`NTT_SHAPES` under its shape: rows x w -> n, inverse,
    canonical output, 16-bit in and out."""
    import torch
    from ligero_tpu_torch.engine import cuda_ntt
    routed = cuda_ntt.ntt_routed

    def counted(field, x, n, inverse, canon_out, rt, *args, **kw):
        rows = x.numel() // (x.shape[-2] * x.shape[-1])
        out16 = kw.get("out16", args[1] if len(args) > 1 else False)
        key = (f"{rows} x {x.shape[-2]} -> {n}" + " inverse" * inverse
               + " canon_out" * canon_out
               + " 16-bit in" * (x.dtype == torch.int16)
               + " 16-bit out" * bool(out16))
        NTT_SHAPES[key] = NTT_SHAPES.get(key, 0) + 1
        return routed(field, x, n, inverse, canon_out, rt, *args, **kw)

    cuda_ntt.ntt_routed = counted


def ntt_shapes_text() -> str:
    return str(dict(sorted(NTT_SHAPES.items())))


def wrappers():
    from ligero_tpu_torch.engine import (cuda_hash, cuda_lc, cuda_mont,
                                         cuda_ntt, cuda_poseidon, cuda_tree)
    mods = {"cuda_ntt": cuda_ntt, "cuda_mont": cuda_mont,
            "cuda_hash": cuda_hash, "cuda_lc": cuda_lc,
            "cuda_tree": cuda_tree, "cuda_poseidon": cuda_poseidon}
    return {name: getattr(mods[spec[0]], COUNTERS.get(name, "launches"))
            for name, spec in KERNELS.items()}


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _rand_elems(torch, gen, shape, field, below_r=False):
    """Random limbs < 2^16: below R, or reduced below p (top limb cut)."""
    L = field.num_limbs
    limbs = torch.randint(0, 1 << 16, tuple(shape) + (L,), generator=gen,
                          dtype=torch.int32, device="cuda")
    if not below_r:
        top = field.p >> (16 * (L - 1))
        limbs[..., L - 1] = torch.remainder(limbs[..., L - 1], top)
    return limbs


def _rand_elems16(torch, gen, shape, field):
    """:func:`_rand_elems` (reduced below p) in 16-bit limbs: the resident
    and streaming modes' chunk storage (``fieldops.narrow16``)."""
    from ligero_tpu_torch.engine import fieldops
    return fieldops.narrow16(_rand_elems(torch, gen, shape, field))


def _time_cuda(torch, fn, iters: int) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def _time_once(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


#: the symbol of each kernel's launches in a profile (csrc/)
KERNEL_SYMBOLS = {"ntt": "ntt", "ntt16": "ntt", "mont_mul": "mont_mul",
                  "blake2s_cols": "blake2s_kernel",
                  "blake2s_stream": "blake2s_kernel",
                  "row_combine": "row_combine_kernel",
                  "row_combine16": "row_combine_kernel",
                  "sha256_tree": "sha256", "poseidon_cols": "poseidon",
                  "poseidon_stream": "poseidon"}


def _device_ms(torch, fn, symbol: str, iters: int = 3, tries: int = 3):
    """The device time a call of ``fn`` spends in the kernels whose name
    holds ``symbol``: the self device time of those kernels in a
    torch.profiler trace of the device alone over ``iters`` calls (after a
    warm-up), divided by ``iters``.  Beside the CUDA-event time of the
    call, it separates the kernel from the call's other launches and from
    the host's enqueue.  The profiler now and then drops a kernel's record
    from a trace: a trace whose launches of the kernel are none, or not the
    same number a call, is taken again, ``tries`` times in all; then None,
    logged (only the call's CUDA-event time stands)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        total, count = 0.0, 0
        for ev in prof.key_averages():
            if symbol in ev.key:
                t = getattr(ev, "self_device_time_total", None)
                total += t if t is not None else ev.self_cuda_time_total
                count += ev.count
        if total > 0 and count % iters == 0:
            return total / 1e3 / iters
    log(f"device time of {symbol}: no whole trace of its launches in "
        f"{tries} tries (not measured)")
    return None


def _ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f}"


def bound(nbytes: float, ops: float,
          ops_per_s: float = INT32_OPS_PER_S) -> tuple[float, str]:
    """(least ms the card could take, what bounds it) for work that must
    move ``nbytes`` and do ``ops`` 32-bit integer operations at
    ``ops_per_s`` (a work function's third item, where it gives one)."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / ops_per_s * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def ntt_products(w: int, n: int, epilogue: bool) -> int:
    """Montgomery products a row of the transform needs, w-wide rows
    zero-extended to n, as ``csrc/ntt.cu`` decomposes it: c = n / s
    transforms of s points (s the least power of two >= w), each of
    s/2 log2 s radix-2 butterflies less the s - 1 whose twiddle is one
    (a block of 2h points has one at pos 0 in every stage), plus the twist
    of the w inputs of every coset, which coset 0 skips where there is no
    output constant (``epilogue``: n^-1 or from-Montgomery) to fold in."""
    s = 1 << (w - 1).bit_length()
    c = n // s
    butterflies = (s // 2) * (s.bit_length() - 1) - (s - 1)
    return c * butterflies + w * (c if epilogue else c - 1)


def ntt_work(field, rows: int, w: int, n: int, epilogue: bool,
             in16: bool = False, out16: bool = False):
    """Bytes and operations of a batched NTT: w-wide rows and the twiddles
    in, n-wide rows out (``in16`` / ``out16``: in 16-bit limbs, half the
    bytes); :func:`ntt_products` products a row."""
    products = rows * ntt_products(w, n, epilogue)
    elem = elem_bytes(field)
    return (rows * (w * (elem // 2 if in16 else elem)
                    + n * (elem // 2 if out16 else elem))
            + (n // 2) * elem // 2, products * mont_mul_ops(field))


def blake2s_work(field, rows: int, cols: int, in16: bool = False):
    """Bytes, operations and their rate of the column hash: 2 L-byte
    canonical elements a block of 64 message bytes after the 8-byte prefix
    (``in16``: the elements read in 16-bit limbs); adds, logic and
    rotations, at the issue rate."""
    blocks = -(-(8 + 2 * field.num_limbs * rows) // 64)
    return (rows * cols * elem_bytes(field) // (2 if in16 else 1) + cols * 32,
            cols * blocks * BLAKE2S_BLOCK_OPS, INT32_ISSUE_PER_S)


def scaled(work, times: int):
    """A work tuple's bytes and operations ``times`` over (a batch)."""
    return (times * work[0], times * work[1]) + tuple(work[2:])


def row_combine_work(field, rows: int, k: int, m16: bool = False):
    """Bytes and the least operations of the combination: M, r and lc each
    moved once (``m16``: M in 16-bit limbs); a term is a W x W-word product
    added unreduced, W^2 wide multiply-adds and the 2 W adds that carry them
    out (a wide multiply-add one operation, as :func:`mont_mul_ops` counts
    them), and each column is reduced once: W adds to fold the carries,
    W + 1 Montgomery steps of W multiply-adds, one Montgomery product.  80
    operations a BN254 term, 168 a BLS12-377 one: below the bytes in both
    fields, so the bytes bound the pass."""
    W, elem = field.num_limbs // 2, elem_bytes(field)
    return (rows * k * (elem // 2 if m16 else elem) + (rows + k) * elem,
            rows * k * (W * W + 2 * W)
            + k * (W + (W + 1) * W + mont_mul_ops(field)))


def tree_work(n: int):
    """Bytes, operations and their rate of the tree: adds, logic and
    rotations, at the issue rate."""
    return (n * 32 + (2 * n - 1) * 32, (n - 1) * SHA256_NODE_OPS,
            INT32_ISSUE_PER_S)


def field_add_ops(field) -> int:
    """32-bit operations of a modular add: W adds with carry, W subtracts
    with borrow, W selects."""
    return 3 * (field.num_limbs // 2)


def poseidon_work(field, rows: int, cols: int, in16: bool = False):
    """Bytes and operations of the column sponges: every element read once,
    one digest written a column (``in16``: the elements read in 16-bit
    limbs); a column of h rows is ceil(h / 2)
    permutations (275 products, 234 modular adds each), h to-Montgomery
    products and rate adds, and one from-Montgomery product.  The adds
    are counted (~13 % of the operations)."""
    perms = (rows + 1) // 2
    products = perms * POSEIDON_PRODUCTS + rows + 1
    adds = perms * POSEIDON_ADDS + rows
    elem = elem_bytes(field)
    return ((rows * elem // (2 if in16 else 1) + elem) * cols,
            cols * (products * mont_mul_ops(field) + adds * field_add_ops(field)))


def phase_kernels(torch, field, gen, dims, zk_dims) -> dict:
    """Each kernel on the card vs its plain version, same inputs, at the
    shapes of both main paths of ``field`` (dims = m, k, n, nnz of A, t;
    zk_dims = b, d2), then the NTT at its route edges and the full-width
    commit kernels.  Returns per-kernel results; the first case of a kernel
    gives its reported times and bound."""
    from ligero_tpu_torch.engine import (cuda_hash, cuda_lc, cuda_mont,
                                         cuda_ntt, cuda_tree, fieldops,
                                         hashops, ntt)
    m, k, n, nnz, t = dims
    b, d2 = zk_dims
    rows, kb = 4 * m, k + b
    elem = elem_bytes(field)
    mm = lambda a, b: cuda_mont.mont_mul(field, a, b)  # noqa: E731

    def elems(*shape, below_r=False):
        return lambda: _rand_elems(torch, gen, shape, field, below_r)

    def elems16(*shape):
        return lambda: _rand_elems16(torch, gen, shape, field)

    def pair(f, g):
        return lambda: (f(), g())

    def leaves(count):
        return lambda: torch.randint(-2**31, 2**31, (count, 8), generator=gen,
                                     dtype=torch.int64,
                                     device="cuda").to(torch.int32)

    def ntt_case(label, batch, w, size, inverse=False, canon=False):
        # rows are independent: the kernel's launch at all ``batch`` rows is
        # held against the plain version on its first PLAIN_ROWS rows
        return ("ntt", f"{label}, {batch} x {w} -> {size} "
                f"[route {route_text(cuda_ntt.route(w, size, batch))}]",
                elems(batch, w),
                lambda x: cuda_ntt.ntt(field, x, size, inverse, canon),
                lambda x: ntt.ntt_ref(field, x, size, inverse, canon),
                ntt_work(field, batch, w, size, inverse or canon),
                lambda x: x[:PLAIN_ROWS])

    def ntt16_case(label, w, size, in16, out16, inverse=False, canon=False):
        # the 16-bit entry at a chunk of the resident and streaming modes
        # (STREAM_CHUNK rows), against its plain version (widen, ntt_ref,
        # narrow) on the chunk's first PLAIN_ROWS rows
        batch = STREAM_CHUNK
        return ("ntt16", f"{label}, {batch} x {w} -> {size} "
                f"[route {route_text(cuda_ntt.route(w, size, batch))}]",
                (elems16 if in16 else elems)(batch, w),
                lambda x: cuda_ntt.ntt(field, x, size, inverse, canon, out16),
                lambda x: cuda_ntt.ntt16_ref(field, x, size, inverse, canon,
                                             out16),
                ntt_work(field, batch, w, size, inverse or canon, in16,
                         out16),
                lambda x: x[:PLAIN_ROWS])

    cases = [
        # (kernel, label, input maker, kernel call, plain call, (bytes, ops))
        ntt_case(f"NTT_n n={n} canon_out", 256, k, n, canon=True),
        ntt_case(f"iNTT_k k={k}", rows, k, k, inverse=True),
        ntt_case(f"NTT_2k 2k={2 * k}", rows, k, 2 * k),
        ntt_case(f"iNTT_2k 2k={2 * k}", 1, 2 * k, 2 * k, inverse=True),
        # zk shapes: the encode from d2-wide rows, a width that is not a
        # power of two, the products' d2 domain
        ntt_case(f"zk NTT_n n={n} canon_out", 256, d2, n, canon=True),
        ntt_case(f"zk NTT_n n={n} canon_out, w = k + b", 256, kb, n, canon=True),
        ntt_case(f"zk NTT_d2 d2={d2} of k + b", rows, kb, d2),
        ntt_case(f"zk NTT_d2 d2={d2} of k", rows, k, d2),
        ntt_case(f"zk iNTT_d2 d2={d2}", 1, d2, d2, inverse=True),
        ("mont_mul", f"mont_mul a<R x b<p, nnz={nnz}",
         pair(elems(nnz, below_r=True), elems(nnz)),
         lambda ab: mm(*ab), lambda ab: fieldops.mont_mul(field, *ab),
         (3 * nnz * elem, nnz * mont_mul_ops(field))),
        ("row_combine", f"row_combine {rows} x {k}",
         pair(elems(rows), elems(rows, k)),
         lambda rm: cuda_lc.row_combine(field, *rm),
         lambda rm: cuda_lc.row_combine_ref(field, *rm),
         row_combine_work(field, rows, k)),
        ("row_combine", f"zk row_combine {rows} x {kb}",
         pair(elems(rows), elems(rows, kb)),
         lambda rm: cuda_lc.row_combine(field, *rm),
         lambda rm: cuda_lc.row_combine_ref(field, *rm),
         row_combine_work(field, rows, kb)),
        ("sha256_tree", f"SHA-256 tree n={n}", leaves(n),
         cuda_tree.tree_flat, hashops.tree_flat, tree_work(n)),
        # the 16-bit entries on a chunk: the resident encode's NTT_n from a
        # coefficient chunk into a codeword chunk (16 bits in and out; the
        # streaming re-encode too), iNTT_k of a message chunk into a
        # coefficient chunk, the linear product's NTT_2k of a chunk
        ntt16_case(f"NTT_n n={n} canon_out, 16 bits in and out", k, n, True,
                   True, canon=True),
        ntt16_case(f"iNTT_k k={k}, 16 bits in and out", k, k, True, True,
                   inverse=True),
        ntt16_case(f"NTT_2k 2k={2 * k}, 16 bits in", k, 2 * k, True, False),
        ntt16_case(f"zk NTT_n n={n} canon_out, w = k + b, 16 bits in and "
                   "out", kb, n, True, True, canon=True),
        ("row_combine16", f"row_combine {STREAM_CHUNK} x {k}, 16-bit matrix",
         pair(elems(STREAM_CHUNK), elems16(STREAM_CHUNK, k)),
         lambda rm: cuda_lc.row_combine(field, *rm),
         lambda rm: cuda_lc.row_combine16_ref(field, *rm),
         row_combine_work(field, STREAM_CHUNK, k, m16=True)),
        ("row_combine16", f"zk row_combine {STREAM_CHUNK} x {kb}, 16-bit "
         "matrix", pair(elems(STREAM_CHUNK), elems16(STREAM_CHUNK, kb)),
         lambda rm: cuda_lc.row_combine(field, *rm),
         lambda rm: cuda_lc.row_combine16_ref(field, *rm),
         row_combine_work(field, STREAM_CHUNK, kb, m16=True)),
    ]
    results: dict = {}
    for name, label, make, kern, plain, work, *cut in cases:
        # a cut (of the input, then of the result where that differs): the
        # plain version on part of the input (rows or columns that the
        # kernel treats independently), held against the same part of the
        # kernel's whole-input result
        inp = make()
        got, _ = _time_once(torch, lambda: kern(inp))
        part = cut[0](inp) if cut else inp
        want, plain_ms = _time_once(torch, lambda: plain(part))
        if cut:
            got = cut[-1](got)
        require(got.shape == want.shape and got.dtype == want.dtype,
                f"{label}: shape/dtype {tuple(got.shape)} {got.dtype} vs "
                f"{tuple(want.shape)} {want.dtype}")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        ms = _time_cuda(torch, lambda: kern(inp), iters=5)
        dev_ms = _device_ms(torch, lambda: kern(inp), KERNEL_SYMBOLS[name])
        bound_ms, bound_by = bound(*work)
        on = (f" on {tuple(part.shape[:2])}"
              if cut and part.shape != inp.shape else "")
        log(f"kernel [{field.name}] {label}: max_abs_err={err} kernel "
            f"{ms:.4f} ms (device {_ms(dev_ms)} ms), plain {plain_ms:.3f} "
            f"ms{on}, bound {bound_ms:.4f} ms by {bound_by} (bytes "
            f"{work[0] / HBM_BYTES_PER_S * 1e3:.4f} ms, operations "
            f"{bound(0, *work[1:])[0]:.4f} ms)")
        require(err == 0, f"{label}: kernel disagrees with its plain version")
        res = results.setdefault(name, {
            "max_abs_err": 0, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by})
        res["max_abs_err"] = max(res["max_abs_err"], err)
        del got, want, inp, part
        torch.cuda.empty_cache()
    results["ntt"]["max_abs_err"] = max(
        results["ntt"]["max_abs_err"], ntt_route_cases(torch, field, gen))
    if field.name == "bls12_377_fq":      # the lazy butterflies' edges
        edge = ntt_edge_value_cases(torch, field, gen)
        for key in ("ntt", "ntt16"):
            results[key]["max_abs_err"] = max(results[key]["max_abs_err"],
                                              edge)
    results["blake2s_cols"], results["blake2s_stream"] = blake2s_commit_cases(
        torch, field, gen, rows, n)
    # the commit's full-width NTT_n, column hash and tree (all rows, all n
    # columns; zk: 4m + 3 rows from d2-wide coefficients), kernel only
    for label, key, nrows, w in (("", "", rows, k),
                                 ("zk ", "zk_", rows + 3, d2)):
        x = _rand_elems(torch, gen, (nrows, w), field)
        ms = _time_cuda(torch, lambda: cuda_ntt.ntt(field, x, n, canon_out=True),
                        iters=3)
        full = bound(*ntt_work(field, nrows, w, n, True))
        log(f"kernel [{field.name}] {label}NTT_n n={n} canon_out, full "
            f"{nrows} x {w} -> {n}: {ms:.3f} ms, bound %.3f ms by %s" % full)
        results["ntt"][f"{key}full_ms"] = ms
        results["ntt"][f"{key}full_bound_ms"] = full[0]
        u = cuda_ntt.ntt(field, x, n, canon_out=True)
        del x
        ms = _time_cuda(torch, lambda: cuda_hash.blake2s_columns(field, u),
                        iters=3)
        full = bound(*blake2s_work(field, nrows, n))
        log(f"kernel [{field.name}] {label}Blake2s columns, full {nrows} x "
            f"{n}: {ms:.3f} ms, bound %.3f ms by %s" % full)
        results["blake2s_cols"][f"{key}full_ms"] = ms
        results["blake2s_cols"][f"{key}full_bound_ms"] = full[0]
        del u
        torch.cuda.empty_cache()
    return results


def row_cuts(rows: int, chunk_rows) -> list[int]:
    """The rows of each absorb: chunks of ``chunk_rows`` (an int; the last
    one short), or ``chunk_rows`` itself, a list of row counts."""
    if isinstance(chunk_rows, int):
        return [min(chunk_rows, rows - r0) for r0 in range(0, rows, chunk_rows)]
    return list(chunk_rows)


def stream_digests(field, u, chunk_rows):
    """The streamed absorb over the rows of ``u`` in chunks of
    ``chunk_rows`` (:func:`row_cuts`; the streaming commit's launches)."""
    from ligero_tpu_torch.engine import cuda_hash
    rows, n, _ = u.shape
    hs = cuda_hash.ColumnHashStream(field, n, rows, u.device)
    r0 = 0
    for cr in row_cuts(rows, chunk_rows):
        hs.absorb(u[r0:r0 + cr], cr)
        r0 += cr
    return hs.digests()


def stream_digests_plain(field, u, chunk_rows):
    """:func:`stream_digests` through the plain version, on the same
    tensors."""
    from ligero_tpu_torch.engine import hashops
    rows, n, _ = u.shape
    state, blocks, r0 = hashops.blake2s_stream_start(n, rows, u.device), 0, 0
    for cr in row_cuts(rows, chunk_rows):
        state = hashops.blake2s_absorb_ref(u[r0:r0 + cr], cr, state, blocks,
                                           r0 + cr == rows, rows)
        blocks += (2 + cr * field.num_limbs // 2) // 16
        r0 += cr
    return state[:, :8]


def cuts_text(cuts) -> str:
    """(536, 536, 536, 444) -> "536 x 3 + 444"."""
    parts, i = [], 0
    while i < len(cuts):
        j = i
        while j < len(cuts) and cuts[j] == cuts[i]:
            j += 1
        parts.append(f"{cuts[i]} x {j - i}" if j - i > 1 else str(cuts[i]))
        i = j
    return " + ".join(parts)


def _diff(torch, got, want) -> int:
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def plain_columns(torch, n: int):
    """The columns of an n-column case that a column hash's plain version
    computes: the first and the last PLAIN_COLUMNS / 2 (in the first and
    the last block of a column kernel's launch), or all n where n is no
    more than PLAIN_COLUMNS.  An index tensor on the card."""
    if n <= PLAIN_COLUMNS:
        return torch.arange(n, device="cuda")
    h = PLAIN_COLUMNS // 2
    return torch.cat([torch.arange(h, device="cuda"),
                      torch.arange(n - h, n, device="cuda")])


def blake2s_commit_cases(torch, field, gen, rows: int, n: int):
    """The column hash at the commit's shape, ``rows`` x ``n``, both
    entries, against one plain run: the whole-column kernel at full width,
    its :func:`plain_columns` held against the plain version (computed
    once, at full depth); the streamed 16-bit entry over the same
    matrix in STREAM_CHUNK-row chunks, equal to it; then the streamed entry
    against its plain version on the same card tensors at each of
    STREAM_PLAIN_CASES (the chunkings the streaming paths give it, the
    largest cut in depth; the plain version takes one small step a block,
    so its time is its launches'), 256 columns.  Both entries are timed
    (CUDA events over the call, and the profiler's device time of the
    kernel).  Returns the whole-column and the streamed records."""
    from ligero_tpu_torch.engine import cuda_hash, fieldops, hashops
    u = _rand_elems(torch, gen, (rows, n), field)
    pcols = plain_columns(torch, n)
    want, plain_ms = _time_once(
        torch, lambda: hashops.blake2s_columns_ref(u[:, pcols]))
    u16 = fieldops.narrow16(u)
    cols_bound, cols_by = bound(*blake2s_work(field, rows, n))
    stream_bound, stream_by = bound(*blake2s_work(field, rows, n, in16=True))
    whole = cuda_hash.blake2s_columns(field, u)
    err = _diff(torch, whole[pcols], want)
    require(err == 0, f"Blake2s columns {rows} x {n}: the kernel disagrees "
            "with its plain version")
    require(torch.equal(stream_digests(field, u16, STREAM_CHUNK), whole),
            f"streamed Blake2s {rows} x {n}: differs from the whole-column "
            "kernel")

    def call():
        return cuda_hash.blake2s_columns(field, u)

    def streamed():
        return stream_digests(field, u16, STREAM_CHUNK)

    ms, dev_ms = _time_cuda(torch, call, 3), _device_ms(torch, call,
                                                        "blake2s_kernel")
    stream_ms = _time_cuda(torch, streamed, 3)
    stream_dev_ms = _device_ms(torch, streamed, "blake2s_kernel")
    log(f"kernel [{field.name}] Blake2s columns {rows} x {n}: first and "
        f"last {PLAIN_COLUMNS // 2} columns max_abs_err=0 against the plain "
        "version; "
        f"{ms:.3f} ms (device {_ms(dev_ms)}), bound {cols_bound:.3f} ms by "
        f"{cols_by}; streamed 16-bit in chunks of {STREAM_CHUNK}, equal: "
        f"{stream_ms:.3f} ms (device {_ms(stream_dev_ms)}), bound "
        f"{stream_bound:.3f} ms")
    del u, u16, whole
    torch.cuda.empty_cache()
    stream_err, stream_plain_ms = 0, None
    for cuts in STREAM_PLAIN_CASES:
        nrows = sum(cuts)
        v = _rand_elems16(torch, gen, (nrows, 256), field)
        plain, case_ms = _time_once(torch, lambda: stream_digests_plain(
            field, v, cuts))
        case_err = _diff(torch, stream_digests(field, v, cuts), plain)
        require(case_err == 0, f"streamed Blake2s {nrows} x 256 in absorbs "
                f"of {cuts}: the kernel disagrees with its plain version")
        log(f"kernel [{field.name}] streamed Blake2s {nrows} x 256 in absorbs "
            f"of {cuts_text(cuts)} rows: max_abs_err=0 against its plain "
            f"version ({case_ms:.1f} ms)")
        stream_plain_ms = stream_plain_ms or case_ms
        del v
    first = STREAM_PLAIN_CASES[0]
    cols = {"max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": cols_bound, "bound_by": cols_by,
            "shape": f"{rows} x {n}; plain on its first and last "
                     f"{PLAIN_COLUMNS // 2} columns"}
    stream = {"max_abs_err": stream_err, "ms": stream_ms,
              "device_ms": stream_dev_ms, "plain_ms": stream_plain_ms,
              "bound_ms": stream_bound, "bound_by": stream_by,
              "whole_column_ms": ms,
              "shape": f"{rows} x {n} in chunks of {STREAM_CHUNK}; plain at "
                       f"{sum(first)} x 256 in absorbs of {cuts_text(first)}"}
    return cols, stream


def blake2s_stream_cases(torch, field, gen, zk_rows: int) -> None:
    """The streamed absorb at ragged chunkings: rows of every residue mod 4
    (103 = 4 x 25 + 3 an odd zk total) in chunks of one, two and three
    periods of the column map and of 32 rows, each against its plain
    version and the whole-column kernel; the zk path's own count
    ``zk_rows`` in chunks of 128 and STREAM_CHUNK rows against the
    whole-column kernel."""
    from ligero_tpu_torch.engine import cuda_hash, fieldops, hashops
    E = hashops.period_rows(field.num_limbs)
    small, large = (E, 2 * E, 3 * E, 32), (128, STREAM_CHUNK)
    for nrows, chunkings, plains in (
            (100, small, (False, True)), (101, small, (False, True)),
            (102, small, (False, True)), (103, small, (False, True)),
            (zk_rows, large, (False,))):
        u = _rand_elems16(torch, gen, (nrows, 256), field)
        whole = cuda_hash.blake2s_columns(field, fieldops.widen16(u))
        for cr in chunkings:
            for plain in plains:
                digests = stream_digests_plain if plain else stream_digests
                require(torch.equal(digests(field, u, cr), whole),
                        f"streamed Blake2s {nrows} x 256 in chunks of {cr} "
                        f"({'plain' if plain else 'kernel'}): differs from "
                        "the whole-column kernel")
    log(f"kernel [{field.name}] streamed Blake2s at rows 100-103 in chunks "
        f"of {small}, kernel and plain version, and at {zk_rows} rows in "
        f"chunks of {large}: bit-equal to the whole-column kernel")


def poseidon_stream_run(field, u, rows: int, chunk_rows: int, plain: bool,
                        state=None, r0: int = 0):
    """Rows [r0, rows) of ``u`` through the Poseidon chunked absorb in
    chunks of ``chunk_rows`` (the kernel, or its plain version on the same
    tensors), from ``state``, the states after r0 rows (fresh where r0 =
    0): (the states after each chunk but the last, the digests)."""
    return poseidon_chunks_run(field, u, list(range(r0 + chunk_rows, rows,
                                                    chunk_rows)), rows,
                               plain=plain, state=state, r0=r0)


def poseidon_chunks_run(field, u, cuts, rows: int, lanes=None,
                        plain: bool = False, state=None, r0: int = 0):
    """Rows [r0, rows) of ``u`` through the chunked absorb (the kernel at
    ``lanes`` lanes a column, default the wrapper's rule; or the plain
    version), a chunk ending at each of ``cuts`` and the last at ``rows``
    (``rows`` None: no last chunk), from ``state`` (the states after r0
    rows; fresh where r0 = 0): (the states after each cut, the digests or
    None)."""
    from ligero_tpu_torch.engine import cuda_poseidon, poseidon_cols
    from ligero_tpu_torch.sponge import test_poseidon_config
    cfg = test_poseidon_config(field)
    st = (poseidon_cols.poseidon_stream_start(field, u.shape[1], u.device)
          if state is None else state.clone())
    states, a = [], r0
    for b in list(cuts) + ([] if rows is None else [rows]):
        last = b == rows
        if plain:
            out = poseidon_cols.poseidon_absorb_plain(field, cfg, u[a:b],
                                                      b - a, st, a == 0, last)
        else:
            out = cuda_poseidon.poseidon_absorb(field, cfg, u[a:b], b - a, st,
                                                a == 0, last, lanes)
        if last:
            return states, out
        st = out
        states.append(out.clone())
        a = b
    return states, None


def poseidon_plain_segments(torch, field, u, steps, states) -> dict:
    """The plain chunked absorb over each of ``steps``, (a, b, last): rows
    [a, b) of ``u`` from ``states[a]`` (fresh where a = 0); the steps of one
    (b - a, a = 0, last) side by side, their columns concatenated, in one
    call.  {(a, b, last): the states after b rows, or the digests}."""
    from ligero_tpu_torch.engine import poseidon_cols
    from ligero_tpu_torch.sponge import test_poseidon_config
    cfg = test_poseidon_config(field)
    n = u.shape[1]
    groups: dict = {}
    for a, b, last in steps:
        groups.setdefault((b - a, a == 0, last), []).append((a, b))
    out = {}
    for (length, first, last), segs in groups.items():
        chunk = torch.cat([u[a:b] for a, b in segs], dim=1)
        state = (poseidon_cols.poseidon_stream_start(field, chunk.shape[1],
                                                     u.device) if first
                 else torch.cat([states[a] for a, _ in segs]))
        res = poseidon_cols.poseidon_absorb_plain(field, cfg, chunk, length,
                                                  state, first, last)
        for i, (a, b) in enumerate(segs):
            out[(a, b, last)] = res[i * n:(i + 1) * n]
        del chunk, state, res
    return out


def poseidon_deep_cases(torch, field, gen, cases, diff) -> tuple[int, float]:
    """The chunked absorb at ``cases`` ((rows, chunk rows), sharing one
    matrix of POSEIDON_DEEP_COLS columns) against its plain version by
    segments (see POSEIDON_STREAM_CASES): every state and digest of each
    case's run, at the path's lanes a column (one, the rule's at 16384
    columns) and at the rule's for this width, plus the kernel's segment
    states; each digest set also against the whole-column kernel, and four
    columns of it against the host sponge.  (max_abs_err, the plain
    version's ms)."""
    from ligero_tpu_torch.engine import cuda_poseidon, fieldops, poseidon_cols
    from ligero_tpu_torch.ligero.types import LigeroMTPoseidonParams
    from ligero_tpu_torch.sponge import test_poseidon_config
    cfg = test_poseidon_config(field)
    width = POSEIDON_DEEP_COLS
    top = max(r for r, _ in cases)
    u = _rand_elems16(torch, gen, (top, width), field)
    u32 = fieldops.widen16(u)      # for the whole-column kernel and host
    cuts = {r: list(range(cr, r, cr)) for r, cr in cases}
    points = sorted(set(range(POSEIDON_SEGMENT, top, POSEIDON_SEGMENT))
                    | {c for r in cuts for c in cuts[r]})
    seg_states = dict(zip(points, poseidon_chunks_run(
        field, u, points, None, lanes=1)[0]))
    steps = [(a, b, False) for a, b in zip([0] + points[:-1], points)]
    tails = {r: max([0] + [p for p in points if p < r]) for r, _ in cases}
    steps += [(t, r, True) for r, t in tails.items()]
    plain, plain_ms = _time_once(torch, lambda: poseidon_plain_segments(
        torch, field, u, steps, seg_states))
    after = {b: out for (a, b, last), out in plain.items() if not last}
    err = max(diff(seg_states[b], after[b]) for b in points)
    require(err == 0, f"Poseidon chunked {top} x {width} in "
            f"{POSEIDON_SEGMENT}-row segments: a kernel state disagrees with "
            "the plain version's segment")
    mt = LigeroMTPoseidonParams(field)
    js = (0, width // 3, 2 * width // 3, width - 1)
    for r, cr in cases:
        want = plain[(tails[r], r, True)]
        for lanes in sorted({1, cuda_poseidon.lanes_for(width)}):
            states, digests = poseidon_chunks_run(field, u, cuts[r], r,
                                                  lanes=lanes)
            case = max([diff(digests, want)]
                       + [diff(st, after[c]) for st, c in zip(states,
                                                              cuts[r])])
            log(f"kernel [{field.name}] Poseidon chunked absorb {r} x {width} "
                f"in chunks of {cr}, {lanes} lane(s) a column: "
                f"max_abs_err={case} against its plain version "
                f"({len(states)} states between chunks and the digests)")
            require(case == 0, f"Poseidon chunked {r} x {width} in chunks of "
                    f"{cr} at {lanes} lane(s): the kernel disagrees with its "
                    "plain version")
            err = max(err, case)
        require(torch.equal(want, cuda_poseidon.poseidon_columns(
            field, cfg, u32[:r])), f"Poseidon {r} x {width}: the plain "
            "chunked digests differ from the whole-column kernel")
        host = [mt.col_hash(field, field.limbs_to_ints(
            u32[:r, j].cpu().numpy())) for j in js]
        require([poseidon_cols.digests_to_bytes(want)[j] for j in js] == host,
                f"Poseidon {r} x {width}: differs from the host sponge")
    log(f"kernel [{field.name}] Poseidon chunked absorb at {cases} x {width}: "
        f"{len(points)} kernel segment states and every run bit-equal to the "
        f"plain version ({plain_ms:.1f} ms over {len(steps)} segments), the "
        f"digests to the whole-column kernel and, at columns {js}, to the "
        "host sponge")
    del u, u32, seg_states, plain
    torch.cuda.empty_cache()
    return err, plain_ms


def poseidon_stream_entry(torch, field, gen, rows: int, n: int) -> dict:
    """The Poseidon chunked absorb (``cuda_poseidon.poseidon_absorb``, BN254
    Fr): against its plain version on the same card tensors, at the
    streaming paths' row counts and chunkings (POSEIDON_STREAM_CASES, by
    segments), and at POSEIDON_PLAIN_CASES at the commit's full width ``n``
    against the plain version row after row on its :func:`plain_columns`
    (the 39-row case takes the plain states after the 36-row
    case's 32 shared rows); every state between chunks and every digest
    bit-equal; over the commit's full width, ``rows`` x ``n`` in
    STREAM_CHUNK-row chunks, bit-equal to the whole-column kernel on the
    same matrix, both timed, with the whole column's bound."""
    from ligero_tpu_torch.engine import cuda_poseidon, fieldops
    from ligero_tpu_torch.sponge import test_poseidon_config
    cfg = test_poseidon_config(field)

    def whole(u):
        # the whole-column kernel, on the 16-bit chunks' int32 widening
        return cuda_poseidon.poseidon_columns(field, cfg, fieldops.widen16(u))

    def diff(a, b) -> int:
        return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())

    err, plain_ms = 0, None
    for cases in POSEIDON_STREAM_CASES:
        case_err, case_ms = poseidon_deep_cases(torch, field, gen, cases, diff)
        err, plain_ms = max(err, case_err), plain_ms or case_ms
    (r1, c1), (r2, _), (r3, c3) = POSEIDON_PLAIN_CASES
    u = _rand_elems16(torch, gen, (r2, n), field)
    v = _rand_elems16(torch, gen, (r3, n), field)
    pc = plain_columns(torch, n)
    pu, pv = u[:, pc], v[:, pc]
    t0 = time.perf_counter()
    plain = {r1: poseidon_stream_run(field, pu, r1, c1, True),
             r3: poseidon_stream_run(field, pv, r3, c3, True)}
    shared = (r1 // c1) * c1 if r1 % c1 else r1 - c1
    plain[r2] = ([], poseidon_stream_run(
        field, pu, r2, c1, True, plain[r1][0][shared // c1 - 1], shared)[1])
    torch.cuda.synchronize()
    short_ms = (time.perf_counter() - t0) * 1e3
    for (nrows, cr), mat in zip(POSEIDON_PLAIN_CASES, (u, u, v)):
        states, digests = poseidon_stream_run(field, mat, nrows, cr, False)
        want_states, want = plain[nrows]
        case = max([diff(digests[pc], want)] + [
            diff(a[pc], b) for a, b in zip(states, want_states)])
        require(torch.equal(digests, whole(mat[:nrows])), f"Poseidon chunked "
                f"{nrows} x {n} in chunks of {cr}: differs from the "
                "whole-column kernel")
        log(f"kernel [{field.name}] Poseidon chunked absorb {nrows} x {n} in "
            f"chunks of {cr}, {cuda_poseidon.lanes_for(n)} lane(s) a column: "
            f"max_abs_err={case} against its plain version on its first and "
            f"last {len(pc) // 2} columns ({len(want_states)} states between "
            "chunks and the digests)")
        require(case == 0, f"Poseidon chunked {nrows} x {n} in chunks of "
                f"{cr}: the kernel disagrees with its plain version")
        err = max(err, case)
    log(f"kernel [{field.name}] Poseidon chunked absorb: plain version "
        f"{short_ms:.1f} ms over the three cases at {len(pc)} of {n} columns")
    del u, v
    w = _rand_elems16(torch, gen, (rows, n), field)
    w32 = fieldops.widen16(w)
    require(torch.equal(poseidon_stream_run(field, w, rows, STREAM_CHUNK,
                                            False)[1], whole(w32)),
            f"Poseidon chunked {rows} x {n}: differs from the whole-column "
            "kernel")
    ms = _time_cuda(torch, lambda: poseidon_stream_run(
        field, w, rows, STREAM_CHUNK, False), 3)
    whole_ms = _time_cuda(torch, lambda: whole(w32), 3)
    bound_ms, by = bound(*poseidon_work(field, rows, n, in16=True))
    launches = -(-rows // STREAM_CHUNK)
    log(f"kernel [{field.name}] Poseidon chunked absorb {rows} x {n} in "
        f"{launches} chunks of {STREAM_CHUNK}, 16-bit limbs: bit-equal to the "
        f"whole-column kernel; {ms:.3f} ms (whole-column {whole_ms:.3f} ms, "
        f"{ms / whole_ms - 1:+.1%}), bound {bound_ms:.3f} ms by {by} "
        f"({bound_ms / ms:.1%})")
    del w, w32
    torch.cuda.empty_cache()
    first = POSEIDON_STREAM_CASES[0]
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "whole_column_ms": whole_ms,
            "short_plain_ms": short_ms,
            "lanes": cuda_poseidon.lanes_for(n),
            "shape": f"{rows} x {n} in {launches} chunks of {STREAM_CHUNK}; "
                     f"plain at {first} x {POSEIDON_DEEP_COLS} by "
                     f"{POSEIDON_SEGMENT}-row segments (plain_ms), and at "
                     f"{POSEIDON_PLAIN_CASES} x {n} row after row on "
                     f"{len(pc)} columns (short_plain_ms)"}


def host_hash_context(n: int) -> None:
    """Context only: the host's hashlib over n - 1 two-to-one hashes."""
    digests = [os.urandom(32) for _ in range(n)]
    t0 = time.perf_counter()
    while len(digests) > 1:
        digests = [hashlib.sha256(digests[i] + digests[i + 1]).digest()
                   for i in range(0, len(digests), 2)]
    log(f"context: host hashlib, {n - 1} SHA-256 two-to-one hashes: "
        f"{(time.perf_counter() - t0) * 1e3:.3f} ms")


def blake2s_residue_cases(torch, field, gen) -> None:
    """The column kernel of a 48-byte field, whose message repeats every 3
    blocks of 4 rows and which stages rows in a ring of three 2-row stages,
    at row counts of every residue mod 12 (96-107: the zk main path's
    4m + 3 = 4103 among them, whose full depth no case holds against the
    plain version; 4m is the kernels phase's case), one matrix and three
    stacked in one launch, at 2 PLAIN_COLUMNS columns (two blocks a
    matrix), against the plain version on PLAIN_COLUMNS of them (~0.4 s a
    count)."""
    for nrows in range(96, 108):
        blake2s_batch_case(torch, field, gen, BATCH, nrows, 2 * PLAIN_COLUMNS)


def blake2s_full_batch_case(torch, field, gen, B, rows, n,
                            plain: bool) -> dict:
    """B full (rows, n) matrices in one launch (at the 2^20 shape their
    element offsets pass 2^31) against B single launches, and with
    ``plain`` each matrix's :func:`plain_columns` at full depth against
    the plain version (which hashes the B matrices' slices side by
    side as one matrix; ~10-25 s, one small step a block of rows, so it
    runs where no other case holds these rows against it: the kernel
    stages rows in a ring of three pairs, so where a column's rows end in
    it goes with the rows mod 6: the 2^18 batch paths' 2052 and 2055 rows
    take residues that the 4100 and 4103 rows of the kernels phase do
    not); returns the times and bound."""
    from ligero_tpu_torch.engine import cuda_hash, hashops
    L, pcols = field.num_limbs, plain_columns(torch, n)
    pc = len(pcols)
    u = _rand_elems(torch, gen, (B * rows, n), field)
    got = cuda_hash.blake2s_columns(field, u, B)
    err, plain_ms = None, None
    if plain:
        side = u.reshape(B, rows, n, L)[:, :, pcols].permute(
            1, 0, 2, 3).reshape(rows, B * pc, L)
        want, plain_ms = _time_once(
            torch, lambda: hashops.blake2s_columns_ref(side))
        err = max(_diff(torch, got[i * n + pcols], want[i * pc:(i + 1) * pc])
                  for i in range(B))
        require(err == 0, f"batched Blake2s {B} x {rows} x {n}: the kernel "
                f"disagrees with its plain version on its first and last "
                f"{pc // 2} columns")
        del side, want
    for i in range(B):
        require(torch.equal(got[i * n:(i + 1) * n], cuda_hash.blake2s_columns(
            field, u[i * rows:(i + 1) * rows])), f"batched Blake2s {B} x "
            f"{rows} x {n}, matrix {i}: differs from its single launch")
    ms = _time_cuda(torch, lambda: cuda_hash.blake2s_columns(field, u, B), 3)
    dev_ms = _device_ms(torch, lambda: cuda_hash.blake2s_columns(field, u, B),
                        "blake2s_kernel")
    bound_ms, by = bound(*scaled(blake2s_work(field, rows, n), B))
    held = (f"first and last {pc // 2} columns of each max_abs_err=0 against "
            f"the plain version ({plain_ms:.1f} ms), " if plain else "")
    log(f"kernel [{field.name}] batched Blake2s, full {B} x {rows} x {n}: "
        f"{held}bit-equal to {B} single launches; "
        f"{ms:.3f} ms (device {_ms(dev_ms)}), bound {bound_ms:.3f} ms by {by}")
    del u, got
    torch.cuda.empty_cache()
    shape = f"{B} x {rows} x {n}" + (
        f"; plain on the first and last {pc // 2} columns of each"
        if plain else "")
    return {"shape": shape, "max_abs_err": err, "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by}


def blake2s_batch_case(torch, field, gen, B, nrows, cols) -> dict:
    """The column kernel over B stacked (nrows, cols) matrices in one
    launch, and over the first alone, against the plain version on each
    matrix's :func:`plain_columns` (which it hashes side by side as one
    matrix); returns the times and the bound of the batched launch."""
    from ligero_tpu_torch.engine import cuda_hash, hashops
    L, pcols = field.num_limbs, plain_columns(torch, cols)
    pc = len(pcols)
    u = _rand_elems(torch, gen, (B * nrows, cols), field)
    side = u.reshape(B, nrows, cols, L)[:, :, pcols].permute(
        1, 0, 2, 3).reshape(nrows, B * pc, L)
    want, plain_ms = _time_once(
        torch, lambda: hashops.blake2s_columns_ref(side))
    got = cuda_hash.blake2s_columns(field, u, B)
    require(all(torch.equal(got[i * cols + pcols], want[i * pc:(i + 1) * pc])
                for i in range(B)), f"batched Blake2s {B} x {nrows} x {cols}: "
            "kernel disagrees with its plain version")
    require(torch.equal(cuda_hash.blake2s_columns(field, u[:nrows])[pcols],
                        want[:pc]), f"Blake2s columns {nrows} x {cols}: "
            "kernel disagrees with its plain version")
    ms = _time_cuda(torch, lambda: cuda_hash.blake2s_columns(field, u, B), 5)
    one = _time_cuda(
        torch, lambda: cuda_hash.blake2s_columns(field, u[:nrows]), 5)
    bound_ms, by = bound(*scaled(blake2s_work(field, nrows, cols), B))
    log(f"kernel [{field.name}] batched Blake2s {B} x {nrows} x {cols}: "
        f"max_abs_err=0, and one matrix alone; kernel {ms:.4f} ms (one "
        f"matrix {one:.4f} ms), plain {plain_ms:.3f} ms, bound "
        f"{bound_ms:.4f} ms by {by}")
    del u, side, want, got
    torch.cuda.empty_cache()
    return {"shape": f"{B} x {nrows} x {cols}; plain on {pc} columns of "
                     "each", "ms": ms, "one_ms": one,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by}


def row_combine_batch_case(torch, field, gen, B, rows, k) -> dict:
    """row_combine over B (rows, k) matrices with their own challenges in
    one launch (grid z) against the plain version; returns the times and
    the bound."""
    from ligero_tpu_torch.engine import cuda_lc
    r = _rand_elems(torch, gen, (B, rows), field)
    mats = _rand_elems(torch, gen, (B, rows, k), field)
    got = cuda_lc.row_combine_batch(field, r, mats)
    want, plain_ms = _time_once(
        torch, lambda: cuda_lc.row_combine_batch_ref(field, r, mats))
    require(got.shape == want.shape and torch.equal(got, want),
            f"batched row_combine {B} x {rows} x {k}: kernel disagrees with "
            "its plain version")
    ms = _time_cuda(
        torch, lambda: cuda_lc.row_combine_batch(field, r, mats), 5)
    one = _time_cuda(
        torch, lambda: cuda_lc.row_combine(field, r[0], mats[0]), 5)
    dev_ms = _device_ms(torch, lambda: cuda_lc.row_combine_batch(
        field, r, mats), "row_combine_kernel")
    bound_ms, by = bound(*scaled(row_combine_work(field, rows, k), B))
    log(f"kernel [{field.name}] batched row_combine {B} x {rows} x {k}: "
        f"max_abs_err=0 kernel {ms:.4f} ms (device {_ms(dev_ms)}; one "
        f"{one:.4f} ms), plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms by "
        f"{by}")
    del r, mats, got, want
    torch.cuda.empty_cache()
    return {"shape": f"{B} x {rows} x {k}", "ms": ms, "device_ms": dev_ms,
            "one_ms": one, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by}


def batch_kernel_cases(torch, field, gen, results, rows, k, n) -> None:
    """The batched launches of the serving path, B = 3, bit-equal to their
    per-proof versions: Blake2s over three stacked matrices of a depth
    with the zk path's residue of 4m + 3 rows mod 12 (the kernel's rows go
    in a ring of three 2-row stages; the plain version takes one step a
    block of rows, ~20 s at 4103 rows) against the plain version (and one
    matrix of them in a single launch, the zk main path's case), then over
    three full (4m, n) matrices, whose element offsets pass 2^31, against
    three single launches (held against the plain version at that row
    count in the kernels phase); row_combine over three (4m, k) matrices with their own
    challenges; three trees on one stream (at n and at 64 leaves: what B
    launches cost).  The batched times and bounds go into ``results``
    beside the single launches'."""
    from ligero_tpu_torch.engine import cuda_tree, hashops
    B = BATCH

    def check(label, got, want):
        require(got.shape == want.shape and torch.equal(got, want),
                f"{label}: kernel disagrees with its per-proof version")

    results["blake2s_cols"]["batched"] = blake2s_batch_case(
        torch, field, gen, B, 96 + (rows + 3) % 12, 2 * PLAIN_COLUMNS)
    results["blake2s_cols"]["batched_full"] = blake2s_full_batch_case(
        torch, field, gen, B, rows, n, plain=False)
    results["row_combine"]["batched"] = row_combine_batch_case(
        torch, field, gen, B, rows, k)
    for leaves_n in (n, 64):
        forest = torch.randint(-2**31, 2**31, (B, leaves_n, 8), generator=gen,
                               dtype=torch.int64, device="cuda").to(torch.int32)
        got = cuda_tree.forest_flat(forest)
        for i in range(B):
            check(f"{B} trees n={leaves_n}", got[i], hashops.tree_flat(forest[i]))
        ms = _time_cuda(torch, lambda: cuda_tree.forest_flat(forest), 20)
        one = _time_cuda(torch, lambda: cuda_tree.tree_flat(forest[0]), 20)
        log(f"kernel {B} SHA-256 trees n={leaves_n} in {B} launches on one "
            f"stream: bit-equal, {ms:.4f} ms (one tree {one:.4f} ms)")
        results["sha256_tree"].setdefault("forest", {})[str(leaves_n)] = {
            "trees": B, "ms": ms, "one_ms": one}
    torch.cuda.empty_cache()


def spot_cases(torch, field, gen, rows, k, n, t) -> None:
    """The spot evaluation (int8 tensor-core products around the port's own
    limb split, regroup and fold; no TPU kernel behind it; not on the
    verifier's path while it is the slower route) at the linear phase's
    shape: bit-equal to the NTT route on all rows and to its
    plain version (the plain full transform, then a gather) on its first
    PLAIN_ROWS rows,
    Montgomery and canonical output; then a row longer than K_MAX, which
    contracts in chunks.  Times of both routes and the spot route's bound
    (the int8 multiply-adds over the tensor cores' rate, or its bytes)."""
    from ligero_tpu_torch.engine import cuda_ntt, spot
    js = torch.randperm(n, generator=gen, device="cuda")[:t].cpu().numpy()
    idx = torch.as_tensor(js, device="cuda")
    shapes = [(rows, k), (64, 2 * spot.K_MAX + 40)]
    for nrows, w in shapes:
        x = _rand_elems(torch, gen, (nrows, w), field)
        for canon in (False, True):
            got = spot.spot_eval(field, x, js, n, canon_out=canon)
            via_ntt = cuda_ntt.ntt(field, x, n, canon_out=canon).index_select(
                1, idx)
            want, plain_ms = _time_once(torch, lambda: spot.spot_ref(
                field, x[:PLAIN_ROWS], js, n, canon_out=canon))
            ok = (torch.equal(got, via_ntt)
                  and torch.equal(got[:PLAIN_ROWS], want))
            log(f"spot {nrows} x {w} at {t} of {n} columns, canon_out={canon}: "
                f"bit-equal to the NTT route and the plain version: {ok} "
                f"(plain, {min(nrows, PLAIN_ROWS)} rows: {plain_ms:.3f} ms)")
            require(ok, f"spot_eval {nrows} x {w} canon_out={canon} disagrees")
            del got, via_ntt, want
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms = _time_cuda(torch, lambda: spot.spot_eval(field, x, js, n), 3)
        spot_peak = torch.cuda.max_memory_allocated() - base
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ntt_ms = _time_cuda(torch, lambda: cuda_ntt.ntt(
            field, x, n).index_select(1, idx), 3)
        ntt_peak = torch.cuda.max_memory_allocated() - base
        macs = spot.L7 * spot.L7 * nrows * w * t
        by_ops = 2 * macs / INT8_OPS_PER_S * 1e3
        by_bytes = nrows * (w + t) * elem_bytes(field) / HBM_BYTES_PER_S * 1e3
        log(f"spot {nrows} x {w} at {t} of {n} columns: spot route {ms:.3f} ms "
            f"(transients {spot_peak / 2**30:.2f} GiB), NTT route "
            f"{ntt_ms:.3f} ms (transients {ntt_peak / 2**30:.2f} GiB); bound "
            f"{max(by_ops, by_bytes):.3f} ms by "
            f"{'operations' if by_ops >= by_bytes else 'bytes'} "
            f"({macs:.3e} int8 multiply-adds)")
        del x
        torch.cuda.empty_cache()


_SASS: dict = {}


def library_sass(path: str) -> str:
    """The library's SASS (``cuobjdump -sass``), dumped once a run."""
    if path not in _SASS:
        tool = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "cuobjdump")
        res = subprocess.run([tool, "-sass", path], capture_output=True,
                             text=True, timeout=300)
        require(res.returncode == 0, f"cuobjdump failed: {res.stderr[-300:]}")
        _SASS[path] = res.stdout
    return _SASS[path]


def sass_loops(path: str, symbol: str) -> dict:
    """The loops of every function of the library whose mangled name holds
    ``symbol``, from its SASS (:func:`library_sass`): {name: [loop body,
    ...]}, a body the instructions from a backward branch's target to the
    branch."""
    import re
    out, name, body = {}, None, []
    for line in library_sass(path).splitlines() + ["Function : end"]:
        if "Function : " in line:
            if name and symbol in name:
                instrs = [(int(a, 16), text) for a, text in body]
                back = [(at, int(t, 16)) for at, text in instrs
                        for t in re.findall(r"BRA (0x[0-9a-f]+)", text)
                        if int(t, 16) < at]
                require(back, f"SASS {name}: no loop")
                out[name] = [[text for at, text in instrs if b[1] <= at <= b[0]]
                             for b in back]
            name, body = line.split("Function : ")[1].strip(), []
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
        if m:
            body.append((m.group(1), m.group(2)))
    return out


def _instantiation(name: str, flags_text) -> str:
    """A kernel's field and template flags (Lb1E = true) in words."""
    import re
    field = "bls12_377_fq" if "Bls12377Fq" in name else "bn254_fr"
    flags = re.findall(r"Lb([01])E", name)
    return field + "".join(f", {text}" for flag, text in zip(flags, flags_text)
                           if flag == "1")


def row_combine_sass(path: str) -> dict:
    """Where the row loop of each ``row_combine_kernel`` instantiation
    stands its copies and its products, from the library's SASS
    (:func:`sass_loops`): the loop with the most wide multiply-adds; in it
    the cp.async copies of the rows ahead (LDGSTS), the shared loads
    of the staged rows (LDS), the wide multiply-adds of the unreduced
    products (IMAD.WIDE, IMAD.HI and their carried forms) and the waits
    for the copies (LDGDEPBAR / DEPBAR).  Returns {instantiation:
    {"body": length, "copies": n, "first_copy": i, "last_copy": j,
    "shared_loads": n, "multiplies": n, "first_multiply": k,
    "last_multiply": l, "waits": n}}."""
    import re
    out = {}
    for name, loops in sass_loops(path, "row_combine_kernel").items():
        # template arguments <F, M16, PERCOL>
        field = _instantiation(name, ("16-bit", "r per column"))
        loop = max(loops, key=lambda body: sum(
            bool(re.search(r"\bIMAD\.(WIDE|HI)", t)) for t in body))

        def where(pattern):
            return [i for i, text in enumerate(loop)
                    if re.search(pattern, text)]
        copies = where(r"\bLDGSTS\b")
        mults = where(r"\bIMAD\.(WIDE|HI)")
        out[field] = {"body": len(loop), "copies": len(copies),
                      "first_copy": min(copies, default=None),
                      "last_copy": max(copies, default=None),
                      "shared_loads": len(where(r"\bLDS\b")),
                      "multiplies": len(mults),
                      "first_multiply": min(mults, default=None),
                      "last_multiply": max(mults, default=None),
                      "waits": len(where(r"\b(LDGDEPBAR|DEPBAR)\b"))}
    return out


#: opcodes that issue on the integer (ALU) pipe, and on the FMA pipe
ALU_OPS = ("LOP3", "SHF", "IADD3", "PRMT", "LEA", "ISETP", "SEL", "VIADD",
           "IABS", "FLO", "POPC", "BMSK", "SGXT", "LOP")
FMA_OPS = ("IMAD", "IMUL")


def blake2s_sass(path: str) -> dict:
    """The compression loop of each ``blake2s_kernel`` instantiation from
    the library's SASS (:func:`sass_loops`: the loop with the most funnel
    shifts), its instructions by the pipe that issues them: the integer
    pipe's (LOP3, SHF, IADD3, ...) and the FMA pipe's (IMAD and its forms,
    adds and moves ptxas puts there).  Per scheduler a cycle the integer
    pipe takes 16 lanes, the FMA pipe's integer half 16, the issue 32, so
    the least cycles of a warp's pass through the loop are the larger of 2
    x integer, 2 x FMA and all instructions; ``mix_over_issue`` is that
    over the loop's blocks' 968 operations a block at the issue rate (one
    cycle each).  Returns {instantiation: {"body": n, "alu": a, "fma": f,
    "blocks": b, "mix_over_issue": x, "ops": {opcode: n}}}."""
    import collections
    out = {}
    for name, loops in sass_loops(path, "blake2s_kernel").items():
        field = _instantiation(name, ("16-bit",))
        loop = max(loops, key=lambda body: sum(
            t.split()[1 if t.startswith("@") else 0].startswith("SHF")
            for t in body))
        ops = collections.Counter(
            t.split()[1 if t.startswith("@") else 0].split(".")[0]
            for t in loop)
        alu = sum(n for op, n in ops.items() if op in ALU_OPS)
        fma = sum(n for op, n in ops.items() if op in FMA_OPS)
        # one compression body a pass (the rotations: 4 a G, 8 G a round,
        # 10 rounds)
        blocks = max(1, round(ops["SHF"] / 320))
        cycles = max(2 * alu, 2 * fma, len(loop))
        out[field] = {"body": len(loop), "alu": alu, "fma": fma,
                      "blocks": blocks,
                      "mix_over_issue": cycles / (blocks * BLAKE2S_BLOCK_OPS),
                      "ops": dict(ops.most_common(8))}
    return out


def ptxas_lines(log_text: str, symbols) -> list[str]:
    """ptxas's registers, shared memory and spill lines of every compiled
    function whose mangled name holds one of ``symbols``, each beside that
    name (the function being compiled precedes its lines in nvcc.log)."""
    import re
    out, current = [], None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = m.group(1)
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            current = m.group(1)
        if current and any(sym in current for sym in symbols) and (
                "registers" in line or "spill" in line):
            # _ZN..blake2s_kernelI10Bls12377FqLb1ELi4EE.. -> blake2s_kernel<
            # Bls12377Fq, 1, 4>: the field and the template's flags
            m = re.search(r"(%s)I\d+(\w+?)((?:L[bi]\d+E)+)E"
                          % "|".join(symbols), current)
            name = (f"{m.group(1)}<{m.group(2)}, "
                    f"{', '.join(re.findall(r'L[bi](\d+)E', m.group(3)))}>"
                    if m else current)
            out.append(f"{name}: {line.split('ptxas info    :')[-1].strip()}")
    return out


def ntt_spills(nvcc_log: str) -> list[str]:
    """Print ptxas's registers and spill of every ``ntt.cu`` instantiation;
    return the lines of a BLS12-377 one that spills (its lazy butterflies
    are designed to fit 128 registers)."""
    import re
    lines = ptxas_lines(nvcc_log, ("ntt_pass_kernel", "ntt_stage_kernel"))
    require(any("Bls12377Fq" in line for line in lines),
            "nvcc.log names no BLS12-377 instantiation of ntt.cu")
    for line in lines:
        log("ptxas [ntt]: " + line)
    return [line for line in lines if "Bls12377Fq" in line
            and any(int(b) for b in re.findall(r"(\d+) bytes spill", line))]


def poseidon_levels_work(field, n: int):
    """Bytes and operations of the Merkle levels above n leaves: one
    2-row sponge a node, summed over the levels."""
    works = [poseidon_work(field, 2, w) for w in
             (n >> i for i in range(1, n.bit_length()))]
    return tuple(sum(w[i] for w in works) for i in range(2))


def poseidon_cases(torch, field, gen, rows: int, n: int, t: int) -> dict:
    """The Poseidon sponge kernel (BN254 Fr), every compiled lane count G
    (``cuda_poseidon.LANES``): launched at full width (n columns) and
    the heights POSEIDON_LANE_ROWS (the odd one: a zk column's tail), its first
    :func:`plain_columns` bit-equal to its plain version's on the card; at the commit's full heights (4m and
    4m + 3 rows) and at the verifier's launch (its 3t opened columns of 4m
    rows) against the port's host sponge (``col_hash``) on 8 sampled
    columns, all G bit-equal to each other, each G timed there, at the tree
    levels of n/2, n/4 and n/8 two-row columns and the root, and at full
    height over 2048 and 4096 columns; the launch's own rule
    (``lanes_for``) gives the reported times.  Then the Merkle levels
    against the host ``create_merkle_tree(two_to_one=...)`` at 1024 leaves,
    the level launches at n leaves timed with their bound; three full
    matrices in one launch against three single launches; the chain floor:
    one group of lanes hashing one full column.  Returns the kernel's
    results."""
    from ligero_tpu_torch.engine import cuda_poseidon, poseidon_cols
    from ligero_tpu_torch.ligero.types import LigeroMTPoseidonParams
    from ligero_tpu_torch.merkle import create_merkle_tree
    from ligero_tpu_torch.sponge import test_poseidon_config
    cfg = test_poseidon_config(field)
    mt = LigeroMTPoseidonParams(field)
    lanes = cuda_poseidon.LANES

    def kern(u, g=None):
        return cuda_poseidon.poseidon_columns(field, cfg, u, lanes=g)

    def floor_ms(u, g):
        one = torch.empty((u.shape[0], 1, field.num_limbs), dtype=torch.int32,
                          device="cuda")
        one.copy_(u[:, :1])
        return _time_cuda(torch, lambda: kern(one, g), 2)

    res: dict = {"max_abs_err": 0, "per_lanes": {str(g): {} for g in lanes}}
    pcols = plain_columns(torch, n)
    for h in POSEIDON_LANE_ROWS:
        u = _rand_elems(torch, gen, (h, n), field)
        want, plain_ms = _time_once(
            torch, lambda: poseidon_cols.poseidon_columns_plain(
                field, cfg, u[:, pcols]))
        bound_ms, by = bound(*poseidon_work(field, h, n))
        for g in lanes:
            got = kern(u, g)[pcols]
            err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
            ms = _time_cuda(torch, lambda: kern(u, g), 3)
            log(f"kernel [{field.name}] Poseidon columns {h} x {n}, G = {g}: "
                f"max_abs_err={err} kernel {ms:.3f} ms, plain {plain_ms:.1f} "
                f"ms on its first and last {PLAIN_COLUMNS // 2} columns, "
                f"bound {bound_ms:.3f} ms by "
                f"{by}")
            require(got.shape == want.shape and err == 0, f"Poseidon columns "
                    f"{h} x {n} at G = {g}: the kernel disagrees with its "
                    "plain version")
            res["max_abs_err"] = max(res["max_abs_err"], err)
            res["per_lanes"][str(g)][f"rows_{h}_ms"] = ms
        res[f"rows_{h}"] = {"plain_ms": plain_ms, "bound_ms": bound_ms,
                            "bound_by": by}
        del u, want
    res["plain_ms"] = res[f"rows_{POSEIDON_LANE_ROWS[0]}"]["plain_ms"]
    # full heights: the commit (plain, zk) and the verifier's launch
    for key, h, width in (("", rows, n), ("zk_", rows + 3, n),
                          ("verifier_", rows, 3 * t)):
        u = _rand_elems(torch, gen, (h, width), field)
        js = torch.randperm(width, generator=gen, device="cuda")[:8].tolist()
        host = [mt.col_hash(field, field.limbs_to_ints(u[:, j].cpu().numpy()))
                for j in js]
        bound_ms, by = bound(*poseidon_work(field, h, width))
        first = None
        for g in lanes:
            got = kern(u, g)
            first = got if first is None else first
            require(torch.equal(got, first) and [poseidon_cols.digests_to_bytes(
                got)[j] for j in js] == host, f"Poseidon columns {h} x {width}"
                f" at G = {g}: differs from the host sponge or from G = 1")
            ms = _time_cuda(torch, lambda: kern(u, g), 2)
            res["per_lanes"][str(g)][f"{key or 'commit_'}ms"] = ms
            log(f"kernel [{field.name}] Poseidon columns, full {h} x {width}, "
                f"G = {g}: 8 sampled columns equal the host sponge; "
                f"{ms:.3f} ms, bound {bound_ms:.3f} ms by {by} "
                f"({bound_ms / ms:.1%})")
        g = cuda_poseidon.lanes_for(width)
        ms = res["per_lanes"][str(g)][f"{key or 'commit_'}ms"]
        floor = floor_ms(u, cuda_poseidon.lanes_for(1))
        log(f"kernel [{field.name}] Poseidon columns, full {h} x {width}: the "
            f"launch's rule takes G = {g}, {ms:.3f} ms ({bound_ms / ms:.1%} of "
            f"the bound); chain floor (one column, G = "
            f"{cuda_poseidon.lanes_for(1)}) {floor:.3f} ms ({floor / ms:.1%})")
        if not key:
            res.update(ms=ms, lanes=g, bound_ms=bound_ms, bound_by=by,
                       chain_floor_ms=floor, chain_floor_g1_ms=floor_ms(u, 1))
        elif key == "zk_":
            res.update(zk_full_ms=ms, zk_full_bound_ms=bound_ms)
        else:
            res["verifier"] = {"shape": f"{h} x {width}", "ms": ms, "lanes": g,
                               "bound_ms": bound_ms, "bound_by": by,
                               "chain_floor_ms": floor}
        del u
    # the widths around the rule's thresholds: tree levels (2 rows) from
    # n/2 columns to the root, and full-height launches of 2048 and 4096
    # columns; each G, all bit-equal to G = 1
    for h, width, iters in ([(2, n >> i, 20) for i in (1, 2, 3)] + [(2, 1, 20)]
                            + [(rows, 2048, 1), (rows, 4096, 1)]):
        key = f"{'level' if h == 2 else 'full'}_{width}_ms"
        u = _rand_elems(torch, gen, (h, width), field)
        want = kern(u, 1)
        for g in lanes:
            require(torch.equal(kern(u, g), want), f"Poseidon {h} x {width} "
                    f"at G = {g} differs from G = 1")
            res["per_lanes"][str(g)][key] = _time_cuda(
                torch, lambda: kern(u, g), iters)
        log(f"kernel [{field.name}] Poseidon {h} x {width}: every G bit-equal; "
            + ", ".join(f"G = {g} {res['per_lanes'][str(g)][key]:.4f} ms"
                        for g in lanes) + f"; the rule takes G = "
            f"{cuda_poseidon.lanes_for(width)}")
        del u
    # the tree: levels of Poseidon two-to-one, one launch a level
    leaves = _rand_elems(torch, gen, (1024,), field)
    got = poseidon_cols.tree_levels(field, cfg, leaves)
    digests = poseidon_cols.digests_to_bytes(leaves)
    want = create_merkle_tree(digests, two_to_one=mt.two_to_one).levels
    require([poseidon_cols.digests_to_bytes(lv) for lv in got] == want,
            "Poseidon tree levels at 1024 leaves differ from the host tree")
    leaves = _rand_elems(torch, gen, (n,), field)
    levels_ms = _time_cuda(
        torch, lambda: poseidon_cols.tree_levels(field, cfg, leaves), 3)
    bound_ms, by = bound(*poseidon_levels_work(field, n))
    res["levels"] = {"launches": n.bit_length() - 1, "ms": levels_ms,
                     "bound_ms": bound_ms, "bound_by": by}
    log(f"kernel [{field.name}] Poseidon tree: levels at 1024 leaves equal "
        f"the host tree's; {n.bit_length() - 1} level launches at {n} leaves "
        f"{levels_ms:.3f} ms, bound {bound_ms:.4f} ms by {by}")
    # three full matrices in one launch against three single launches
    B = BATCH
    u = _rand_elems(torch, gen, (B * rows, n), field)
    mats = u.view(B, rows, n, field.num_limbs)
    got = kern(mats)
    for i in range(B):
        require(torch.equal(got[i], kern(u[i * rows:(i + 1) * rows])),
                f"batched Poseidon {B} x {rows} x {n}, matrix {i}: differs "
                "from its single launch")
    ms = _time_cuda(torch, lambda: kern(mats), 1)
    bound_ms, by = bound(*scaled(poseidon_work(field, rows, n), B))
    res["batched_full"] = {"shape": f"{B} x {rows} x {n}", "ms": ms,
                           "lanes": cuda_poseidon.lanes_for(B * n),
                           "bound_ms": bound_ms, "bound_by": by}
    log(f"kernel [{field.name}] batched Poseidon, full {B} x {rows} x {n}: "
        f"bit-equal to {B} single launches; {ms:.3f} ms "
        f"({ms / res['ms']:.2f}x one), bound {bound_ms:.3f} ms by {by}")
    del u, mats, got
    torch.cuda.empty_cache()
    return res


def kernel_cases_2e22(torch, field, gen, results: dict) -> None:
    """The kernel shapes of the 2^22-gate instance (m = 2049, k = 4096,
    n = 32768; the zk d2 from the compile's own rule), held against the
    plain versions: iNTT_k, NTT_n 4096 -> 32768 canonical, NTT_2k and zk
    NTT_d2 launched at 256 rows, the plain version on the first PLAIN_ROWS;
    row_combine over 8196 x 4096; the tree at 32768
    leaves.  Then at full size: iNTT_k and NTT_n over all 8196 rows, each
    full transform's first 256 rows equal to the 256-row launch's (the
    route may differ with the row count); Blake2s over the 8196 x 32768
    canonical codewords, 16 sampled columns equal to the host's hashlib
    column hash (``hashes.column_hash``; the plain version would take tens
    of seconds for its ~4100 dependent block steps, and holds the kernel at
    the 2^20 commit's 4100 rows, on 256 columns, in the kernels phase).  Times go into ``results[...]["2^22"]``."""
    from ligero_tpu_torch.engine import (cuda_lc, cuda_ntt, cuda_tree,
                                         fieldops, hashops, ntt)
    from ligero_tpu_torch.hashes import column_hash
    from ligero_tpu_torch.ligero.compile import calculate_t, zk_parameters
    m, k, n = DIMS_22
    rows = 4 * m
    t = calculate_t(field, 128, (n - k + 1, n), n)
    b, d2 = zk_parameters(k, n, t, True)

    def check(name, label, got, want, plain_ms, ms, work):
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        bound_ms, by = bound(*work)
        log(f"kernel [{field.name}] 2^22 {label}: max_abs_err={err} kernel "
            f"{ms:.4f} ms, plain {plain_ms:.1f} ms, bound {bound_ms:.4f} ms "
            f"by {by}")
        require(got.shape == want.shape and err == 0,
                f"2^22 {label}: the kernel disagrees with its plain version")
        results[name].setdefault("2^22", {})[label] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": by}
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)

    firsts = {}
    for label, w, size, inverse, canon in (
            (f"iNTT_k k={k}", k, k, True, False),
            (f"NTT_n {k} -> {n} canon_out", k, n, False, True),
            (f"NTT_2k 2k={2 * k}", k, 2 * k, False, False),
            (f"zk NTT_d2 d2={d2} of k + b", k + b, d2, False, False)):
        x = _rand_elems(torch, gen, (256, w), field)
        got = cuda_ntt.ntt(field, x, size, inverse, canon)
        want, plain_ms = _time_once(
            torch, lambda: ntt.ntt_ref(field, x[:PLAIN_ROWS], size, inverse,
                                       canon))
        ms = _time_cuda(torch, lambda: cuda_ntt.ntt(field, x, size, inverse,
                                                     canon), 5)
        check("ntt", f"{label}, 256 x {w} [route "
              f"{route_text(cuda_ntt.route(w, size, 256))}; plain on "
              f"{PLAIN_ROWS} rows]", got[:PLAIN_ROWS], want, plain_ms, ms,
              ntt_work(field, 256, w, size, inverse or canon))
        firsts[label] = (x, got)
        del want
    r = _rand_elems(torch, gen, (rows,), field)
    mat = _rand_elems(torch, gen, (rows, k), field)
    got = cuda_lc.row_combine(field, r, mat)
    want, plain_ms = _time_once(
        torch, lambda: cuda_lc.row_combine_ref(field, r, mat))
    ms = _time_cuda(torch, lambda: cuda_lc.row_combine(field, r, mat), 5)
    check("row_combine", f"row_combine {rows} x {k}", got, want, plain_ms, ms,
          row_combine_work(field, rows, k))
    del r, mat
    leaves = torch.randint(-2**31, 2**31, (n, 8), generator=gen,
                           dtype=torch.int64, device="cuda").to(torch.int32)
    got = cuda_tree.tree_flat(leaves)
    want, plain_ms = _time_once(torch, lambda: hashops.tree_flat(leaves))
    ms = _time_cuda(torch, lambda: cuda_tree.tree_flat(leaves), 5)
    check("sha256_tree", f"SHA-256 tree n={n}", got, want, plain_ms, ms,
          tree_work(n))
    torch.cuda.empty_cache()
    # full size, kernel only; the full transforms agree with the checked
    # 256-row launches on their first rows
    for label, w, size, inverse, canon in (
            (f"iNTT_k k={k}", k, k, True, False),
            (f"NTT_n {k} -> {n} canon_out", k, n, False, True)):
        x256, got256 = firsts[label]
        x = _rand_elems(torch, gen, (rows, w), field)
        x[:256] = x256
        out = cuda_ntt.ntt(field, x, size, inverse, canon)
        require(torch.equal(out[:256], got256), f"2^22 {label}: the full "
                f"{rows}-row transform differs from the 256-row launch")
        del out
        ms = _time_cuda(torch, lambda: cuda_ntt.ntt(field, x, size, inverse,
                                                     canon), 3)
        full = bound(*ntt_work(field, rows, w, size, inverse or canon))
        log(f"kernel [{field.name}] 2^22 {label}, full {rows} x {w} -> {size} "
            f"[route {route_text(cuda_ntt.route(w, size, rows))}]: first 256 "
            f"rows equal the checked launch; {ms:.3f} ms, bound %.3f ms by %s"
            % full)
        results["ntt"]["2^22"][f"{label}, full {rows} rows"] = {
            "ms": ms, "bound_ms": full[0], "bound_by": full[1]}
        if canon:
            u = cuda_ntt.ntt(field, x, size, inverse, canon)
        del x
        torch.cuda.empty_cache()
    from ligero_tpu_torch.engine import cuda_hash
    words = cuda_hash.blake2s_columns(field, u)
    js = torch.randperm(n, generator=gen, device="cuda")[:16].tolist()
    digests = words.cpu().numpy().view("<u4")
    for j in js:
        host = column_hash(field, field.limbs_to_ints(u[:, j].cpu().numpy()))
        require(digests[j].tobytes() == host, f"2^22 Blake2s columns {rows} x "
                f"{n}: column {j} differs from the host's column hash")
    ms = _time_cuda(torch, lambda: cuda_hash.blake2s_columns(field, u), 3)
    full = bound(*blake2s_work(field, rows, n))
    log(f"kernel [{field.name}] 2^22 Blake2s columns, full {rows} x {n}: 16 "
        f"sampled columns equal the host column hash; {ms:.3f} ms, bound "
        "%.3f ms by %s" % full)
    results["blake2s_cols"].setdefault("2^22", {})[f"full {rows} x {n}"] = {
        "ms": ms, "bound_ms": full[0], "bound_by": full[1]}
    u16 = fieldops.narrow16(u)
    del u
    require(torch.equal(stream_digests(field, u16, STREAM_CHUNK), words),
            f"2^22 streamed Blake2s {rows} x {n}: differs from the "
            "whole-column kernel")
    ms = _time_cuda(torch, lambda: stream_digests(field, u16, STREAM_CHUNK), 3)
    full = bound(*blake2s_work(field, rows, n, in16=True))
    log(f"kernel [{field.name}] 2^22 streamed Blake2s, full {rows} x {n} in "
        f"chunks of {STREAM_CHUNK}, 16-bit limbs: bit-equal to the "
        f"whole-column kernel; {ms:.3f} ms, bound %.3f ms by %s" % full)
    results["blake2s_stream"].setdefault("2^22", {})[
        f"full {rows} x {n}, chunks of {STREAM_CHUNK}"] = {
        "ms": ms, "bound_ms": full[0], "bound_by": full[1]}
    del u16, firsts, words
    torch.cuda.empty_cache()


def route_text(rt) -> str:
    """An NTT route in a few words: its name, cosets and sub-transforms."""
    split = " x ".join(str(1 << l) for l in (rt.l0, rt.l1, rt.l2) if l)
    return f"{rt.name}, {1 << rt.lc} coset(s) of {split or 1}"


def ntt_route_cases(torch, field, gen) -> int:
    """The NTT kernel against its plain version where its routes meet: w = n
    and w < n at n = 2, 1024, 2048, 4096 (one pass, cosets); w = 1, w = s,
    w = s + 1 and a width that is no power of two at n = 16384 (cosets);
    n = 8192, 65536 and 2^17 (two passes), alone and under cosets; single
    rows, which take two passes at any size; the four-shard prover core's
    512-row blocks (n = 512, and 512 -> 4096 under cosets; the plain
    version on their first PLAIN_ROWS rows).  Small batches elsewhere, every
    combination of inverse and canon_out; BLS12-377 up to n = 16384, the
    largest transform of its paths.  Returns the largest absolute
    difference seen (0 or the run fails)."""
    from ligero_tpu_torch.engine import cuda_ntt, ntt
    shapes = [(5, 2, 2), (5, 1, 2), (5, 1024, 1024), (5, 100, 1024),
              (5, 2048, 2048), (5, 1500, 2048), (5, 4096, 4096),
              (5, 2049, 4096), (5, 1, 16384), (5, 2048, 16384),
              (5, 2049, 16384), (5, 1000, 16384), (2, 8192, 8192),
              (2, 5000, 16384), (2, 65536, 65536), (1, 1 << 17, 1 << 17),
              (1, 40000, 1 << 17),
              # single rows: split in two passes so that they fill the card
              (1, 2048, 2048), (1, 2048, 4096), (1, 4095, 16384),
              # the four-shard prover core's blocks: iNTT_512 and NTT
              # 512 -> 4096 of 512 rows
              (512, 512, 512), (512, 512, 4096)]
    if field.num_limbs != 16:
        shapes = [sh for sh in shapes if sh[2] <= 16384]
    worst = 0
    for batch, w, size in shapes:
        x = _rand_elems(torch, gen, (batch, w), field)
        errs = []
        for inverse in (False, True):
            for canon in (False, True):
                got = cuda_ntt.ntt(field, x, size, inverse, canon)
                want = ntt.ntt_ref(field, x[:PLAIN_ROWS], size, inverse,
                                   canon)
                errs.append(int((got[:PLAIN_ROWS].to(torch.int64)
                                 - want.to(torch.int64)).abs().max()))
        worst = max(worst, *errs)
        log(f"kernel [{field.name}] NTT {batch} x {w} -> {size}, inverse x "
            f"canon_out: "
            f"max_abs_err={max(errs)} [route "
            f"{route_text(cuda_ntt.route(w, size, batch))}]")
        require(max(errs) == 0, f"NTT {batch} x {w} -> {size}: kernel "
                "disagrees with its plain version")
    return worst


#: (n, w, tile limit) of the BLS12-377 edge-value cases: NTT_n's eight
#: cosets of 2048, one pass of the 2048-element tile (two blocks an SM), the
#: 4096-element tile, two passes (the zk encode's split), global stages
EDGE_ROUTES = ((16384, 2048, 12), (2048, 2048, 12), (4096, 4096, 12),
               (8192, 8192, 7), (1024, 1024, 3))
#: (inverse, canon_out, 16-bit in, 16-bit out) of each edge-value call
#: (three, to keep the plain versions' time short; the CUDA twins of
#: tests/test_torch_ntt.py take every combination)
EDGE_CALLS = ((False, False, False, False), (True, True, True, True),
              (False, True, True, False))


def ntt_edge_value_cases(torch, field, gen) -> int:
    """BLS12-377's lazy butterflies at the edges of the field: rows of every
    element p - 1, of 0, of 0 and p - 1 in turns, and random (three rows of
    each kind, in one batch), through every route (by a lowered tile limit
    where needed, as the CUDA twins do) and a lone row of each kind,
    forward and inverse, plain and canonical output, int32 and 16-bit
    storage in and out (:data:`EDGE_CALLS`), against ``ntt_ref`` /
    ``ntt16_ref``.
    Returns the largest absolute difference seen (0 or the run fails)."""
    from ligero_tpu_torch.engine import cuda_ntt, fieldops, ntt
    L = field.num_limbs
    kinds = ("p-1", "zero", "alternating", "random")
    top = torch.tensor(field.ints_to_limbs([field.p - 1])[0].astype("int32"),
                       device="cuda")
    errs: dict = {kind: [] for kind in kinds}
    for n, w, tile_log in EDGE_ROUTES:
        x = torch.zeros((3 * len(kinds), w, L), dtype=torch.int32,
                        device="cuda")
        x[0:3] = top
        x[6:9, 1::2] = top
        x[9:12] = _rand_elems(torch, gen, (3, w), field)
        rt = ntt.ntt_plan(w, n, tile_log)
        for inverse, canon, in16, out16 in EDGE_CALLS:
            xin = fieldops.narrow16(x) if in16 else x
            got = cuda_ntt.ntt_routed(field, xin, n, inverse, canon, rt,
                                      tile_log, out16)
            want = cuda_ntt.ntt16_ref(field, xin, n, inverse, canon, out16)
            for i, kind in enumerate(kinds):
                rows = slice(3 * i, 3 * i + 3)
                lone = cuda_ntt.ntt(field, xin[3 * i:3 * i + 1], n, inverse,
                                    canon, out16)
                errs[kind] += [_diff(torch, got[rows], want[rows]),
                               _diff(torch, lone, want[3 * i:3 * i + 1])]
    for kind in kinds:
        log(f"kernel [{field.name}] NTT edge values {kind}, 3 rows through "
            f"{len(EDGE_ROUTES)} routes and a lone row, {len(EDGE_CALLS)} "
            f"calls each (inverse, canon_out, 16-bit in and out): "
            f"max_abs_err={max(errs[kind])}")
        require(max(errs[kind]) == 0, f"NTT edge values {kind}: kernel "
                "disagrees with its plain version")
    return max(max(e) for e in errs.values())


def tree_chain_floor(torch, n: int) -> float:
    """The least a tree of n leaves can take on this card, in ms: its
    log2 n levels are a chain of dependent two-to-one hashes, timed here
    as one warp hashing its own output over and over (the difference of a
    long and a short chain, so that the launch cancels)."""
    from ligero_tpu_torch.engine import cuda_tree
    dev = torch.device("cuda")
    short, long_ = 16, 272
    per_hash = (min(cuda_tree.chain_probe_ms(long_, dev) for _ in range(3))
                - min(cuda_tree.chain_probe_ms(short, dev) for _ in range(3))
                ) / (long_ - short)
    levels = n.bit_length() - 1
    log(f"kernel SHA-256 tree n={n}: chain floor {levels * per_hash:.4f} ms "
        f"({levels} levels x {per_hash * 1e3:.3f} us a dependent two-to-one "
        f"hash, {per_hash * 1e6 / 128:.2f} ns a round)")
    return levels * per_hash


def tree_bit_equality(torch, gen) -> None:
    """The tree kernel against the plain SHA-256 levels at small, split and
    large n and around its 64-node groups, 10 fresh inputs each, then 100
    times on one input at n = 16384 (a wrong last-block handshake would
    show as a rare stale read).  The plain levels run over the 10 trees
    side by side (pairs never cross a tree: n is a power of two)."""
    from ligero_tpu_torch.engine import cuda_tree, hashops
    reps = 10
    for n in (2, 4, 32, 64, 128, 512, 1024, 2048, 4096, 8192, 65536):
        forest = torch.randint(-2**31, 2**31, (reps, n, 8), generator=gen,
                               dtype=torch.int64, device="cuda").to(torch.int32)
        got = [cuda_tree.tree_flat(forest[r]) for r in range(reps)]
        level = hashops._byteswap(hashops._words64(forest.reshape(-1, 8)))
        off, width = 8 * n, n
        for r in range(reps):
            require(torch.equal(got[r][:off], forest[r].reshape(-1)),
                    f"sha256_tree n={n}: leaves not copied (input {r})")
        while width > 1:
            level = hashops.sha256_two_to_one(level[0::2], level[1::2])
            width //= 2
            want = hashops._to_i32(level).reshape(reps, width * 8)
            for r in range(reps):
                require(torch.equal(got[r][off:off + 8 * width], want[r]),
                        f"sha256_tree n={n}: level of {width} nodes differs "
                        f"(input {r})")
            off += 8 * width
        log(f"kernel SHA-256 tree n={n}: bit-equal on {reps} fresh inputs "
            f"({len(cuda_tree.tree_steps(n))} step(s) in one launch)")
    n = 16384
    leaves = torch.randint(-2**31, 2**31, (n, 8), generator=gen,
                           dtype=torch.int64, device="cuda").to(torch.int32)
    want = hashops.tree_flat(leaves)
    for rep in range(100):
        require(torch.equal(cuda_tree.tree_flat(leaves), want),
                f"sha256_tree n={n}: run {rep} of 100 on one input differs")
    log(f"kernel SHA-256 tree n={n}: 100 runs on one input all bit-equal to "
        "the plain version")


# ---------------------------------------------------------------------------
# phase 4: byte parity: card = CPU = the JAX package's recorded digests
# ---------------------------------------------------------------------------

def golden_circuit(entry):
    """(field, circuit, outputs, prove call) of one ``golden_proofs.json``
    entry (its ``field`` key names the field; BN254 Fr where it has none;
    its ``mt`` key, where present, the commitment)."""
    from ligero_tpu_torch import FIELDS, ArithmeticCircuit
    from ligero_tpu_torch.synthetic import generate_random_circuit
    field = FIELDS[entry.get("field", "bn254_fr")]
    kw = {"zk_seed": bytes.fromhex(entry["zk_seed"])} if entry["zk"] else {}
    if entry["circuit"] == "cube":
        c = ArithmeticCircuit(field)
        x = c.new_variable_with_label("x")
        c.add(c.pow(x, 3), c.constant(-26))
        return field, c, [c.last()], lambda lig, sp: lig.prove_with_labels(
            [("x", 3)], sp, **kw)
    circ, outs, vars_ = generate_random_circuit(
        field, entry["gates"], num_vars=entry["num_vars"], seed=entry["seed"])
    return field, circ, outs, lambda lig, sp: lig.prove(vars_, sp, **kw)


def phase_parity() -> None:
    from ligero_tpu_torch import LigeroCircuit, test_sponge

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "ligero_tpu_torch", "testdata", "golden_proofs.json")
    with open(path) as f:
        entries = json.load(f)["proofs"]
    from ligero_tpu_torch.ligero.types import LigeroMTPoseidonParams

    require(len(entries) >= 11, "golden_proofs.json holds too few cases")
    require(sum(e.get("mt") == "poseidon" for e in entries) >= 2,
            "golden_proofs.json holds no Poseidon-committed case")
    for entry in entries:
        field, circ, outs, prove = golden_circuit(entry)
        sponge = test_sponge(field)
        kw = dict(lambda_=entry["lambda"], zk=entry["zk"])
        if entry.get("mt") == "poseidon":
            kw["mt_params"] = LigeroMTPoseidonParams(field)
        on_card = LigeroCircuit(circ, outs, device="cuda", **kw)
        on_cpu = LigeroCircuit(circ, outs, device="cpu", **kw)
        probe = OverlapProbe(on_card)
        got = prove(on_card, sponge.clone())
        probe.remove()
        require(len(probe.handles) == 3 and probe.finished == probe.handles,
                f"parity {entry['name']}: the card's proof did not take the "
                "opening overlap (three started sets, each finished)")
        data = got.to_bytes(field)
        same = data == prove(on_cpu, sponge.clone()).to_bytes(field)
        golden = (len(data) == entry["length"]
                  and hashlib.sha256(data).hexdigest() == entry["sha256"])
        # the CPU's Poseidon leaves of ~470 opened columns take its plain
        # version ~0.5 min: the CPU verifies the default-committed proofs
        ok_cpu = "mt_params" in kw or on_cpu.verify(got, sponge.clone())
        ok_card = on_card.verify(got, sponge.clone())
        log(f"parity [{field.name}] {entry['name']} (opening overlap on the "
            f"card): card bytes = CPU bytes: {same}, = the "
            f"JAX package's digest: {golden}, CPU verifies: "
            f"{'not run' if 'mt_params' in kw else ok_cpu}, card "
            f"verifies: {ok_card}")
        require(same and golden and ok_cpu and ok_card,
                f"parity failed: {entry['name']}")


# ---------------------------------------------------------------------------
# phase 5: the main paths at 2^20 gates
# ---------------------------------------------------------------------------

def make_circuit(field, log2_gates: int, seed: int):
    from ligero_tpu_torch.synthetic import generate_random_circuit
    t0 = time.perf_counter()
    circ, outs, vars_ = generate_random_circuit(field, 1 << log2_gates,
                                                seed=seed)
    log(f"circuit 2^{log2_gates} gates generated "
        f"({time.perf_counter() - t0:.1f} s, {circ.num_nodes()} nodes)")
    return circ, outs, vars_


def build_instance(circ, outs, zk: bool, poseidon: bool = False):
    """A main path's instance: the synthetic circuit compiled for the card
    (no ``device`` given: the card is the default), committed with the
    default params or ``LigeroMTPoseidonParams``."""
    from ligero_tpu_torch import LigeroCircuit
    from ligero_tpu_torch.ligero.types import LigeroMTPoseidonParams
    from ligero_tpu_torch.utils.profiling import PhaseTimer

    t0 = time.perf_counter()
    mt = LigeroMTPoseidonParams(circ.field) if poseidon else None
    lig = LigeroCircuit(circ, outs, zk=zk, timer=PhaseTimer(enabled=True),
                        mt_params=mt)
    require(lig.device.type == "cuda", "the default device is not the card")
    log(f"LigeroCircuit(zk={zk}, poseidon={poseidon}) built "
        f"({time.perf_counter() - t0:.1f} s): "
        f"m={lig.m} k={lig.k} n={lig.n} t={lig.t} b={lig.blind_t} "
        f"d2={lig.d2}, U is {lig.num_rows} x {lig.n}, "
        f"nnz(A)={len(lig.state.a_vals)}")
    return lig


def instance_dims(lig):
    """The kernels phase's shapes of a plain instance: (m, k, n, nnz of A,
    t), and the zk path's (b, d2) at the same size."""
    return ((lig.m, lig.k, lig.n, len(lig.state.a_vals), lig.t),
            (3 * lig.t, max(2 * lig.k, 1 << (
                2 * (lig.k + 3 * lig.t) - 2).bit_length())))


def reset_counts(torch, wraps) -> None:
    """Every launch count to 0, just before a path is driven."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for counter in wraps.values():
        counter.reset()
    NTT_SHAPES.clear()


def read_counts(wraps, path: str, earlier: dict | None = None,
                absent=NOT_ON_DEFAULT) -> dict:
    """The launch counts just after a path was driven (added to those of
    its ``earlier`` half, where it was driven in two); every kernel but
    those ``absent`` from the path (the other commitment's) must have been
    launched on it, and those not at all."""
    launches = {name: counter.count + (earlier or {}).get(name, 0)
                for name, counter in wraps.items()}
    log(f"kernel launches on the {path} path: {launches}")
    log(f"NTT launches by shape on the {path} path"
        f"{' (its verify)' if earlier else ''}: {ntt_shapes_text()}")
    require(all((v == 0) == (name in absent) for name, v in launches.items()),
            f"on the {path} path a kernel was not launched, or one of "
            f"{absent} was: {launches}")
    return launches


def flip_byte(data: bytes) -> bytes:
    flipped = bytearray(data)
    flipped[8 + 32 + 8] ^= 1  # low byte of the first interleaved lc element
    return bytes(flipped)


def path_tag(field, zk: bool, poseidon: bool = False) -> str:
    """The prefix of a path's name and log lines: "" / "zk " for BN254 Fr,
    "bls " / "bls zk " for BLS12-377 Fq, "poseidon " before "zk " where
    the Poseidon params commit."""
    return (("" if field.num_limbs == 16 else "bls ")
            + ("poseidon " if poseidon else "") + ("zk " if zk else ""))


def is_poseidon(lig) -> bool:
    from ligero_tpu_torch.ligero.types import is_default_mt_params
    return not is_default_mt_params(lig.mt_params)


#: what the opening overlap showed on each main path (OverlapProbe.check)
#: and BN254's walls of both routes (overlap_walls), for the record
OVERLAP: dict = {}


class OverlapProbe:
    """Wraps, on one instance, ``_start_open_async`` and
    ``_finish_open_async``: keeps each started set's handle, each finished
    one, and an event recorded on the current stream just before each start
    (the second: the end of the linear phase, as far as the current
    stream's work goes).  ``remove`` unwraps."""

    def __init__(self, lig):
        import torch
        self.lig, self.handles, self.finished, self.marks = lig, [], [], []
        start, finish = lig._start_open_async, lig._finish_open_async

        def started(u_canon, idx):
            mark = torch.cuda.Event(enable_timing=True)
            mark.record()
            self.marks.append(mark)
            self.handles.append(start(u_canon, idx))
            return self.handles[-1]

        def finished(handle, tree):
            self.finished.append(handle)
            return finish(handle, tree)

        lig._start_open_async, lig._finish_open_async = started, finished

    def remove(self) -> None:
        del self.lig._start_open_async, self.lig._finish_open_async

    def check(self, torch, tag: str) -> dict:
        """Three sets started and finished in order; each one's gather and
        copy ran on the backend's side stream, not the current one, into
        pinned int16 host memory; set 1's copy completed before the linear
        phase's work on the current stream did (its event before the second
        mark: a route that only gathers at the end fails here)."""
        hs = self.handles
        require(len(hs) == 3 and self.finished == hs,
                f"{tag}the prove did not take the opening overlap: "
                f"{len(hs)} sets started, {len(self.finished)} finished")
        current = torch.cuda.current_stream()
        for h in hs:
            require(h.err is None and h.stream is not None
                    and h.stream != current and h.host.is_pinned()
                    and h.host.dtype == torch.int16 and h.event.query(),
                    f"{tag}an opened set was not copied on a side stream "
                    "into pinned 16-bit host memory")
        lead_ms = hs[0].event.elapsed_time(self.marks[1])
        set_ms = [mark.elapsed_time(h.event) for mark, h in zip(self.marks,
                                                                 hs)]
        log(f"{tag}opening overlap: 3 sets on a side stream into pinned "
            f"memory ({sum(h.host.nbytes for h in hs)} bytes), start to "
            f"copy done {', '.join(f'{ms:.3f}' for ms in set_ms)} ms; set "
            f"1's copy done {lead_ms:.3f} ms before the linear phase ended")
        require(lead_ms > 0, f"{tag}set 1's copy completed after the linear "
                "phase, not behind it")
        return {"set_ms": set_ms, "set1_before_linear_end_ms": lead_ms,
                "copied_bytes": sum(h.host.nbytes for h in hs)}


def prove_fused(lig, vars_, sponge, **kw):
    """A prove of ``lig`` on the fused gather (every set after the
    quadratic phase), as batches and the chunked modes take it."""
    lig._open_overlap_ok = lambda u_canon, batch=1: False
    try:
        return lig.prove(vars_, sponge, **kw)
    finally:
        del lig._open_overlap_ok


def overlap_walls(torch, lig, vars_) -> dict:
    """Walls of the two routes of one warm direct-mode instance, the
    timer off, in turns (fused, overlap, overlap, fused), then one timed
    call each: its ``open`` phase and sub-phases (ms and counts)."""
    from ligero_tpu_torch import test_sponge
    sponge = test_sponge(lig.field)
    routes = {"fused": lambda: prove_fused(lig, vars_, sponge.clone()),
              "overlap": lambda: lig.prove(vars_, sponge.clone())}
    walls = {"fused": [], "overlap": []}
    lig.timer.enabled = False
    try:
        for route in ("fused", "overlap", "overlap", "fused"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            routes[route]()
            torch.cuda.synchronize()
            walls[route].append(time.perf_counter() - t0)
    finally:
        lig.timer.enabled = True
    out = {"walls_s": walls, "timed": {}}
    for route, prove in routes.items():
        lig.timer.reset()
        t0 = time.perf_counter()
        prove()
        wall = time.perf_counter() - t0
        timed = {name: [lig.timer.totals[name] * 1e3, lig.timer.counts[name]]
                 for name in ("open", "open.gather", "open.to_ints",
                              "open.paths", "linear", "quadratic")}
        out["timed"][route] = {"wall_s": wall, "phases": timed}
        log(f"overlap walls [{route}]: {', '.join(f'{w:.3f}' for w in walls[route])} s "
            f"(timer off); timed {wall:.3f} s: "
            + ", ".join(f"{name} {ms:.1f} ms x{n}"
                        for name, (ms, n) in timed.items()))
    return out


def phase_main(torch, field, lig, vars_, fused_check: bool = False) -> dict:
    """Drive one main path (plain or zk, as ``lig`` was compiled); returns
    the kernels' launch counts of its first prove + verify.  The first
    prove takes the opening overlap (:class:`OverlapProbe`); with
    ``fused_check`` a prove on the fused gather gives the same bytes."""
    from ligero_tpu_torch import LigeroProof, test_sponge

    timer = lig.timer
    sponge = test_sponge(field)
    wraps = wrappers()
    poseidon = is_poseidon(lig)
    tag = path_tag(field, lig.zk, poseidon)
    kw = {"zk_seed": ZK_SEED} if lig.zk else {}

    reset_counts(torch, wraps)
    timer.reset()
    probe = OverlapProbe(lig)
    t0 = time.perf_counter()
    proof = lig.prove(vars_, sponge.clone(), **kw)
    prove_s = time.perf_counter() - t0
    probe.remove()
    prove_phases = dict(timer.totals)
    timer.reset()
    t0 = time.perf_counter()
    ok = lig.verify(proof, sponge.clone())
    verify_s = time.perf_counter() - t0
    launches = read_counts(wraps, f"{tag or 'plain '}main", absent=(
        NOT_ON_POSEIDON if poseidon else NOT_ON_DEFAULT))
    verify_phases = dict(timer.totals)
    peak = torch.cuda.max_memory_allocated()
    estimate = lig.backend.direct_bytes(
        lig.num_rows, lig.k, lig.n, len(lig.state.a_vals), lig.blind_t, lig.d2)
    log(f"{tag}prove #1: {prove_s:.3f} s; verify: {ok} ({verify_s:.3f} s); "
        f"peak device memory {peak / 2**30:.2f} GiB (the direct-mode "
        f"estimate: {estimate / 2**30:.2f} GiB)")
    require(estimate >= peak, "the direct-mode memory estimate lies below "
            "the measured peak")
    for name, secs in sorted(prove_phases.items(), key=lambda kv: -kv[1]):
        log(f"  {tag}prove  {name:22s} {secs * 1e3:10.1f} ms")
    for name, secs in sorted(verify_phases.items(), key=lambda kv: -kv[1]):
        log(f"  {tag}verify {name:22s} {secs * 1e3:10.1f} ms")
    require(ok, "verify rejected the honest proof")
    OVERLAP[f"{tag or 'plain '}main".strip()] = probe.check(torch, tag)

    data = proof.to_bytes(field)
    if fused_check:
        same = prove_fused(lig, vars_, sponge.clone(), **kw).to_bytes(
            field) == data
        log(f"{tag}fused gather's proof = the overlap route's: {same}")
        require(same, "the fused gather's proof differs from the opening "
                "overlap's")
    if not lig.zk:   # under zk the batch phase proves each seed twice
        timer.reset()
        t0 = time.perf_counter()
        proof2 = lig.prove(vars_, sponge.clone())
        log(f"{tag}prove #2: {time.perf_counter() - t0:.3f} s")
        for name, secs in sorted(timer.totals.items(), key=lambda kv: -kv[1]):
            log(f"  {tag}prove #2 {name:20s} {secs * 1e3:10.1f} ms")
        require(proof2.to_bytes(field) == data, "two proofs differ")
        log(f"{tag}two proofs byte-identical ({len(data)} bytes)")
        del proof2

    bad_vars = [(vars_[0][0], (vars_[0][1] + 1) % field.p)] + vars_[1:]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        bad = lig.prove(bad_vars, sponge.clone(), **kw)
    bad_ok = lig.verify(bad, sponge.clone())
    log(f"{tag}tampered witness: verify={bad_ok} (expect False)")
    require(not bad_ok, "a proof of a tampered witness verified")
    del bad

    try:
        flip_ok = lig.verify(LigeroProof.from_bytes(flip_byte(data), field),
                             sponge.clone())
    except ValueError as e:
        log(f"{tag}flipped byte: deserializer rejects ({e})")
        flip_ok = False
    log(f"{tag}flipped byte: verify={flip_ok} (expect False)")
    require(not flip_ok, "a proof with a flipped byte verified")
    return launches


def phase_batch(torch, field, lig, vars_, full: bool = True,
                tag: str | None = None) -> dict:
    """The batch path at the main path's size: ``prove_batch`` of B
    witnesses (plain: honest, one changed input, honest; zk: the honest
    witness under two seeds; not ``full``: honest, one changed input)
    against B sequential ``prove`` calls, byte for byte; ``verify_batch``
    over [honest, honest, tampered witness, flipped byte, truncated column
    list] (not ``full``: [honest, tampered witness]) against the verdicts
    ``verify`` gives one by one (it gave the first four kinds on the main
    path).  Returns the launch counts of the batched prove + verify.
    ``tag``: the path's name before "batch" (a mesh's: "sharded ")."""
    from ligero_tpu_torch import LigeroProof, test_sponge

    sponge = test_sponge(field)
    wraps = wrappers()
    poseidon = is_poseidon(lig)
    tag = path_tag(field, lig.zk, poseidon) + (tag or "")
    bad_vars = [(vars_[0][0], (vars_[0][1] + 1) % field.p)] + vars_[1:]
    if lig.zk:
        witnesses, seeds = [vars_] * ZK_BATCH, [ZK_SEED, ZK_SEED[::-1]]
    elif full:
        witnesses, seeds = [vars_, bad_vars, vars_], None
    else:
        witnesses, seeds = [vars_, bad_vars], None
    B = len(witnesses)
    fits = lig.backend.max_batch(lig.num_rows, lig.k, lig.n,
                                 len(lig.state.a_vals), lig.blind_t, lig.d2)
    require(fits >= B, f"only {fits} proofs fit the card together")

    def single(i, assignment):
        kw = {"zk_seed": seeds[i]} if seeds else {}
        return lig.prove(assignment, sponge.clone(), **kw)

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # the changed input, by design
        reset_counts(torch, wraps)
        t0 = time.perf_counter()
        proofs = lig.prove_batch(witnesses, sponge, zk_seeds=seeds)
        torch.cuda.synchronize()
        batch_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        proving = {name: counter.count for name, counter in wraps.items()}
        log(f"kernel launches of {tag}prove_batch: {proving}")
        log(f"NTT launches by shape of {tag}prove_batch: {ntt_shapes_text()}")
        torch.cuda.empty_cache()   # as before the batch: both start cold
        t0 = time.perf_counter()
        sequential = [single(i, w) for i, w in enumerate(witnesses)]
        torch.cuda.synchronize()
        seq_s = time.perf_counter() - t0
        blobs = [p.to_bytes(field) for p in proofs]
        require(blobs == [p.to_bytes(field) for p in sequential],
                "prove_batch differs from sequential prove calls")
        del sequential
        bad = proofs[1] if not lig.zk else single(0, bad_vars)
    if full:
        short = LigeroProof.from_bytes(blobs[0], field)
        short.linear.columns = short.linear.columns[:-1]
        batch = [proofs[0], proofs[-1], bad,
                 LigeroProof.from_bytes(flip_byte(blobs[0]), field), short]
        expected = [True, True, False, False, False]
    else:
        batch, expected = [proofs[0], bad], [True, False]
    estimate = lig.backend.direct_bytes(
        lig.num_rows, lig.k, lig.n, len(lig.state.a_vals), lig.blind_t,
        lig.d2, batch=B)
    require(estimate >= peak, f"the estimate for a batch of {B}, "
            f"{estimate / 2**30:.2f} GiB, lies below the measured peak, "
            f"{peak / 2**30:.2f} GiB")
    log(f"{tag}prove_batch of {B}: byte-equal to {B} sequential proves; "
        f"{batch_s:.3f} s ({B / batch_s:.3f} proofs/s) against {seq_s:.3f} s "
        f"sequential ({B / seq_s:.3f} proofs/s); peak device memory "
        f"{peak / 2**30:.2f} GiB (estimate {estimate / 2**30:.2f} GiB; batches "
        f"of up to {fits})")
    # the sequential proves above were the comparison: they do not count
    reset_counts(torch, wraps)
    lig.timer.reset()
    t0 = time.perf_counter()
    verdicts = lig.verify_batch(batch, sponge)
    torch.cuda.synchronize()
    vbatch_s = time.perf_counter() - t0
    vpeak = torch.cuda.max_memory_allocated()
    launches = read_counts(wraps, f"{tag}batch", earlier=proving, absent=(
        NOT_ON_POSEIDON if poseidon else NOT_ON_DEFAULT))
    dims = (lig.num_rows, lig.k, lig.n, len(lig.state.a_vals))
    part = lig.backend.max_verify_batch(*dims)
    vestimate = lig.backend.verify_bytes(*dims, batch=min(part, len(batch)))
    log(f"  {tag}verify_batch v.ntt_cols "
        f"{lig.timer.totals.get('v.ntt_cols', 0.0) * 1e3:10.1f} ms")
    log(f"{tag}verify_batch of {len(batch)} in parts of {part}: {verdicts} in "
        f"{vbatch_s:.3f} s; peak device memory {vpeak / 2**30:.2f} GiB "
        f"(verifier estimate {vestimate / 2**30:.2f} GiB)")
    require(verdicts == expected, f"verify_batch verdicts {verdicts}")
    require(vestimate >= vpeak, "the verifier's memory estimate lies below "
            "the measured verify_batch peak")
    return launches


def count_open_ntts(lig):
    """Count the NTT launches of each prove's openings: the ``open``
    phase's device work is the backend's ``gather_columns_batch`` alone,
    wrapped here (an attribute of the instance's backend; ``del`` it to
    unwrap), and the backend's ``opened_to_host``, the one copy of opened
    columns to the host; returns the list of counts, one a call, and beside
    it the storage each call found: the coefficient chunks' and the held
    codewords' dtypes (None where re-encoded), the devices the opened
    columns left and the dtypes they reached the host in, the bytes of
    those host tensors (``opened_bytes``) and the limbs the gather returned
    (``opened_limbs``)."""
    from ligero_tpu_torch.engine import cuda_ntt
    be, counts, storage, crossed = lig.backend, [], [], []
    gather, to_host = be.gather_columns_batch, be.opened_to_host

    def launched():
        return cuda_ntt.launches.count + cuda_ntt.launches16.count

    def copied(cols, **kw):
        host = to_host(cols, **kw)
        crossed.append((cols.device.type, host.dtype, host.nbytes))
        return host

    def counted(u_canon, idx):
        before = launched()
        crossed.clear()
        out = gather(u_canon, idx)
        counts.append(launched() - before)
        held = u_canon.canon if u_canon.resident else None
        storage.append({
            "coeffs_dtype": str(u_canon.coeffs.chunks[0].dtype),
            "codewords_dtype": held and str(held.chunks[0].dtype),
            "opened_from": sorted({dev for dev, _, _ in crossed}),
            "opened_dtypes": sorted({str(dt) for _, dt, _ in crossed}),
            "opened_bytes": sum(nb for _, _, nb in crossed),
            "opened_limbs": out.size})
        return out

    be.gather_columns_batch, be.opened_to_host = counted, copied
    return counts, storage


def require_16bit_openings(tag: str, storage: dict) -> None:
    """The opened columns left the card and reached the host as int16, two
    bytes for every limb the gather returned."""
    require(storage["opened_from"] == ["cuda"]
            and storage["opened_dtypes"] == ["torch.int16"]
            and storage["opened_bytes"] == 2 * storage["opened_limbs"] > 0,
            f"{tag}: the openings did not cross to the host in 16-bit "
            f"limbs: {storage}")


def phase_streaming(torch, field, lig, vars_, want: bytes | None = None,
                    tampered_witness: bool = True, warm: bool = False) -> dict:
    """Drive a resident- or streaming-mode path (``lig.encode_mode``): one
    ``prove`` and one ``verify`` (True), their launch counts (the default
    commitment: every kernel but the whole-column Blake2s and the Poseidon
    sponge's; Poseidon: every kernel but Blake2s's and the SHA-256 tree;
    the streamed absorb once a part at least), the openings' NTT launches
    (resident mode: none; streaming: one a part), each call's peak against
    its mode's estimate (``resident_bytes`` or ``streaming_bytes``; the
    verifier's ``streaming_verify_bytes``) and the card's memory, the
    proof byte-equal to ``want`` (the direct-mode proof) where given, a
    flipped byte and (with ``tampered_witness``) a tampered witness
    rejected; with ``want`` or ``warm``, also a second, warm prove and
    verify, timed, with the warm prove's phases."""
    from ligero_tpu_torch import LigeroProof, test_sponge

    mode = lig.encode_mode
    require(mode in ("resident", "streaming"), "the instance is in "
            f"{mode} mode")
    resident = mode == "resident"
    poseidon = is_poseidon(lig)
    tag = path_tag(field, lig.zk, poseidon) + mode
    sponge, wraps, timer = test_sponge(field), wrappers(), lig.timer
    kw = {"zk_seed": ZK_SEED} if lig.zk else {}
    be = lig.backend
    dims = (lig.num_rows, lig.k, lig.n, len(lig.state.a_vals))
    data = lig.num_rows - (3 if lig.zk else 0)
    chunks = -(-data // lig.chunk_rows)
    # the tables earlier paths cached (NTT twiddles and twists of their
    # sizes and fields) go, so that each peak below holds this instance's
    # own tables, made again in the run, and nothing of another path's
    drop_cached_tables(torch)
    others = torch.cuda.memory_allocated()
    log(f"{tag}: {lig.num_rows} rows in chunks of {lig.chunk_rows} "
        f"({chunks} chunks, the last of {data - (chunks - 1) * lig.chunk_rows}"
        f" rows); the device's budget {be.memory_budget() / 2**30:.2f} GiB")

    opens, storage = count_open_ntts(lig)
    try:
        reset_counts(torch, wraps)
        timer.reset()
        t0 = time.perf_counter()
        proof = lig.prove(vars_, sponge.clone(), **kw)
        torch.cuda.synchronize()
        prove_s = time.perf_counter() - t0
        prove_peak = torch.cuda.max_memory_allocated()
        prove_phases = dict(timer.totals)
        torch.cuda.reset_peak_memory_stats()
        timer.reset()
        t0 = time.perf_counter()
        ok = lig.verify(proof, sponge.clone())
        torch.cuda.synchronize()
        verify_s = time.perf_counter() - t0
        verify_peak = torch.cuda.max_memory_allocated()
        launches = read_counts(wraps, tag, absent=(
            NOT_ON_POSEIDON_STREAMING if poseidon else NOT_ON_STREAMING))
    finally:
        del be.gather_columns_batch, be.opened_to_host
    estimate = (be.resident_bytes if resident else be.streaming_bytes)(
        *dims, lig.blind_t, lig.d2, chunk_rows=lig.chunk_rows,
        poseidon=poseidon)
    vestimate = be.streaming_verify_bytes(*dims, lig.chunk_rows)
    direct = be.direct_bytes(*dims, lig.blind_t, lig.d2)
    card = torch.cuda.get_device_properties(0).total_memory
    log(f"{tag} prove #1 (with A's one-time upload): {prove_s:.3f} s, peak "
        f"{prove_peak / 2**30:.3f} GiB ({mode} estimate "
        f"{estimate / 2**30:.3f} GiB; direct mode would need "
        f"{direct / 2**30:.2f} GiB); verify: {ok} ({verify_s:.3f} s), peak "
        f"{verify_peak / 2**30:.3f} GiB (estimate {vestimate / 2**30:.3f} "
        f"GiB); {others / 2**30:.3f} GiB allocated before the prove; the "
        f"card holds {card / 2**30:.2f} GiB")
    for name, secs in sorted(prove_phases.items(), key=lambda kv: -kv[1]):
        log(f"  {tag} prove  {name:22s} {secs * 1e3:10.1f} ms")
    for name, secs in sorted(timer.totals.items(), key=lambda kv: -kv[1]):
        log(f"  {tag} verify {name:22s} {secs * 1e3:10.1f} ms")
    require(ok, f"{tag}: verify rejected the honest proof")
    require(prove_peak <= estimate and verify_peak <= vestimate,
            f"{tag}: a measured peak lies above its {mode} estimate")
    require(max(prove_peak, verify_peak) < card, f"{tag}: peak past the card")
    parts = chunks + (1 if lig.zk else 0)
    absorbs = launches["poseidon_stream" if poseidon else "blake2s_stream"]
    log(f"{tag}: the openings launched {opens} NTT(s); the streamed absorb "
        f"{absorbs} time(s) for {parts} part(s); coefficient chunks "
        f"{storage[0]['coeffs_dtype']}, codeword chunks "
        f"{storage[0]['codewords_dtype'] or 're-encoded'}, the openings' copy "
        f"to the host {storage[0]['opened_bytes']} bytes "
        f"({', '.join(storage[0]['opened_dtypes'])}, "
        f"{storage[0]['opened_limbs']} limbs)")
    require_16bit_openings(tag, storage[0])
    require(storage[0]["coeffs_dtype"] == "torch.int16"
            and storage[0]["codewords_dtype"] in (
                ("torch.int16",) if resident else (None,)),
            f"{tag}: the chunks are not 16-bit limbs: {storage[0]}")
    require(absorbs >= parts, f"{tag}: fewer streamed absorbs than parts")
    require(opens == [0] if resident else opens == [parts],
            f"{tag}: the openings launched {opens} NTTs")
    data_bytes = proof.to_bytes(field)
    warm_res = {}
    if want is not None or warm:
        if want is not None:
            require(data_bytes == want, f"{tag}: the proof differs from the "
                    "direct-mode proof")
        warm_res = warm_walls(torch, lig, vars_, kw)
        log(f"{tag}: proof of {len(data_bytes)} bytes"
            + (", byte-equal to the direct-mode proof" if want else "")
            + f"; warm prove {warm_res['prove_s']:.3f} s, verify "
            f"{warm_res['verify_s']:.3f} s")
        for name in ("rs_encode", "zk_blind", "commit", "open.gather"):
            if name in warm_res["phases"]:
                log(f"  {tag} warm prove {name:14s} "
                    f"{warm_res['phases'][name] * 1e3:10.1f} ms")
    flip_ok = lig.verify(LigeroProof.from_bytes(flip_byte(data_bytes), field),
                         sponge.clone())
    log(f"{tag} flipped byte: verify={flip_ok} (expect False)")
    require(not flip_ok, f"{tag}: a proof with a flipped byte verified")
    if tampered_witness:
        bad_vars = [(vars_[0][0], (vars_[0][1] + 1) % field.p)] + vars_[1:]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            bad = lig.prove(bad_vars, sponge.clone(), **kw)
        bad_ok = lig.verify(bad, sponge.clone())
        log(f"{tag} tampered witness: verify={bad_ok} (expect False)")
        require(not bad_ok, f"{tag}: a proof of a tampered witness verified")
    return {"launches": launches, "mode": mode, "prove_s": prove_s,
            "verify_s": verify_s, "open_ntts": opens[0],
            "storage": storage[0],
            "warm_prove_s": warm_res.get("prove_s"),
            "warm_verify_s": warm_res.get("verify_s"),
            "warm_phases_ms": {name: secs * 1e3 for name, secs in
                               warm_res.get("phases", {}).items()},
            "prove_peak_gib": prove_peak / 2**30,
            "verify_peak_gib": verify_peak / 2**30,
            "allocated_before_gib": others / 2**30,
            "estimate_gib": estimate / 2**30,
            "verify_estimate_gib": vestimate / 2**30,
            "direct_bytes_gib": direct / 2**30, "chunk_rows": lig.chunk_rows,
            "proof": data_bytes}


def drop_cached_tables(torch) -> None:
    """Free the device tables the port caches by size and field (the NTT's
    twiddles and twists, the plain transform's twiddles, the spot
    evaluation's tables) and cuBLAS's workspaces."""
    from ligero_tpu_torch.engine import cuda_ntt, ntt, spot
    for cache in (cuda_ntt._TABLES, ntt._TW_CACHE, spot._TABLES):
        cache.clear()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()


def warm_walls(torch, lig, vars_, kw) -> dict:
    """Host-clock walls of one more ``prove`` and ``verify`` (True) of an
    instance whose one-time work (A's upload, the tables) is done, that
    proof's bytes and the prove's phase times (where the instance's timer
    is on)."""
    from ligero_tpu_torch import test_sponge
    sponge = test_sponge(lig.field)
    torch.cuda.synchronize()
    lig.timer.reset()
    t0 = time.perf_counter()
    proof = lig.prove(vars_, sponge.clone(), **kw)
    torch.cuda.synchronize()
    prove_s = time.perf_counter() - t0
    phases = dict(lig.timer.totals)
    t0 = time.perf_counter()
    require(lig.verify(proof, sponge.clone()), "a warm verify failed")
    torch.cuda.synchronize()
    return {"prove_s": prove_s, "verify_s": time.perf_counter() - t0,
            "want": proof.to_bytes(lig.field), "phases": phases}


def single_reference(torch, lig, vars_) -> dict:
    """What a later path of the same instance is held against: a warm
    single-device, direct-mode instance's :func:`warm_walls` (its proof
    under the smoke's zk seed), its dims and its estimate."""
    dims = (lig.num_rows, lig.k, lig.n, len(lig.state.a_vals), lig.blind_t,
            lig.d2)
    return {**warm_walls(torch, lig, vars_,
                         {"zk_seed": ZK_SEED} if lig.zk else {}),
            "dims": dims, "direct_bytes": lig.backend.direct_bytes(*dims)}


def single_instance_reference(torch, field, circ, outs, vars_, zk: bool,
                              poseidon: bool = False) -> dict:
    """:func:`single_reference` of a single-device instance in direct mode
    built, and proved once (A's one-time upload), here."""
    from ligero_tpu_torch import test_sponge
    single = build_instance(circ, outs, zk=zk, poseidon=poseidon)
    require(single.encode_mode == "direct", "the reference instance does "
            "not fit direct mode")
    single.prove(vars_, test_sponge(field), **(
        {"zk_seed": ZK_SEED} if zk else {}))
    reference = single_reference(torch, single, vars_)
    del single
    torch.cuda.empty_cache()
    return reference


def phase_streaming_forced(torch, field, circ, outs, vars_, zk: bool,
                           poseidon: bool = False,
                           chunk_rows: int = FORCED_CHUNK_ROWS,
                           reference: dict | None = None,
                           mode: str = "streaming") -> dict:
    """Streaming (or resident) mode forced by the memory budget on an
    instance direct mode takes: the direct-mode proof first
    (``reference``, or a direct instance built, warmed and proved here),
    then the instance built under a budget at its streaming (resident)
    estimate for chunks of ``chunk_rows`` (below the direct estimate),
    driven by :func:`phase_streaming`."""
    from ligero_tpu_torch.engine.backend import TorchBackend

    if reference is None:
        reference = single_instance_reference(torch, field, circ, outs,
                                              vars_, zk, poseidon)
    log(f"{path_tag(field, zk, poseidon)}direct mode at this size: warm prove "
        f"{reference['prove_s']:.3f} s, verify {reference['verify_s']:.3f} s")
    be = TorchBackend(field)
    budget = (be.resident_bytes if mode == "resident" else be.streaming_bytes)(
        *reference["dims"], chunk_rows=chunk_rows, poseidon=poseidon)
    require(budget < reference["direct_bytes"], f"the {mode} estimate does "
            "not lie below the direct one")
    card_budget = TorchBackend.memory_budget
    TorchBackend.memory_budget = lambda self: budget
    try:
        lig = build_instance(circ, outs, zk=zk, poseidon=poseidon)
        require(lig.encode_mode == mode, f"{lig.encode_mode} mode under the "
                f"{mode} budget")
        res = phase_streaming(torch, field, lig, vars_,
                              want=reference["want"])
    finally:
        TorchBackend.memory_budget = card_budget
    del lig
    torch.cuda.empty_cache()
    res["direct_warm_prove_s"] = reference["prove_s"]
    res["direct_warm_verify_s"] = reference["verify_s"]
    return res


def mesh_devices(torch, D: int) -> list[str]:
    """D shards: distinct cards as far as the host has them, else the
    first card again."""
    count = torch.cuda.device_count()
    return [f"cuda:{i % count}" for i in range(D)]


def phase_sharded(torch, field, circ, outs, vars_, zk: bool, poseidon: bool,
                  D: int, reference: dict, chunk_rows: int = 0) -> dict:
    """The row-sharded backend over a mesh of D shards
    (``parallel.ShardedBackend``; on one card all D shards share it: its
    walls are the controller's cost, not scaling): one ``prove`` and one
    ``verify`` (True) with their launch counts (the commitment's kernels),
    the proof byte-equal to the single-device proof of the same instance
    (``reference``), warm walls of both, a flipped byte and a tampered
    witness rejected, and each physical device's prover and verifier peaks
    against the mesh's estimates (``ShardedBackend.device_bytes``): a peak
    over its estimate fails.  With ``chunk_rows``: streaming mode over the
    mesh, forced by a budget at the mesh's streaming estimate for chunks of
    that many rows (below its direct estimate; the chunks that budget
    gives may be larger), the peaks against
    ``ShardedBackend.stream_device_bytes``."""
    from ligero_tpu_torch import LigeroCircuit, LigeroProof, test_sponge
    from ligero_tpu_torch.engine.backend import TorchBackend
    from ligero_tpu_torch.ligero.types import LigeroMTPoseidonParams
    from ligero_tpu_torch.parallel import RowMesh, ShardedBackend
    from ligero_tpu_torch.utils.profiling import PhaseTimer

    tag = (path_tag(field, zk, poseidon) + "sharded "
           + ("streaming " if chunk_rows else "") + f"D={D}")
    drop_cached_tables(torch)
    mesh = RowMesh(mesh_devices(torch, D))
    physical = mesh.physical
    card_budget = TorchBackend.memory_budget
    if chunk_rows:
        probe = ShardedBackend(field, mesh)
        budget = probe.streaming_bytes(*reference["dims"],
                                       chunk_rows=chunk_rows)
        require(budget < probe.direct_bytes(*reference["dims"]),
                f"{tag}: the mesh's streaming estimate does not lie below "
                "its direct one")
        TorchBackend.memory_budget = lambda self: budget
    try:
        t0 = time.perf_counter()
        lig = LigeroCircuit(circ, outs, zk=zk, timer=PhaseTimer(enabled=True),
                            mt_params=(LigeroMTPoseidonParams(field)
                                       if poseidon else None),
                            backend=ShardedBackend(field, mesh))
    finally:
        TorchBackend.memory_budget = card_budget
    log(f"{tag}: {mesh}, built ({time.perf_counter() - t0:.1f} s); U is "
        f"{lig.num_rows} x {lig.n}, {lig.encode_mode} mode"
        + (f", chunks of {lig.chunk_rows} rows" if chunk_rows else ""))
    require(lig.encode_mode == ("streaming" if chunk_rows else "direct"),
            f"{tag}: {lig.encode_mode} mode")
    be, kw = lig.backend, ({"zk_seed": ZK_SEED} if zk else {})
    dims = (lig.num_rows, lig.k, lig.n, len(lig.state.a_vals), lig.blind_t,
            lig.d2)
    if chunk_rows:
        chunk_rows = lig.chunk_rows            # the budget's, at least ours
        estimate = be.stream_device_bytes(*dims, chunk_rows=chunk_rows)
        vestimate = be.stream_device_bytes(*dims[:4], chunk_rows=chunk_rows,
                                           verifier=True)
    else:
        estimate = be.device_bytes(*dims)
        vestimate = be.device_bytes(*dims[:4], verifier=True)
    sponge, wraps = test_sponge(field), wrappers()

    def reset_peaks():
        for dev in physical:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)

    def peaks() -> dict:
        return {str(dev): torch.cuda.max_memory_allocated(dev)
                for dev in physical}

    one_stream = ""
    if chunk_rows:
        one_stream = ", streaming_bytes {:.3f} GiB".format(TorchBackend(
            field).streaming_bytes(*dims, chunk_rows=chunk_rows) / 2**30)
    others = {str(dev): torch.cuda.memory_allocated(dev) for dev in physical}
    reset_counts(torch, wraps)
    reset_peaks()
    t0 = time.perf_counter()
    proof = lig.prove(vars_, sponge.clone(), **kw)
    for dev in physical:
        torch.cuda.synchronize(dev)
    prove_s = time.perf_counter() - t0
    prove_peaks = peaks()
    reset_peaks()
    t0 = time.perf_counter()
    ok = lig.verify(proof, sponge.clone())
    for dev in physical:
        torch.cuda.synchronize(dev)
    verify_s = time.perf_counter() - t0
    verify_peaks = peaks()
    launches = read_counts(wraps, tag, absent=(
        NOT_ON_STREAMING if chunk_rows else
        NOT_ON_POSEIDON if poseidon else NOT_ON_DEFAULT))
    require(ok, f"{tag}: verify rejected the honest proof")
    data = proof.to_bytes(field)
    require(data == reference["want"], f"{tag}: the proof differs from the "
            "single-device proof")
    warm = warm_walls(torch, lig, vars_, kw)
    p1, v1 = reference["prove_s"], reference["verify_s"]
    log(f"{tag}: proof byte-equal to the single-device proof ({len(data)} "
        f"bytes); prove #1 (A's upload) {prove_s:.3f} s, verify "
        f"{verify_s:.3f} s; warm prove {warm['prove_s']:.3f} s, verify "
        f"{warm['verify_s']:.3f} s against one device's {p1:.3f} / {v1:.3f} "
        f"s ({warm['prove_s'] / p1 - 1:+.1%} / {warm['verify_s'] / v1 - 1:+.1%})")
    for dev in map(str, physical):
        log(f"{tag} {dev}: prove peak {prove_peaks[dev] / 2**30:.3f} GiB "
            f"(mesh estimate {estimate[dev] / 2**30:.3f} GiB), verify peak "
            f"{verify_peaks[dev] / 2**30:.3f} GiB (estimate "
            f"{vestimate[dev] / 2**30:.3f} GiB); {others[dev] / 2**30:.3f} GiB "
            "allocated before; one device's direct_bytes "
            f"{reference['direct_bytes'] / 2**30:.3f} GiB{one_stream}")
        require(prove_peaks[dev] <= estimate[dev]
                and verify_peaks[dev] <= vestimate[dev],
                f"{tag}: a peak on {dev} lies above the mesh's estimate")
    for name, secs in sorted(lig.timer.totals.items(), key=lambda kv: -kv[1]):
        log(f"  {tag} warm {name:22s} {secs * 1e3:10.1f} ms")
    flip_ok = lig.verify(LigeroProof.from_bytes(flip_byte(data), field),
                         sponge.clone())
    bad_vars = [(vars_[0][0], (vars_[0][1] + 1) % field.p)] + vars_[1:]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        bad_ok = lig.verify(lig.prove(bad_vars, sponge.clone(), **kw),
                            sponge.clone())
    log(f"{tag}: flipped byte verify={flip_ok}, tampered witness "
        f"verify={bad_ok} (expect False, False)")
    require(not flip_ok and not bad_ok, f"{tag}: a flipped or tampered "
            "proof verified")
    del lig, be
    torch.cuda.empty_cache()
    return {"launches": launches, "devices": [str(d) for d in mesh.devices],
            "chunk_rows": chunk_rows,
            "prove_s": prove_s, "verify_s": verify_s,
            "warm_prove_s": warm["prove_s"], "warm_verify_s": warm["verify_s"],
            "single_warm_prove_s": reference["prove_s"],
            "single_warm_verify_s": reference["verify_s"],
            "prove_peak_gib": {d: v / 2**30 for d, v in prove_peaks.items()},
            "verify_peak_gib": {d: v / 2**30 for d, v in verify_peaks.items()},
            "estimate_gib": {d: v / 2**30 for d, v in estimate.items()},
            "verify_estimate_gib": {d: v / 2**30
                                    for d, v in vestimate.items()},
            "single_direct_bytes_gib": reference["direct_bytes"] / 2**30}


def _max_err(torch, got, want) -> int:
    return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def core_plain_chain(torch, field, preenc, r, k: int, n: int, core_out):
    """The core's outputs ``(u, leaves, root, lc)`` against its kernels'
    plain versions on the same card tensors: U from ``ntt.ntt_ref``
    (iNTT_k, then NTT_n with the canonical epilogue), the Blake2s leaves of
    every CORE_PLAIN_COL_STEP-th column from ``hashops.blake2s_columns_ref``
    over the plain U, the root from ``hashops.tree_flat`` over the kernel's
    leaves, lc from ``cuda_lc.row_combine_ref``.  Every difference must be
    0.  Returns ``(errors, the plain flat tree, plain ms)``; the flat tree
    holds every subtree root the sharded core makes."""
    from ligero_tpu_torch.engine import cuda_lc, hashops, ntt
    u, leaves, root, lc = core_out
    cols = torch.arange(0, n, CORE_PLAIN_COL_STEP, device=u.device)

    def chain():
        u_plain = ntt.ntt_ref(field, ntt.ntt_ref(field, preenc, k,
                                                 inverse=True), n,
                              canon_out=True)
        return (u_plain,
                hashops.blake2s_columns_ref(u_plain.index_select(1, cols)),
                hashops.tree_flat(leaves),
                cuda_lc.row_combine_ref(field, r, preenc))

    (u_plain, leaves_plain, flat, lc_plain), ms = _time_once(torch, chain)
    errs = {"u": _max_err(torch, u, u_plain),
            "leaves": _max_err(torch, leaves.index_select(0, cols),
                               leaves_plain),
            "root": _max_err(torch, root, flat[-8:]),
            "lc": _max_err(torch, lc, lc_plain)}
    return errs, flat, ms


def phase_core(torch, field, gen, smi: str) -> dict:
    """The prover core (``parallel.core_step``) at each of CORE_SHAPES:
    ``make_prover_core`` bit-equal to the backend path on the same card
    tensors (``rs_encode_and_canon``, ``commit_columns``' leaves and root,
    ``row_combine``) and timed, its RS-encode + Merkle-commit elements a
    second beside the card.  At the first shape the core is also held
    against its kernels' plain versions (:func:`core_plain_chain`), and
    ``make_sharded_prover_core`` over two and four shards gives every
    stage's outputs bit-equal to the single core's (the subtree roots to
    the plain tree's level log2(n / D)), so the sharded core's own kernel
    shapes (row blocks of 4m / D, column blocks of n / D) are held against
    the plain versions too.  Returns the launch counts of the core at the
    headline shape and of the four-shard core's full stage, the rates and
    the plain check's errors."""
    import numpy as np
    from ligero_tpu_torch.engine import cuda_tree
    from ligero_tpu_torch.engine.backend import TorchBackend
    from ligero_tpu_torch.parallel import (make_prover_core,
                                           make_sharded_prover_core)
    from ligero_tpu_torch.parallel.core_step import STAGES

    be, wraps = TorchBackend(field), wrappers()
    tag = "" if field.num_limbs == 16 else "bls "
    launches, rates, plain = {}, {}, {}
    for four_m, k, n in CORE_SHAPES:
        shape = f"{four_m} x {k} -> {n}"
        preenc = _rand_elems(torch, gen, (four_m, k), field)
        r = _rand_elems(torch, gen, (four_m,), field)
        fn = make_prover_core(field, four_m, k, n)
        reset_counts(torch, wraps)
        u, leaves, root, lc = fn(preenc, r)
        torch.cuda.synchronize()
        if (four_m, k, n) == CORE_SHAPES[-1]:
            launches[f"{tag}core"] = read_counts(wraps, f"{tag}core",
                                                 absent=NOT_ON_CORE)
        # the backend path on the same tensors (launches not counted)
        u_ref = be.rs_encode_and_canon(preenc, k, n)[1]
        leaf_bytes, levels = be.commit_columns(u_ref)
        got = leaves.cpu().numpy().view(np.uint32).astype("<u4")
        require(torch.equal(u, u_ref)
                and [got[j].tobytes() for j in range(n)] == leaf_bytes
                and root.cpu().numpy().view(np.uint32).astype(">u4").tobytes()
                == levels[-1][0]
                and torch.equal(lc, be.row_combine(r, preenc)),
                f"core [{field.name}] {shape}: differs from the backend path")
        del u_ref
        ms = _time_cuda(torch, lambda: fn(preenc, r), 5)
        rates[shape] = {"ms": ms, "elements_per_s": four_m * n / (ms / 1e3)}
        log(f"core [{field.name}] {shape}: bit-equal to the backend path; "
            f"{ms:.3f} ms a call (lc included): RS-encode + Merkle-commit "
            f"{four_m * n / (ms / 1e3):.4g} elements/s on {smi}")
        if (four_m, k, n) != CORE_SHAPES[0]:
            del u, leaves, root, lc, preenc, r
            torch.cuda.empty_cache()
            continue
        errs, flat, plain_ms = core_plain_chain(torch, field, preenc, r, k,
                                                n, (u, leaves, root, lc))
        log(f"core [{field.name}] {shape} against the plain chain (ntt_ref "
            f"iNTT_{k} then NTT_{n} canon_out, blake2s_columns_ref at "
            f"{n // CORE_PLAIN_COL_STEP} columns, tree_flat, "
            f"row_combine_ref): max_abs_err {errs} ({plain_ms:.1f} ms)")
        require(not any(errs.values()), f"core [{field.name}] {shape}: "
                f"differs from its kernels' plain versions ({errs})")
        plain[shape] = {"max_abs_err": errs, "plain_ms": plain_ms}
        for D in (2, 4):
            level = (n // D).bit_length() - 1
            off = cuda_tree.level_offset(n, level)
            for stage in STAGES:
                fnd = make_sharded_prover_core(field, mesh_devices(torch, D),
                                               four_m, k, n, stage=stage)
                counted = D == 4 and stage == "full"
                if counted:
                    reset_counts(torch, wraps)
                out = fnd(preenc, r)
                torch.cuda.synchronize()
                if counted:
                    launches[f"{tag}sharded core"] = read_counts(
                        wraps, f"{tag}sharded core D=4", absent=NOT_ON_CORE)
                same = [torch.equal(torch.cat(out[0]).to(u.device), u)]
                if stage == "encode+a2a":
                    same.append(torch.equal(torch.cat(
                        [c.to(u.device) for c in out[1]], dim=1), u))
                if stage in ("encode+a2a+hash", "full"):
                    same.append(torch.equal(torch.cat(
                        [lv.to(u.device) for lv in out[1]]), leaves))
                if stage == "encode+a2a+hash":
                    same.append(torch.equal(out[2].reshape(-1).to(u.device),
                                            flat[off:off + 8 * D]))
                if stage == "full":
                    same += [torch.equal(out[2], root),
                             torch.equal(out[3], lc)]
                require(all(same), f"sharded core [{field.name}] {shape} D = "
                        f"{D}, stage {stage}: differs from the single core "
                        f"({same})")
            ms_d = _time_cuda(torch, lambda: fnd(preenc, r), 3)
            rates[f"{shape} D={D}"] = {"ms": ms_d, "elements_per_s":
                                       four_m * n / (ms_d / 1e3)}
            log(f"sharded core [{field.name}] {shape} over {D} shards "
                f"({mesh_devices(torch, D)}): every stage bit-equal to the "
                f"single core; full stage {ms_d:.3f} ms a call, "
                f"{four_m * n / (ms_d / 1e3):.4g} elements/s")
        del u, leaves, root, lc, preenc, r, flat
        torch.cuda.empty_cache()
    return {"launches": launches, "rates": rates, "plain": plain}


def phase_streaming_reach(torch, field) -> dict:
    """BLS12-377 at 2^23 gates, which direct mode refuses on this card:
    resident mode by the card's own budget (one prove and verify, a
    flipped byte rejected, the peaks beside the estimates, a warm prove
    and verify); then the same compiled instance
    (``LigeroCircuit.from_compiled``, no second compile; A's
    column-sorted upload and the witness layout, the same at one chunking,
    handed over, so that its first prove is a warm one) in streaming mode
    under a budget at its streaming estimate: the proof byte-equal to the
    resident one, its walls, phases and peaks."""
    from ligero_tpu_torch import LigeroCircuit
    from ligero_tpu_torch.engine.backend import TorchBackend
    from ligero_tpu_torch.utils.profiling import PhaseTimer

    circ, outs, vars_ = make_circuit(field, STREAM_LOG2_GATES, SEED)
    lig = build_instance(circ, outs, zk=False)
    del circ, outs
    be = lig.backend
    dims = (lig.num_rows, lig.k, lig.n, len(lig.state.a_vals))
    require(be.direct_bytes(*dims) > be.memory_budget(),
            "direct mode fits this instance")
    require(lig.encode_mode == "resident", f"{lig.encode_mode} mode by the "
            "card's budget, not resident")
    res = phase_streaming(torch, field, lig, vars_, tampered_witness=False,
                          warm=True)
    budget = be.streaming_bytes(*dims, chunk_rows=lig.chunk_rows)
    card_budget = TorchBackend.memory_budget
    TorchBackend.memory_budget = lambda self: budget
    try:
        lig_s = LigeroCircuit.from_compiled(lig.state,
                                            timer=PhaseTimer(enabled=True))
    finally:
        TorchBackend.memory_budget = card_budget
    require((lig_s.encode_mode, lig_s.chunk_rows)
            == ("streaming", lig.chunk_rows), "the streaming budget gave "
            f"{lig_s.encode_mode} mode in chunks of {lig_s.chunk_rows}")
    # the instance's one-time work, the same in both modes at one
    # chunking: A's column-sorted upload and the witness layout
    lig_s._coo, lig_s._witness = lig._coo, lig._witness
    del lig
    torch.cuda.empty_cache()
    wraps = wrappers()
    opens, storage = count_open_ntts(lig_s)
    try:
        reset_counts(torch, wraps)
        warm = warm_walls(torch, lig_s, vars_, {})
        peak = torch.cuda.max_memory_allocated()
        launches = read_counts(wraps, f"bls streaming 2^{STREAM_LOG2_GATES}",
                               absent=NOT_ON_STREAMING)
    finally:
        del lig_s.backend.gather_columns_batch, lig_s.backend.opened_to_host
    require(warm["want"] == res["proof"], "the streaming proof differs from "
            "the resident proof of the same instance")
    estimate = lig_s.backend.streaming_bytes(*dims,
                                             chunk_rows=lig_s.chunk_rows)
    log(f"bls streaming 2^{STREAM_LOG2_GATES} (the same instance, A's upload "
        f"and the witness layout handed over): proof byte-equal to the "
        f"resident one; prove "
        f"{warm['prove_s']:.3f} s, verify {warm['verify_s']:.3f} s (resident "
        f"warm: {res['warm_prove_s']:.3f} / {res['warm_verify_s']:.3f} s); "
        f"peak {peak / 2**30:.3f} GiB (streaming estimate "
        f"{estimate / 2**30:.3f} GiB; resident: {res['prove_peak_gib']:.3f} "
        f"under {res['estimate_gib']:.3f}); the openings launched {opens} "
        f"NTT(s) and copied {storage[0]['opened_bytes']} bytes to the host "
        f"(resident: {res['storage']['opened_bytes']})")
    for name in ("rs_encode", "commit", "open.gather"):
        log(f"  {name:12s} resident {res['warm_phases_ms'].get(name, 0):10.1f}"
            f" ms, streaming {warm['phases'].get(name, 0) * 1e3:10.1f} ms")
    require(peak <= estimate, "the streaming peak lies above its estimate")
    require(opens[0] > 0, "the streaming openings launched no NTT")
    require_16bit_openings(f"bls streaming 2^{STREAM_LOG2_GATES}", storage[0])
    res["streaming"] = {"launches": launches,
        "prove_s": warm["prove_s"], "verify_s": warm["verify_s"],
        "peak_gib": peak / 2**30, "estimate_gib": estimate / 2**30,
        "open_ntts": opens[0], "storage": storage[0],
        "phases_ms": {name: secs * 1e3
                      for name, secs in warm["phases"].items()}}
    del lig_s, vars_
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 6: the entry points: HTTP service and command line
# ---------------------------------------------------------------------------

def write_r1cs(path: str, cs) -> None:
    """A constraint system -> circom's binary ``.r1cs`` (iden3 layout:
    header, constraints, wire-to-label map; 32-byte field elements for
    BN254 Fr, 48 for BLS12-377 Fq)."""
    p, fs = cs.field.p, 8 * cs.field.num_u64_limbs
    n_wires = cs.num_instance + cs.num_witness
    header = (struct.pack("<I", fs) + p.to_bytes(fs, "little")
              + struct.pack("<IIII", n_wires, cs.num_instance - 1, 0,
                            cs.num_witness)
              + struct.pack("<QI", n_wires, cs.num_constraints))
    body = bytearray()
    for rows in zip(cs.a, cs.b, cs.c):
        for row in rows:
            body += struct.pack("<I", len(row))
            for coeff, wire in row:
                body += struct.pack("<I", wire) + (coeff % p).to_bytes(fs, "little")
    labels = b"".join(struct.pack("<Q", i) for i in range(n_wires))
    with open(path, "wb") as f:
        f.write(b"r1cs" + struct.pack("<II", 1, 3))
        for kind, data in ((1, header), (2, bytes(body)), (3, labels)):
            f.write(struct.pack("<IQ", kind, len(data)) + data)


def write_wtns(path: str, p: int, values) -> None:
    """A witness vector -> circom's binary ``.wtns``."""
    header = struct.pack("<I", 32) + p.to_bytes(32, "little") + struct.pack(
        "<I", len(values))
    data = b"".join(v.to_bytes(32, "little") for v in values)
    with open(path, "wb") as f:
        f.write(b"wtns" + struct.pack("<II", 2, 2))
        for kind, blob in ((1, header), (2, data)):
            f.write(struct.pack("<IQ", kind, len(blob)) + blob)


class Serving:
    """The port's HTTP service for ``service`` in a thread on an ephemeral
    port; ``call(path, body)`` sends one request (GET without a body)."""

    def __init__(self, service):
        from http.server import HTTPServer

        from ligero_tpu_torch.server import make_handler
        self.httpd = HTTPServer(("127.0.0.1", 0), make_handler(service))
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=30)

    def call(self, path, body=None):
        data = None if body is None else json.dumps(body).encode()
        req = urllib.request.Request(
            self.url + path, data, {"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as r:
            out = json.loads(r.read())
        log(f"serve {'POST' if body is not None else 'GET'} {path}: "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        return out


def phase_serve_bls(torch, field) -> dict:
    """A BLS12-377 Fq service in a thread, no device named: one /circuits,
    /prove and /verify on a repeated-squaring ``.r1cs`` over the field
    (48-byte elements) written here; returns the requests' launch counts."""
    from ligero_tpu_torch.circuit.r1cs import (
        repeated_squaring_constraint_system, repeated_squaring_witness)
    from ligero_tpu_torch.server import ProverService

    squarings = 1 << BLS_LOG2_SQUARINGS
    wraps = wrappers()
    with tempfile.TemporaryDirectory() as tmp:
        r1cs = os.path.join(tmp, "squarings_bls12_377.r1cs")
        write_r1cs(r1cs, repeated_squaring_constraint_system(field, squarings))
        witness = [str(v) for v in repeated_squaring_witness(field, 7, squarings)]
        with Serving(ProverService(field)) as srv:
            health = srv.call("/health")
            require(health["device"].startswith("cuda")
                    and health["field"] == field.name,
                    f"the {field.name} service does not run on the card: "
                    f"{health}")
            reset_counts(torch, wraps)
            info = srv.call("/circuits", {"name": "sq", "r1cs": r1cs})
            require(info["constraints"] == squarings, f"/circuits: {info}")
            one = srv.call("/prove", {"name": "sq", "witness": witness})
            require(srv.call("/verify", {"name": "sq", "proof": one["proof"]})
                    ["verified"] is True, f"/verify rejected the honest "
                    f"{field.name} proof")
            corrupted = flip_byte(bytes.fromhex(one["proof"])).hex()
            require(srv.call("/verify", {"name": "sq", "proof": corrupted})
                    ["verified"] is False, "/verify took a corrupted proof")
            launches = read_counts(wraps, "bls serve")
    log(f"serve [{field.name}]: {info}; proof {len(one['proof']) // 2} bytes")
    return launches


def phase_serve(torch, field) -> dict:
    """The serving path through its entry points; returns the launch counts
    of the service's requests (the CLI's run in other processes)."""
    from ligero_tpu_torch.circuit.r1cs import (
        repeated_squaring_constraint_system, repeated_squaring_witness)
    from ligero_tpu_torch.server import ProverService

    squarings = 1 << LOG2_SQUARINGS
    wraps = wrappers()
    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as tmp:
        r1cs = os.path.join(tmp, "squarings.r1cs")
        wtns = os.path.join(tmp, "witness.wtns")
        proof_path = os.path.join(tmp, "proof.bin")
        write_r1cs(r1cs, repeated_squaring_constraint_system(field, squarings))
        witnesses = [repeated_squaring_witness(field, x, squarings)
                     for x in (3, 4, 5)]
        write_wtns(wtns, field.p, witnesses[0])

        with Serving(ProverService()) as srv:
            call = srv.call
            health = call("/health")
            require(health["status"] == "ok"
                    and health["device"].startswith("cuda"),
                    f"the service does not run on the card: {health}")
            info = call("/circuits", {"name": "sq", "r1cs": r1cs})
            require(info["constraints"] == squarings, f"/circuits: {info}")
            log(f"serve circuit: {info}")
            call("/warmup", {"name": "sq"})
            reset_counts(torch, wraps)
            as_text = [[str(v) for v in w] for w in witnesses]
            one = call("/prove", {"name": "sq", "witness": as_text[0]})
            many = call("/prove", {"name": "sq", "witnesses": as_text})
            require(many["proofs"][0] == one["proof"] and len(set(
                many["proofs"])) == 3, "/prove: the batch differs from the "
                "single proof")
            require(call("/verify", {"name": "sq", "proof": one["proof"]})
                    ["verified"] is True, "/verify rejected the honest proof")
            corrupted = flip_byte(bytes.fromhex(many["proofs"][1])).hex()
            verdicts = call("/verify", {"name": "sq", "proofs": [
                many["proofs"][0], corrupted, many["proofs"][2]]})["verified"]
            require(verdicts == [True, False, True],
                    f"/verify of a batch: {verdicts}")
            launches = read_counts(wraps, "serve")
            require("sq" in call("/health")["circuits"], "/health lost the "
                    "circuit")

        env = dict(os.environ, PYTHONPATH=root)
        for verb, args in (("prove", ["--witness", wtns, "--out", proof_path]),
                           ("verify", ["--proof", proof_path])):
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, "-m", "ligero_tpu_torch", verb, "--r1cs",
                 r1cs, *args], cwd=root, env=env, capture_output=True,
                text=True, timeout=600)
            require(res.returncode == 0, f"CLI {verb} failed: "
                    f"{res.stderr[-2000:]}")
            out = json.loads(res.stdout.strip().splitlines()[-1])
            log(f"CLI {verb}: {out} ({time.perf_counter() - t0:.1f} s with "
                "the interpreter's start)")
            require(out["device"].startswith("cuda"),
                    "the CLI did not run on the card")
        require(out["verified"] is True, "CLI verify rejected the proof")
        with open(proof_path, "rb") as f:
            require(f.read().hex() == one["proof"], "the CLI's proof differs "
                    "from the service's")
        log("serve: the CLI's proof bytes equal the service's")
    return launches


# ---------------------------------------------------------------------------
# phase 7: the process mesh, the bench and the graft entry points
# ---------------------------------------------------------------------------

def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def check_launches(launches: dict, path: str, absent) -> dict:
    """:func:`read_counts`'s check on counts read elsewhere (a rank's)."""
    log(f"kernel launches on the {path} path: {launches}")
    require(all((v == 0) == (name in absent) for name, v in launches.items()),
            f"on the {path} path a kernel was not launched, or one of "
            f"{absent} was: {launches}")
    return launches


def worker_module():
    """``scripts/torch_multihost_worker.py`` as a module: its seeded core
    inputs are the ranks' inputs."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_multihost_worker", os.path.join(REPO, WORKER))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_nccl_world(torch, field) -> dict:
    """A process group of one rank over NCCL (``multihost.initialize``
    with the backend named; the path of a host with several cards, one
    rank a card): the sharded core over its ``ProcessRowMesh`` at the
    headline shape, every stage bit-equal to the single core, timed beside
    it; the full stage's launches counted."""
    from ligero_tpu_torch.parallel import (make_prover_core,
                                           make_sharded_prover_core,
                                           multihost)
    from ligero_tpu_torch.parallel.core_step import STAGES

    four_m, k, n = CORE_SHAPES[-1]
    preenc, r = (torch.from_numpy(a.view("int32")).cuda() for a in
                 worker_module().core_inputs(field, four_m, k))
    single = make_prover_core(field, four_m, k, n)
    u, leaves, root, lc = single(preenc, r)
    multihost.initialize(f"localhost:{free_port()}", 1, 0, backend="nccl",
                         device="cuda:0")
    try:
        mesh = multihost.global_row_mesh("cuda:0")
        require(mesh.size == 1 and mesh.comm.backend == "nccl"
                and not mesh.comm.staged, f"not an NCCL world of one: {mesh}")
        for stage in STAGES:
            fn = make_sharded_prover_core(field, mesh, four_m, k, n,
                                          stage=stage)
            if stage == "full":
                fn(preenc, r)                             # warm
                wraps = wrappers()
                reset_counts(torch, wraps)
            out = fn(preenc, r)
            torch.cuda.synchronize()
            if stage == "full":
                launches = read_counts(wraps, "nccl core",
                                       absent=NOT_ON_CORE)
            same = [torch.equal(out[0][0], u)]
            if stage == "encode+a2a":
                same.append(torch.equal(out[1][0], u))
            if stage in ("encode+a2a+hash", "full"):
                same.append(torch.equal(out[1][0], leaves))
            if stage == "full":
                same += [torch.equal(out[2], root), torch.equal(out[3], lc)]
            require(all(same), f"NCCL world of one, stage {stage}: differs "
                    f"from the single core ({same})")
        ms = _time_cuda(torch, lambda: fn(preenc, r), 3)
        single_ms = _time_cuda(torch, lambda: single(preenc, r), 3)
    finally:
        multihost.shutdown()
    log(f"NCCL world of one [{field.name}] {four_m} x {k} -> {n}: every "
        f"stage bit-equal to the single core; {ms:.3f} ms a call against "
        f"the single core's {single_ms:.3f} ms")
    return {"launches": launches, "ms": ms, "single_ms": single_ms}


def phase_process_mesh(torch, field, want_direct: bytes,
                       want_streaming: bytes) -> dict:
    """A world of two ranks on the one card over gloo, asked for by name
    (NCCL refuses two ranks on one GPU): two ``torch_multihost_worker.py``
    processes on ``cuda:0``, started once the kernels are built.  Each
    runs the sharded core at the headline shape in both fields (root and
    lc equal to the single core's on the same inputs), a BN254 2^20-gate
    plain prove -> verify in direct mode and a 2^18-gate one in streaming
    mode forced by the budget, each after a warm-up prove and verify,
    each proof byte-equal to the single-device proof of this run
    (``want_*``) and verified on both ranks.  Per rank: walls, launches,
    the device peak against ``device_bytes`` / ``stream_device_bytes`` (a
    peak above fails) and the bytes the collectives staged through host
    memory.  On one card this is the cost of the host-staged collectives,
    not scaling.  A rank that exits non-zero fails the phase, its stderr
    tail printed."""
    four_m, k, n = CORE_SHAPES[-1]
    bls = "bls12_377_fq"
    port, tmp = free_port(), tempfile.mkdtemp(prefix="ligero_ranks_")
    env = dict(os.environ, PYTHONPATH=REPO)
    procs, outs, errs = [], [], []
    t0 = time.perf_counter()
    try:
        for pid in range(PROCESS_RANKS):
            out = os.path.join(tmp, f"rank{pid}.json")
            err = open(os.path.join(tmp, f"rank{pid}.err"), "w+")
            outs.append(out)
            errs.append(err)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.join(REPO, WORKER), str(pid),
                 str(PROCESS_RANKS), str(port), out, "--field", field.name,
                 "--mode", f"core,core:{bls},direct,streaming",
                 "--device", "cuda:0", "--backend", "gloo",
                 "--core", f"{four_m},{k},{n}",
                 "--gates", str(1 << LOG2_GATES),
                 "--stream-gates", str(1 << BATCH_LOG2_GATES),
                 "--stream-chunk", str(FORCED_CHUNK_ROWS),
                 "--num-vars", "64", "--circuit-seed", str(SEED), "--warm"],
                cwd=REPO, env=env, stdout=err, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + WORKER_TIMEOUT_S
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        raise SmokeFailure(f"the ranks ran past {WORKER_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for pid, (p, err) in enumerate(zip(procs, errs)):
        err.seek(0)
        tail = err.read()[-3000:]
        err.close()
        if p.returncode != 0:
            print(tail, file=sys.stderr, flush=True)
        require(p.returncode == 0, f"rank {pid} exited {p.returncode}")
    recs = []
    for out in outs:
        with open(out) as f:
            recs.append(json.load(f))
    log(f"process mesh: {PROCESS_RANKS} ranks on cuda:0 over "
        f"{recs[0]['backend']}, {wall:.1f} s from start to exit (one card: "
        "these numbers are the host-staged collectives' cost, not scaling)")

    # the single core on the ranks' inputs, in both fields
    import numpy as np
    from ligero_tpu_torch.fields import FIELDS
    from ligero_tpu_torch.parallel import make_prover_core
    inputs = worker_module().core_inputs
    for run, fname in (("core", field.name), (f"core:{bls}", bls)):
        f = FIELDS[fname]
        preenc, r = (torch.from_numpy(a.view("int32")).cuda()
                     for a in inputs(f, four_m, k))
        _, _, root, lc = make_prover_core(f, four_m, k, n)(preenc, r)
        want = (root.cpu().numpy().view(np.uint32).astype(">u4")
                .tobytes().hex(),
                lc.cpu().numpy().view(np.uint32).astype("<u4").tobytes().hex())
        for rec in recs:
            got = rec["runs"][run]
            require((got["root"], got["lc"]) == want,
                    f"process mesh {run}, rank {rec['rank']}: root or lc "
                    "differs from the single core")
        log(f"process mesh core [{fname}] {four_m} x {k} -> {n}: root and lc "
            "of both ranks bit-equal to the single core; rank walls "
            + ", ".join(f"{rec['runs'][run]['wall_s'] * 1e3:.1f} ms"
                        for rec in recs) + "; staged through the host "
            + ", ".join(f"{rec['runs'][run]['staged_bytes'] / 2**20:.1f} MiB"
                        for rec in recs))
    for run, want in (("direct", want_direct), ("streaming", want_streaming)):
        digest = hashlib.sha256(want).hexdigest()
        for rec in recs:
            got = rec["runs"][run]
            require(got["sha256"] == digest and got["bytes"] == len(want),
                    f"process mesh {run}, rank {rec['rank']}: the proof "
                    "differs from the single-device proof")
            require(got["verified"], f"process mesh {run}, rank "
                    f"{rec['rank']}: verify rejected the honest proof")
            require(got["peak_bytes"] <= got["estimate_bytes"]
                    and got["verify_peak_bytes"]
                    <= got["verify_estimate_bytes"],
                    f"process mesh {run}, rank {rec['rank']}: a peak lies "
                    "above its estimate")
            log(f"process mesh {run} 2^{got['gates'].bit_length() - 1} "
                f"rank {rec['rank']}: proof byte-equal to the single-device "
                f"proof ({got['bytes']} bytes), verify True; warm prove "
                f"{got['wall_s']:.3f} s, verify {got['verify_wall_s']:.3f} s; "
                f"peaks {got['peak_bytes'] / 2**30:.3f} / "
                f"{got['verify_peak_bytes'] / 2**30:.3f} GiB against "
                f"{got['estimate_bytes'] / 2**30:.3f} / "
                f"{got['verify_estimate_bytes'] / 2**30:.3f} GiB; staged "
                f"{got['staged_bytes'] / 2**30:.3f} / "
                f"{got['verify_staged_bytes'] / 2**30:.3f} GiB"
                + (f"; chunks of {got['chunk_rows']} rows"
                   if run == "streaming" else ""))
    paths = {"process core": ("core", NOT_ON_CORE),
             "bls process core": (f"core:{bls}", NOT_ON_CORE),
             "process direct": ("direct", NOT_ON_DEFAULT),
             "process streaming": ("streaming", NOT_ON_STREAMING)}
    launches = {}
    for path, (run, absent) in paths.items():
        counts = {}
        for rec in recs:
            for key in ("launches", "verify_launches"):
                for name, v in rec["runs"][run].get(key, {}).items():
                    counts[name] = counts.get(name, 0) + v
        launches[path] = check_launches(counts, path + " (both ranks)",
                                        absent)
    return {"launches": launches, "wall_s": wall,
            "ranks": [{run: {key: val for key, val in got.items()
                             if key not in ("launches", "verify_launches",
                                            "lc", "root")}
                       for run, got in rec["runs"].items()} for rec in recs]}


def phase_bench(torch) -> dict:
    """``python -m ligero_tpu_torch.bench`` at the ``large`` scale in both
    fields, in this process: its canary passes, one JSON line of under
    2000 characters; the core's launches counted."""
    import contextlib
    import io
    from ligero_tpu_torch import bench

    lines, launches = {}, {}
    wraps = wrappers()
    for fname, path in (("bn254_fr", "bench"), ("bls12_377_fq", "bls bench")):
        buf = io.StringIO()
        reset_counts(torch, wraps)
        with contextlib.redirect_stdout(buf):
            rc = bench.main(["--field", fname, "--scale", "large"])
        torch.cuda.synchronize()
        launches[path] = read_counts(wraps, path, absent=NOT_ON_CORE)
        text = buf.getvalue().strip()
        require(rc == 0 and len(text.splitlines()) == 1 and len(text) < 2000,
                f"bench [{fname}]: exit {rc}, output {text[:500]!r}")
        lines[fname] = json.loads(text)
        log(f"bench [{fname}]: {text}")
    return {"launches": launches, "lines": lines}


def phase_graft(torch) -> dict:
    """``graft_entry.entry()`` on the card (its core's outputs bit-equal
    to the backend path on the same tensors) and ``dryrun_multichip(2)``
    with both mesh devices on the card (its proofs byte-equal to one
    device's, direct and streaming); launches counted on each."""
    from ligero_tpu_torch import graft_entry
    from ligero_tpu_torch.engine.backend import TorchBackend
    from ligero_tpu_torch.fields import BN254_FR

    wraps = wrappers()
    fn, (preenc, r) = graft_entry.entry()
    require(preenc.device.type == "cuda", "entry() did not take the card")
    four_m, k, n = graft_entry.CARD_SHAPE
    reset_counts(torch, wraps)
    u, leaves, root, lc = fn(preenc, r)
    torch.cuda.synchronize()
    launches = {"entry": read_counts(wraps, "entry", absent=NOT_ON_CORE)}
    be = TorchBackend(BN254_FR)
    require(torch.equal(u, be.rs_encode_and_canon(preenc, k, n)[1])
            and torch.equal(lc, be.row_combine(r, preenc))
            and tuple(leaves.shape) == (n, 8) and tuple(root.shape) == (8,),
            "entry(): the core differs from the backend path")
    reset_counts(torch, wraps)
    t0 = time.perf_counter()
    res = graft_entry.dryrun_multichip(2)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches["dryrun"] = read_counts(
        wraps, "dryrun_multichip(2)",
        absent=("poseidon_cols", "poseidon_stream"))
    require(res["devices"] == mesh_devices(torch, 2), "dryrun_multichip(2) "
            f"ran on {res['devices']}")
    log(f"entry(): {four_m} x {k} -> {n} on the card, bit-equal to the "
        f"backend path; dryrun_multichip(2) on {res['devices']}: sharded "
        "core, direct and streaming proofs (chunks of "
        f"{res['chunk_rows']} rows) byte-equal to one device's, {secs:.1f} s")
    return {"launches": launches, "dryrun_s": secs,
            "chunk_rows": res["chunk_rows"]}


class Laps:
    """Each phase's seconds on the host clock: ``laps(name)`` closes the
    phase that ran since the last call, logs it and keeps it."""

    def __init__(self):
        self.seconds: dict = {}
        self.last = time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = self.seconds.get(name, 0.0) + now - self.last
        log(f"phase [{name}]: {now - self.last:.1f} s")
        self.last = now


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from ligero_tpu_torch import BLS12_377_FQ, BN254_FR, LigeroCircuit
    from ligero_tpu_torch.engine import cuda_build
    from ligero_tpu_torch.parallel import ShardedBackend

    field = BN254_FR
    start = time.perf_counter()
    laps = Laps()
    smi = nvidia_smi_line()
    log(f"device: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}, "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}; nvidia-smi: {smi}")

    tally_ntt_shapes()
    t0 = time.perf_counter()
    cuda_build.library()
    log(f"kernels built from {cuda_build.CSRC} in "
        f"{time.perf_counter() - t0:.1f} s")
    if os.path.exists(cuda_build.LOG_PATH):
        with open(cuda_build.LOG_PATH) as f:
            nvcc_log = f.read()
        for line in nvcc_log.splitlines():
            if "registers" in line or "spill" in line:
                log("ptxas: " + line.strip())
        # the redesigned kernels' instantiations, each by name
        for line in ptxas_lines(nvcc_log, ("blake2s_kernel",
                                           "row_combine_kernel")):
            log("ptxas [blake2s / row_combine]: " + line)
    require(os.path.exists(cuda_build.LOG_PATH),
            f"no nvcc log at {cuda_build.LOG_PATH} to read ntt.cu's spill from")
    spills = ntt_spills(nvcc_log)
    require(not spills, "ntt.cu's BLS12-377 instantiations spill: "
            + "; ".join(spills))
    for name, mix in blake2s_sass(cuda_build.LIB_PATH).items():
        log(f"SASS blake2s_kernel [{name}]: compression loop of {mix['body']} "
            f"instructions ({mix['blocks']} block(s) a pass), {mix['alu']} on "
            f"the integer pipe, {mix['fma']} on the FMA pipe: its least issue "
            f"time is {mix['mix_over_issue']:.3f} x the bound's (968 "
            f"operations a block at the issue rate); {mix['ops']}")
    rc_sass = row_combine_sass(cuda_build.LIB_PATH)
    for name, where in rc_sass.items():
        log(f"SASS row_combine_kernel [{name}]: row loop of {where['body']} "
            f"instructions: {where['copies']} cp.async copies (LDGSTS) at "
            f"{where['first_copy']}..{where['last_copy']}, "
            f"{where['waits']} waits, {where['shared_loads']} shared loads, "
            f"{where['multiplies']} wide multiply-adds at "
            f"{where['first_multiply']}..{where['last_multiply']}")

    laps("build")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(20)
    circ, outs, vars_ = make_circuit(field, LOG2_GATES, SEED)
    lig = build_instance(circ, outs, zk=False)
    dims, zk_dims = instance_dims(lig)
    results = phase_kernels(torch, field, gen, dims, zk_dims)
    results["row_combine"]["sass"] = rc_sass
    rows = 4 * lig.m
    tree_bit_equality(torch, gen)
    results["sha256_tree"]["chain_floor_ms"] = tree_chain_floor(torch, lig.n)
    batch_kernel_cases(torch, field, gen, results, rows, lig.k, lig.n)
    spot_cases(torch, field, gen, rows, lig.k, lig.n, lig.t)
    blake2s_stream_cases(torch, field, gen, rows + 3)
    results["poseidon_cols"] = poseidon_cases(torch, field, gen, rows, lig.n,
                                              lig.t)
    results["poseidon_stream"] = poseidon_stream_entry(torch, field, gen, rows,
                                                       lig.n)
    kernel_cases_2e22(torch, field, gen, results)
    host_hash_context(lig.n)
    laps("kernels bn254")
    core = {field.name: phase_core(torch, field, gen, smi)}
    nccl = phase_nccl_world(torch, field)
    laps("core bn254, nccl")
    phase_parity()
    laps("parity")
    by_path = {"plain": phase_main(torch, field, lig, vars_,
                                   fused_check=True)}
    OVERLAP["walls bn254 plain"] = overlap_walls(torch, lig, vars_)
    ref = single_reference(torch, lig, vars_)
    want_2e20 = ref["want"]          # the process mesh's direct proof
    del lig
    torch.cuda.empty_cache()
    # resident mode forced by the budget at this size, 1024-row chunks,
    # against this instance's direct proof
    resident = {"resident": phase_streaming_forced(
        torch, field, circ, outs, vars_, False, chunk_rows=STREAM_CHUNK,
        reference=ref, mode="resident")}
    laps("main 2^20 plain, resident")
    # the same instance over a mesh of two shards
    sharded = {"sharded": phase_sharded(torch, field, circ, outs, vars_,
                                        False, False, 2, ref)}
    # and in streaming mode over the mesh, forced into STREAM_CHUNK-row
    # chunks (a device's rows a step; the last step one short chunk)
    sharded["sharded streaming"] = phase_sharded(
        torch, field, circ, outs, vars_, False, False, 2, ref,
        chunk_rows=STREAM_CHUNK)
    lig = build_instance(circ, outs, zk=True)
    require((lig.blind_t, lig.d2) == zk_dims, "zk kernel shapes were not the "
            f"zk path's: {zk_dims} vs {(lig.blind_t, lig.d2)}")
    by_path["zk"] = phase_main(torch, field, lig, vars_, fused_check=True)
    ref_zk = single_reference(torch, lig, vars_)
    del lig
    torch.cuda.empty_cache()
    resident["zk resident"] = phase_streaming_forced(
        torch, field, circ, outs, vars_, True, chunk_rows=STREAM_CHUNK,
        reference=ref_zk, mode="resident")
    laps("sharded 2^20, zk, zk resident")
    # the same circuit committed with the Poseidon params, then in streaming
    # mode forced by the budget into STREAM_CHUNK-row chunks
    streaming = {}
    for zk, path in ((False, "poseidon"), (True, "poseidon zk")):
        lig = build_instance(circ, outs, zk=zk, poseidon=True)
        by_path[path] = phase_main(torch, field, lig, vars_)
        ref = single_reference(torch, lig, vars_)
        del lig
        torch.cuda.empty_cache()
        path = path_tag(field, zk, True) + "streaming"
        streaming[path] = phase_streaming_forced(
            torch, field, circ, outs, vars_, zk, poseidon=True,
            chunk_rows=STREAM_CHUNK, reference=ref)
        by_path[path] = streaming[path]["launches"]
    del circ, outs, vars_
    laps("poseidon 2^20, streaming")
    circ, outs, vars_ = make_circuit(field, BATCH_LOG2_GATES, SEED)
    for zk, path in ((False, "batch"), (True, "zk batch")):
        lig = build_instance(circ, outs, zk=zk)
        # the batched launches at this path's own shapes
        B = ZK_BATCH if zk else BATCH
        results["blake2s_cols"][f"{path} path"] = blake2s_full_batch_case(
            torch, field, gen, B, lig.num_rows, lig.n, plain=True)
        results["row_combine"][f"{path} path"] = row_combine_batch_case(
            torch, field, gen, B, 4 * lig.m, lig.k + (lig.blind_t if zk else 0))
        by_path[path] = phase_batch(torch, field, lig, vars_)
        ref = single_reference(torch, lig, vars_) if zk else None
        del lig
        torch.cuda.empty_cache()
        # the same batch over a mesh of two shards
        lig = LigeroCircuit(circ, outs, zk=zk, backend=ShardedBackend(
            field, mesh_devices(torch, 2)))
        by_path[path.replace("batch", "sharded batch")] = phase_batch(
            torch, field, lig, vars_, tag="sharded ")
        del lig
        torch.cuda.empty_cache()
    # zk over a mesh of three shards: 4m + 3 rows, the last block padded
    sharded["zk sharded"] = phase_sharded(torch, field, circ, outs, vars_,
                                          True, False, 3, ref)
    # and in streaming mode over the three, FORCED_CHUNK_ROWS-row chunks
    sharded["zk sharded streaming"] = phase_sharded(
        torch, field, circ, outs, vars_, True, False, 3, ref,
        chunk_rows=FORCED_CHUNK_ROWS)
    # the batch path under the Poseidon commitment: one sponge launch for
    # both proofs' columns, one a tree level for both trees
    lig = build_instance(circ, outs, zk=False, poseidon=True)
    by_path["poseidon batch"] = phase_batch(torch, field, lig, vars_,
                                            full=False)
    ref = single_reference(torch, lig, vars_)
    del lig
    torch.cuda.empty_cache()
    sharded["poseidon sharded"] = phase_sharded(torch, field, circ, outs,
                                                vars_, False, True, 2, ref)
    # the Poseidon commit over the held codeword chunks: resident mode
    # forced at this size, 1024-row chunks (the last of 4 rows)
    resident["poseidon resident"] = phase_streaming_forced(
        torch, field, circ, outs, vars_, False, poseidon=True,
        chunk_rows=STREAM_CHUNK, reference=ref, mode="resident")
    # streaming mode, forced by the budget at this size, plain and zk
    for zk in (False, True):
        path = path_tag(field, zk) + "streaming"
        streaming[path] = phase_streaming_forced(torch, field, circ, outs,
                                                 vars_, zk)
        by_path[path] = streaming[path]["launches"]
    # two ranks on the card: the 2^20 direct and this size's streaming
    # proofs against this run's single-device ones
    want_2e18 = single_instance_reference(torch, field, circ, outs, vars_,
                                          False)["want"]
    del circ, outs, vars_
    laps("2^18 batches, mesh, poseidon resident, streaming")
    drop_cached_tables(torch)
    process = phase_process_mesh(torch, field, want_2e20, want_2e18)
    by_path.update(process["launches"])
    laps("process mesh")

    # the same synthetic circuit over BLS12-377 Fq, the kernels' second field
    bls = BLS12_377_FQ
    circ, outs, vars_ = make_circuit(bls, LOG2_GATES, SEED)
    lig = build_instance(circ, outs, zk=False)
    bls_dims, zk_dims = instance_dims(lig)
    bls_results = phase_kernels(torch, bls, gen, bls_dims, zk_dims)
    blake2s_residue_cases(torch, bls, gen)
    blake2s_stream_cases(torch, bls, gen, 4 * lig.m + 3)
    bls_results["blake2s_cols"]["batched_full"] = blake2s_full_batch_case(
        torch, bls, gen, BATCH, 4 * lig.m, lig.n, plain=False)
    bls_results["row_combine"]["batched"] = row_combine_batch_case(
        torch, bls, gen, 2, 4 * lig.m, lig.k)   # the bls batch path's B
    laps("kernels bls12_377")
    core[bls.name] = phase_core(torch, bls, gen, smi)
    by_path["bls plain"] = phase_main(torch, bls, lig, vars_,
                                      fused_check=True)
    by_path["bls batch"] = phase_batch(torch, bls, lig, vars_, full=False)
    del lig
    torch.cuda.empty_cache()
    lig = build_instance(circ, outs, zk=True)
    require((lig.blind_t, lig.d2) == zk_dims, "zk kernel shapes were not the "
            f"zk path's: {zk_dims} vs {(lig.blind_t, lig.d2)}")
    by_path["bls zk"] = phase_main(torch, bls, lig, vars_)
    del lig, circ, outs, vars_
    torch.cuda.empty_cache()
    circ, outs, vars_ = make_circuit(bls, BATCH_LOG2_GATES, SEED)
    ref = single_instance_reference(torch, bls, circ, outs, vars_, False)
    sharded["bls sharded"] = phase_sharded(torch, bls, circ, outs, vars_,
                                           False, False, 2, ref)
    sharded["bls sharded streaming"] = phase_sharded(
        torch, bls, circ, outs, vars_, False, False, 2, ref,
        chunk_rows=FORCED_CHUNK_ROWS)
    resident["bls resident"] = phase_streaming_forced(
        torch, bls, circ, outs, vars_, False, chunk_rows=STREAM_CHUNK,
        reference=ref, mode="resident")
    for zk in (False, True):
        path = path_tag(bls, zk) + "streaming"
        streaming[path] = phase_streaming_forced(torch, bls, circ, outs,
                                                 vars_, zk)
        by_path[path] = streaming[path]["launches"]
    del circ, outs, vars_
    laps("bls12_377 2^20, 2^18 mesh, resident, streaming")
    path = f"bls resident 2^{STREAM_LOG2_GATES}"
    resident[path] = phase_streaming_reach(torch, bls)
    by_path[path] = resident[path]["launches"]
    by_path[f"bls streaming 2^{STREAM_LOG2_GATES}"] = resident[path][
        "streaming"].pop("launches")
    for path, res in resident.items():
        if path != f"bls resident 2^{STREAM_LOG2_GATES}":
            by_path[path] = res["launches"]
    laps(f"bls12_377 2^{STREAM_LOG2_GATES} resident and streaming")

    for path, res in sharded.items():
        by_path[path] = res["launches"]
    for res in core.values():
        by_path.update(res["launches"])
    by_path["nccl core"] = nccl["launches"]
    bench = phase_bench(torch)
    by_path.update(bench["launches"])
    graft = phase_graft(torch)
    by_path.update(graft["launches"])
    laps("bench, graft entry")
    by_path["serve"] = phase_serve(torch, field)
    by_path["bls serve"] = phase_serve_bls(torch, bls)
    laps("serve, CLI")
    for mod in ("jax", "ligero_tpu"):
        require(sys.modules.get(mod) is None, f"{mod} was imported")

    extra = ("chain_floor_ms", "batched", "batched_full", "forest", "full_ms",
             "zk_full_ms", "full_bound_ms", "zk_full_bound_ms", "batch path",
             "zk batch path", "2^22", "levels", "lanes",
             "per_lanes", "verifier", "chain_floor_g1_ms", "sass",
             "whole_column_ms", "short_plain_ms", "shape", "device_ms",
             *(f"rows_{h}" for h in POSEIDON_LANE_ROWS))

    def timings(res: dict) -> dict:
        return {"max_abs_err": res["max_abs_err"], "ms": res["ms"],
                "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                "bound_by": res["bound_by"],
                **{key: res[key] for key in extra if key in res}}

    def paths(name: str, bls_paths: bool) -> dict:
        return {path: counts[name] for path, counts in by_path.items()
                if path.startswith("bls") == bls_paths}

    # BN254 Fr's numbers at the top level of each entry, BLS12-377 Fq's
    # beside them (the Poseidon sponge has none: its digests hold no
    # BLS12-377 element); no single PyTorch call computes any of these
    # functions
    record = {"kernels": []}
    for name, (_, src, rep) in KERNELS.items():
        entry = {"name": name, "route": "cuda", "source": src, "replaces": rep,
                 "launches": sum(counts[name] for counts in by_path.values()),
                 "launches_by_path": paths(name, False),
                 **timings(results[name]), "library_ms": None}
        if name in bls_results:
            entry["max_abs_err"] = max(results[name]["max_abs_err"],
                                       bls_results[name]["max_abs_err"])
            entry["bls12_377_fq"] = {
                "replaces": BLS_REPLACES.get(name, rep),
                "launches_by_path": paths(name, True),
                **timings(bls_results[name])}
        record["kernels"].append(entry)
    for group, paths_ in (("streaming", streaming), ("resident", resident)):
        record[group] = {path: {key: val for key, val in res.items()
                                if key not in ("launches", "proof")}
                         for path, res in paths_.items()}
    record["sharded"] = {path: {key: val for key, val in res.items()
                                if key != "launches"}
                         for path, res in sharded.items()}
    record["core"] = {name: res["rates"] for name, res in core.items()}
    record["nccl_world"] = {key: val for key, val in nccl.items()
                            if key != "launches"}
    record["process_mesh"] = {key: val for key, val in process.items()
                              if key != "launches"}
    record["bench"] = {name: {"value": line["value"],
                              "step_s": line["config"]["step_s"]}
                       for name, line in bench["lines"].items()}
    record["graft"] = {key: val for key, val in graft.items()
                       if key != "launches"}
    record["overlap"] = OVERLAP
    record["phase_s"] = laps.seconds
    record["total_s"] = time.perf_counter() - start
    log(f"chip_smoke: every phase passed in {record['total_s']:.1f} s")
    print(smi, flush=True)
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
