"""Challenge expansion: ark-ff ``F::rand`` + rand-0.8 ``gen_range`` semantics.

The port's own copy of ``ligero_tpu/sampling.py``, same names and structure;
the tests hold the two against each other on the same inputs.

Reproduces, bit for bit, the PRNG pipeline of the reference
(reference src/utils.rs:23-55):

* ``get_field_elements_from_prng`` — ChaCha20 seeded with 32 sponge bytes,
  then ``F::rand`` rejection sampling.  ark-ff samples ``N`` u64 limbs
  (least-significant first), masks the top limb down to
  ``MODULUS_BIT_SIZE`` bits and accepts iff the value is below the
  modulus.  Crucially the accepted raw limbs ARE the Montgomery
  representation (``Fp(BigInt::rand(rng))``), so the canonical value is
  ``raw * R^{-1} mod p``.
* ``get_distinct_indices_from_prng`` — BTreeSet of ``gen_range(0..n)``
  draws (rand 0.8 widening-multiply rejection), complement-sampled when
  ``t > n/2``, always ascending.

The bulk sampler is vectorised with numpy: because every ``F::rand``
attempt consumes exactly ``N`` u64s back-to-back, the candidate stream is
*oblivious* to which candidates get rejected — candidate ``t`` always uses
u64s ``[N*t, N*(t+1))``.  Element ``j`` of the output is simply the ``j``-th
accepted candidate, which is trivially parallel.
"""

from __future__ import annotations

import numpy as np

from .chacha import ChaChaRng, u64_stream
from .fields import FieldSpec


# ---------------------------------------------------------------------------
# F::rand
# ---------------------------------------------------------------------------

def _u64s_to_mont_limb16(u64s: np.ndarray, field: FieldSpec) -> np.ndarray:
    """(n, N_u64) uint64 -> (n, L) uint32 16-bit limbs (same integer).

    The 16-bit little-endian limbs of LSB-first u64 limbs are exactly the
    contiguous little-endian u16 view of the buffer — one widening copy
    instead of four strided passes."""
    n = u64s.shape[0]
    u16 = np.ascontiguousarray(u64s).view("<u2").reshape(n, field.num_limbs)
    return u16.astype(np.uint32)


def rand_field_elements_u64(field: FieldSpec, count: int, seed: bytes,
                            reuse: bool = False) -> np.ndarray:
    """``get_field_elements_from_prng`` as ``(count, NL)`` u64 limbs.

    Same draws as :func:`rand_field_elements_limbs` (Montgomery form), kept
    in the u64-limb layout the native host kernels consume — callers that
    feed ``native.sparse_row_mul_mont`` etc. skip the u64→u16→u64 round
    trip (a ~2.4s/2.97M-elem host cost at the 2^19 linear phase).

    ``reuse=True`` returns a view of a shared per-(count, limbs, thread)
    cached buffer — it is INVALIDATED by the next same-shape draw with
    ``reuse=True`` (including the internal draw in
    :func:`rand_field_elements_limbs`).  Only opt in when the vector is
    consumed before any other expansion can run (the ``_r_a_coeff_rows``
    phase-local product does; the default keeps ownership with the caller
    at the cost of a fresh allocation and its first-touch page faults).
    """
    if count == 0:
        return np.zeros((0, field.num_u64_limbs), dtype=np.uint64)
    from . import native
    if native.available():
        out = native.chacha_fr_sample(field, count, seed, reuse=True)
        return out if reuse else out.copy()
    limbs16 = rand_field_elements_limbs(field, count, seed)
    return native.u16_to_u64_limbs(limbs16)


def rand_field_elements_limbs(field: FieldSpec, count: int, seed: bytes) -> np.ndarray:
    """``get_field_elements_from_prng``: Montgomery-form 16-bit limb array.

    Returns ``(count, L)`` uint32 limbs, little-endian 16-bit, Montgomery form.
    """
    if count == 0:
        return np.zeros((0, field.num_limbs), dtype=np.uint32)
    from . import native
    if native.available():
        # reuse=True is safe: the u64 draw is converted to a fresh u16
        # array right here and never escapes
        return _u64s_to_mont_limb16(
            native.chacha_fr_sample(field, count, seed, reuse=True), field)
    nl = field.num_u64_limbs
    shave = 64 * nl - field.modulus_bit_size
    mask = np.uint64(0xFFFFFFFFFFFFFFFF >> shave) if shave < 64 else np.uint64(0)
    p_limbs64 = np.array([(field.p >> (64 * i)) & 0xFFFFFFFFFFFFFFFF for i in range(nl)],
                         dtype=np.uint64)

    accepted_chunks = []
    got = 0
    pos = 0  # u64 stream position
    # Expected acceptance rate is p / 2^MODULUS_BIT_SIZE (>= 1/2 always,
    # ~0.91 for BN254 Fr); 5% relative slack is a many-hundred-sigma
    # margin at protocol sizes without wasting keystream, and the retry
    # loop below covers any shortfall exactly.
    accept = field.p / float(2 ** field.modulus_bit_size)
    want_attempts = int(count / accept * 1.05) + 64
    while got < count:
        raw = u64_stream(seed, (pos + want_attempts * nl) * 1)[pos:pos + want_attempts * nl]
        # NOTE: u64_stream recomputes from the start; fine for one or two rounds.
        cand = raw.reshape(want_attempts, nl).copy()
        cand[:, -1] &= mask
        # lexicographic comparison cand < p, from most significant limb down
        lt = np.zeros(want_attempts, dtype=bool)
        decided = np.zeros(want_attempts, dtype=bool)
        for i in reversed(range(nl)):
            limb = cand[:, i]
            newly_lt = ~decided & (limb < p_limbs64[i])
            newly_gt = ~decided & (limb > p_limbs64[i])
            lt |= newly_lt
            decided |= newly_lt | newly_gt
        ok = lt  # equality everywhere => not accepted (value == p impossible but anyway)
        acc = cand[ok]
        accepted_chunks.append(acc)
        got += acc.shape[0]
        pos += want_attempts * nl
        want_attempts = max(64, int((count - got) / accept * 1.3) + 64)

    acc = np.concatenate(accepted_chunks, axis=0)[:count]
    return _u64s_to_mont_limb16(acc, field)


def rand_field_elements(field: FieldSpec, count: int, seed: bytes) -> list[int]:
    """Canonical-int variant of :func:`rand_field_elements_limbs`."""
    limbs = rand_field_elements_limbs(field, count, seed)
    return field.mont_limbs_to_ints(limbs)


def rand_field_element_scalar(field: FieldSpec, rng: ChaChaRng) -> int:
    """Scalar ``F::rand`` against a live RNG (used for Poseidon constants).

    Returns the canonical integer value.
    """
    nl = field.num_u64_limbs
    shave = 64 * nl - field.modulus_bit_size
    mask = (0xFFFFFFFFFFFFFFFF >> shave) if shave < 64 else 0
    while True:
        limbs = [rng.next_u64() for _ in range(nl)]
        limbs[-1] &= mask
        raw = 0
        for limb in reversed(limbs):
            raw = (raw << 64) | limb
        if raw < field.p:
            return (raw * field.R_inv) % field.p


# ---------------------------------------------------------------------------
# gen_range + distinct indices
# ---------------------------------------------------------------------------

def gen_range(rng: ChaChaRng, n: int) -> int:
    """rand 0.8 ``Rng::gen_range(0..n)`` for usize on a 64-bit platform.

    UniformInt::sample_single: zone = (range << range.leading_zeros()) - 1;
    draw v: u64; (hi, lo) = widening_mul(v, range); accept iff lo <= zone.
    """
    assert 0 < n < (1 << 64)
    lz = 64 - n.bit_length()
    zone = ((n << lz) - 1) & 0xFFFFFFFFFFFFFFFF
    while True:
        v = rng.next_u64()
        prod = v * n
        hi, lo = prod >> 64, prod & 0xFFFFFFFFFFFFFFFF
        if lo <= zone:
            return hi


def get_distinct_indices_from_prng(n: int, t: int, seed: bytes) -> list[int]:
    """reference src/utils.rs:31-55 — sorted distinct column indices."""
    rng = ChaChaRng(seed, rounds=20)
    to_select = min(t, n - t)
    selected: set[int] = set()
    while len(selected) < to_select:
        selected.add(gen_range(rng, n))
    if to_select == t:
        return sorted(selected)
    return [i for i in range(n) if i not in selected]


def get_distinct_indices_excluding(n: int, t: int, seed: bytes,
                                   stride: int) -> list[int]:
    """zk-mode column sampling: ``t`` sorted distinct indices in ``[0, n)``
    avoiding multiples of ``stride`` (the embedded message-domain points,
    where the zk row blinding vanishes and a column would reveal witness
    values directly).  Framework extension — no reference counterpart; the
    draw stream is the same rand-0.8 ``gen_range`` as the non-zk sampler,
    with excluded points rejected like duplicates."""
    if t > n - n // stride:
        raise ValueError("not enough off-domain columns to sample")
    rng = ChaChaRng(seed, rounds=20)
    selected: set[int] = set()
    while len(selected) < t:
        j = gen_range(rng, n)
        if j % stride:
            selected.add(j)
    return sorted(selected)


def get_field_elements_from_prng(field: FieldSpec, n: int, seed: bytes) -> list[int]:
    """reference src/utils.rs:23-29 (canonical ints)."""
    return rand_field_elements(field, n, seed)
