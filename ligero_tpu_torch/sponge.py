"""Poseidon duplex sponge — bit-compatible with ark-crypto-primitives 0.5.

The port's own copy of ``ligero_tpu/sponge.py``, same names and structure;
the tests hold the two against each other on the same inputs.

The whole Fiat–Shamir transcript of the reference runs through a single
``PoseidonSponge`` built by ``ark_poly_commit::test_sponge()`` (reference
src/ligero/tests.rs:28,151):

* state width 3 (rate 2, capacity 1; capacity element is ``state[0]``),
* alpha = 17, 8 full + 31 partial rounds,
* MDS = [[1,0,1],[1,1,0],[0,1,1]],
* 39 x 3 round constants drawn as ``F::rand(ark_std::test_rng())``
  (StdRng = ChaCha12, fixed 32-byte seed).

The sponge is transcript-serial and tiny (a few dozen permutations per
proof), so it runs on the host over canonical Python ints.  Absorb/squeeze
buffering reproduces the ark ``DuplexSpongeMode`` state machine exactly —
including the mid-absorb permutes for inputs longer than the rate, which the
reference hits when absorbing the k-element ``preenc_u_lc`` vector.

Byte encodings (ark ``Absorb``/``CryptographicSponge``):

* absorbing a byte string (the Merkle root): prepend the u64 LE length,
  then split into chunks of ``(MODULUS_BIT_SIZE - 1)/8`` bytes, each read
  as a little-endian integer => one field element per chunk.
* ``squeeze_bytes(n)``: squeeze ``ceil(n / usable)`` native elements, take
  the low ``usable`` bytes of each canonical LE encoding, truncate to n.
"""

from __future__ import annotations

from dataclasses import dataclass

from .chacha import ark_std_test_rng
from .fields import FieldSpec
from .sampling import rand_field_element_scalar

_ABSORBING = 0
_SQUEEZING = 1


@dataclass
class PoseidonConfig:
    field: FieldSpec
    full_rounds: int
    partial_rounds: int
    alpha: int
    mds: list[list[int]]
    ark: list[list[int]]  # (full+partial) x state_size round constants
    rate: int
    capacity: int

    @property
    def state_size(self) -> int:
        return self.rate + self.capacity


_test_config_cache: dict[str, PoseidonConfig] = {}
_native_ark_cache: dict[str, "object"] = {}  # field -> Montgomery round consts


def test_poseidon_config(field: FieldSpec) -> PoseidonConfig:
    """``ark_poly_commit::test_sponge::<F>()``'s PoseidonConfig."""
    if field.name in _test_config_cache:
        return _test_config_cache[field.name]
    full_rounds, partial_rounds, alpha = 8, 31, 17
    mds = [[1, 0, 1], [1, 1, 0], [0, 1, 1]]
    rng = ark_std_test_rng()
    ark = [[rand_field_element_scalar(field, rng) for _ in range(3)]
           for _ in range(full_rounds + partial_rounds)]
    cfg = PoseidonConfig(field, full_rounds, partial_rounds, alpha, mds, ark, 2, 1)
    _test_config_cache[field.name] = cfg
    return cfg


class PoseidonSponge:
    """ark PoseidonSponge over canonical host ints."""

    def __init__(self, config: PoseidonConfig):
        self.cfg = config
        self.p = config.field.p
        self.state = [0] * config.state_size
        self.mode = _ABSORBING
        self.mode_index = 0  # next_absorb_index / next_squeeze_index

    def clone(self) -> "PoseidonSponge":
        s = PoseidonSponge(self.cfg)
        s.state = list(self.state)
        s.mode = self.mode
        s.mode_index = self.mode_index
        return s

    # -- permutation -------------------------------------------------------
    def _permute(self) -> None:
        cfg, p = self.cfg, self.p
        state = list(self.state)
        half_full = cfg.full_rounds // 2
        total = cfg.full_rounds + cfg.partial_rounds
        for r in range(total):
            is_full = r < half_full or r >= half_full + cfg.partial_rounds
            rc = cfg.ark[r]
            state = [(s + c) % p for s, c in zip(state, rc)]
            if is_full:
                state = [pow(s, cfg.alpha, p) for s in state]
            else:
                state[0] = pow(state[0], cfg.alpha, p)
            state = [sum(m_ij * s_j for m_ij, s_j in zip(row, state)) % p
                     for row in cfg.mds]
        self.state = state

    # -- absorb ------------------------------------------------------------
    def _absorb_internal(self, rate_start: int, elems: list[int]) -> None:
        cfg = self.cfg
        rem = elems
        while True:
            if rate_start + len(rem) <= cfg.rate:
                for i, e in enumerate(rem):
                    self.state[cfg.capacity + rate_start + i] = \
                        (self.state[cfg.capacity + rate_start + i] + e) % self.p
                self.mode = _ABSORBING
                self.mode_index = rate_start + len(rem)
                return
            num = cfg.rate - rate_start
            for i in range(num):
                self.state[cfg.capacity + rate_start + i] = \
                    (self.state[cfg.capacity + rate_start + i] + rem[i]) % self.p
            self._permute()
            rem = rem[num:]
            rate_start = 0

    # Absorbs at/above this length run the whole duplex state machine in
    # the native C++ kernel (lh_poseidon_absorb) — the 2^20 transcript
    # absorbs k=1024-element vectors (512 serial permutations), which at
    # host-int speed cost seconds.
    NATIVE_ABSORB_THRESHOLD = 16

    def absorb_field_elems(self, elems: list[int]) -> None:
        """Absorb native field elements (``Vec<F>`` in ark)."""
        if not elems:
            return
        elems = [e % self.p for e in elems]
        if len(elems) >= self.NATIVE_ABSORB_THRESHOLD and self._native_absorb(elems):
            return
        if self.mode == _ABSORBING:
            idx = self.mode_index
            if idx == self.cfg.rate:
                self._permute()
                idx = 0
            self._absorb_internal(idx, elems)
        else:
            self._permute()
            self._absorb_internal(0, elems)

    def _native_absorb(self, elems: list[int]) -> bool:
        """C++ fast path for long absorbs; bit-exact vs the Python machine
        (values pass through Montgomery form, an exact bijection)."""
        from . import native
        if not native.available():
            return False
        cfg, field = self.cfg, self.cfg.field
        nl = field.num_u64_limbs
        ark_mont = _native_ark_cache.get(field.name)
        if ark_mont is None:
            flat = [c for row in cfg.ark for c in row]
            ark_mont = native.ints_to_u64_limbs(flat, nl)
            native.to_mont_inplace(field, ark_mont)
            _native_ark_cache[field.name] = ark_mont
        state = native.ints_to_u64_limbs(self.state, nl)
        native.to_mont_inplace(field, state)
        ev = native.ints_to_u64_limbs(elems, nl)
        native.to_mont_inplace(field, ev)
        self.mode, self.mode_index = native.poseidon_absorb(
            field, ark_mont, cfg.full_rounds, cfg.partial_rounds, cfg.alpha,
            state, self.mode, self.mode_index, ev)
        native.from_mont_inplace(field, state)
        sz = nl * 8
        buf = state.tobytes()
        self.state = [int.from_bytes(buf[i * sz:(i + 1) * sz], "little")
                      for i in range(cfg.state_size)]
        return True

    def absorb_bytes(self, data: bytes) -> None:
        """Absorb a byte string with ark's u8-batch encoding (len prefix)."""
        buf = len(data).to_bytes(8, "little") + data
        usable = self.cfg.field.sponge_usable_bytes
        elems = [int.from_bytes(buf[i:i + usable], "little")
                 for i in range(0, len(buf), usable)]
        self.absorb_field_elems(elems)

    # -- squeeze -----------------------------------------------------------
    def _squeeze_internal(self, rate_start: int, count: int) -> list[int]:
        cfg = self.cfg
        out: list[int] = []
        rem = count
        while True:
            if rate_start + rem <= cfg.rate:
                out.extend(self.state[cfg.capacity + rate_start:
                                      cfg.capacity + rate_start + rem])
                self.mode = _SQUEEZING
                self.mode_index = rate_start + rem
                return out
            num = cfg.rate - rate_start
            out.extend(self.state[cfg.capacity + rate_start:
                                  cfg.capacity + rate_start + num])
            if rem != cfg.rate:  # faithful to the ark code path
                self._permute()
            rem -= num
            rate_start = 0

    def squeeze_native_field_elements(self, count: int) -> list[int]:
        if count == 0:
            return []
        if self.mode == _ABSORBING:
            self._permute()
            return self._squeeze_internal(0, count)
        idx = self.mode_index
        if idx == self.cfg.rate:
            self._permute()
            idx = 0
        return self._squeeze_internal(idx, count)

    def squeeze_bytes(self, num_bytes: int) -> bytes:
        usable = self.cfg.field.sponge_usable_bytes
        num_elems = (num_bytes + usable - 1) // usable
        elems = self.squeeze_native_field_elements(num_elems)
        sz = self.cfg.field.serialized_size
        out = b"".join(e.to_bytes(sz, "little")[:usable] for e in elems)
        return out[:num_bytes]


def test_sponge(field: FieldSpec) -> PoseidonSponge:
    """``ark_poly_commit::test_sponge::<F>()``."""
    return PoseidonSponge(test_poseidon_config(field))


# These are library functions named for ark parity, not pytest tests.
test_sponge.__test__ = False
test_poseidon_config.__test__ = False
