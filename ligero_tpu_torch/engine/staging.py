"""The shared-memory staging of the Blake2s column hash and the row
combination (``csrc/stage.cuh``), as pure functions the CPU tests reach.

Each warp of either kernel copies its columns' slice of the next rows into
a ring of shared-memory stages with cp.async and reads its own column's
element from there, 16 bytes at a time.  :func:`stage_swizzle` is where a
chunk of an element lands (``stage_swizzle`` in stage.cuh);
:func:`hash_smem_bytes` and :func:`lc_smem_bytes` are the kernels' shared
memory a block (``HashShape``, ``LcShape``).
"""

from __future__ import annotations

#: shared memory a block may use on an H100 (sm_90)
SMEM_MAX = 232448
#: warps a block of either kernel
WARPS = 4


def stage_swizzle(eb: int, c: int) -> int:
    """The xor applied to the 16-byte chunk index of local column c's
    element of ``eb`` bytes: chunk q is stored at chunk q ^ swizzle."""
    if eb == 64:
        return (c >> 1) & 3
    if eb == 48:
        return 0
    if eb in (32, 96):
        return (c >> 2) & 1
    raise ValueError(f"no staging for {eb}-byte elements")


def phase_bank_groups(eb: int, q: int, lanes) -> list[int]:
    """The 16-byte bank groups (of the 8 a 128-byte row of banks holds)
    that ``lanes`` (local columns) hit reading chunk q of their elements
    at stride ``eb``."""
    return [(c * eb // 16 + (q ^ stage_swizzle(eb, c))) % 8 for c in lanes]


def hash_smem_bytes(words: int, narrow: bool) -> int:
    """Shared memory of a block of the column hash (csrc/blake2s_cols.cu
    ``HashShape``): per warp 3 stages of two rows of its 32 columns."""
    eb = (4 if narrow else 8) * words
    return WARPS * 3 * 2 * 32 * eb


def lc_smem_bytes(words: int, m16: bool, per_column: bool,
                  rows_per_chunk: int) -> int:
    """Shared memory of a block of the row combination (csrc/row_combine.cu
    ``LcShape``): a chunk's r, packed (per-row r), then per warp 3 stages
    of RS rows of its 32 columns (RS = 4096 bytes over a row's slice, at
    least 1)."""
    ebm = (4 if m16 else 8) * words
    ebr = 8 * words if per_column else 0
    row = 32 * (ebm + ebr)
    rs = 1 if row >= 4096 else 4096 // row
    r_bytes = 0 if per_column else rows_per_chunk * 4 * words
    return r_bytes + WARPS * 3 * rs * row
