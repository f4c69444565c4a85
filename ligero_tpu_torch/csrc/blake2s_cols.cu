// Blake2s-256 of every column of a canonical codeword matrix.
//
// Replaces ligero_tpu/engine/pallas_hash.py:_blake2s_kernel_factory
// (blake2s_columns_pallas).  Column j's message is the ark serialization of
// the column: the row count as a u64 LE prefix, then each element's 4 W
// canonical little-endian bytes (the packed 16-bit limb pairs: 32 bytes for
// BN254 Fr, 48 for BLS12-377 Fq).  The digest is emitted as 8 LE words, the
// layout of blake2s_columns_pallas.
//
// The message of a column repeats every P blocks of E elements (16 P =
// E W): because of the 8-byte prefix each period opens with the last two
// words of the element before it:
//   BN254 (W = 8, P = 1, E = 2): block b holds words 6-7 of row 2b - 1, all
//     of row 2b and words 0-5 of row 2b + 1;
//   BLS12-377 (W = 12, P = 3, E = 4): block 3q holds words 10-11 of row
//     4q - 1, all of row 4q and words 0-1 of row 4q + 1; block 3q + 1 words
//     2-11 of row 4q + 1 and 0-5 of row 4q + 2; block 3q + 2 words 6-11 of
//     row 4q + 2 and 0-9 of row 4q + 3, whose words 10-11 are carried.
// (engine/hashops.py: column_block_words is the same map, held there
// against the serialization.)  Any n is accepted.  A batch of B matrices
// of one shape, stacked as (B * rows, n, L), hashes in one launch: column
// c < B n is column c % n of matrix c / n, and every column's message opens
// with its own matrix's row count, so the digests are those of B separate
// launches.
//
// The streamed entry (lt_blake2s_absorb) hashes a column whose rows arrive
// in chunks: the streaming commit re-encodes the codeword matrix a row
// chunk at a time and never holds it whole.  Each column's state between
// launches is its chaining value and two carried words: a chunk of a
// multiple of E rows fills whole blocks after those two words and leaves
// the last two words of its last row, so the word map above holds in every
// chunk.  The last chunk may have any row count; its launch also makes the
// final compression with the message's full length (a 64-bit counter).
// Both entries are one kernel, so the digests are those of the whole-column
// entry for every chunking.  The streamed entry reads the chunk's uint16
// limbs (the resident and streaming modes' 16-bit chunks, the JAX
// package's narrow16: a uint16 element is its packed words, the message
// words themselves); the whole-column entry reads int32 limbs.
//
// What bounds it on this card: 968 integer operations a 64-byte block as
// issued (10 rounds x 8 G x 12, and the final xors: adds, xors and
// rotations, none a multiply) against 128 (int32) or 64 (16-bit) bytes
// read, so instruction issue, not memory: at the least the card issues
// them at its four schedulers' 128 lanes an SM a cycle, the adds on the
// integer lanes or, as IMAD, on the FMA pipe's (chip_smoke.py
// INT32_ISSUE_PER_S).  The design before this one ran one thread a column,
// which loaded a period's elements and only then compressed its blocks: at
// the commit's 16384 columns that is one warp a scheduler, and nothing
// covered a load's wait.  Now each warp keeps a ring of three stages of
// two rows of its 32 columns in shared memory, filled with cp.async
// (stage.cuh) while it hashes the blocks that the stage before completes
// (a BN254 period is one stage, a BLS12-377 period two: its block 3q + 1
// reads row 4q + 1 from the stage before); a warp's columns of one row are
// contiguous in memory, so its copies are whole 128-byte lines; the lanes
// read their words from the stage, the chunks of an element swizzled so
// that no two lanes of a phase share a bank; no element is held in
// registers across a compression, and one compression body serves every
// block of a period (three unrolled would not fit the instruction cache).
// Still one thread a column: two or four lanes a column (Blake2s's row
// form, the diagonal step's words moved by shuffles) ran 2.6-3.7x slower
// at every column count measured, since a block's chain of dependent G
// steps does not shorten and the shuffles add to it (PERF.md, kernel
// table).
#include <cuda_runtime.h>

#include "field.cuh"
#include "stage.cuh"

namespace {

constexpr int WARPS = 4;  // warps a block; each warp works alone
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint32_t rotr32(uint32_t x, int r) {
  return __funnelshift_r(x, x, r);
}

__device__ __forceinline__ uint32_t blake_iv(int i) {
  constexpr uint32_t IV[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u,
                              0xa54ff53au, 0x510e527fu, 0x9b05688cu,
                              0x1f83d9abu, 0x5be0cd19u};
  return IV[i];
}

__device__ __forceinline__ int sigma(int r, int i) {
  constexpr unsigned char S[10][16] = {
      {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
      {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
      {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
      {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
      {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
      {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
      {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
      {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
      {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
      {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0}};
  return S[r][i];
}

__device__ __forceinline__ void g(uint32_t& a, uint32_t& b, uint32_t& c,
                                  uint32_t& d, uint32_t x, uint32_t y) {
  a = a + b + x;
  d = rotr32(d ^ a, 16);
  c = c + d;
  b = rotr32(b ^ c, 12);
  a = a + b + y;
  d = rotr32(d ^ a, 8);
  c = c + d;
  b = rotr32(b ^ c, 7);
}

// One compression: h the chaining value; msg(r, i) message word σ_r(i) of
// the block.
template <class Msg>
__device__ __forceinline__ void compress(uint32_t h[8], Msg msg,
                                         unsigned long long t, bool last) {
  uint32_t v[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = h[i];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[8 + i] = blake_iv(i);
  v[12] = blake_iv(4) ^ (uint32_t)t;
  v[13] = blake_iv(5) ^ (uint32_t)(t >> 32);
  v[14] = blake_iv(6) ^ (last ? FULL : 0u);
  v[15] = blake_iv(7);
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    g(v[0], v[4], v[8], v[12], msg(r, 0), msg(r, 1));
    g(v[1], v[5], v[9], v[13], msg(r, 2), msg(r, 3));
    g(v[2], v[6], v[10], v[14], msg(r, 4), msg(r, 5));
    g(v[3], v[7], v[11], v[15], msg(r, 6), msg(r, 7));
    g(v[0], v[5], v[10], v[15], msg(r, 8), msg(r, 9));
    g(v[1], v[6], v[11], v[12], msg(r, 10), msg(r, 11));
    g(v[2], v[7], v[8], v[13], msg(r, 12), msg(r, 13));
    g(v[3], v[4], v[9], v[14], msg(r, 14), msg(r, 15));
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] ^= v[i] ^ v[8 + i];
}

__host__ __device__ constexpr int gcd_int(int a, int b) {
  return b ? gcd_int(b, a % b) : a;
}

struct HashArgs {
  const void* u;  // whole-column: (batch * rows, n, L) int32; absorb:
                  // (>= rows, n, L) uint16
  long long rows;     // rows absorbed (a matrix's rows)
  long long n;        // columns of a matrix
  long long columns;  // batch * n
  long long nblocks;  // 64-byte blocks compressed
  unsigned long long block0, byte_len;
  int final;
  int32_t* state;  // absorb: (n, 10), updated in place; else null
  int32_t* out;    // whole-column: (batch * n, 8)
};

// A warp's share of shared memory: a ring of S stages of two rows of its
// 32 columns (a period is E = 2 or 4 rows: one or two stages).
template <class F, bool NARROW>
struct HashShape {
  static constexpr int W = F::W;
  static constexpr int P = W / gcd_int(16, W), E = 16 / gcd_int(16, W);
  static constexpr int SPP = E / 2;                  // stages a period
  static constexpr int EB = NARROW ? 4 * W : 8 * W;  // an element's bytes
  static constexpr int CPE = EB / 16;                // its 16-byte chunks
  static constexpr int S = 3;                        // stages in the ring
  static constexpr int STAGE = 2 * 32 * EB;
  static constexpr int WARP_BYTES = S * STAGE;
  static constexpr int SMEM = WARPS * WARP_BYTES;
  // the stage of its period in which block bb's last word arrives
  static constexpr __host__ __device__ int block_stage(int bb) {
    return ((16 * bb + 13) / W) / 2;
  }
};

// The 16 message words of block BB of a period (column lc): the two carried
// words, then words of the period's elements, each from the stage that
// holds its row: cur (the stage that completes the block) or prev (the
// stage before).
template <class Sh, bool NARROW, int BB>
__device__ __forceinline__ void block_words(uint32_t m[16],
                                            const unsigned char* cur,
                                            const unsigned char* prev, int lc,
                                            uint32_t carry0, uint32_t carry1) {
  constexpr int W = Sh::W, EB = Sh::EB;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int off = 16 * BB + i - 2;  // word of the period's elements
    if (off < 0) {
      m[i] = off == -2 ? carry0 : carry1;
    } else {
      const int e = off / W;  // the element's row in the period
      const unsigned char* st = e / 2 == Sh::block_stage(BB) ? cur : prev;
      m[i] = stage_word<EB, NARROW>(st + ((e % 2) * 32 + lc) * EB, lc, off % W);
    }
  }
}

template <class F, bool NARROW>
__global__ void __launch_bounds__(32 * WARPS)
    blake2s_kernel(const HashArgs a) {
  using Sh = HashShape<F, NARROW>;
  constexpr int W = Sh::W, P = Sh::P, SPP = Sh::SPP, EB = Sh::EB,
                CPE = Sh::CPE, S = Sh::S;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x / 32, lc = threadIdx.x % 32;  // lc: column
  unsigned char* ring = smem + warp * Sh::WARP_BYTES;
  const long long c0 = ((long long)blockIdx.x * WARPS + warp) * 32;
  const long long col = c0 + lc;
  const bool valid = col < a.columns;

  // this lane's copies: chunk j = lc + 32 t of the warp's slice of a row,
  // from row 0 of its column's matrix
  const unsigned char* src[CPE];
  uint32_t dst[CPE];
  bool copies[CPE];
#pragma unroll
  for (int t = 0; t < CPE; ++t) {
    const int j = lc + 32 * t, c = j / CPE, q = j % CPE;
    const long long cg = c0 + c;
    copies[t] = cg < a.columns;
    const long long mat = copies[t] ? cg / a.n : 0, cc = copies[t] ? cg % a.n : 0;
    src[t] = static_cast<const unsigned char*>(a.u) +
             ((mat * a.rows) * a.n + cc) * EB + 16 * q;
    dst[t] = c * EB + 16 * (q ^ stage_swizzle<EB>(c));
  }
  const long long row_bytes = a.n * EB;
  const long long stages = (a.nblocks + P - 1) / P * SPP;
  // rows 2s, 2s + 1 into the ring (rows past the message: zeros)
  auto issue = [&](long long s) {
    if (s < stages) {
      const uint32_t base = smem_addr(ring + (s % S) * Sh::STAGE);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const long long row = 2 * s + j;
        const bool zero = row >= a.rows;
#pragma unroll
        for (int t = 0; t < CPE; ++t)
          if (copies[t])
            cp_async16(base + j * 32 * EB + dst[t],
                       src[t] + (zero ? 0 : row * row_bytes), zero);
      }
    }
    cp_async_commit();
  };
  issue(0);
  issue(1);

  // the chaining value and the two carried words
  uint32_t h[8], carry0 = 0u, carry1 = 0u;
  int32_t* st = a.state ? a.state + (valid ? col : 0) * 10 : nullptr;
#pragma unroll
  for (int w = 0; w < 8; ++w)
    if (st)
      h[w] = valid ? (uint32_t)st[w] : 0u;
    else
      h[w] = blake_iv(w) ^ (w == 0 ? 0x01010020u : 0u);  // 32-byte digest, fanout 1
  if (st) {
    carry0 = valid ? (uint32_t)st[8] : 0u;
    carry1 = valid ? (uint32_t)st[9] : 0u;
  } else {  // the u64 LE row count opens block 0
    carry0 = (uint32_t)a.rows;
    carry1 = (uint32_t)((unsigned long long)a.rows >> 32);
  }
  const uint32_t carry_in0 = carry0, carry_in1 = carry1;

  for (long long s = 0; s < stages; ++s) {
    cp_async_wait<1>();  // stage s has landed (s + 1 may be in flight)
    __syncwarp();
    const unsigned char* cur = ring + (s % S) * Sh::STAGE;
    const unsigned char* prev = ring + ((s + S - 1) % S) * Sh::STAGE;
    const long long q = s / SPP;
    const int hs = (int)(s % SPP);
    // the blocks that complete in this stage, one compression body for all
    // (a period of three blocks unrolled would not fit the instruction
    // cache)
#pragma unroll 1
    for (int bb = 0; bb < P; ++bb) {
      const long long b = q * P + bb;
      if (Sh::block_stage(bb) != hs || b >= a.nblocks) continue;
      uint32_t m[16];
      switch (bb) {
        case 0:
          block_words<Sh, NARROW, 0>(m, cur, prev, lc, carry0, carry1);
          break;
        case 1:
          if constexpr (P > 1)
            block_words<Sh, NARROW, 1>(m, cur, prev, lc, carry0, carry1);
          break;
        default:
          if constexpr (P > 2)
            block_words<Sh, NARROW, 2>(m, cur, prev, lc, carry0, carry1);
          break;
      }
      const bool last = a.final && b == a.nblocks - 1;
      const unsigned long long t =
          last ? a.byte_len : 64ull * (a.block0 + (unsigned long long)(b + 1));
      compress(h, [&](int r, int x) { return m[sigma(r, x)]; }, t, last);
    }
    if (hs == SPP - 1) {  // the period's last element: its last two words
      carry0 = stage_word<EB, NARROW>(cur + (32 + lc) * EB, lc, W - 2);
      carry1 = stage_word<EB, NARROW>(cur + (32 + lc) * EB, lc, W - 1);
    }
    __syncwarp();  // stage s - 1 is read: the next issue refills its slot
    issue(s + 2);
  }
  cp_async_wait<0>();

  if (!valid) return;
#pragma unroll
  for (int w = 0; w < 8; ++w)
    if (st)
      st[w] = (int32_t)h[w];
    else
      a.out[col * 8 + w] = (int32_t)h[w];
  if (st) {
    // a final chunk keeps the carried words it came with (the plain
    // version's state); any other leaves its last row's last two
    st[8] = (int32_t)(a.final ? carry_in0 : carry0);
    st[9] = (int32_t)(a.final ? carry_in1 : carry1);
  }
}

template <class F, bool NARROW>
int launch(const HashArgs& a, cudaStream_t stream) {
  if (a.columns <= 0) return (int)cudaSuccess;
  using Sh = HashShape<F, NARROW>;
  auto kernel = blake2s_kernel<F, NARROW>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::SMEM);
  if (err != cudaSuccess) return (int)err;
  const long long per_block = 32LL * WARPS;
  kernel<<<(unsigned)((a.columns + per_block - 1) / per_block), 32 * WARPS,
           Sh::SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// field: a field id (field.cuh); u: (batch * rows, n, L) int32 canonical
// limbs; out: (batch * n, 8) int32 digest words.
extern "C" int lt_blake2s_cols(int field, const void* u, long long rows,
                               long long n, long long batch, void* out,
                               void* stream) {
  return with_field(field, [&](auto f) {
    using F = decltype(f);
    const unsigned long long byte_len =
        8ull + 4ull * F::W * (unsigned long long)rows;
    HashArgs a{u,       rows, n,        batch * n, (long long)((byte_len + 63) / 64),
               0ull,    byte_len, 1,    nullptr,   (int32_t*)out};
    return launch<F, false>(a, (cudaStream_t)stream);
  });
}

// field: a field id; u: (>= rows, n, L) canonical uint16 limbs, rows [0,
// rows) absorbed; state: (n, 10) int32, updated in place; block0: blocks
// compressed before; final: also the last compression, with byte counter
// byte_len (not final: rows a multiple of the period's elements).
extern "C" int lt_blake2s_absorb(int field, const void* u, long long rows,
                                 long long n, void* state, long long block0,
                                 int final, long long byte_len, void* stream) {
  return with_field(field, [&](auto f) {
    using F = decltype(f);
    const long long words = 2 + (long long)F::W * rows;
    HashArgs a{u,
               rows,
               n,
               n,
               final ? (words + 15) / 16 : words / 16,
               (unsigned long long)block0,
               (unsigned long long)byte_len,
               final,
               (int32_t*)state,
               nullptr};
    return launch<F, true>(a, (cudaStream_t)stream);
  });
}
