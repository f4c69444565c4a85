// Blake2s-256 of every column of a canonical codeword matrix.
//
// Replaces ligero_tpu/engine/pallas_hash.py:_blake2s_kernel_factory
// (blake2s_columns_pallas).  Column j's message is the ark serialization of
// the column: the row count as a u64 LE prefix, then each element's 4 W
// canonical little-endian bytes (the packed 16-bit limb pairs: 32 bytes for
// BN254 Fr, 48 for BLS12-377 Fq).  The digest is emitted as 8 LE words, the
// layout of blake2s_columns_pallas.
//
// One thread per column streams that column straight from the (rows, n, L)
// int32 matrix; nothing is re-laid out in memory first.  Because of the
// 8-byte prefix the message repeats every P blocks of E elements (16 P =
// E W), each period opening with the last two words of the element before
// it:
//   BN254 (W = 8, P = 1, E = 2): block b holds words 6-7 of row 2b - 1, all
//     of row 2b and words 0-5 of row 2b + 1;
//   BLS12-377 (W = 12, P = 3, E = 4): block 3q holds words 10-11 of row
//     4q - 1, all of row 4q and words 0-1 of row 4q + 1; block 3q + 1 words
//     2-11 of row 4q + 1 and 0-5 of row 4q + 2; block 3q + 2 words 6-11 of
//     row 4q + 2 and 0-9 of row 4q + 3, whose words 10-11 are carried.
// A thread loads a period's E elements at once (engine/hashops.py:
// column_block_words is the same map, held there against the
// serialization).  Any n is accepted.  A batch of B matrices of one shape,
// stacked as (B * rows, n, L), hashes in one launch: thread c < B n takes
// column c % n of matrix c / n, and every column's message opens with its
// own matrix's row count, so the digests are those of B separate launches.
//
// The streamed entry (lt_blake2s_absorb) hashes a column whose rows arrive
// in chunks: the streaming commit re-encodes the codeword matrix a row
// chunk at a time and never holds it whole.  Each column's state between
// launches is its chaining value and two carried words: a chunk of a
// multiple of E rows fills whole blocks after those two words (64 bytes per
// two BN254 rows, 192 per four BLS12-377 rows) and leaves the last two
// words of its last row, so the word map above holds in every chunk.  The
// last chunk may have any row count; its launch also makes the final
// compression with the message's full length (a 64-bit counter: nothing
// here limits a column to 2^32 bytes).  Both entries share absorb_column,
// so the digests are those of the whole-column kernel for every chunking.
//
// Cost on the card: 10 rounds x 8 G functions per 64-byte block, i.e. about
// 1000 dependent 32-bit operations per block and 2 (BN254) or 4/3
// (BLS12-377) element loads, so the kernel is bound by integer issue, not
// by memory.  With one thread per column a 16384-column matrix fills only
// ~4 warps per SM; splitting columns across threads needs a tree-free hash
// and is left to later work.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

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

__device__ __forceinline__ void g(uint32_t v[16], int a, int b, int c, int d,
                                  uint32_t x, uint32_t y) {
  v[a] = v[a] + v[b] + x;
  v[d] = rotr32(v[d] ^ v[a], 16);
  v[c] = v[c] + v[d];
  v[b] = rotr32(v[b] ^ v[c], 12);
  v[a] = v[a] + v[b] + y;
  v[d] = rotr32(v[d] ^ v[a], 8);
  v[c] = v[c] + v[d];
  v[b] = rotr32(v[b] ^ v[c], 7);
}

__device__ __forceinline__ void compress(uint32_t h[8], const uint32_t m[16],
                                         unsigned long long t, bool last) {
  uint32_t v[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    v[i] = h[i];
    v[i + 8] = blake_iv(i);
  }
  v[12] ^= (uint32_t)t;
  v[13] ^= (uint32_t)(t >> 32);
  if (last) v[14] = ~v[14];
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    g(v, 0, 4, 8, 12, m[sigma(r, 0)], m[sigma(r, 1)]);
    g(v, 1, 5, 9, 13, m[sigma(r, 2)], m[sigma(r, 3)]);
    g(v, 2, 6, 10, 14, m[sigma(r, 4)], m[sigma(r, 5)]);
    g(v, 3, 7, 11, 15, m[sigma(r, 6)], m[sigma(r, 7)]);
    g(v, 0, 5, 10, 15, m[sigma(r, 8)], m[sigma(r, 9)]);
    g(v, 1, 6, 11, 12, m[sigma(r, 10)], m[sigma(r, 11)]);
    g(v, 2, 7, 8, 13, m[sigma(r, 12)], m[sigma(r, 13)]);
    g(v, 3, 4, 9, 14, m[sigma(r, 14)], m[sigma(r, 15)]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] ^= v[i] ^ v[i + 8];
}

__host__ __device__ constexpr int gcd_int(int a, int b) {
  return b ? gcd_int(b, a % b) : a;
}

// Absorbs rows [0, rows) of one column (element r at u + r * stride) into
// the chaining value h, after the two carried words (the u64 prefix or the
// last two words of the rows before), compressing nblocks 64-byte blocks
// from block block0 on.  final: the last block is the message's last, with
// byte counter byte_len, and rows past the end read as zeros.  Not final:
// rows is a multiple of E, every block is whole, and the carry leaves with
// the last row's last two words.
template <class F>
__device__ __forceinline__ void absorb_column(
    uint32_t h[8], uint32_t& carry0, uint32_t& carry1,
    const int32_t* __restrict__ u, long long stride, long long rows,
    long long nblocks, unsigned long long block0, bool final,
    unsigned long long byte_len) {
  constexpr int W = F::W;
  constexpr int P = W / gcd_int(16, W), E = 16 / gcd_int(16, W);  // 16P = EW
  for (long long q = 0; q * P < nblocks; ++q) {
    typename F::Fe e[E];
#pragma unroll
    for (int j = 0; j < E; ++j) {
      const long long r = q * E + j;
      e[j] = r < rows ? load_limbs<W>(u + r * stride) : fe_zero<W>();
    }
#pragma unroll
    for (int bb = 0; bb < P; ++bb) {
      const long long b = q * P + bb;
      if (b < nblocks) {
        uint32_t m[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int off = 16 * bb + i - 2;  // word of the period's elements
          m[i] = off == -2   ? carry0
                 : off == -1 ? carry1
                             : e[off / W].w[off % W];
        }
        const bool last = final && b == nblocks - 1;
        const unsigned long long t =
            last ? byte_len
                 : 64ull * (block0 + (unsigned long long)(b + 1));
        compress(h, m, t, last);
      }
    }
    carry0 = e[E - 1].w[W - 2];
    carry1 = e[E - 1].w[W - 1];
  }
}

__device__ __forceinline__ void blake_init(uint32_t h[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = blake_iv(i);
  h[0] ^= 0x01010020u;  // digest 32 bytes, no key, fanout 1, depth 1
}

template <class F>
__global__ void blake2s_cols_kernel(const int32_t* __restrict__ u,
                                    long long rows, long long n,
                                    long long batch,
                                    int32_t* __restrict__ out) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= batch * n) return;
  const long long col = idx % n;
  u += (idx / n) * rows * n * F::L + col * F::L;
  uint32_t h[8];
  blake_init(h);
  const unsigned long long byte_len =
      8ull + 4ull * F::W * (unsigned long long)rows;
  uint32_t carry0 = (uint32_t)rows;  // the u64 LE prefix opens block 0
  uint32_t carry1 = (uint32_t)((unsigned long long)rows >> 32);
  absorb_column<F>(h, carry0, carry1, u, n * F::L, rows,
                   (long long)((byte_len + 63) / 64), 0, true, byte_len);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[idx * 8 + i] = (int32_t)h[i];
}

// The streamed form: one chunk of a column's rows a launch.  state: (n, 10)
// int32 per column, the chaining value (words 0-7) and the two carried
// words (8-9); block0: the 64-byte blocks compressed before this chunk.
template <class F>
__global__ void blake2s_absorb_kernel(const int32_t* __restrict__ u,
                                      long long rows, long long n,
                                      int32_t* __restrict__ state,
                                      unsigned long long block0, int final,
                                      unsigned long long byte_len) {
  const long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= n) return;
  int32_t* s = state + col * 10;
  uint32_t h[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = (uint32_t)s[i];
  uint32_t carry0 = (uint32_t)s[8], carry1 = (uint32_t)s[9];
  const long long words = 2 + (long long)F::W * rows;
  absorb_column<F>(h, carry0, carry1, u + col * F::L, n * F::L, rows,
                   final ? (words + 15) / 16 : words / 16, block0, final != 0,
                   byte_len);
#pragma unroll
  for (int i = 0; i < 8; ++i) s[i] = (int32_t)h[i];
  s[8] = (int32_t)carry0;
  s[9] = (int32_t)carry1;
}

}  // namespace

// field: a field id (field.cuh); u: (batch * rows, n, L) int32 canonical
// limbs; out: (batch * n, 8) int32 digest words.
extern "C" int lt_blake2s_cols(int field, const void* u, long long rows,
                               long long n, long long batch, void* out,
                               void* stream) {
  return with_field(field, [&](auto f) {
    const long long total = batch * n;
    if (total > 0) {
      const int threads = 128;
      blake2s_cols_kernel<decltype(f)>
          <<<(unsigned)((total + threads - 1) / threads), threads, 0,
             (cudaStream_t)stream>>>((const int32_t*)u, rows, n, batch,
                                     (int32_t*)out);
    }
    return cudaGetLastError();
  });
}

// field: a field id; u: (>= rows, n, L) int32 canonical limbs, rows [0,
// rows) absorbed; state: (n, 10) int32, updated in place; block0: blocks
// compressed before; final: also the last compression, with byte counter
// byte_len (not final: rows a multiple of the period's elements).
extern "C" int lt_blake2s_absorb(int field, const void* u, long long rows,
                                 long long n, void* state, long long block0,
                                 int final, long long byte_len, void* stream) {
  return with_field(field, [&](auto f) {
    if (n > 0) {
      const int threads = 128;
      blake2s_absorb_kernel<decltype(f)>
          <<<(unsigned)((n + threads - 1) / threads), threads, 0,
             (cudaStream_t)stream>>>(
              (const int32_t*)u, rows, n, (int32_t*)state,
              (unsigned long long)block0, final,
              (unsigned long long)byte_len);
    }
    return cudaGetLastError();
  });
}
