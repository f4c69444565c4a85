// Batched NTT over BN254 Fr or BLS12-377 Fq (natural order in and out),
// every butterfly stage in shared memory.
//
// Replaces ligero_tpu/engine/mxu_ntt.py:_mxu_kernel_factory (mxu_ntt_pallas,
// mxu_ntt_split_pallas) and ligero_tpu/engine/pallas_ntt.py:
// _ntt_kernel_factory (ntt_pallas, ntt_pallas_fourstep).  Both TPU kernels
// compute this same function; the int8 7-bit limb matmuls of the MXU
// variant exist only to feed the TPU's matrix unit.  The JAX package runs
// every BLS12-377 transform through _ntt_kernel_factory (mxu_ntt takes
// 16-limb fields only); here both fields are instantiations of one template.
//
// Each row of x holds w <= n Montgomery coefficients and is zero-extended
// to n; the output is the n-point transform, optionally times a constant
// (n^-1 for an inverse, from-Montgomery for canonical output).  Outputs are
// fully reduced, so any decomposition gives the TPU kernels' bits.
//
// What bounds it on this card: operations.  A row of the 2^20-gate commit
// (2048 -> 16384) is ~100k Montgomery products, each 122 wide multiply-adds
// and ~70 carry adds once compiled for BN254 (~2.2 times as many for
// BLS12-377's 12 words), against 1.2 MB moved (64 bytes an element at the
// boundary; 96 for BLS12-377): 4100 rows take ~10 ms of arithmetic where
// the bytes alone would take 1.4 ms.  A transform that sweeps global memory
// once per stage runs at the same rate of products (the arithmetic hides
// the sweeps), so what pays is doing fewer and cheaper products, and the
// design moves every byte once only so that memory never gets in the way:
//
//  * Zero extension as cosets.  With s the least power of two >= w and
//    c = n / s, X[c q + r] = NTT_s(x[i] omega_n^(i r))[q]: c independent
//    s-point transforms of the twisted input, no work on zeros.  The twist
//    table carries the output constant too (the transform is linear), so
//    there is no epilogue product, and coset 0 needs no twist where there
//    is no constant.
//  * One pass where s fits a block's shared memory (s <= 4096): the row is
//    read once (its c blocks share it in L2), all log2 s stages run on a
//    word-major padded tile (a warp's 32-bit accesses fall in 32 banks),
//    the output is written once.  No scratch.
//  * Two passes above that: s = n1 n2, n2-point transforms down the
//    columns, the twiddle omega_s^(i1 k2) on the way into the n1-point
//    transforms along the rows, one packed (4 W-byte) intermediate written
//    and read once.  A block takes as many neighbouring short transforms as
//    fill its tile, so global accesses stay contiguous runs.
//  * Where s exceeds the square of the tile limit, 2^l0 interleaved
//    two-pass transforms are joined by l0 radix-2 stages over the packed
//    intermediate (the only global stage sweep left; no shape of the
//    2^20-gate paths comes near it).
//  * Inside the tile: Gentleman-Sande stages on natural-order input,
//    RADIX_LOG stages at a time in registers (NttShape: three for BN254, a
//    thread owning 8 elements between barriers; two for BLS12-377, 4),
//    stage-major twiddles so that a warp's loads are contiguous and
//    cached, no product where the twiddle is one (in the lowest group: the
//    last stage, half of the one before it, a quarter of the one before
//    that), and the bit reversal folded into the addresses of the final
//    store.  The products themselves are field.cuh's carry chains.  Where
//    log2 of the transform is 1 mod RADIX_LOG, its top stage is done on the
//    way in (a thread a butterfly, as it loads), so that no group of a
//    lone stage costs a round trip through the tile and the lowest group
//    skips its position-0 products in all its stages.
//  * The store goes by 16-byte chunks of the destination, the chunks of
//    consecutive destinations to consecutive threads: a warp's store then
//    covers a few runs of whole elements.  Element by element, each of its
//    16-byte stores touched 32 lines (the outputs are bit-reversed and
//    n / s apart), and the stores took ~2 ms of a 24.7 ms BLS12-377 NTT_n.
//  * BLS12-377's butterflies are lazy (NttArith): between the load and the
//    store every value lies in [0, 2p), the sum takes one conditional
//    subtraction of 2p, the difference a - b + 2p (< 4p, no reduction)
//    goes straight into a product that skips its conditional subtraction
//    (REDC(a b) < a b / R + p < 2p for any a < R), and the store reduces
//    to [0, p) once.  Every value a pass writes to memory, the packed
//    intermediate too, is fully reduced, so the global stages and any
//    decomposition give the same bits.  cuda_ntt.lazy_bound_model walks
//    these bounds through every route.  BN254's are field.cuh's fully
//    reduced forms.
//
// Storage of x and out: int32 words of 16-bit limbs, or (IN16, and
// PassArgs::out16) uint16 limbs, the resident and streaming modes' chunks
// (the JAX package's narrow16): the encode writes its coefficient and
// codeword chunks in 16 bits, the products and the openings read them, and
// no widening pass over a chunk runs.  A uint16 element is the packed
// element (field.cuh: load_limbs16), so it moves half the bytes; the
// arithmetic, and so the bits, are the same.  The output's storage is a
// run-time flag: it only sets the stride of the store's addresses.
//
// The host (engine/cuda_ntt.py, engine/ntt.py:ntt_plan) chooses the route
// and launches one lt_ntt_pass per pass; engine/ntt.py:ntt_structured is the
// same decomposition in plain PyTorch.  The route is the same for both
// fields: the tile limit counts elements, and a 4096-element BLS12-377 tile
// (202,848 bytes with the padding) still fits the 232,448 a block may use.
//
// Registers decide the rest.  __launch_bounds__(512, 1) gives a thread 128
// registers.  BN254 keeps 8 elements of 8 words in them (64) beside a
// product's temporaries; 8 elements of 12 words (96) would leave too few,
// so BLS12-377 does two stages between barriers, 4 elements (48), beside
// the product's walked operand (12), its twiddle (12) and its two
// accumulators (24).  The tile's pitch is a constant (tile_at), so an
// element's words lie at constant offsets from its word 0: with a pitch
// known only at run time ptxas held the word addresses of a thread's
// elements from their loads to their stores and spilled them (BLS12-377
// 128-156 bytes, with the fully reduced forms; BN254 244-308).  A block of
// a tile of at most 2048 elements has 256 threads: two such blocks share
// an SM (128 registers x 512 threads, 2 x 99 KiB of shared memory for
// BLS12-377), so that one computes while the other waits at a barrier or
// moves its tile.  A 4096-element tile takes 512 threads and the SM alone.
// On an H100 (PERF.md, Findings) one block of 512 threads for a
// 2048-element BLS12-377 tile ran 12 % slower, and a persistent block of
// two 256-thread groups, each with its own tile and started half a tile
// apart, was no faster than two blocks (and slower on short launches);
// holding a group's three twiddles in registers spilled, and prefetching
// them into L1 changed nothing.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int MAX_TILE_LOG = 12;  // 4096 elements: 132 KiB with the padding
                                  // (198 KiB for BLS12-377)
// The most threads a block has: __launch_bounds__(MAX_THREADS, 1) leaves
// 65536 / MAX_THREADS = 128 registers a thread, so that two blocks of
// MAX_THREADS / 2 share an SM where their tiles fit its shared memory.
constexpr int MAX_THREADS = 512;
// The largest tile of which two fit an SM's shared memory for either field
// (2 x 99 KiB for BLS12-377).
constexpr int PAIR_TILE_LOG = 11;
// The tile is word-major in segments of 2^SEG_LOG elements, each with one
// word of padding every 32 elements (a warp's accesses of one word of 32
// neighbouring elements fall in 32 banks) and one at its end, so that the
// W words of one element, SEG_PITCH apart, fall in W banks (the store
// reads them side by side).
constexpr int SEG_LOG = 11;
constexpr int SEG_PITCH = (1 << SEG_LOG) + (1 << SEG_LOG >> 5) + 1;

// The stages a thread does between barriers (see the head of this file).
template <class F>
struct NttShape {
  static constexpr int RADIX_LOG = 3;
};

template <>
struct NttShape<Bls12377Fq> {
  static constexpr int RADIX_LOG = 2;
};

// The threads of a block of a 2^tile_log-element tile: a thread each
// 2^RADIX_LOG elements, at least 32, at most MAX_THREADS, and at most
// MAX_THREADS / 2 where two such tiles fit an SM, so that two blocks share
// it (BN254's 8 elements a thread give such a tile 256 threads already).
template <class F>
constexpr int block_threads(int tile_log) {
  const int t = tile_log - NttShape<F>::RADIX_LOG;
  const int cap = tile_log <= PAIR_TILE_LOG ? 8 : 9;
  return t < 5 ? 32 : (t > cap ? 1 << cap : 1 << t);
}

// A butterfly's arithmetic.  LAZY: whether values between the load and
// the store may lie above p (cuda_ntt.LAZY_FIELDS).  BN254: field.cuh's
// fully reduced forms, every value in [0, p).
template <class F>
struct NttArith {
  static constexpr bool LAZY = false;
  using Fe = typename F::Fe;
  static __device__ __forceinline__ Fe twist(const Fe& a, const Fe& b) {
    return F::mul(a, b);
  }
  static __device__ __forceinline__ Fe out(const Fe& a) { return a; }
  static __device__ __forceinline__ Fe sum(const Fe& x, const Fe& y) {
    return F::add(x, y);
  }
  static __device__ __forceinline__ Fe diff(const Fe& x, const Fe& y) {
    return F::sub(x, y);
  }
  static __device__ __forceinline__ Fe diff_mul(const Fe& x, const Fe& y,
                                                const Fe& tw) {
    return F::mul(F::sub(x, y), tw);
  }
};

// BLS12-377: the lazy forms (see the head of this file).
template <>
struct NttArith<Bls12377Fq> {
  static constexpr bool LAZY = true;
  using Fe = fq::Fe;
  // a < R, b < p -> [0, 2p)
  static __device__ __forceinline__ Fe twist(const Fe& a, const Fe& b) {
    return fq::fe_mont_mul_2p(a, b);
  }
  // [0, 2p) -> [0, p): what a pass stores
  static __device__ __forceinline__ Fe out(const Fe& a) {
    return fq::fe_reduce_p(a);
  }
  // x, y < 2p -> x + y, x - y, (x - y) tw, each in [0, 2p), for tw < p
  static __device__ __forceinline__ Fe sum(const Fe& x, const Fe& y) {
    return fq::fe_add_2p(x, y);
  }
  static __device__ __forceinline__ Fe diff(const Fe& x, const Fe& y) {
    return fq::fe_sub_2p(x, y);
  }
  static __device__ __forceinline__ Fe diff_mul(const Fe& x, const Fe& y,
                                                const Fe& tw) {
    return fq::fe_mont_mul_2p(fq::fe_sub_4p(x, y), tw);
  }
};

enum Mode { COSET = 0, PASS1 = 1, PASS2 = 2 };

struct PassArgs {
  const void* x;        // (rows, w, L) limbs: input of COSET and PASS1
  uint32_t* z;          // (rows, n, W) packed intermediate of the two passes
  void* out;            // (rows, n, L) limbs
  const uint32_t* tws;  // stage-major twiddles: [h + pos] = omega_{2h}^pos
  const uint32_t* pw;   // twist table omega_n^e K, e < n; null for no twist
  int w, logn, lc, l0, l1, l2, lg;
  int k_is_one;         // K is Montgomery one: coset 0 needs no twist
  int out16;            // out holds uint16 limbs (else int32 words)
};

__device__ __forceinline__ uint32_t bitrev(uint32_t x, int bits) {
  return bits ? __brev(x) >> (32 - bits) : 0u;
}

__host__ __device__ __forceinline__ int pad(int idx) {
  return idx + (idx >> 5);
}

// Words of shared memory a 2^tile_log-element tile takes: whole segments.
__host__ __device__ constexpr int tile_words(int W, int tile_log) {
  return (tile_log > SEG_LOG ? 1 << (tile_log - SEG_LOG) : 1) * W * SEG_PITCH;
}

// Word j of tile element idx lives at sm[tile_at<W>(idx) + j * SEG_PITCH].
template <int W>
__device__ __forceinline__ int tile_at(int idx) {
  return (idx >> SEG_LOG) * (W * SEG_PITCH) +
         pad(idx & ((1 << SEG_LOG) - 1));
}

template <int W>
__device__ __forceinline__ FeT<W> tile_load(const uint32_t* sm, int idx) {
  FeT<W> r;
  const uint32_t* p = sm + tile_at<W>(idx);
#pragma unroll
  for (int j = 0; j < W; ++j) r.w[j] = p[j * SEG_PITCH];
  return r;
}

template <int W>
__device__ __forceinline__ void tile_store(uint32_t* sm, int idx,
                                           const FeT<W>& v) {
  uint32_t* p = sm + tile_at<W>(idx);
#pragma unroll
  for (int j = 0; j < W; ++j) p[j * SEG_PITCH] = v.w[j];
}

// LR Gentleman-Sande stages on tile bits [B, B + LR): the stages with half
// 2^(B - lg + LR - 1) down to 2^(B - lg) of the transforms whose element j
// of neighbour g sits at tile index (j << lg) + g.  A thread owns the
// 2^LR elements that differ in those bits.  OUT (the lowest group): the
// elements go back reduced for the store (NttArith::out).
template <class F, int LR, bool OUT>
__device__ __forceinline__ void dif_group(uint32_t* sm, int tile, int B,
                                          int lg,
                                          const uint32_t* __restrict__ tws) {
  using A = NttArith<F>;
  constexpr int R = 1 << LR;
  const int b = B - lg;
  for (int u = threadIdx.x; u < (tile >> LR); u += blockDim.x) {
    const int ulow = u & ((1 << B) - 1);
    const int base = ulow + ((u >> B) << (B + LR));
    const int pos0 = ulow >> lg;
    typename F::Fe a[R];
#pragma unroll
    for (int t = 0; t < R; ++t) a[t] = tile_load<F::W>(sm, base + (t << B));
#pragma unroll
    for (int q = LR - 1; q >= 0; --q) {
      const int hb = b + q;  // log2 of this stage's half
#pragma unroll
      for (int tl = 0; tl < (1 << q); ++tl) {
        // the twiddle omega_{2h}^pos is one at pos = 0: the whole last stage,
        // and tl = 0 of every stage of the lowest group (there pos = tl)
        const bool one = hb == 0 || (b == 0 && tl == 0);
        typename F::Fe tw;
        if (!one)
          tw = load_packed<F::W>(
              tws + (size_t)((1 << hb) + pos0 + (tl << b)) * F::W);
#pragma unroll
        for (int th = 0; th < (1 << (LR - 1 - q)); ++th) {
          const int t = tl + (th << (q + 1));
          const typename F::Fe x = a[t], y = a[t + (1 << q)];
          a[t] = A::sum(x, y);
          a[t + (1 << q)] = one ? A::diff(x, y) : A::diff_mul(x, y, tw);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < R; ++t)
      tile_store<F::W>(sm, base + (t << B), OUT ? A::out(a[t]) : a[t]);
  }
  __syncthreads();
}

// The store of a tile of reduced elements by 16-byte chunks: C chunks an
// element (W / 4 of packed words, or W / 2 of int32 limbs, a chunk then
// two words' four limbs), the chunks of consecutive destinations to
// consecutive threads.  Destinations run along the neighbours g where
// they lie side by side (along_g: COSET's cosets, PASS2's k2), else along
// the transform's outputs q; dst(gi, qi) is element (g, q)'s.  The tile
// holds q at bitrev(q) (Gentleman-Sande order).
template <int W, int C, class Dst>
__device__ __forceinline__ void store_chunks(const uint32_t* sm, int tile,
                                             int lt, int lg, bool along_g,
                                             Dst dst) {
  constexpr bool limbs32 = C == W / 2;
  const int gmask = (1 << lg) - 1, qmask = (1 << lt) - 1;
  for (int k = threadIdx.x; k < tile * C; k += blockDim.x) {
    const int part = k % C, eo = k / C;
    const int gi = along_g ? eo & gmask : eo >> lt;
    const int qi = along_g ? eo >> lg : eo & qmask;
    const uint32_t* s =
        sm + tile_at<W>(((int)bitrev((uint32_t)qi, lt) << lg) | gi);
    uint4* d = dst(gi, qi) + part;
    if constexpr (limbs32) {
      const uint32_t w0 = s[(2 * part) * SEG_PITCH];
      const uint32_t w1 = s[(2 * part + 1) * SEG_PITCH];
      *d = make_uint4(w0 & 0xffffu, w0 >> 16, w1 & 0xffffu, w1 >> 16);
    } else {
      *d = make_uint4(s[(4 * part) * SEG_PITCH], s[(4 * part + 1) * SEG_PITCH],
                      s[(4 * part + 2) * SEG_PITCH],
                      s[(4 * part + 3) * SEG_PITCH]);
    }
  }
}

// One pass: a block loads 2^lg neighbouring transforms of 2^lt points
// (twisting on the way in), runs every stage in shared memory, and stores
// them bit-reversed to where the next pass, or the caller, reads them.
//
//   COSET  lt = logn - lc.  Neighbours are cosets r of one row: element i
//          is x[i] pw[i r mod n]; output q goes to out[c q + r].
//   PASS1  lt = l2.  Neighbours are i1: element i2 is x[i] pw[i r mod n]
//          with i = i0 + n0 (i1 + n1 i2); output k2 goes to z[i1][k2] of
//          segment (row, r, bitrev(i0)).
//   PASS2  lt = l1.  Neighbours are k2: element i1 is z[i1][k2]
//          pw[c n0 i1 k2 mod n]; output k1 goes to position k2 + n2 k1 of
//          out's coset r (l0 = 0) or, in place, of the segment (l0 > 0).
// IN16: x holds uint16 limbs (COSET and PASS1 read x; PASS2 reads z only).
template <class F, int MODE, bool IN16>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    ntt_pass_kernel(PassArgs a) {
  using A = NttArith<F>;
  constexpr int W = F::W;
  constexpr int RL = NttShape<F>::RADIX_LOG;
  extern __shared__ uint32_t sm[];
  const int lt = MODE == COSET ? a.logn - a.lc : (MODE == PASS1 ? a.l2 : a.l1);
  const int lg = a.lg;
  const int tile = 1 << (lt + lg);
  const int gmask = (1 << lg) - 1;
  const long long n = 1LL << a.logn;

  // which transforms this block owns
  long long rest = blockIdx.x;
  const int avail = MODE == COSET ? a.lc : (MODE == PASS1 ? a.l1 : a.l2);
  const int first = (int)(rest & ((1LL << (avail - lg)) - 1)) << lg;
  rest >>= avail - lg;
  int i0 = 0, r = 0;
  if (MODE != COSET) {
    i0 = (int)(rest & ((1LL << a.l0) - 1));
    rest >>= a.l0;
    r = (int)(rest & ((1LL << a.lc) - 1));
    rest >>= a.lc;
  }
  const long long row = rest;
  const long long seg =
      (((row << a.lc) + r) << a.l0) + bitrev((uint32_t)i0, a.l0);

  // element e of the tile, twisted (for BLS12-377 in [0, 2p))
  const auto load = [&](int e) {
    const int g = first + (e & gmask), j = e >> lg;
    typename F::Fe v;
    if (MODE == PASS2) {
      v = load_packed<W>(a.z + ((((seg << a.l1) + j) << a.l2) + g) * W);
      const unsigned long long ex =
          (((unsigned long long)j * (unsigned)g) << (a.lc + a.l0)) & (n - 1);
      v = A::twist(v, load_packed<W>(a.pw + ex * W));
    } else {
      const int rr = MODE == COSET ? g : r;
      const long long i =
          MODE == COSET ? (long long)j
                        : i0 + ((g + ((long long)j << a.l1)) << a.l0);
      if (i < a.w) {
        v = load_elem<W, IN16>(a.x, row * a.w + i);
        if (a.pw && (rr != 0 || !a.k_is_one)) {
          const unsigned long long ex =
              ((unsigned long long)i * (unsigned)rr) & (n - 1);
          v = A::twist(v, load_packed<W>(a.pw + ex * W));
        }
      } else {
        v = fe_zero<W>();
      }
    }
    return v;
  };

  // lt = 1 mod RL (lt > 1): the top stage (half tile / 2) on the way in, a
  // thread a butterfly, so that the groups below take RL stages each; no
  // barrier and no round trip through the tile of its own.
  const bool top_in = lt > 1 && lt % RL == 1;
  if (top_in) {
    const int half = tile >> 1;
    const uint32_t* tw_top = a.tws + (size_t)(1 << (lt - 1)) * W;
#pragma unroll 1
    for (int e = threadIdx.x; e < half; e += blockDim.x) {
      const typename F::Fe x = load(e), y = load(e + half);
      const typename F::Fe tw = load_packed<W>(tw_top + (e >> lg) * W);
      tile_store<W>(sm, e, A::sum(x, y));
      tile_store<W>(sm, e + half, A::diff_mul(x, y, tw));
    }
  } else {
#pragma unroll 1
    for (int e = threadIdx.x; e < tile; e += blockDim.x)
      tile_store<W>(sm, e, load(e));
  }
  __syncthreads();

  // The rest RL stages at a time from the top; the lowest group takes what
  // is left (RL stages where top_in), skips the product at position 0 in
  // each of its stages, and writes its elements back reduced.
  for (int b = top_in ? lt - 1 : lt; b > 0;) {
    const int lr = b < RL ? b : RL;
    b -= lr;
    if (lr == RL) {
      if (b)
        dif_group<F, RL, false>(sm, tile, b + lg, lg, a.tws);
      else
        dif_group<F, RL, true>(sm, tile, lg, lg, a.tws);
    } else if (lr == 2) {
      if constexpr (RL > 2) dif_group<F, 2, true>(sm, tile, lg, lg, a.tws);
    } else {
      dif_group<F, 1, true>(sm, tile, lg, lg, a.tws);
    }
  }
  if (A::LAZY && lt == 0) {  // transforms of one point: reduced in place
    for (int e = threadIdx.x; e < tile; e += blockDim.x)
      tile_store<W>(sm, e, A::out(tile_load<W>(sm, e)));
    __syncthreads();
  }

  // where output (first + gi, qi) goes: the next pass's packed words (z),
  // or the caller's limbs (int32, or uint16 where out16, which are the
  // packed words too)
  const int limb_bytes = a.out16 ? 2 : 4;
  const auto dst = [&](int gi, int qi) -> uint4* {
    const int g = first + gi;
    const long long q = qi;
    long long e;
    if (MODE == COSET) {
      e = row * n + (q << a.lc) + g;
    } else if (MODE == PASS1) {
      return (uint4*)(a.z + ((((seg << a.l1) + g) << a.l2) + q) * W);
    } else {
      const long long k = g + (q << a.l2);
      if (a.l0) return (uint4*)(a.z + ((seg << (a.l1 + a.l2)) + k) * W);
      e = row * n + (k << a.lc) + r;
    }
    return (uint4*)((char*)a.out + e * 2 * W * limb_bytes);
  };
  const bool packed = MODE == PASS1 || (MODE == PASS2 && a.l0) || a.out16;
  if (packed)
    store_chunks<W, W / 4>(sm, tile, lt, lg, MODE != PASS1, dst);
  else
    store_chunks<W, W / 2>(sm, tile, lt, lg, true, dst);
}

// One Cooley-Tukey stage over the packed intermediate, a thread a
// butterfly: joins the 2^l0 interleaved two-pass transforms of a segment
// (row, r), which sit in bit-reversed order of i0.  The last stage writes
// the limbs of out's coset r (uint16 limbs where OUT16).
template <class F, bool OUT16>
__global__ void ntt_stage_kernel(uint32_t* __restrict__ z,
                                 void* __restrict__ out,
                                 const uint32_t* __restrict__ tws, int logn,
                                 int lc, int st, long long total, int last) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int ls = logn - lc;
  const long long seg = i >> (ls - 1);
  const long long k = i & ((1LL << (ls - 1)) - 1);
  const long long half = 1LL << st;
  const long long pos = k & (half - 1);
  const long long lo = ((k >> st) << (st + 1)) + pos;
  const long long hi = lo + half;
  const long long base = seg << ls;
  constexpr int W = F::W;
  const typename F::Fe x = load_packed<W>(z + (base + lo) * W);
  const typename F::Fe y = load_packed<W>(z + (base + hi) * W);
  const typename F::Fe t = F::mul(y, load_packed<W>(tws + (half + pos) * W));
  const typename F::Fe u = F::add(x, t);
  const typename F::Fe v = F::sub(x, t);
  if (last) {
    const long long row = seg >> lc, r = seg & ((1LL << lc) - 1);
    const long long o = (row << logn) + r;
    store_elem<W, OUT16>(out, o + (lo << lc), u);
    store_elem<W, OUT16>(out, o + (hi << lc), v);
  } else {
    store_packed<W>(z + (base + lo) * W, u);
    store_packed<W>(z + (base + hi) * W, v);
  }
}

// Launches one pass: the tile's segments as dynamic shared memory (past
// 48 KB only by opting in), and all of the SM's L1 as shared memory, so
// that two 2048-element tiles share it.
template <class F, int MODE, bool IN16>
cudaError_t launch_pass(const PassArgs& a, long long blocks, int lt,
                        cudaStream_t st) {
  const auto kernel = ntt_pass_kernel<F, MODE, IN16>;
  const int tile_log = lt + a.lg;
  const size_t bytes = (size_t)tile_words(F::W, tile_log) * sizeof(uint32_t);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)blocks, block_threads<F>(tile_log), bytes, st>>>(a);
  return cudaGetLastError();
}

// The pass's instantiation for its input's storage: COSET and PASS1 read
// x, PASS2 reads z only.
template <class F>
cudaError_t launch_mode(int mode, bool in16, const PassArgs& a,
                        long long blocks, int lt, cudaStream_t st) {
  if (mode == COSET)
    return in16 ? launch_pass<F, COSET, true>(a, blocks, lt, st)
                : launch_pass<F, COSET, false>(a, blocks, lt, st);
  if (mode == PASS1)
    return in16 ? launch_pass<F, PASS1, true>(a, blocks, lt, st)
                : launch_pass<F, PASS1, false>(a, blocks, lt, st);
  return launch_pass<F, PASS2, false>(a, blocks, lt, st);
}

}  // namespace

// One pass of a transform (see ntt_pass_kernel) over field id `field`
// (field.cuh).  mode: 0 coset (the whole transform in one pass), 1 and 2
// the first and second of two passes.  x: (rows, w, L) limbs, int32 or,
// with in16, uint16; z: (rows, n, W) packed scratch (two passes only);
// out: (rows, n, L) limbs, int32 or, with out16, uint16;
// tws: stage-major packed twiddles of at least 2^lt entries; pw: (n, W)
// packed twist table, or null for none (mode 2 needs one).  n = 2^logn =
// 2^(lc + l0 + l1 + l2); lg: log2 of the neighbouring transforms a block
// takes; k_is_one: pw[0] is Montgomery one, so coset 0 of modes 0 and 1
// skips its twist.
extern "C" int lt_ntt_pass(int field, int mode, const void* x, void* z,
                           void* out, const void* tws, const void* pw, int w,
                           long long rows, int logn, int lc, int l0, int l1,
                           int l2, int lg, int k_is_one, int in16, int out16,
                           void* stream) {
  if (rows <= 0 || logn < 1 || lc < 0 || l0 < 0 || l1 < 0 || l2 < 0 || lg < 0 ||
      lc + l0 + l1 + l2 != logn || w < 1 || (long long)w > (1LL << (logn - lc)))
    return (int)cudaErrorInvalidValue;
  const int lt = mode == COSET ? logn - lc : (mode == PASS1 ? l2 : l1);
  const int avail = mode == COSET ? lc : (mode == PASS1 ? l1 : l2);
  if (mode < COSET || mode > PASS2 || lg > avail || lt + lg > MAX_TILE_LOG ||
      (mode == COSET && (l0 || l1)) || (mode == PASS2 && !pw))
    return (int)cudaErrorInvalidValue;
  // blocks: rows x cosets x (i0, and the other pass's index) / neighbours
  const long long blocks = rows << (logn - lt - lg);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  PassArgs a = {x, (uint32_t*)z, out, (const uint32_t*)tws,
                (const uint32_t*)pw, w, logn, lc, l0, l1, l2, lg, k_is_one,
                out16 != 0};
  cudaStream_t st = (cudaStream_t)stream;
  return with_field(field, [&](auto f) {
    return launch_mode<decltype(f)>(mode, in16 != 0, a, blocks, lt, st);
  });
}

// Stage st (l1 + l2 <= st < logn - lc) of the global stages that join the
// interleaved two-pass transforms; `last` writes out (uint16 limbs with
// out16) instead of z.
extern "C" int lt_ntt_stage(int field, void* z, void* out, const void* tws,
                            long long rows, int logn, int lc, int st,
                            int last, int out16, void* stream) {
  if (rows <= 0 || lc < 0 || st < 0 || st >= logn - lc)
    return (int)cudaErrorInvalidValue;
  const long long total = rows << (logn - 1);
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return with_field(field, [&](auto f) {
    using F = decltype(f);
    auto kernel = out16 ? ntt_stage_kernel<F, true> : ntt_stage_kernel<F, false>;
    kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (uint32_t*)z, out, (const uint32_t*)tws, logn, lc, st, total, last);
    return cudaGetLastError();
  });
}
