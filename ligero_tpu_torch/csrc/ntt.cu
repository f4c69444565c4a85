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
//  * Inside the tile: Gentleman-Sande stages on natural-order input, three
//    stages at a time in registers for BN254 (a thread owns 8 elements
//    between barriers), two for BLS12-377 (see NttShape), stage-major
//    twiddles so that a warp's loads are contiguous
//    and cached, no product where the twiddle is one (the last stage, half
//    of the one before it, a quarter of the one before that), and the bit
//    reversal folded into the addresses of the final store.  The products
//    themselves are field.cuh's carry chains.
//
// Storage of x and out: int32 words of 16-bit limbs, or (template
// parameters IN16 / OUT16) uint16 limbs, the resident and streaming modes'
// chunks (the JAX package's narrow16): the encode writes its coefficient
// and codeword chunks in 16 bits, the products and the openings read them,
// and no widening pass over a chunk runs.  A uint16 element is the packed
// element (field.cuh: load_limbs16), so it moves half the bytes; the
// arithmetic, and so the bits, are the same.
//
// The host (engine/cuda_ntt.py, engine/ntt.py:ntt_plan) chooses the route
// and launches one lt_ntt_pass per pass; engine/ntt.py:ntt_structured is the
// same decomposition in plain PyTorch.  The route is the same for both
// fields: the tile limit counts elements, and a 4096-element BLS12-377 tile
// (202,752 bytes with the padding) still fits the 232,448 a block may use.
//
// Registers decide the rest.  __launch_bounds__(512, 1) gives a thread 128
// registers.  BN254 keeps 8 elements of 8 words in them (64) beside a
// product's temporaries; 8 elements of 12 words (96) would leave too few,
// so BLS12-377 does two stages between barriers, 4 elements (48), at the
// same 512 threads and one block to an SM.  On an H100 this shape, with
// ptxas's 128-152 bytes of spill, beat two stages at 256 threads (no
// spill) and three stages at 256 or 512 threads (PERF.md, Findings).
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int MAX_TILE_LOG = 12;  // 4096 elements: 132 KB with the padding
                                  // (198 KB for BLS12-377)
constexpr int IO_UNROLL = 2;      // elements in flight when loading, storing
// The most threads a block has: __launch_bounds__(MAX_THREADS, 1) leaves
// 65536 / MAX_THREADS = 128 registers a thread (two 2048-element BN254
// tiles or one other tile to an SM).
constexpr int MAX_THREADS = 512;

// The stages a thread does between barriers (see the head of this file).
template <class F>
struct NttShape {
  static constexpr int RADIX_LOG = 3;
};

template <>
struct NttShape<Bls12377Fq> {
  static constexpr int RADIX_LOG = 2;
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
};

__device__ __forceinline__ uint32_t bitrev(uint32_t x, int bits) {
  return bits ? __brev(x) >> (32 - bits) : 0u;
}

// Word-major tile with one word of padding every 32 elements: word j of
// element idx lives at sm[j * pitch + pad(idx)].
__host__ __device__ __forceinline__ int pad(int idx) {
  return idx + (idx >> 5);
}

template <int W>
__device__ __forceinline__ FeT<W> tile_load(const uint32_t* sm, int pitch,
                                            int idx) {
  FeT<W> r;
  const int p = pad(idx);
#pragma unroll
  for (int j = 0; j < W; ++j) r.w[j] = sm[j * pitch + p];
  return r;
}

template <int W>
__device__ __forceinline__ void tile_store(uint32_t* sm, int pitch, int idx,
                                           const FeT<W>& v) {
  const int p = pad(idx);
#pragma unroll
  for (int j = 0; j < W; ++j) sm[j * pitch + p] = v.w[j];
}

// LR Gentleman-Sande stages on tile bits [B, B + LR): the stages with half
// 2^(B - lg + LR - 1) down to 2^(B - lg) of the transforms whose element j
// of neighbour g sits at tile index (j << lg) + g.  A thread owns the
// 2^LR elements that differ in those bits.
template <class F, int LR>
__device__ __forceinline__ void dif_group(uint32_t* sm, int pitch, int tile,
                                          int B, int lg,
                                          const uint32_t* __restrict__ tws) {
  constexpr int R = 1 << LR;
  const int b = B - lg;
  for (int u = threadIdx.x; u < (tile >> LR); u += blockDim.x) {
    const int ulow = u & ((1 << B) - 1);
    const int base = ulow + ((u >> B) << (B + LR));
    const int pos0 = ulow >> lg;
    typename F::Fe a[R];
#pragma unroll
    for (int t = 0; t < R; ++t) a[t] = tile_load<F::W>(sm, pitch, base + (t << B));
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
          a[t] = F::add(x, y);
          const typename F::Fe d = F::sub(x, y);
          a[t + (1 << q)] = one ? d : F::mul(d, tw);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < R; ++t)
      tile_store<F::W>(sm, pitch, base + (t << B), a[t]);
  }
  __syncthreads();
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
// IN16 / OUT16: x / out hold uint16 limbs (PASS1 reads x only, PASS2
// writes out only).
template <class F, int MODE, bool IN16, bool OUT16>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    ntt_pass_kernel(PassArgs a) {
  constexpr int W = F::W;
  extern __shared__ uint32_t sm[];
  const int lt = MODE == COSET ? a.logn - a.lc : (MODE == PASS1 ? a.l2 : a.l1);
  const int lg = a.lg;
  const int tile = 1 << (lt + lg);
  const int pitch = pad(tile);
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

#pragma unroll IO_UNROLL
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    const int g = first + (e & gmask), j = e >> lg;
    typename F::Fe v;
    if (MODE == PASS2) {
      v = load_packed<W>(a.z + ((((seg << a.l1) + j) << a.l2) + g) * W);
      const unsigned long long ex =
          (((unsigned long long)j * (unsigned)g) << (a.lc + a.l0)) & (n - 1);
      v = F::mul(v, load_packed<W>(a.pw + ex * W));
    } else {
      const int rr = MODE == COSET ? g : r;
      const long long i =
          MODE == COSET
              ? (long long)j
              : i0 + ((g + ((long long)j << a.l1)) << a.l0);
      if (i < a.w) {
        v = load_elem<W, IN16>(a.x, row * a.w + i);
        if (a.pw && (rr != 0 || !a.k_is_one)) {
          const unsigned long long ex =
              ((unsigned long long)i * (unsigned)rr) & (n - 1);
          v = F::mul(v, load_packed<W>(a.pw + ex * W));
        }
      } else {
        v = fe_zero<W>();
      }
    }
    tile_store<W>(sm, pitch, e, v);
  }
  __syncthreads();

  constexpr int RADIX_LOG = NttShape<F>::RADIX_LOG;
  int b = lt;
  while (b > 0) {
    const int lr = b >= RADIX_LOG ? RADIX_LOG : b;
    b -= lr;
    if (lr == RADIX_LOG)
      dif_group<F, RADIX_LOG>(sm, pitch, tile, b + lg, lg, a.tws);
    else if (lr == 2)
      dif_group<F, 2>(sm, pitch, tile, b + lg, lg, a.tws);
    else
      dif_group<F, 1>(sm, pitch, tile, b + lg, lg, a.tws);
  }

#pragma unroll IO_UNROLL
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    const int g = first + (e & gmask);
    const long long q = bitrev((uint32_t)(e >> lg), lt);
    const typename F::Fe v = tile_load<W>(sm, pitch, e);
    if (MODE == COSET) {
      store_elem<W, OUT16>(a.out, row * n + (q << a.lc) + g, v);
    } else if (MODE == PASS1) {
      store_packed<W>(a.z + ((((seg << a.l1) + g) << a.l2) + q) * W, v);
    } else {
      const long long k = g + (q << a.l2);
      if (a.l0 == 0)
        store_elem<W, OUT16>(a.out, row * n + (k << a.lc) + r, v);
      else
        store_packed<W>(a.z + ((seg << (a.l1 + a.l2)) + k) * W, v);
    }
  }
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

template <class F, int MODE, bool IN16, bool OUT16>
cudaError_t launch_pass(const PassArgs& a, long long blocks, int lt,
                        cudaStream_t st) {
  const int tile = 1 << (lt + a.lg);
  const size_t bytes = (size_t)pad(tile) * F::W * sizeof(uint32_t);
  if (bytes > 48 * 1024) {  // above the default limit only by opting in
    cudaError_t err = cudaFuncSetAttribute(
        ntt_pass_kernel<F, MODE, IN16, OUT16>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  int threads = tile >> NttShape<F>::RADIX_LOG;
  threads = threads < 32 ? 32 : (threads > MAX_THREADS ? MAX_THREADS : threads);
  ntt_pass_kernel<F, MODE, IN16, OUT16>
      <<<(unsigned)blocks, threads, bytes, st>>>(a);
  return cudaGetLastError();
}

// The pass's instantiation for its storage: COSET reads x and writes out,
// PASS1 reads x only, PASS2 writes out only.
template <class F>
cudaError_t launch_mode(int mode, bool in16, bool out16, const PassArgs& a,
                        long long blocks, int lt, cudaStream_t st) {
  if (mode == COSET) {
    if (in16)
      return out16 ? launch_pass<F, COSET, true, true>(a, blocks, lt, st)
                   : launch_pass<F, COSET, true, false>(a, blocks, lt, st);
    return out16 ? launch_pass<F, COSET, false, true>(a, blocks, lt, st)
                 : launch_pass<F, COSET, false, false>(a, blocks, lt, st);
  }
  if (mode == PASS1)
    return in16 ? launch_pass<F, PASS1, true, false>(a, blocks, lt, st)
                : launch_pass<F, PASS1, false, false>(a, blocks, lt, st);
  return out16 ? launch_pass<F, PASS2, false, true>(a, blocks, lt, st)
               : launch_pass<F, PASS2, false, false>(a, blocks, lt, st);
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
                (const uint32_t*)pw, w, logn, lc, l0, l1, l2, lg, k_is_one};
  cudaStream_t st = (cudaStream_t)stream;
  return with_field(field, [&](auto f) {
    return launch_mode<decltype(f)>(mode, in16 != 0, out16 != 0, a, blocks,
                                    lt, st);
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
