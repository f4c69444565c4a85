// Batched NTT over BN254 Fr (natural order in and out), every butterfly
// stage in shared memory.
//
// Replaces ligero_tpu/engine/mxu_ntt.py:_mxu_kernel_factory (mxu_ntt_pallas,
// mxu_ntt_split_pallas) and ligero_tpu/engine/pallas_ntt.py:
// _ntt_kernel_factory (ntt_pallas, ntt_pallas_fourstep).  Both TPU kernels
// compute this same function; the int8 7-bit limb matmuls of the MXU
// variant exist only to feed the TPU's matrix unit.
//
// Each row of x holds w <= n Montgomery coefficients and is zero-extended
// to n; the output is the n-point transform, optionally times a constant
// (n^-1 for an inverse, from-Montgomery for canonical output).  Outputs are
// fully reduced, so any decomposition gives the TPU kernels' bits.
//
// What bounds it on this card: operations.  A row of the 2^20-gate commit
// (2048 -> 16384) is ~100k Montgomery products, each 122 wide multiply-adds
// and ~70 carry adds once compiled, against 1.2 MB moved (64 bytes an
// element at the boundary): 4100 rows take ~10 ms of arithmetic where the
// bytes alone would take 1.4 ms.  A transform that sweeps global memory
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
//    transforms along the rows, one packed (32-byte) intermediate written
//    and read once.  A block takes as many neighbouring short transforms as
//    fill its tile, so global accesses stay contiguous runs.
//  * Where s exceeds the square of the tile limit, 2^l0 interleaved
//    two-pass transforms are joined by l0 radix-2 stages over the packed
//    intermediate (the only global stage sweep left; no shape of the
//    2^20-gate paths comes near it).
//  * Inside the tile: Gentleman-Sande stages on natural-order input, three
//    stages at a time in registers (a thread owns 8 elements between
//    barriers), stage-major twiddles so that a warp's loads are contiguous
//    and cached, no product where the twiddle is one (the last stage, half
//    of the one before it, a quarter of the one before that), and the bit
//    reversal folded into the addresses of the final store.  The products
//    themselves are field.cuh's carry chains.
//
// The host (engine/cuda_ntt.py, engine/ntt.py:ntt_plan) chooses the route
// and launches one lt_ntt_pass per pass; engine/ntt.py:ntt_structured is the
// same decomposition in plain PyTorch.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

constexpr int MAX_TILE_LOG = 12;  // 4096 elements: 132 KB with the padding
constexpr int RADIX_LOG = 3;      // stages a thread does between barriers
constexpr int MAX_THREADS = 512;  // 128 registers a thread: two 2048-element
                                  // tiles or one 4096-element tile to an SM
constexpr int IO_UNROLL = 2;      // elements in flight when loading, storing

enum Mode { COSET = 0, PASS1 = 1, PASS2 = 2 };

struct PassArgs {
  const int32_t* x;     // (rows, w, 16) limbs: input of COSET and PASS1
  uint32_t* z;          // (rows, n, 8) packed intermediate of the two passes
  int32_t* out;         // (rows, n, 16) limbs
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

__device__ __forceinline__ fr::Fe tile_load(const uint32_t* sm, int pitch,
                                            int idx) {
  fr::Fe r;
  const int p = pad(idx);
#pragma unroll
  for (int j = 0; j < fr::W; ++j) r.w[j] = sm[j * pitch + p];
  return r;
}

__device__ __forceinline__ void tile_store(uint32_t* sm, int pitch, int idx,
                                           const fr::Fe& v) {
  const int p = pad(idx);
#pragma unroll
  for (int j = 0; j < fr::W; ++j) sm[j * pitch + p] = v.w[j];
}

// LR Gentleman-Sande stages on tile bits [B, B + LR): the stages with half
// 2^(B - lg + LR - 1) down to 2^(B - lg) of the transforms whose element j
// of neighbour g sits at tile index (j << lg) + g.  A thread owns the
// 2^LR elements that differ in those bits.
template <int LR>
__device__ __forceinline__ void dif_group(uint32_t* sm, int pitch, int tile,
                                          int B, int lg,
                                          const uint32_t* __restrict__ tws) {
  constexpr int R = 1 << LR;
  const int b = B - lg;
  for (int u = threadIdx.x; u < (tile >> LR); u += blockDim.x) {
    const int ulow = u & ((1 << B) - 1);
    const int base = ulow + ((u >> B) << (B + LR));
    const int pos0 = ulow >> lg;
    fr::Fe a[R];
#pragma unroll
    for (int t = 0; t < R; ++t) a[t] = tile_load(sm, pitch, base + (t << B));
#pragma unroll
    for (int q = LR - 1; q >= 0; --q) {
      const int hb = b + q;  // log2 of this stage's half
#pragma unroll
      for (int tl = 0; tl < (1 << q); ++tl) {
        // the twiddle omega_{2h}^pos is one at pos = 0: the whole last stage,
        // and tl = 0 of every stage of the lowest group (there pos = tl)
        const bool one = hb == 0 || (b == 0 && tl == 0);
        fr::Fe tw;
        if (!one)
          tw = fr::load_packed(
              tws + (size_t)((1 << hb) + pos0 + (tl << b)) * fr::W);
#pragma unroll
        for (int th = 0; th < (1 << (LR - 1 - q)); ++th) {
          const int t = tl + (th << (q + 1));
          const fr::Fe x = a[t], y = a[t + (1 << q)];
          a[t] = fr::fe_add(x, y);
          const fr::Fe d = fr::fe_sub(x, y);
          a[t + (1 << q)] = one ? d : fr::fe_mont_mul(d, tw);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < R; ++t) tile_store(sm, pitch, base + (t << B), a[t]);
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
template <int MODE>
__global__ void __launch_bounds__(MAX_THREADS, 1) ntt_pass_kernel(PassArgs a) {
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
    fr::Fe v;
    if (MODE == PASS2) {
      v = fr::load_packed(a.z + ((((seg << a.l1) + j) << a.l2) + g) * fr::W);
      const unsigned long long ex =
          (((unsigned long long)j * (unsigned)g) << (a.lc + a.l0)) & (n - 1);
      v = fr::fe_mont_mul(v, fr::load_packed(a.pw + ex * fr::W));
    } else {
      const int rr = MODE == COSET ? g : r;
      const long long i =
          MODE == COSET
              ? (long long)j
              : i0 + ((g + ((long long)j << a.l1)) << a.l0);
      if (i < a.w) {
        v = fr::load_limbs(a.x + (row * a.w + i) * fr::L);
        if (a.pw && (rr != 0 || !a.k_is_one)) {
          const unsigned long long ex =
              ((unsigned long long)i * (unsigned)rr) & (n - 1);
          v = fr::fe_mont_mul(v, fr::load_packed(a.pw + ex * fr::W));
        }
      } else {
        v = fr::fe_zero();
      }
    }
    tile_store(sm, pitch, e, v);
  }
  __syncthreads();

  int b = lt;
  while (b > 0) {
    const int lr = b >= RADIX_LOG ? RADIX_LOG : b;
    b -= lr;
    if (lr == 3)
      dif_group<3>(sm, pitch, tile, b + lg, lg, a.tws);
    else if (lr == 2)
      dif_group<2>(sm, pitch, tile, b + lg, lg, a.tws);
    else
      dif_group<1>(sm, pitch, tile, b + lg, lg, a.tws);
  }

#pragma unroll IO_UNROLL
  for (int e = threadIdx.x; e < tile; e += blockDim.x) {
    const int g = first + (e & gmask);
    const long long q = bitrev((uint32_t)(e >> lg), lt);
    const fr::Fe v = tile_load(sm, pitch, e);
    if (MODE == COSET) {
      fr::store_limbs(a.out + (row * n + (q << a.lc) + g) * fr::L, v);
    } else if (MODE == PASS1) {
      fr::store_packed(a.z + ((((seg << a.l1) + g) << a.l2) + q) * fr::W, v);
    } else {
      const long long k = g + (q << a.l2);
      if (a.l0 == 0)
        fr::store_limbs(a.out + (row * n + (k << a.lc) + r) * fr::L, v);
      else
        fr::store_packed(a.z + ((seg << (a.l1 + a.l2)) + k) * fr::W, v);
    }
  }
}

// One Cooley-Tukey stage over the packed intermediate, a thread a
// butterfly: joins the 2^l0 interleaved two-pass transforms of a segment
// (row, r), which sit in bit-reversed order of i0.  The last stage writes
// the limbs of out's coset r.
__global__ void ntt_stage_kernel(uint32_t* __restrict__ z,
                                 int32_t* __restrict__ out,
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
  const fr::Fe x = fr::load_packed(z + (base + lo) * fr::W);
  const fr::Fe y = fr::load_packed(z + (base + hi) * fr::W);
  const fr::Fe t =
      fr::fe_mont_mul(y, fr::load_packed(tws + (half + pos) * fr::W));
  const fr::Fe u = fr::fe_add(x, t);
  const fr::Fe v = fr::fe_sub(x, t);
  if (last) {
    const long long row = seg >> lc, r = seg & ((1LL << lc) - 1);
    const long long o = (row << logn) + r;
    fr::store_limbs(out + (o + (lo << lc)) * fr::L, u);
    fr::store_limbs(out + (o + (hi << lc)) * fr::L, v);
  } else {
    fr::store_packed(z + (base + lo) * fr::W, u);
    fr::store_packed(z + (base + hi) * fr::W, v);
  }
}

template <int MODE>
cudaError_t launch_pass(const PassArgs& a, long long blocks, int lt,
                        cudaStream_t st) {
  const int tile = 1 << (lt + a.lg);
  const size_t bytes = (size_t)pad(tile) * fr::W * sizeof(uint32_t);
  if (bytes > 48 * 1024) {  // above the default limit only by opting in
    cudaError_t err = cudaFuncSetAttribute(
        ntt_pass_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return err;
  }
  int threads = tile >> RADIX_LOG;
  threads = threads < 32 ? 32 : (threads > MAX_THREADS ? MAX_THREADS : threads);
  ntt_pass_kernel<MODE><<<(unsigned)blocks, threads, bytes, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

// One pass of a transform (see ntt_pass_kernel).  mode: 0 coset (the whole
// transform in one pass), 1 and 2 the first and second of two passes.
// x: (rows, w, 16) int32 limbs; z: (rows, n, 8) packed scratch (two passes
// only); out: (rows, n, 16) int32; tws: stage-major twiddles of at least
// 2^lt entries; pw: (n, 8) packed twist table, or null for none (mode 2
// needs one).  n = 2^logn = 2^(lc + l0 + l1 + l2); lg: log2 of the
// neighbouring transforms a block takes; k_is_one: pw[0] is Montgomery one,
// so coset 0 of modes 0 and 1 skips its twist.
extern "C" int lt_ntt_pass(int mode, const void* x, void* z, void* out,
                           const void* tws, const void* pw, int w,
                           long long rows, int logn, int lc, int l0, int l1,
                           int l2, int lg, int k_is_one, void* stream) {
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
  PassArgs a = {(const int32_t*)x, (uint32_t*)z, (int32_t*)out,
                (const uint32_t*)tws, (const uint32_t*)pw,
                w, logn, lc, l0, l1, l2, lg, k_is_one};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = mode == COSET   ? launch_pass<COSET>(a, blocks, lt, st)
                    : mode == PASS1 ? launch_pass<PASS1>(a, blocks, lt, st)
                                    : launch_pass<PASS2>(a, blocks, lt, st);
  return (int)err;
}

// Stage st (l1 + l2 <= st < logn - lc) of the global stages that join the
// interleaved two-pass transforms; `last` writes out instead of z.
extern "C" int lt_ntt_stage(void* z, void* out, const void* tws,
                            long long rows, int logn, int lc, int st, int last,
                            void* stream) {
  if (rows <= 0 || lc < 0 || st < 0 || st >= logn - lc)
    return (int)cudaErrorInvalidValue;
  const long long total = rows << (logn - 1);
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  ntt_stage_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (uint32_t*)z, (int32_t*)out, (const uint32_t*)tws, logn, lc, st, total,
      last);
  return (int)cudaGetLastError();
}
