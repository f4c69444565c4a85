// Challenge-weighted row combination: lc[c] = sum_i r_i * M[i, c] mod p.
//
// Replaces ligero_tpu/engine/mxu_lc.py:_mxu_lc_kernel_factory (mxu_lc).
// Each term is REDC(r_i M_i) (Montgomery in, Montgomery out when both are
// Montgomery), so lc[c] = (sum_i r_i M_i[c]) R^-1 mod p.  r_i is one
// element per row (broadcast over the columns) or, with r per column, one
// per (row, column): the linear phase's sum_i r_i(w) u_i(w) and the
// verifier's spot sums.  A batch of B combinations of one shape, (B, rows,
// k) x (B, rows), runs in one launch (the grid's third axis).  M may be
// uint16 limbs (M16: the resident and streaming modes' chunks, the JAX
// package's narrow16), read as packed elements.  BN254 Fr and BLS12-377 Fq
// are instantiations of one template (field.cuh).
//
// What bounds it on this card: the pass reads one element of M a term
// (64 or 96 bytes in int32 limbs, 32 or 48 in 16 bits), and the least
// arithmetic a term is a W x W-word product, W^2 wide multiply-adds.  The
// design before this one paid a whole CIOS product and a modular add a
// term (about 2 W^2 + 5 W operations), more than the 16-bit chunk's bytes
// allow, gave the 1024-row chunk 256 blocks (about two warps a scheduler)
// and added the partial sums in a second launch.  Now:
//  - deferred reduction, the TPU kernel's own idea (mxu_lc.py folds one
//    REDC at the end): a thread adds its column's products r_i M_i of a
//    chunk of rows unreduced (field.cuh fe_mul_acc: W^2 wide multiply-adds
//    on fixed aligned register pairs, an even- and an odd-weighted
//    accumulator, and 2 W carry adds a term, the carries kept aside), then
//    reduces once: the fold gives S, 2W + 1 words; W + 1 Montgomery steps
//    give T = S 2^-32(W+1) mod p, and one Montgomery product by
//    K = 2^32 R mod p gives S R^-1 mod p, fully reduced.  Bounds: with
//    r < R and M < p (the callers' operands: r a sampled element < p,
//    M reduced), S < rows R p; the steps add M' p < 2^32(W+1) p, so
//    S + M' p < 2^32(2W+1) for rows < 2^32 (no word past the 2W + 1), and
//    T < S / 2^32(W+1) + p < 2p < R for rows < 2^32: fe_mont_mul's range.
//    A chunk has at most RPC_MAX = 256 rows (engine/cuda_lc.py geometry;
//    the bound, word by word: cuda_lc.deferred_sum_model).  The sum is
//    exact, so the result is sum_i REDC(r_i M_i) mod p bit for bit.
//  - the card filled and bytes in flight: a block is four warps of 32
//    columns and a chunk of rows (grid: column groups x chunks x batch),
//    the chunks sized so that the grid holds about four blocks an SM;
//    each warp brings its columns' next rows (contiguous in every row of
//    M) through a ring of shared-memory stages filled with cp.async
//    (stage.cuh) while it multiplies the rows before; r's rows of the
//    chunk are staged once in shared memory and read as broadcasts.
//  - one launch: each block writes its chunk's reduced sums, and the last
//    block of a column group to finish (an atomic ticket a column group,
//    reset by that block for the next launch) adds the chunks' sums mod p
//    and writes lc.
#include <cuda_runtime.h>

#include "field.cuh"
#include "stage.cuh"

namespace {

constexpr int THREADS = 128;  // a block: four warps of 32 columns each
constexpr int STAGES = 3;     // a warp's ring of staged rows
constexpr int RPC_MAX = 256;  // rows a chunk at most (r staged in shared memory)

// K = 2^32 R mod p: REDC(T K) = T 2^32 mod p restores the R^-1 that the
// reduction's W + 1 steps (2^-32(W+1) = R^-1 2^-32) take
template <class F>
__device__ __forceinline__ uint32_t restore_word(int j);

template <>
__device__ __forceinline__ uint32_t restore_word<Bn254Fr>(int j) {
  constexpr uint32_t K[8] = {0x15b8b9dau, 0x93e78865u, 0xb05ea154u,
                             0x16df2426u, 0x302ab839u, 0x1271b743u,
                             0xec6c226eu, 0x06bc037eu};
  return K[j];
}

template <>
__device__ __forceinline__ uint32_t restore_word<Bls12377Fq>(int j) {
  constexpr uint32_t K[12] = {0xabdcbccfu, 0xff133f67u, 0xa714cde2u,
                              0xfd57bd13u, 0x680ef04eu, 0xd5a37c3au,
                              0xa9bd68acu, 0xc63c8655u, 0x129d1948u,
                              0x2f7b4891u, 0xd3aa6ef9u, 0x00028b78u};
  return K[j];
}

// S = e + 2^32 o + 2^32W ce + 2^32(W+1) co (fe_mul_acc's accumulator) ->
// S R^-1 mod p (the bounds above)
template <class F>
__device__ __forceinline__ typename F::Fe deferred_reduce(
    const uint32_t e[2 * F::W], const uint32_t o[2 * F::W - 2],
    const uint32_t ce[F::W + 1], const uint32_t co[F::W]) {
  constexpr int W = F::W;
  uint32_t s[2 * W + 1];
  uint64_t carry = 0;
#pragma unroll
  for (int x = 0; x <= 2 * W; ++x) {  // the fold: S in 2W + 1 words
    uint64_t v = carry;
    if (x < 2 * W) v += e[x];
    if (x >= 1 && x <= 2 * W - 2) v += o[x - 1];
    if (x >= W) v += ce[x - W];
    if (x >= W + 1 && x <= 2 * W - 1) v += co[x - W - 1];
    s[x] = (uint32_t)v;
    carry = v >> 32;
  }
#pragma unroll
  for (int t = 0; t <= W; ++t) {  // s += m p 2^32t clears s[t]
    const uint32_t m = s[t] * F::NP0;
    carry = 0;
#pragma unroll
    for (int j = 0; j < W; ++j) {
      const uint64_t v = (uint64_t)m * F::p_word(j) + s[t + j] + carry;
      s[t + j] = (uint32_t)v;
      carry = v >> 32;
    }
#pragma unroll
    for (int j = t + W; j <= 2 * W; ++j) {
      const uint64_t v = (uint64_t)s[j] + carry;
      s[j] = (uint32_t)v;
      carry = v >> 32;
    }
  }
  typename F::Fe t, k;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    t.w[j] = s[W + 1 + j];
    k.w[j] = restore_word<F>(j);
  }
  return F::mul(t, k);
}

// a packed element written by another block of this launch (past L1)
template <int W>
__device__ __forceinline__ FeT<W> load_cg(const uint32_t* p) {
  FeT<W> e;
#pragma unroll
  for (int q = 0; q < W / 4; ++q) {
    const uint4 x = __ldcg(reinterpret_cast<const uint4*>(p) + q);
    e.w[4 * q] = x.x;
    e.w[4 * q + 1] = x.y;
    e.w[4 * q + 2] = x.z;
    e.w[4 * q + 3] = x.w;
  }
  return e;
}

// a warp's share of shared memory: STAGES stages of RS rows of its 32
// columns (M's elements, then r's where r is per column)
template <class F, bool M16, bool PERCOL>
struct LcShape {
  static constexpr int W = F::W;
  static constexpr int EBM = M16 ? 4 * W : 8 * W;  // an element of M
  static constexpr int EBR = PERCOL ? 8 * W : 0;   // one of r
  static constexpr int ROW = 32 * (EBM + EBR);     // a warp's slice of a row
  static constexpr int RS = ROW >= 4096 ? 1 : 4096 / ROW;  // rows a stage
  static constexpr int STAGE = RS * ROW;
  static constexpr int WARP_BYTES = STAGES * STAGE;
  static constexpr int CPM = EBM / 16, CPR = EBR / 16;  // copies a lane a row
};

// the blocks an SM the registers must allow: four, but three for
// BLS12-377's int32 matrix with r per column, which at 128 registers
// spills 56 bytes; with r per row it spills 28 bytes at four, and a build
// that gave it three ran 4100 x 2048 22 % slower (PERF.md, kernel table)
template <class F, bool M16, bool PERCOL>
__global__ void __launch_bounds__(THREADS,
                                  F::W == 12 && !M16 && PERCOL ? 3 : 4)
    row_combine_kernel(const void* __restrict__ m,
                       const int32_t* __restrict__ r,
                       uint32_t* __restrict__ partial, int* __restrict__ tickets,
                       int32_t* __restrict__ out, long long rows, long long k,
                       long long rpc) {
  using Sh = LcShape<F, M16, PERCOL>;
  using Fe = typename F::Fe;
  constexpr int W = F::W, L = F::L, EBM = Sh::EBM, EBR = Sh::EBR, RS = Sh::RS;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_block;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long chunk = blockIdx.y, batch = blockIdx.z, chunks = gridDim.y;
  const long long c0 = (long long)blockIdx.x * THREADS + warp * 32;
  const long long col = c0 + lane;
  const long long r0 = chunk * rpc;
  const long long nrows = (r0 + rpc < rows ? r0 + rpc : rows) - r0;
  const long long row0 = batch * rows + r0;  // the chunk's first row of M, r
  uint32_t* rsm = reinterpret_cast<uint32_t*>(smem);
  unsigned char* ring =
      smem + (PERCOL ? 0 : rpc * 4 * W) + warp * Sh::WARP_BYTES;

  // this lane's copies of a row: chunk j = lane + 32 t of the warp's slice
  const unsigned char* msrc[Sh::CPM];
  uint32_t mdst[Sh::CPM];
  bool mok[Sh::CPM];
#pragma unroll
  for (int t = 0; t < Sh::CPM; ++t) {
    const int j = lane + 32 * t, c = j / Sh::CPM, q = j % Sh::CPM;
    mok[t] = c0 + c < k;
    msrc[t] = static_cast<const unsigned char*>(m) + (c0 + c) * EBM + 16 * q;
    mdst[t] = c * EBM + 16 * (q ^ stage_swizzle<EBM>(c));
  }
  const unsigned char* rsrc[PERCOL ? Sh::CPR : 1];
  uint32_t rdst[PERCOL ? Sh::CPR : 1];
  bool rok[PERCOL ? Sh::CPR : 1];
  if constexpr (PERCOL) {
#pragma unroll
    for (int t = 0; t < Sh::CPR; ++t) {
      const int j = lane + 32 * t, c = j / Sh::CPR, q = j % Sh::CPR;
      rok[t] = c0 + c < k;
      rsrc[t] = reinterpret_cast<const unsigned char*>(r) + (c0 + c) * EBR +
                16 * q;
      rdst[t] = 32 * EBM + c * EBR + 16 * (q ^ stage_swizzle<EBR>(c));
    }
  }
  const int stages = (int)((nrows + RS - 1) / RS);
  auto issue = [&](int s) {
    if (s < stages) {
      const uint32_t base = smem_addr(ring + (s % STAGES) * Sh::STAGE);
#pragma unroll
      for (int j = 0; j < RS; ++j) {
        const long long i = (long long)s * RS + j;
        if (i < nrows) {
          const long long row = row0 + i;
#pragma unroll
          for (int t = 0; t < Sh::CPM; ++t)
            if (mok[t])
              cp_async16(base + j * Sh::ROW + mdst[t], msrc[t] + row * k * EBM,
                         false);
          if constexpr (PERCOL) {
#pragma unroll
            for (int t = 0; t < Sh::CPR; ++t)
              if (rok[t])
                cp_async16(base + j * Sh::ROW + rdst[t],
                           rsrc[t] + row * k * EBR, false);
          }
        }
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);
  if constexpr (!PERCOL) {  // the chunk's r, packed, once for the block,
    // while the first rows of M are in flight
    for (long long i = threadIdx.x; i < nrows; i += THREADS)
      store_packed<W>(rsm + i * W, load_limbs<W>(r + (row0 + i) * L));
    __syncthreads();
  }

  // the unreduced sum (field.cuh fe_mul_acc)
  uint32_t e[2 * W], o[2 * W - 2], ce[W + 1], co[W];
#pragma unroll
  for (int j = 0; j < 2 * W; ++j) e[j] = 0u;
#pragma unroll
  for (int j = 0; j < 2 * W - 2; ++j) o[j] = 0u;
#pragma unroll
  for (int j = 0; j <= W; ++j) ce[j] = 0u;
#pragma unroll
  for (int j = 0; j < W; ++j) co[j] = 0u;
  for (int s = 0; s < stages; ++s) {
    issue(s + STAGES - 1);
    cp_async_wait<STAGES - 1>();
    __syncwarp();
    const unsigned char* st = ring + (s % STAGES) * Sh::STAGE;
#pragma unroll
    for (int j = 0; j < RS; ++j) {
      const long long i = (long long)s * RS + j;
      if (i < nrows) {
        const Fe b = stage_elem<EBM, M16, W>(st + j * Sh::ROW + lane * EBM, lane);
        Fe a;
        if constexpr (PERCOL)
          a = stage_elem<EBR, false, W>(
              st + j * Sh::ROW + 32 * EBM + lane * EBR, lane);
        else
          a = load_packed<W>(rsm + i * W);
        F::mul_acc(e, o, ce, co, a, b);
      }
    }
    __syncwarp();  // the stage is read: the next issue may refill it
  }
  cp_async_wait<0>();
  const Fe v = deferred_reduce<F>(e, o, ce, co);

  if (chunks == 1) {
    if (col < k) store_limbs<W>(out + (batch * k + col) * L, v);
    return;
  }
  if (col < k) store_packed<W>(partial + ((batch * chunks + chunk) * k + col) * W, v);
  __threadfence();
  __syncthreads();
  int* ticket = tickets + batch * gridDim.x + blockIdx.x;
  if (threadIdx.x == 0) last_block = atomicAdd(ticket, 1) == chunks - 1;
  __syncthreads();
  if (!last_block) return;
  __threadfence();  // every chunk's sums are visible to this block
  if (col < k) {  // the chunks' sums, INFLIGHT loads at a time
    constexpr int INFLIGHT = W == 8 ? 8 : 4;
    const uint32_t* p = partial + (batch * chunks * k + col) * W;
    Fe sum = load_cg<W>(p);
    long long ch = 1;
    for (; ch + INFLIGHT <= chunks; ch += INFLIGHT) {
      Fe y[INFLIGHT];
#pragma unroll
      for (int j = 0; j < INFLIGHT; ++j) y[j] = load_cg<W>(p + (ch + j) * k * W);
#pragma unroll
      for (int j = 0; j < INFLIGHT; ++j) sum = F::add(sum, y[j]);
    }
    for (; ch < chunks; ++ch) sum = F::add(sum, load_cg<W>(p + ch * k * W));
    store_limbs<W>(out + (batch * k + col) * L, sum);
  }
  if (threadIdx.x == 0) *ticket = 0;  // ready for the next launch
}

template <class F, bool M16, bool PERCOL>
int launch(const void* m, const void* r, void* partial, void* tickets,
           void* out, long long batch, long long rows, long long k,
           long long chunks, long long rpc, cudaStream_t stream) {
  using Sh = LcShape<F, M16, PERCOL>;
  const int smem =
      (PERCOL ? 0 : (int)(rpc * 4 * F::W)) + (THREADS / 32) * Sh::WARP_BYTES;
  auto kernel = row_combine_kernel<F, M16, PERCOL>;
  // (always: the kernel's static ticket flag counts toward the default
  // 48 KiB as well)
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((k + THREADS - 1) / THREADS), (unsigned)chunks,
                  (unsigned)batch);
  kernel<<<grid, THREADS, smem, stream>>>(
      m, (const int32_t*)r, (uint32_t*)partial, (int*)tickets, (int32_t*)out,
      rows, k, rpc);
  return (int)cudaGetLastError();
}

}  // namespace

// field: a field id (field.cuh); m: (batch, rows, k, L) int32, or uint16
// with m16; r: (batch, rows, L) or, with r_per_column, (batch, rows, k,
// L); chunks of rows_per_chunk rows (the last may be short); where chunks >
// 1, partial: (batch, chunks, k, W) int32 scratch and tickets: batch x
// ceil(k / 128) int32, zero (each launch leaves them zero); out: (batch,
// k, L) int32, every element written.
extern "C" int lt_row_combine(int field, const void* m, const void* r,
                              void* partial, void* tickets, void* out,
                              long long batch, long long rows, long long k,
                              long long chunks, long long rows_per_chunk,
                              int r_per_column, int m16, void* stream) {
  if (k <= 0 || rows <= 0 || chunks <= 0 || chunks > 65535 || batch <= 0 ||
      batch > 65535 || rows_per_chunk <= 0 || rows_per_chunk > RPC_MAX ||
      (chunks - 1) * rows_per_chunk >= rows || chunks * rows_per_chunk < rows ||
      (chunks > 1 && (partial == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return with_field(field, [&](auto f) {
    using F = decltype(f);
    auto go = [&](auto kernel_launch) {
      return kernel_launch(m, r, partial, tickets, out, batch, rows, k, chunks,
                           rows_per_chunk, st);
    };
    if (m16)
      return r_per_column ? go(launch<F, true, true>) : go(launch<F, true, false>);
    return r_per_column ? go(launch<F, false, true>) : go(launch<F, false, false>);
  });
}
