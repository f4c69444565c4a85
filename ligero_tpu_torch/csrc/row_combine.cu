// Challenge-weighted row combination: lc[c] = sum_i r_i * M[i, c] mod p.
//
// Replaces ligero_tpu/engine/mxu_lc.py:_mxu_lc_kernel_factory (mxu_lc).
// The TPU kernel splits limbs into int8 pieces for its matrix unit and
// folds a REDC at the end; here each product is a CIOS Montgomery product
// and the sum is a chain of modular adds, so the result is exact whatever
// the order.  r_i is one element per row (broadcast over columns), or, with
// r_col_stride = L, one element per (row, column): the latter serves the
// linear phase's sum_i r_i(w) u_i(w) and the verifier's spot sums.  BN254
// Fr and BLS12-377 Fq are instantiations of one template (field.cuh).
//
// Cost on the card: one 8 W-byte element of M per product (64 bytes for
// BN254, 96 for BLS12-377), so at the interleaved-phase shape (4100 x 2048)
// the pass reads 0.5 or 0.8 GB and is bound by bandwidth, as long as enough
// loads are in flight.  A first launch gives each thread one column and a
// chunk of rows (the grid's second axis), so the card is filled even when
// M has few columns; a second launch adds the per-chunk partial sums.  Both
// launches take a batch of B independent combinations of one shape on the
// grid's third axis: (B, rows, k) x (B, rows) -> (B, k).  Loads in flight:
// a thread issues the next row's two operand loads before the current
// row's product (a register double buffer), so each thread has a row's
// loads in flight while its product runs: at 12 words the product (~350
// operations) no longer hides behind one row's loads.  The loads are
// unconditional (the last row of a chunk loads itself again) and a compiler
// barrier stands between them and the product, or the compiler sinks them
// below it into the next iteration's wait.  At least four blocks of four
// warps an SM (launch bounds: 128 registers a thread) keep four warps a
// scheduler.  M may be uint16 limbs (template parameter M16: the resident
// and streaming modes' coefficient chunks, the JAX package's narrow16),
// read as packed elements: half the bytes of M, which is what bounds the
// pass, and the same sums.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

template <class F, bool M16>
__global__ void __launch_bounds__(128, 4)
row_combine_partial(const void* __restrict__ m,
                    const int32_t* __restrict__ r,
                    uint32_t* __restrict__ partial, long long rows,
                    long long k, long long rows_per_chunk, int r_col_stride) {
  long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= k) return;
  const long long chunk = blockIdx.y, batch = blockIdx.z;
  constexpr int W = F::W, L = F::L;
  using Fe = typename F::Fe;
  const long long r_row = r_col_stride ? k * L : L;
  const long long m0 = batch * rows * k + col;  // element of M's row 0
  r += batch * rows * r_row + col * r_col_stride;
  partial += batch * gridDim.y * k * W;
  const long long r0 = chunk * rows_per_chunk;
  const long long r1 = r0 + rows_per_chunk < rows ? r0 + rows_per_chunk : rows;
  Fe acc = fe_zero<W>();
  if (r0 < r1) {
    Fe a = load_limbs<W>(r + r0 * r_row),
       b = load_elem<W, M16>(m, m0 + r0 * k);
    for (long long i = r0; i < r1; ++i) {
      // the next row's operands (the last row's own again: no branch for
      // the compiler to sink below the product), then a barrier that keeps
      // the loads ahead of this row's product
      const long long next = i + 1 < r1 ? i + 1 : i;
      const Fe a_next = load_limbs<W>(r + next * r_row);
      const Fe b_next = load_elem<W, M16>(m, m0 + next * k);
      asm volatile("" ::: "memory");
      acc = F::add(acc, F::mul(a, b));
      a = a_next;
      b = b_next;
    }
  }
  store_packed<W>(partial + (chunk * k + col) * W, acc);
}

template <class F>
__global__ void row_combine_finish(const uint32_t* __restrict__ partial,
                                   long long chunks, long long k,
                                   int32_t* __restrict__ out) {
  constexpr int W = F::W;
  long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= k) return;
  partial += (long long)blockIdx.y * chunks * k * W;
  out += (long long)blockIdx.y * k * F::L;
  typename F::Fe acc = fe_zero<W>();
  for (long long c = 0; c < chunks; ++c)
    acc = F::add(acc, load_packed<W>(partial + (c * k + col) * W));
  store_limbs<W>(out + col * F::L, acc);
}

}  // namespace

// field: a field id (field.cuh); m: (batch, rows, k, L) int32, or uint16
// with m16; r: (batch,
// rows, L) or, with r_per_column, (batch, rows, k, L); partial: (batch,
// chunks, k, W) int32 scratch; out: (batch, k, L) int32.
extern "C" int lt_row_combine(int field, const void* m, const void* r,
                              void* partial, void* out, long long batch,
                              long long rows, long long k, long long chunks,
                              long long rows_per_chunk, int r_per_column,
                              int m16, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (k <= 0 || chunks <= 0 || chunks > 65535 || batch <= 0 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const int threads = 128;
  return with_field(field, [&](auto f) {
    using F = decltype(f);
    dim3 grid((unsigned)((k + threads - 1) / threads), (unsigned)chunks,
              (unsigned)batch);
    auto partial_kernel =
        m16 ? row_combine_partial<F, true> : row_combine_partial<F, false>;
    partial_kernel<<<grid, threads, 0, st>>>(
        m, (const int32_t*)r, (uint32_t*)partial, rows, k, rows_per_chunk,
        r_per_column ? F::L : 0);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dim3 finish_grid((unsigned)((k + threads - 1) / threads), (unsigned)batch);
    row_combine_finish<F><<<finish_grid, threads, 0, st>>>(
        (const uint32_t*)partial, chunks, k, (int32_t*)out);
    return cudaGetLastError();
  });
}
