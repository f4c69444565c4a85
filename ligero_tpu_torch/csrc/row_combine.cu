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
// the pass reads 0.5 or 0.8 GB and is bandwidth-bound.  A first launch gives each thread one column and a
// chunk of rows (the grid's second axis), so the card is filled even when
// M has few columns; a second launch adds the per-chunk partial sums.  Both
// launches take a batch of B independent combinations of one shape on the
// grid's third axis: (B, rows, k) x (B, rows) -> (B, k).
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

template <class F>
__global__ void row_combine_partial(const int32_t* __restrict__ m,
                                    const int32_t* __restrict__ r,
                                    uint32_t* __restrict__ partial,
                                    long long rows, long long k,
                                    long long rows_per_chunk,
                                    int r_col_stride) {
  long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= k) return;
  const long long chunk = blockIdx.y, batch = blockIdx.z;
  constexpr int W = F::W, L = F::L;
  const long long r_row = r_col_stride ? k * L : L;
  m += batch * rows * k * L;
  r += batch * rows * r_row;
  partial += batch * gridDim.y * k * W;
  const long long r0 = chunk * rows_per_chunk;
  const long long r1 = r0 + rows_per_chunk < rows ? r0 + rows_per_chunk : rows;
  typename F::Fe acc = fe_zero<W>();
  for (long long i = r0; i < r1; ++i) {
    const typename F::Fe a =
        load_limbs<W>(r + i * r_row + col * r_col_stride);
    const typename F::Fe b = load_limbs<W>(m + (i * k + col) * L);
    acc = F::add(acc, F::mul(a, b));
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

// field: a field id (field.cuh); m: (batch, rows, k, L) int32; r: (batch,
// rows, L) or, with r_per_column, (batch, rows, k, L); partial: (batch,
// chunks, k, W) int32 scratch; out: (batch, k, L) int32.
extern "C" int lt_row_combine(int field, const void* m, const void* r,
                              void* partial, void* out, long long batch,
                              long long rows, long long k, long long chunks,
                              long long rows_per_chunk, int r_per_column,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (k <= 0 || chunks <= 0 || chunks > 65535 || batch <= 0 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const int threads = 128;
  return with_field(field, [&](auto f) {
    using F = decltype(f);
    dim3 grid((unsigned)((k + threads - 1) / threads), (unsigned)chunks,
              (unsigned)batch);
    row_combine_partial<F><<<grid, threads, 0, st>>>(
        (const int32_t*)m, (const int32_t*)r, (uint32_t*)partial, rows, k,
        rows_per_chunk, r_per_column ? F::L : 0);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    dim3 finish_grid((unsigned)((k + threads - 1) / threads), (unsigned)batch);
    row_combine_finish<F><<<finish_grid, threads, 0, st>>>(
        (const uint32_t*)partial, chunks, k, (int32_t*)out);
    return cudaGetLastError();
  });
}
