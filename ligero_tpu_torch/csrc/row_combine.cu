// Challenge-weighted row combination: lc[c] = sum_i r_i * M[i, c] mod p.
//
// Replaces ligero_tpu/engine/mxu_lc.py:_mxu_lc_kernel_factory (mxu_lc).
// The TPU kernel splits limbs into int8 pieces for its matrix unit and
// folds a REDC at the end; here each product is a CIOS Montgomery product
// and the sum is a chain of modular adds, so the result is exact whatever
// the order.  r_i is one element per row (broadcast over columns), or, with
// r_col_stride = 16, one element per (row, column): the latter serves the
// linear phase's sum_i r_i(w) u_i(w) and the verifier's spot sums.
//
// Cost on the card: one 64-byte element of M per product, so at the
// interleaved-phase shape (4100 x 2048) the pass reads 0.5 GB and is
// bandwidth-bound.  A first launch gives each thread one column and a
// chunk of rows (the grid's second axis), so the card is filled even when
// M has few columns; a second launch adds the per-chunk partial sums.  Both
// launches take a batch of B independent combinations of one shape on the
// grid's third axis: (B, rows, k) x (B, rows) -> (B, k).
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

__global__ void row_combine_partial(const int32_t* __restrict__ m,
                                    const int32_t* __restrict__ r,
                                    uint32_t* __restrict__ partial,
                                    long long rows, long long k,
                                    long long rows_per_chunk,
                                    int r_col_stride) {
  long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= k) return;
  const long long chunk = blockIdx.y, batch = blockIdx.z;
  const long long r_row = r_col_stride ? k * fr::L : fr::L;
  m += batch * rows * k * fr::L;
  r += batch * rows * r_row;
  partial += batch * gridDim.y * k * fr::W;
  const long long r0 = chunk * rows_per_chunk;
  const long long r1 = r0 + rows_per_chunk < rows ? r0 + rows_per_chunk : rows;
  fr::Fe acc = fr::fe_zero();
  for (long long i = r0; i < r1; ++i) {
    fr::Fe a = fr::load_limbs(r + i * r_row + col * r_col_stride);
    fr::Fe b = fr::load_limbs(m + (i * k + col) * fr::L);
    acc = fr::fe_add(acc, fr::fe_mont_mul(a, b));
  }
  fr::store_packed(partial + (chunk * k + col) * fr::W, acc);
}

__global__ void row_combine_finish(const uint32_t* __restrict__ partial,
                                   long long chunks, long long k,
                                   int32_t* __restrict__ out) {
  long long col = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= k) return;
  partial += (long long)blockIdx.y * chunks * k * fr::W;
  out += (long long)blockIdx.y * k * fr::L;
  fr::Fe acc = fr::fe_zero();
  for (long long c = 0; c < chunks; ++c)
    acc = fr::fe_add(acc, fr::load_packed(partial + (c * k + col) * fr::W));
  fr::store_limbs(out + col * fr::L, acc);
}

}  // namespace

// m: (batch, rows, k, 16) int32; r: (batch, rows, 16) or, with r_per_column,
// (batch, rows, k, 16); partial: (batch, chunks, k, 8) int32 scratch; out:
// (batch, k, 16) int32.
extern "C" int lt_row_combine(const void* m, const void* r, void* partial,
                              void* out, long long batch, long long rows,
                              long long k, long long chunks,
                              long long rows_per_chunk, int r_per_column,
                              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (k <= 0 || chunks <= 0 || chunks > 65535 || batch <= 0 || batch > 65535)
    return (int)cudaErrorInvalidValue;
  const int threads = 128;
  dim3 grid((unsigned)((k + threads - 1) / threads), (unsigned)chunks,
            (unsigned)batch);
  row_combine_partial<<<grid, threads, 0, st>>>(
      (const int32_t*)m, (const int32_t*)r, (uint32_t*)partial, rows, k,
      rows_per_chunk, r_per_column ? fr::L : 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 finish_grid((unsigned)((k + threads - 1) / threads), (unsigned)batch);
  row_combine_finish<<<finish_grid, threads, 0, st>>>(
      (const uint32_t*)partial, chunks, k, (int32_t*)out);
  return (int)cudaGetLastError();
}
