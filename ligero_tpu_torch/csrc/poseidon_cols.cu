// Poseidon digests of the columns of canonical limb matrices, BN254 Fr: the
// commitment of LigeroMTPoseidonParams, its column leaves and, over the
// 2-element columns [left, right] of a level, every Merkle level above them.
//
// Replaces the sponge rounds of ligero_tpu/engine/poseidon_cols.py
// (PoseidonColumns._round / _permute / _absorb_chunk), which the JAX
// package runs as one Pallas Montgomery multiply launch per product per
// round (mont_mul_pallas, ligero_tpu/engine/pallas_kernels.py:
// _mont_mul_kernel_factory).  Here the whole sponge of a column runs in
// registers, the 39 x 3 round constants and R^2 mod p in shared memory.
//
// The schedule is ark's duplex sponge (engine/poseidon_cols.py): the first
// pair is added into the rate slots 1 and 2 with no permutation before it,
// every later pair is permute-then-add, an odd height's last element is
// added into slot 1 alone after the last permutation, then one final
// permutation; the digest is state[1] out of Montgomery form.  A
// permutation is 4 full rounds, 31 partial rounds (S-box on state[0]) and
// 4 full rounds: add the round's constants, x^17 (four squarings and a
// product), the binary MDS [[1,0,1],[1,1,0],[0,1,1]] (three adds).
//
// Every value stays below p (one lane a column) or 2p (several, see
// Lanes), which the CIOS product (field.cuh: a < R, b < p gives a result
// < p) and the add (a, b < p) need: the state starts at 0; a product of
// two reduced values is reduced; so is an add of two; the round constants
// are reduced.  An input element is canonical (or at least < R = 2^256) and
// enters as mul(x, R^2 mod p), a < R times b < p: reduced.  The digest is
// mul(state[1], 1), reduced below p.
//
// What bounds it.  A column of h rows is h/2 permutations, each a chain of
// dependent products: 31 partial rounds of one S-box (x^17: four squarings
// and a product, one after the other) and 8 full rounds of three
// independent ones.  One thread a column puts one warp on each of the
// card's 528 schedulers at 16384 columns, and the launch takes as long as
// one column alone: a warp's own chain of carry-chained multiply-adds sets
// the time, from a hundred columns to the full commit.  That warp keeps its
// scheduler's integer multiply-add issue most of the way busy (three
// matrices in one launch, three warps a scheduler, take about 2.3 times
// one, not 3: PERF.md), so at the commit the kernel is near the rate at
// which a scheduler issues this instruction mix, which is well under the
// 16.75 T 32-bit operations a second the bound counts.  The design:
// * the three S-boxes of a full round are computed side by side, their
//   products interleaved (195 products deep a permutation, not 275), and
//   with one lane a column the squarings take fr::fe_mont_sqr (28 cross
//   products, doubled, instead of 64 word products): fewer multiply-adds
//   to issue;
// * every round's body stands once in the code (one loop over the rounds,
//   the permutation once, the squarings a loop): a few thousand
//   instructions that stay in the instruction cache, where unrolled copies
//   of the permutation came to several times that;
// * G = 1, 2, 4 or 8 lanes of a warp share one column (template parameter):
//   each lane holds W / G words of every state element, and a product is a
//   distributed CIOS.  Step i broadcasts the multiplier word a_i from the
//   lane that holds it and the reduction factor m from the group's first
//   lane (__shfl_sync), every lane adds a_i b and m p over its own words,
//   and the one-word shift takes the next lane's lowest word
//   (__shfl_down_sync).  Each lane keeps the carry out of its words aside
//   (a pending word, at most 2) and folds it in at the shift, so no carry
//   crosses lanes inside the loop; at the end of the product the pending
//   words move up one lane and a carry-lookahead over the group's ballot
//   bits resolves what ripples further.  Adds resolve their carries the
//   same way, and a second lookahead (the borrows of t - 2p) makes their
//   conditional subtraction.  A product then waits on W steps of a shuffle
//   and short multiply-add chains, and G times more warps are in flight, at
//   the price of more instructions a column.
// The wrapper (engine/cuda_poseidon.py: lanes_for) picks G from the number
// of columns of the launch: past a few thousand columns one lane a column
// keeps every scheduler busy and more lanes only add instructions; below,
// the schedulers the columns leave idle take more lanes and the shorter
// chain wins (the verifier's few hundred opened columns, the small tree
// levels).
//
// Thread layout: lanes l .. l + G - 1 of a warp (l a multiple of G) hash one
// column; lane l + g holds words g W/G .. (g + 1) W/G - 1.  Column c of the
// launch is column c mod n of matrix c / n; its row r is at
// u + (c / n) batch_stride + r row_stride + (c mod n) col_stride (int32
// words), so B stacked matrices go in one launch, and a tree level is read
// as the (2, w/2, L) view of the level below, B trees in one launch.  A warp
// whose first column lies past the last exits; the other lanes past it run
// along on the last column (every shuffle takes the whole warp) and store
// nothing.
//
// The streaming commit's entry (lt_poseidon_absorb) hashes the same columns
// when their rows arrive a chunk at a time, as the streaming mode
// re-encodes them (the JAX package: PoseidonColumns.digests on a
// StreamedCodewords, ligero_tpu/engine/poseidon_cols.py:208-251): one launch
// a chunk, each column's three state words kept on the device between
// launches (96 bytes a column, written canonical), the last chunk's launch
// writing the digests.  Every chunk but the last has an even number of rows,
// so the pairs, and the state after each pair's permutation, are the whole
// column's; the zk height 4m + 3 leaves its odd row to the last chunk.  The
// two entries share one kernel and its absorb loop (absorb_rows); a chunk
// adds two 96-byte state transfers a column to a launch whose time is its
// permutations' chains.
#include <cuda_runtime.h>

#include "field.cuh"

namespace {

using F = Bn254Fr;
using Fe = F::Fe;
constexpr int W = F::W, L = F::L;
constexpr int THREADS = 128;
constexpr int FULL = 8, PARTIAL = 31, ROUNDS = FULL + PARTIAL;
// the round constants (round r, slot s at 3 r + s), then R^2 mod p; all
// Montgomery-form words below p
constexpr int CONSTS = 3 * ROUNDS + 1;
constexpr unsigned ALL = 0xffffffffu;

__constant__ uint32_t P_WORDS[W] = {0xf0000001u, 0x43e1f593u, 0x79b97091u,
                                    0x2833e848u, 0x8181585du, 0xb85045b6u,
                                    0xe131a029u, 0x30644e72u};
__constant__ uint32_t P2_WORDS[W] = {0xe0000002u, 0x87c3eb27u, 0xf372e122u,
                                     0x5067d090u, 0x0302b0bau, 0x70a08b6du,
                                     0xc2634053u, 0x60c89ce5u};  // 2p

// G lanes a column: the arithmetic on one lane's W / G words of an element.
// Values are kept below 2p, not p (lazy reduction): with 4p < R a CIOS
// product of a, b < 2p is (a b + M p) / R < 4p^2 / R + p < 2p with no final
// subtraction, an add subtracts 2p where the sum reaches it, and only the
// digest is reduced below p (canonical).
template <int G>
struct Lanes {
  static constexpr int WG = W / G;
  using E = FeT<WG>;
  int lig;           // this lane's index in its group
  uint32_t p[WG];    // its words of p
  uint32_t p2[WG];   // and of 2p

  __device__ __forceinline__ explicit Lanes(int lane) : lig(lane % G) {
#pragma unroll
    for (int j = 0; j < WG; ++j) {
      p[j] = P_WORDS[lig * WG + j];
      p2[j] = P2_WORDS[lig * WG + j];
    }
  }

  // The carry (or borrow) into this lane from the lower lanes of its group,
  // and out of the group's top lane, from per-lane generate / propagate
  // flags (never both set): read off the sum (g | q) + g of the group's
  // ballot bits, whose carry into bit i is the chain's carry into lane i.
  __device__ __forceinline__ void lookahead(bool gen, bool prop,
                                            uint32_t& cin,
                                            uint32_t& cout) const {
    constexpr uint32_t MASK = (1u << G) - 1u;
    const int base = (threadIdx.x & 31) - lig;
    const uint32_t g = (__ballot_sync(ALL, gen) >> base) & MASK;
    const uint32_t q = (__ballot_sync(ALL, prop) >> base) & MASK;
    const uint32_t s = (g | q) + g;
    cin = ((s ^ q) >> lig) & 1u;
    cout = (s >> G) & 1u;
  }

  // t - q unless that borrows (t < 2q, its words resolved; q = p or 2p)
  __device__ __forceinline__ E reduce_once(const E& t,
                                           const uint32_t (&q)[WG]) const {
    E d;
    uint64_t v = 0;
    uint32_t borrow = 0;
#pragma unroll
    for (int j = 0; j < WG; ++j) {
      v = (uint64_t)t.w[j] - q[j] - borrow;
      d.w[j] = (uint32_t)v;
      borrow = (uint32_t)(v >> 63);
    }
    bool zero = true;
#pragma unroll
    for (int j = 0; j < WG; ++j) zero &= d.w[j] == 0u;
    uint32_t bin, bout;
    lookahead(borrow != 0u, zero, bin, bout);
#pragma unroll
    for (int j = 0; j < WG; ++j) {
      v = (uint64_t)d.w[j] - bin;
      d.w[j] = (uint32_t)v;
      bin = (uint32_t)(v >> 63);
    }
    return bout ? t : d;  // a borrow out of the group: t < q
  }

  // adds cin (0 .. 2) into the words of t, then resolves the carry that
  // ripples across lanes (the value fits the group: no carry leaves it)
  __device__ __forceinline__ void resolve(E& t, uint32_t cin) const {
    uint64_t v = (uint64_t)t.w[0] + cin;
    t.w[0] = (uint32_t)v;
#pragma unroll
    for (int j = 1; j < WG; ++j) {
      v = (uint64_t)t.w[j] + (v >> 32);
      t.w[j] = (uint32_t)v;
    }
    bool ones = true;
#pragma unroll
    for (int j = 0; j < WG; ++j) ones &= t.w[j] == ALL;
    uint32_t c, unused;
    lookahead((v >> 32) != 0u, ones, c, unused);
#pragma unroll
    for (int j = 0; j < WG; ++j) {
      v = (uint64_t)t.w[j] + c;
      t.w[j] = (uint32_t)v;
      c = (uint32_t)(v >> 32);
    }
  }

  // a + b, below 2p, for a, b < 2p (a + b < 4p < 2^256 fits the group)
  __device__ __forceinline__ E add(const E& a, const E& b) const {
    E s;
    uint64_t v = 0;
#pragma unroll
    for (int j = 0; j < WG; ++j) {
      v = (uint64_t)a.w[j] + b.w[j] + (v >> 32);
      s.w[j] = (uint32_t)v;
    }
    // the carry out of the lane's words goes to the lane above
    uint32_t up = __shfl_up_sync(ALL, (uint32_t)(v >> 32), 1, G);
    if (lig == 0) up = 0u;
    resolve(s, up);
    return reduce_once(s, p2);
  }

  // REDC(a b) below 2p for a < R and b < 2p: distributed CIOS (see the
  // header); the running sum stays below b + p < 3p < 2^256.
  __device__ __forceinline__ E mul(const E& a, const E& b) const {
    E t;
#pragma unroll
    for (int j = 0; j < WG; ++j) t.w[j] = 0u;
    uint32_t pend = 0;  // carry pending at this lane's top, word (lig + 1) WG
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const uint32_t x = __shfl_sync(ALL, a.w[i % WG], i / WG, G);
      uint64_t v = 0;
#pragma unroll
      for (int j = 0; j < WG; ++j) {
        v = (uint64_t)x * b.w[j] + t.w[j] + (v >> 32);
        t.w[j] = (uint32_t)v;
      }
      const uint32_t hi_a = (uint32_t)(v >> 32);
      const uint32_t m = __shfl_sync(ALL, t.w[0] * fr::NP0, 0, G);
      v = 0;
#pragma unroll
      for (int j = 0; j < WG; ++j) {
        v = (uint64_t)m * p[j] + t.w[j] + (v >> 32);
        t.w[j] = (uint32_t)v;
      }
      const uint32_t hi_b = (uint32_t)(v >> 32);
      // divide by 2^32: the group's lowest word is 0; every lane's words
      // move down one, its top word takes the next lane's lowest plus what
      // was pending at its top (< 3 2^32 + 3: a new pending word <= 2)
      uint32_t next = __shfl_down_sync(ALL, t.w[0], 1, G);
      if (lig == G - 1) next = 0u;
#pragma unroll
      for (int j = 0; j + 1 < WG; ++j) t.w[j] = t.w[j + 1];
      v = (uint64_t)next + hi_a + hi_b + pend;
      t.w[WG - 1] = (uint32_t)v;
      pend = (uint32_t)(v >> 32);
    }
    // the pending words belong one lane up (the top lane's is 0: t < 2p)
    uint32_t up = __shfl_up_sync(ALL, pend, 1, G);
    if (lig == 0) up = 0u;
    resolve(t, up);
    return t;
  }

  __device__ __forceinline__ E sqr(const E& a) const { return mul(a, a); }

  // t mod p for t < 2p
  __device__ __forceinline__ E canonical(const E& t) const {
    return reduce_once(t, p);
  }
};

// One lane a column: the field's own chains, and its squaring.
template <>
struct Lanes<1> {
  static constexpr int WG = W;
  using E = Fe;
  int lig = 0;
  __device__ __forceinline__ explicit Lanes(int) {}
  __device__ __forceinline__ E add(const E& a, const E& b) const {
    return F::add(a, b);
  }
  __device__ __forceinline__ E mul(const E& a, const E& b) const {
    return F::mul(a, b);
  }
  __device__ __forceinline__ E sqr(const E& a) const { return F::sqr(a); }
  __device__ __forceinline__ E canonical(const E& t) const { return t; }
};

template <int WG>
__device__ __forceinline__ FeT<WG> load_part(const int32_t* src) {
  if constexpr (WG == 1) {
    const int2 v = *reinterpret_cast<const int2*>(src);
    FeT<1> r;
    r.w[0] = (uint32_t)v.x | ((uint32_t)v.y << 16);
    return r;
  } else {
    return load_limbs<WG>(src);
  }
}

template <int WG>
__device__ __forceinline__ void store_part(int32_t* dst, const FeT<WG>& a) {
  if constexpr (WG == 1) {
    *reinterpret_cast<int2*>(dst) =
        make_int2((int)(a.w[0] & 0xffffu), (int)(a.w[0] >> 16));
  } else {
    store_limbs<WG>(dst, a);
  }
}

template <int G>
struct Sponge {
  using Ops = Lanes<G>;
  using E = typename Ops::E;
  static constexpr int WG = Ops::WG;
  const Ops& o;
  const uint32_t* consts;  // shared memory

  __device__ __forceinline__ E constant(int i) const {
    E r;
#pragma unroll
    for (int j = 0; j < WG; ++j) r.w[j] = consts[i * W + o.lig * WG + j];
    return r;
  }

  // x^17: four squarings and a product
  __device__ __forceinline__ E sbox(const E& x) const {
    E y = x;
#pragma unroll 1
    for (int k = 0; k < 4; ++k) y = o.sqr(y);
    return o.mul(y, x);
  }

  __device__ __forceinline__ void mds(E s[3]) const {
    const E t0 = o.add(s[0], s[2]), t1 = o.add(s[0], s[1]),
            t2 = o.add(s[1], s[2]);
    s[0] = t0;
    s[1] = t1;
    s[2] = t2;
  }

  // the three S-boxes side by side: three independent chains
  __device__ __forceinline__ void full_round(E s[3], int r) const {
    E x[3], y[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) y[i] = x[i] = o.add(s[i], constant(3 * r + i));
#pragma unroll 1
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int i = 0; i < 3; ++i) y[i] = o.sqr(y[i]);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) s[i] = o.mul(y[i], x[i]);
    mds(s);
  }

  __device__ __forceinline__ void partial_round(E s[3], int r) const {
#pragma unroll
    for (int i = 0; i < 3; ++i) s[i] = o.add(s[i], constant(3 * r + i));
    s[0] = sbox(s[0]);
    mds(s);
  }

  // one loop over the rounds, each round's body once in the code: the
  // squarings are loops too, so a loop body is one to three products and
  // stays in the instruction cache
  __device__ __forceinline__ void permute(E s[3]) const {
#pragma unroll 1
    for (int r = 0; r < ROUNDS; ++r) {
      if (r < FULL / 2 || r >= FULL / 2 + PARTIAL)
        full_round(s, r);
      else
        partial_round(s, r);
    }
  }
};

// Rows [0, rows) of one column, from col (its row 0; rows row_stride int32
// words apart) absorbed into s: add a pair (or the odd tail alone) into the
// rate, permute, until the rows run out, so that the state is "after the
// permutation" between calls; rows = 0 is one permutation of s.  Both
// entries run it: the whole column in one call, or a chunk of its rows a
// call (an even count but in the column's last chunk, which keeps the pairs
// of the whole column).  The permutation's code stands once.
template <int G>
__device__ __forceinline__ void absorb_rows(const Sponge<G>& sp,
                                            typename Lanes<G>::E s[3],
                                            const int32_t* col, long long rows,
                                            long long row_stride) {
  using E = typename Lanes<G>::E;
  constexpr int WG = Lanes<G>::WG;
  const Lanes<G>& o = sp.o;
  const E r2 = sp.constant(CONSTS - 1);
  for (long long i = 0;;) {
    if (i < rows) {
      // to Montgomery form (a < R, R^2 mod p < p), into the rate
      s[1] = o.add(s[1], o.mul(load_part<WG>(col + i * row_stride), r2));
      if (i + 1 < rows)
        s[2] = o.add(s[2],
                     o.mul(load_part<WG>(col + (i + 1) * row_stride), r2));
    }
    i += 2;
    sp.permute(s);
    if (i >= rows) break;
  }
}

// at least G blocks an SM: 512 / G registers a thread at most, so that a
// 16384-column launch at G lanes (128 G blocks) is resident in one wave.
// state: null for the whole-column entry (each column's sponge starts at
// zero and ends in its digest); else the chunked entry's (total, 3, W) words,
// Montgomery form below p, column c's element i at state + (3 c + i) W: read
// unless first (zero then), written unless last (the digest then).
template <int G>
__global__ void __launch_bounds__(THREADS, G)
poseidon_cols_kernel(const uint32_t* __restrict__ constants,
                     const int32_t* __restrict__ u, long long rows,
                     long long n, long long total, long long row_stride,
                     long long col_stride, long long batch_stride,
                     uint32_t* state, int first, int last,
                     int32_t* __restrict__ out) {
  using Ops = Lanes<G>;
  using E = typename Ops::E;
  constexpr int WG = Ops::WG;
  __shared__ uint32_t consts[CONSTS * W];
  for (int i = threadIdx.x; i < CONSTS * W; i += THREADS)
    consts[i] = constants[i];
  __syncthreads();
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long warp_first = (tid - (threadIdx.x & 31)) / G;
  if (warp_first >= total) return;  // the whole warp: past the last column
  const long long c = tid / G < total ? tid / G : total - 1;
  const Ops o(threadIdx.x & 31);
  const Sponge<G> sp{o, consts};
  const int32_t* col = u + (c / n) * batch_stride + (c % n) * col_stride +
                       2 * WG * o.lig;
  uint32_t* mine = state + c * 3 * W + o.lig * WG;  // (used where non-null)
  E s[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    s[i] = fe_zero<WG>();
    if (!first) {
#pragma unroll
      for (int j = 0; j < WG; ++j) s[i].w[j] = mine[i * W + j];
    }
  }
  absorb_rows<G>(sp, s, col, rows, row_stride);
  if (!last) {
    // canonical (below p), so the words equal the plain version's
    if (tid / G < total) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const E v = o.canonical(s[i]);
#pragma unroll
        for (int j = 0; j < WG; ++j) mine[i * W + j] = v.w[j];
      }
    }
    return;
  }
  E one = fe_zero<WG>();
  if (o.lig == 0) one.w[0] = 1u;
  const E digest = o.canonical(o.mul(s[1], one));  // out of Montgomery form
  if (tid / G < total) store_part<WG>(out + c * L + 2 * WG * o.lig, digest);
}

template <int G>
cudaError_t launch(const void* constants, const void* u, long long rows,
                   long long n, long long total, long long row_stride,
                   long long col_stride, long long batch_stride, void* state,
                   int first, int last, void* out, cudaStream_t st) {
  const long long blocks = (total * G + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (blocks > 0)
    poseidon_cols_kernel<G><<<(unsigned)blocks, THREADS, 0, st>>>(
        (const uint32_t*)constants, (const int32_t*)u, rows, n, total,
        row_stride, col_stride, batch_stride, (uint32_t*)state, first, last,
        (int32_t*)out);
  return cudaGetLastError();
}

cudaError_t launch_lanes(int lanes, const void* constants, const void* u,
                         long long rows, long long n, long long total,
                         long long row_stride, long long col_stride,
                         long long batch_stride, void* state, int first,
                         int last, void* out, cudaStream_t st) {
  switch (lanes) {
    case 1:
      return launch<1>(constants, u, rows, n, total, row_stride, col_stride,
                       batch_stride, state, first, last, out, st);
    case 2:
      return launch<2>(constants, u, rows, n, total, row_stride, col_stride,
                       batch_stride, state, first, last, out, st);
    case 4:
      return launch<4>(constants, u, rows, n, total, row_stride, col_stride,
                       batch_stride, state, first, last, out, st);
    case 8:
      return launch<8>(constants, u, rows, n, total, row_stride, col_stride,
                       batch_stride, state, first, last, out, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// constants: (3 x 39 + 1) x 8 words on the device (round constants, then
// R^2 mod p, Montgomery form); u: batch canonical (rows, n) matrices of L
// int32 limbs, element (r, j) of matrix b at u + b batch_stride +
// r row_stride + j col_stride (int32 words, multiples of 4); lanes: 1, 2,
// 4 or 8 a column; out: (batch n, L) int32, matrix after matrix.
extern "C" int lt_poseidon_cols(const void* constants, const void* u,
                                long long rows, long long n, long long batch,
                                long long row_stride, long long col_stride,
                                long long batch_stride, int lanes, void* out,
                                void* stream) {
  if (rows < 0 || n < 0 || batch < 1 || (row_stride & 3) ||
      (col_stride & 3) || (batch_stride & 3) || n > (1LL << 40) / batch)
    return (int)cudaErrorInvalidValue;
  return (int)launch_lanes(lanes, constants, u, rows, n, n * batch,
                           row_stride, col_stride, batch_stride, nullptr, 1,
                           1, out, (cudaStream_t)stream);
}

// The streaming commit's entry: rows [0, rows) of one canonical (>= rows, n)
// chunk (element (r, j) at u + r row_stride + j col_stride int32 words)
// absorbed into the n columns' sponge states (n, 3, 8) uint32 words:
// zero-started where first, the digests written to out (n, L) int32 where
// last, else the states updated in place.  A chunk that is not the column's
// last has an even, non-zero number of rows, so the pairs of the whole
// column are kept; rows > 0.
extern "C" int lt_poseidon_absorb(const void* constants, const void* u,
                                  long long rows, long long n,
                                  long long row_stride, long long col_stride,
                                  void* state, int first, int last, int lanes,
                                  void* out, void* stream) {
  if (rows < 1 || (!last && (rows & 1)) || n < 0 || n > (1LL << 40) ||
      (row_stride & 3) || (col_stride & 3) || state == nullptr ||
      (last && out == nullptr))
    return (int)cudaErrorInvalidValue;
  return (int)launch_lanes(lanes, constants, u, rows, n, n, row_stride,
                           col_stride, 0, state, first, last, out,
                           (cudaStream_t)stream);
}
