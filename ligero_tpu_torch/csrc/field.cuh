// BN254 scalar field Fr for the Hopper kernels of ligero_tpu_torch.
//
// An element is 8 little-endian 32-bit words.  Montgomery form uses
// R = 2^256, the JAX package's radix (ligero_tpu/engine/fieldops.py and
// ligero_tpu/fields.py: R = 2^(16 L) with L = 16), so a Montgomery value
// is the same integer on both sides of the Python boundary.
//
// At that boundary an element is 16 int32 lanes, each holding one 16-bit
// limb (the JAX package's (..., L) layout).  load_limbs/store_limbs pack
// and unpack limb pairs; kernels keep scratch data in the packed form
// (32 bytes per element instead of 64).
//
// Products are CIOS Montgomery multiplication over 32-bit words.  For
// a < R and b < p the result before the final conditional subtraction is
// below 2p, so the output is fully reduced (< p).  That is the bound the
// sparse r^T A fold relies on (its lo/hi halves are < R).
#pragma once

#include <cstdint>

namespace fr {

constexpr int W = 8;                 // 32-bit words per element
constexpr int L = 16;                // 16-bit limbs per element (Python side)
constexpr uint32_t NP0 = 0xefffffffu;  // -p^-1 mod 2^32

struct Fe {
  uint32_t w[W];
};

__device__ __forceinline__ uint32_t p_word(int j) {
  constexpr uint32_t P[W] = {0xf0000001u, 0x43e1f593u, 0x79b97091u,
                             0x2833e848u, 0x8181585du, 0xb85045b6u,
                             0xe131a029u, 0x30644e72u};
  return P[j];
}

__device__ __forceinline__ Fe fe_zero() {
  Fe r;
#pragma unroll
  for (int j = 0; j < W; ++j) r.w[j] = 0u;
  return r;
}

// The arithmetic below is written as PTX carry chains (add.cc / addc,
// mad.lo.cc / madc.hi.cc), where the same steps in 64-bit C cost a wide
// multiply-add and two adds each.  A chain is one asm statement, so nothing
// can come between a carry and its use.

// d = t - p over W words; returns true when t >= p.
__device__ __forceinline__ bool sub_p(const uint32_t t[W], uint32_t d[W]) {
  uint32_t borrow;
  asm(
      "sub.cc.u32 %0, %9, 0xf0000001;\n\t"
      "subc.cc.u32 %1, %10, 0x43e1f593;\n\t"
      "subc.cc.u32 %2, %11, 0x79b97091;\n\t"
      "subc.cc.u32 %3, %12, 0x2833e848;\n\t"
      "subc.cc.u32 %4, %13, 0x8181585d;\n\t"
      "subc.cc.u32 %5, %14, 0xb85045b6;\n\t"
      "subc.cc.u32 %6, %15, 0xe131a029;\n\t"
      "subc.cc.u32 %7, %16, 0x30644e72;\n\t"
      "subc.u32 %8, 0, 0;\n\t"
      : "=&r"(d[0]), "=&r"(d[1]), "=&r"(d[2]), "=&r"(d[3]), "=&r"(d[4]),
        "=&r"(d[5]), "=&r"(d[6]), "=&r"(d[7]), "=&r"(borrow)
      : "r"(t[0]), "r"(t[1]), "r"(t[2]), "r"(t[3]), "r"(t[4]), "r"(t[5]),
        "r"(t[6]), "r"(t[7]));
  return borrow == 0u;
}

// a + b mod p for a, b < p.
__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b) {
  Fe s, d;
  // a + b < 2p < 2^255: no carry out of the top word
  asm(
      "add.cc.u32 %0, %8, %16;\n\t"
      "addc.cc.u32 %1, %9, %17;\n\t"
      "addc.cc.u32 %2, %10, %18;\n\t"
      "addc.cc.u32 %3, %11, %19;\n\t"
      "addc.cc.u32 %4, %12, %20;\n\t"
      "addc.cc.u32 %5, %13, %21;\n\t"
      "addc.cc.u32 %6, %14, %22;\n\t"
      "addc.u32 %7, %15, %23;\n\t"
      : "=&r"(s.w[0]), "=&r"(s.w[1]), "=&r"(s.w[2]), "=&r"(s.w[3]),
        "=&r"(s.w[4]), "=&r"(s.w[5]), "=&r"(s.w[6]), "=&r"(s.w[7])
      : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]),
        "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]), "r"(b.w[0]), "r"(b.w[1]),
        "r"(b.w[2]), "r"(b.w[3]), "r"(b.w[4]), "r"(b.w[5]), "r"(b.w[6]),
        "r"(b.w[7]));
  return sub_p(s.w, d.w) ? d : s;
}

// a - b mod p for a, b < p.
__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b) {
  Fe d;
  uint32_t borrow;  // all ones when a < b
  asm(
      "sub.cc.u32 %0, %9, %17;\n\t"
      "subc.cc.u32 %1, %10, %18;\n\t"
      "subc.cc.u32 %2, %11, %19;\n\t"
      "subc.cc.u32 %3, %12, %20;\n\t"
      "subc.cc.u32 %4, %13, %21;\n\t"
      "subc.cc.u32 %5, %14, %22;\n\t"
      "subc.cc.u32 %6, %15, %23;\n\t"
      "subc.cc.u32 %7, %16, %24;\n\t"
      "subc.u32 %8, 0, 0;\n\t"
      : "=&r"(d.w[0]), "=&r"(d.w[1]), "=&r"(d.w[2]), "=&r"(d.w[3]),
        "=&r"(d.w[4]), "=&r"(d.w[5]), "=&r"(d.w[6]), "=&r"(d.w[7]),
        "=&r"(borrow)
      : "r"(a.w[0]), "r"(a.w[1]), "r"(a.w[2]), "r"(a.w[3]), "r"(a.w[4]),
        "r"(a.w[5]), "r"(a.w[6]), "r"(a.w[7]), "r"(b.w[0]), "r"(b.w[1]),
        "r"(b.w[2]), "r"(b.w[3]), "r"(b.w[4]), "r"(b.w[5]), "r"(b.w[6]),
        "r"(b.w[7]));
  // d += p where the subtraction borrowed
  asm(
      "add.cc.u32 %0, %0, %8;\n\t"
      "addc.cc.u32 %1, %1, %9;\n\t"
      "addc.cc.u32 %2, %2, %10;\n\t"
      "addc.cc.u32 %3, %3, %11;\n\t"
      "addc.cc.u32 %4, %4, %12;\n\t"
      "addc.cc.u32 %5, %5, %13;\n\t"
      "addc.cc.u32 %6, %6, %14;\n\t"
      "addc.u32 %7, %7, %15;\n\t"
      : "+r"(d.w[0]), "+r"(d.w[1]), "+r"(d.w[2]), "+r"(d.w[3]), "+r"(d.w[4]),
        "+r"(d.w[5]), "+r"(d.w[6]), "+r"(d.w[7])
      : "r"(p_word(0) & borrow), "r"(p_word(1) & borrow),
        "r"(p_word(2) & borrow), "r"(p_word(3) & borrow),
        "r"(p_word(4) & borrow), "r"(p_word(5) & borrow),
        "r"(p_word(6) & borrow), "r"(p_word(7) & borrow));
  return d;
}

// One CIOS step of the product: T = (T + v b + p m) / 2^32 with m chosen
// to clear T's lowest word.  T is kept as two interleaved accumulators,
// T = e + 2^32 o, so that every 32 x 32 product lands on an aligned pair of
// words: mad.lo.cc / madc.hi.cc on such a pair is one wide multiply-add
// with carry.  v's even words feed e, its odd words o; dividing by 2^32
// swaps the roles (the caller alternates the arguments), and the word that
// falls between the pairs, o[1] of the step before, is folded into e[0]
// first.  On entry e is the step before's o and o its e (whose lowest word
// is 0); on exit e[0] is 0.  No carry is lost while v < p (T < 2p after
// every step, whatever b).
__device__ __forceinline__ void cios_step(uint32_t e[W], uint32_t o[W],
                                          const uint32_t v[W], uint32_t b) {
  asm(
      "add.cc.u32 %0, %0, %2;\n\t"
      "madc.lo.cc.u32 %1, %9, %13, %3;\n\t"
      "madc.hi.cc.u32 %2, %9, %13, %4;\n\t"
      "madc.lo.cc.u32 %3, %10, %13, %5;\n\t"
      "madc.hi.cc.u32 %4, %10, %13, %6;\n\t"
      "madc.lo.cc.u32 %5, %11, %13, %7;\n\t"
      "madc.hi.cc.u32 %6, %11, %13, %8;\n\t"
      "madc.lo.cc.u32 %7, %12, %13, 0;\n\t"
      "madc.hi.u32 %8, %12, %13, 0;\n\t"
      : "+r"(e[0]), "+r"(o[0]), "+r"(o[1]), "+r"(o[2]), "+r"(o[3]), "+r"(o[4]),
        "+r"(o[5]), "+r"(o[6]), "+r"(o[7])
      : "r"(v[1]), "r"(v[3]), "r"(v[5]), "r"(v[7]), "r"(b));
  asm(
      "mad.lo.cc.u32 %0, %9, %13, %0;\n\t"
      "madc.hi.cc.u32 %1, %9, %13, %1;\n\t"
      "madc.lo.cc.u32 %2, %10, %13, %2;\n\t"
      "madc.hi.cc.u32 %3, %10, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, %11, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, %11, %13, %5;\n\t"
      "madc.lo.cc.u32 %6, %12, %13, %6;\n\t"
      "madc.hi.cc.u32 %7, %12, %13, %7;\n\t"
      "addc.u32 %8, %8, 0;\n\t"
      : "+r"(e[0]), "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]), "+r"(e[5]),
        "+r"(e[6]), "+r"(e[7]), "+r"(o[7])
      : "r"(v[0]), "r"(v[2]), "r"(v[4]), "r"(v[6]), "r"(b));
}

// e + 2^32 o += p m, m = -e[0] / p mod 2^32: clears e[0].
__device__ __forceinline__ void cios_reduce(uint32_t e[W], uint32_t o[W]) {
  const uint32_t m = e[0] * NP0;
  asm(
      "mad.lo.cc.u32 %0, 0x43e1f593, %8, %0;\n\t"
      "madc.hi.cc.u32 %1, 0x43e1f593, %8, %1;\n\t"
      "madc.lo.cc.u32 %2, 0x2833e848, %8, %2;\n\t"
      "madc.hi.cc.u32 %3, 0x2833e848, %8, %3;\n\t"
      "madc.lo.cc.u32 %4, 0xb85045b6, %8, %4;\n\t"
      "madc.hi.cc.u32 %5, 0xb85045b6, %8, %5;\n\t"
      "madc.lo.cc.u32 %6, 0x30644e72, %8, %6;\n\t"
      "madc.hi.u32 %7, 0x30644e72, %8, %7;\n\t"
      : "+r"(o[0]), "+r"(o[1]), "+r"(o[2]), "+r"(o[3]), "+r"(o[4]), "+r"(o[5]),
        "+r"(o[6]), "+r"(o[7])
      : "r"(m));
  asm(
      "mad.lo.cc.u32 %0, 0xf0000001, %9, %0;\n\t"
      "madc.hi.cc.u32 %1, 0xf0000001, %9, %1;\n\t"
      "madc.lo.cc.u32 %2, 0x79b97091, %9, %2;\n\t"
      "madc.hi.cc.u32 %3, 0x79b97091, %9, %3;\n\t"
      "madc.lo.cc.u32 %4, 0x8181585d, %9, %4;\n\t"
      "madc.hi.cc.u32 %5, 0x8181585d, %9, %5;\n\t"
      "madc.lo.cc.u32 %6, 0xe131a029, %9, %6;\n\t"
      "madc.hi.cc.u32 %7, 0xe131a029, %9, %7;\n\t"
      "addc.u32 %8, %8, 0;\n\t"
      : "+r"(e[0]), "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]), "+r"(e[5]),
        "+r"(e[6]), "+r"(e[7]), "+r"(o[7])
      : "r"(m));
}

// REDC(a * b) = a * b * 2^-256 mod p, fully reduced, for a < R and b < p.
// b is the vector operand of every step and a's words the multipliers, so
// that the running sum stays below 2p though a may exceed p.
__device__ __forceinline__ Fe fe_mont_mul(const Fe& a, const Fe& b) {
  uint32_t x[W], y[W];
#pragma unroll
  for (int j = 0; j < W; j += 2) {
    const uint64_t ev = (uint64_t)b.w[j] * a.w[0];
    const uint64_t od = (uint64_t)b.w[j + 1] * a.w[0];
    x[j] = (uint32_t)ev;
    x[j + 1] = (uint32_t)(ev >> 32);
    y[j] = (uint32_t)od;
    y[j + 1] = (uint32_t)(od >> 32);
  }
  cios_reduce(x, y);
#pragma unroll
  for (int i = 1; i < W; i += 2) {
    cios_step(y, x, b.w, a.w[i]);
    cios_reduce(y, x);
    if (i + 1 < W) {
      cios_step(x, y, b.w, a.w[i + 1]);
      cios_reduce(x, y);
    }
  }
  // after the eighth step e = y, o = x: the result is e / 2^32 + o
  Fe r, d;
  uint32_t top;
  asm(
      "add.cc.u32 %0, %9, %17;\n\t"
      "addc.cc.u32 %1, %10, %18;\n\t"
      "addc.cc.u32 %2, %11, %19;\n\t"
      "addc.cc.u32 %3, %12, %20;\n\t"
      "addc.cc.u32 %4, %13, %21;\n\t"
      "addc.cc.u32 %5, %14, %22;\n\t"
      "addc.cc.u32 %6, %15, %23;\n\t"
      "addc.cc.u32 %7, %16, 0;\n\t"
      "addc.u32 %8, 0, 0;\n\t"
      : "=&r"(r.w[0]), "=&r"(r.w[1]), "=&r"(r.w[2]), "=&r"(r.w[3]),
        "=&r"(r.w[4]), "=&r"(r.w[5]), "=&r"(r.w[6]), "=&r"(r.w[7]), "=&r"(top)
      : "r"(x[0]), "r"(x[1]), "r"(x[2]), "r"(x[3]), "r"(x[4]), "r"(x[5]),
        "r"(x[6]), "r"(x[7]),
        "r"(y[1]), "r"(y[2]), "r"(y[3]), "r"(y[4]), "r"(y[5]), "r"(y[6]), "r"(y[7]));
  bool ge = sub_p(r.w, d.w);
  return (top != 0u || ge) ? d : r;
}

// 16 int32 limbs (< 2^16 each) -> packed element.  src must be 16-byte
// aligned (every (..., 16) int32 row is).
__device__ __forceinline__ Fe load_limbs(const int32_t* src) {
  const int4* s = reinterpret_cast<const int4*>(src);
  Fe r;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    int4 v = s[q];
    r.w[2 * q] = (uint32_t)v.x | ((uint32_t)v.y << 16);
    r.w[2 * q + 1] = (uint32_t)v.z | ((uint32_t)v.w << 16);
  }
  return r;
}

__device__ __forceinline__ void store_limbs(int32_t* dst, const Fe& a) {
  int4* d = reinterpret_cast<int4*>(dst);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    d[q] = make_int4((int)(a.w[2 * q] & 0xffffu), (int)(a.w[2 * q] >> 16),
                     (int)(a.w[2 * q + 1] & 0xffffu),
                     (int)(a.w[2 * q + 1] >> 16));
  }
}

// packed element (8 words, 32-byte aligned)
__device__ __forceinline__ Fe load_packed(const uint32_t* src) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4 a = s[0], b = s[1];
  Fe r;
  r.w[0] = a.x; r.w[1] = a.y; r.w[2] = a.z; r.w[3] = a.w;
  r.w[4] = b.x; r.w[5] = b.y; r.w[6] = b.z; r.w[7] = b.w;
  return r;
}

__device__ __forceinline__ void store_packed(uint32_t* dst, const Fe& a) {
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(a.w[0], a.w[1], a.w[2], a.w[3]);
  d[1] = make_uint4(a.w[4], a.w[5], a.w[6], a.w[7]);
}

}  // namespace fr
