// The two prime fields of the Hopper kernels of ligero_tpu_torch: BN254
// Fr (namespace fr, 8 words) and BLS12-377 Fq (namespace fq, 12 words).
//
// An element is W little-endian 32-bit words.  Montgomery form uses
// R = 2^(32 W), the JAX package's radix (ligero_tpu/fields.py: R = 2^(16 L),
// L = 16 or 24), so a Montgomery value is the same integer on both sides of
// the Python boundary.
//
// At that boundary an element is L = 2 W int32 lanes, each holding one
// 16-bit limb (the JAX package's (..., L) layout).  load_limbs/store_limbs
// pack and unpack limb pairs; kernels keep scratch data in the packed form
// (4 W bytes per element instead of 8 W).
//
// Products are CIOS Montgomery multiplication over 32-bit words.  For
// a < R and b < p the result before the final conditional subtraction is
// below 2p, so the output is fully reduced (< p).  That is the bound the
// sparse r^T A fold relies on (its lo/hi halves are < R).  BN254's p is
// below 2^254 and BLS12-377's below 2^377, so 2p leaves the top word room
// in both.
//
// A kernel is a template over a field trait (Bn254Fr, Bls12377Fq at the end
// of this file): W, L, the id the C entry points take, and the arithmetic.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

template <int W_>
struct FeT {
  uint32_t w[W_];
};

namespace fr {

constexpr int W = 8;                 // 32-bit words per element
constexpr int L = 16;                // 16-bit limbs per element (Python side)
constexpr uint32_t NP0 = 0xefffffffu;  // -p^-1 mod 2^32

using Fe = FeT<W>;

__device__ __forceinline__ uint32_t p_word(int j) {
  constexpr uint32_t P[W] = {0xf0000001u, 0x43e1f593u, 0x79b97091u,
                             0x2833e848u, 0x8181585du, 0xb85045b6u,
                             0xe131a029u, 0x30644e72u};
  return P[j];
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

}  // namespace fr

namespace fq {

constexpr int W = 12;                // 32-bit words per element
constexpr int L = 24;                // 16-bit limbs per element (Python side)
constexpr uint32_t NP0 = 0xffffffffu;  // -p^-1 mod 2^32 (p = 1 mod 2^32)

using Fe = FeT<W>;

__device__ __forceinline__ uint32_t p_word(int j) {
  constexpr uint32_t P[W] = {0x00000001u, 0x8508c000u, 0x30000000u,
                             0x170b5d44u, 0xba094800u, 0x1ef3622fu,
                             0x00f5138fu, 0x1a22d9f3u, 0x6ca1493bu,
                             0xc63b05c0u, 0x17c510eau, 0x01ae3a46u};
  return P[j];
}

// The chains of namespace fr, twelve words wide.  Every statement stays
// within 25 operands: a sum or difference is formed in place in a copy of
// its first operand.

// d = t - p over W words; returns true when t >= p.
__device__ __forceinline__ bool sub_p(const uint32_t t[W], uint32_t d[W]) {
  uint32_t borrow;
  asm(
      "sub.cc.u32 %0, %13, 0x00000001;\n\t"
      "subc.cc.u32 %1, %14, 0x8508c000;\n\t"
      "subc.cc.u32 %2, %15, 0x30000000;\n\t"
      "subc.cc.u32 %3, %16, 0x170b5d44;\n\t"
      "subc.cc.u32 %4, %17, 0xba094800;\n\t"
      "subc.cc.u32 %5, %18, 0x1ef3622f;\n\t"
      "subc.cc.u32 %6, %19, 0x00f5138f;\n\t"
      "subc.cc.u32 %7, %20, 0x1a22d9f3;\n\t"
      "subc.cc.u32 %8, %21, 0x6ca1493b;\n\t"
      "subc.cc.u32 %9, %22, 0xc63b05c0;\n\t"
      "subc.cc.u32 %10, %23, 0x17c510ea;\n\t"
      "subc.cc.u32 %11, %24, 0x01ae3a46;\n\t"
      "subc.u32 %12, 0, 0;\n\t"
      : "=&r"(d[0]), "=&r"(d[1]), "=&r"(d[2]), "=&r"(d[3]), "=&r"(d[4]),
        "=&r"(d[5]), "=&r"(d[6]), "=&r"(d[7]), "=&r"(d[8]), "=&r"(d[9]),
        "=&r"(d[10]), "=&r"(d[11]), "=&r"(borrow)
      : "r"(t[0]), "r"(t[1]), "r"(t[2]), "r"(t[3]), "r"(t[4]), "r"(t[5]),
        "r"(t[6]), "r"(t[7]), "r"(t[8]), "r"(t[9]), "r"(t[10]), "r"(t[11]));
  return borrow == 0u;
}

// a + b mod p for a, b < p.
__device__ __forceinline__ Fe fe_add(const Fe& a, const Fe& b) {
  Fe s = a, d;
  // a + b < 2p < 2^378: no carry out of the top word
  asm(
      "add.cc.u32 %0, %0, %12;\n\t"
      "addc.cc.u32 %1, %1, %13;\n\t"
      "addc.cc.u32 %2, %2, %14;\n\t"
      "addc.cc.u32 %3, %3, %15;\n\t"
      "addc.cc.u32 %4, %4, %16;\n\t"
      "addc.cc.u32 %5, %5, %17;\n\t"
      "addc.cc.u32 %6, %6, %18;\n\t"
      "addc.cc.u32 %7, %7, %19;\n\t"
      "addc.cc.u32 %8, %8, %20;\n\t"
      "addc.cc.u32 %9, %9, %21;\n\t"
      "addc.cc.u32 %10, %10, %22;\n\t"
      "addc.u32 %11, %11, %23;\n\t"
      : "+r"(s.w[0]), "+r"(s.w[1]), "+r"(s.w[2]), "+r"(s.w[3]), "+r"(s.w[4]),
        "+r"(s.w[5]), "+r"(s.w[6]), "+r"(s.w[7]), "+r"(s.w[8]), "+r"(s.w[9]),
        "+r"(s.w[10]), "+r"(s.w[11])
      : "r"(b.w[0]), "r"(b.w[1]), "r"(b.w[2]), "r"(b.w[3]), "r"(b.w[4]),
        "r"(b.w[5]), "r"(b.w[6]), "r"(b.w[7]), "r"(b.w[8]), "r"(b.w[9]),
        "r"(b.w[10]), "r"(b.w[11]));
  return sub_p(s.w, d.w) ? d : s;
}

// a - b mod p for a, b < p.
__device__ __forceinline__ Fe fe_sub(const Fe& a, const Fe& b) {
  Fe d = a;
  uint32_t borrow;  // all ones when a < b
  asm(
      "sub.cc.u32 %0, %0, %13;\n\t"
      "subc.cc.u32 %1, %1, %14;\n\t"
      "subc.cc.u32 %2, %2, %15;\n\t"
      "subc.cc.u32 %3, %3, %16;\n\t"
      "subc.cc.u32 %4, %4, %17;\n\t"
      "subc.cc.u32 %5, %5, %18;\n\t"
      "subc.cc.u32 %6, %6, %19;\n\t"
      "subc.cc.u32 %7, %7, %20;\n\t"
      "subc.cc.u32 %8, %8, %21;\n\t"
      "subc.cc.u32 %9, %9, %22;\n\t"
      "subc.cc.u32 %10, %10, %23;\n\t"
      "subc.cc.u32 %11, %11, %24;\n\t"
      "subc.u32 %12, 0, 0;\n\t"
      : "+r"(d.w[0]), "+r"(d.w[1]), "+r"(d.w[2]), "+r"(d.w[3]), "+r"(d.w[4]),
        "+r"(d.w[5]), "+r"(d.w[6]), "+r"(d.w[7]), "+r"(d.w[8]), "+r"(d.w[9]),
        "+r"(d.w[10]), "+r"(d.w[11]), "=&r"(borrow)
      : "r"(b.w[0]), "r"(b.w[1]), "r"(b.w[2]), "r"(b.w[3]), "r"(b.w[4]),
        "r"(b.w[5]), "r"(b.w[6]), "r"(b.w[7]), "r"(b.w[8]), "r"(b.w[9]),
        "r"(b.w[10]), "r"(b.w[11]));
  // d += p where the subtraction borrowed
  asm(
      "add.cc.u32 %0, %0, %12;\n\t"
      "addc.cc.u32 %1, %1, %13;\n\t"
      "addc.cc.u32 %2, %2, %14;\n\t"
      "addc.cc.u32 %3, %3, %15;\n\t"
      "addc.cc.u32 %4, %4, %16;\n\t"
      "addc.cc.u32 %5, %5, %17;\n\t"
      "addc.cc.u32 %6, %6, %18;\n\t"
      "addc.cc.u32 %7, %7, %19;\n\t"
      "addc.cc.u32 %8, %8, %20;\n\t"
      "addc.cc.u32 %9, %9, %21;\n\t"
      "addc.cc.u32 %10, %10, %22;\n\t"
      "addc.u32 %11, %11, %23;\n\t"
      : "+r"(d.w[0]), "+r"(d.w[1]), "+r"(d.w[2]), "+r"(d.w[3]), "+r"(d.w[4]),
        "+r"(d.w[5]), "+r"(d.w[6]), "+r"(d.w[7]), "+r"(d.w[8]), "+r"(d.w[9]),
        "+r"(d.w[10]), "+r"(d.w[11])
      : "r"(p_word(0) & borrow), "r"(p_word(1) & borrow),
        "r"(p_word(2) & borrow), "r"(p_word(3) & borrow),
        "r"(p_word(4) & borrow), "r"(p_word(5) & borrow),
        "r"(p_word(6) & borrow), "r"(p_word(7) & borrow),
        "r"(p_word(8) & borrow), "r"(p_word(9) & borrow),
        "r"(p_word(10) & borrow), "r"(p_word(11) & borrow));
  return d;
}

// fr::cios_step over twelve words (see there).
__device__ __forceinline__ void cios_step(uint32_t e[W], uint32_t o[W],
                                          const uint32_t v[W], uint32_t b) {
  asm(
      "add.cc.u32 %0, %0, %2;\n\t"
      "madc.lo.cc.u32 %1, %13, %19, %3;\n\t"
      "madc.hi.cc.u32 %2, %13, %19, %4;\n\t"
      "madc.lo.cc.u32 %3, %14, %19, %5;\n\t"
      "madc.hi.cc.u32 %4, %14, %19, %6;\n\t"
      "madc.lo.cc.u32 %5, %15, %19, %7;\n\t"
      "madc.hi.cc.u32 %6, %15, %19, %8;\n\t"
      "madc.lo.cc.u32 %7, %16, %19, %9;\n\t"
      "madc.hi.cc.u32 %8, %16, %19, %10;\n\t"
      "madc.lo.cc.u32 %9, %17, %19, %11;\n\t"
      "madc.hi.cc.u32 %10, %17, %19, %12;\n\t"
      "madc.lo.cc.u32 %11, %18, %19, 0;\n\t"
      "madc.hi.u32 %12, %18, %19, 0;\n\t"
      : "+r"(e[0]), "+r"(o[0]), "+r"(o[1]), "+r"(o[2]), "+r"(o[3]),
        "+r"(o[4]), "+r"(o[5]), "+r"(o[6]), "+r"(o[7]), "+r"(o[8]),
        "+r"(o[9]), "+r"(o[10]), "+r"(o[11])
      : "r"(v[1]), "r"(v[3]), "r"(v[5]), "r"(v[7]), "r"(v[9]), "r"(v[11]),
        "r"(b));
  asm(
      "mad.lo.cc.u32 %0, %13, %19, %0;\n\t"
      "madc.hi.cc.u32 %1, %13, %19, %1;\n\t"
      "madc.lo.cc.u32 %2, %14, %19, %2;\n\t"
      "madc.hi.cc.u32 %3, %14, %19, %3;\n\t"
      "madc.lo.cc.u32 %4, %15, %19, %4;\n\t"
      "madc.hi.cc.u32 %5, %15, %19, %5;\n\t"
      "madc.lo.cc.u32 %6, %16, %19, %6;\n\t"
      "madc.hi.cc.u32 %7, %16, %19, %7;\n\t"
      "madc.lo.cc.u32 %8, %17, %19, %8;\n\t"
      "madc.hi.cc.u32 %9, %17, %19, %9;\n\t"
      "madc.lo.cc.u32 %10, %18, %19, %10;\n\t"
      "madc.hi.cc.u32 %11, %18, %19, %11;\n\t"
      "addc.u32 %12, %12, 0;\n\t"
      : "+r"(e[0]), "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]),
        "+r"(e[5]), "+r"(e[6]), "+r"(e[7]), "+r"(e[8]), "+r"(e[9]),
        "+r"(e[10]), "+r"(e[11]), "+r"(o[11])
      : "r"(v[0]), "r"(v[2]), "r"(v[4]), "r"(v[6]), "r"(v[8]), "r"(v[10]),
        "r"(b));
}

// e + 2^32 o += p m, m = -e[0] / p mod 2^32: clears e[0].
__device__ __forceinline__ void cios_reduce(uint32_t e[W], uint32_t o[W]) {
  const uint32_t m = e[0] * NP0;
  asm(
      "mad.lo.cc.u32 %0, 0x8508c000, %12, %0;\n\t"
      "madc.hi.cc.u32 %1, 0x8508c000, %12, %1;\n\t"
      "madc.lo.cc.u32 %2, 0x170b5d44, %12, %2;\n\t"
      "madc.hi.cc.u32 %3, 0x170b5d44, %12, %3;\n\t"
      "madc.lo.cc.u32 %4, 0x1ef3622f, %12, %4;\n\t"
      "madc.hi.cc.u32 %5, 0x1ef3622f, %12, %5;\n\t"
      "madc.lo.cc.u32 %6, 0x1a22d9f3, %12, %6;\n\t"
      "madc.hi.cc.u32 %7, 0x1a22d9f3, %12, %7;\n\t"
      "madc.lo.cc.u32 %8, 0xc63b05c0, %12, %8;\n\t"
      "madc.hi.cc.u32 %9, 0xc63b05c0, %12, %9;\n\t"
      "madc.lo.cc.u32 %10, 0x01ae3a46, %12, %10;\n\t"
      "madc.hi.u32 %11, 0x01ae3a46, %12, %11;\n\t"
      : "+r"(o[0]), "+r"(o[1]), "+r"(o[2]), "+r"(o[3]), "+r"(o[4]),
        "+r"(o[5]), "+r"(o[6]), "+r"(o[7]), "+r"(o[8]), "+r"(o[9]),
        "+r"(o[10]), "+r"(o[11])
      : "r"(m));
  asm(
      "mad.lo.cc.u32 %0, 0x00000001, %13, %0;\n\t"
      "madc.hi.cc.u32 %1, 0x00000001, %13, %1;\n\t"
      "madc.lo.cc.u32 %2, 0x30000000, %13, %2;\n\t"
      "madc.hi.cc.u32 %3, 0x30000000, %13, %3;\n\t"
      "madc.lo.cc.u32 %4, 0xba094800, %13, %4;\n\t"
      "madc.hi.cc.u32 %5, 0xba094800, %13, %5;\n\t"
      "madc.lo.cc.u32 %6, 0x00f5138f, %13, %6;\n\t"
      "madc.hi.cc.u32 %7, 0x00f5138f, %13, %7;\n\t"
      "madc.lo.cc.u32 %8, 0x6ca1493b, %13, %8;\n\t"
      "madc.hi.cc.u32 %9, 0x6ca1493b, %13, %9;\n\t"
      "madc.lo.cc.u32 %10, 0x17c510ea, %13, %10;\n\t"
      "madc.hi.cc.u32 %11, 0x17c510ea, %13, %11;\n\t"
      "addc.u32 %12, %12, 0;\n\t"
      : "+r"(e[0]), "+r"(e[1]), "+r"(e[2]), "+r"(e[3]), "+r"(e[4]),
        "+r"(e[5]), "+r"(e[6]), "+r"(e[7]), "+r"(e[8]), "+r"(e[9]),
        "+r"(e[10]), "+r"(e[11]), "+r"(o[11])
      : "r"(m));
}

// REDC(a * b) = a * b * 2^-384 mod p, fully reduced, for a < R and b < p
// (the argument of fr::fe_mont_mul; here the sum stays far below 2^384).
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
  // after the twelfth step e = y, o = x: the result is e / 2^32 + o
  Fe r, d;
#pragma unroll
  for (int j = 0; j < W; ++j) r.w[j] = x[j];
  uint32_t top;
  asm(
      "add.cc.u32 %0, %0, %13;\n\t"
      "addc.cc.u32 %1, %1, %14;\n\t"
      "addc.cc.u32 %2, %2, %15;\n\t"
      "addc.cc.u32 %3, %3, %16;\n\t"
      "addc.cc.u32 %4, %4, %17;\n\t"
      "addc.cc.u32 %5, %5, %18;\n\t"
      "addc.cc.u32 %6, %6, %19;\n\t"
      "addc.cc.u32 %7, %7, %20;\n\t"
      "addc.cc.u32 %8, %8, %21;\n\t"
      "addc.cc.u32 %9, %9, %22;\n\t"
      "addc.cc.u32 %10, %10, %23;\n\t"
      "addc.cc.u32 %11, %11, 0;\n\t"
      "addc.u32 %12, 0, 0;\n\t"
      : "+r"(r.w[0]), "+r"(r.w[1]), "+r"(r.w[2]), "+r"(r.w[3]), "+r"(r.w[4]),
        "+r"(r.w[5]), "+r"(r.w[6]), "+r"(r.w[7]), "+r"(r.w[8]), "+r"(r.w[9]),
        "+r"(r.w[10]), "+r"(r.w[11]), "=&r"(top)
      : "r"(y[1]), "r"(y[2]), "r"(y[3]), "r"(y[4]), "r"(y[5]), "r"(y[6]),
        "r"(y[7]), "r"(y[8]), "r"(y[9]), "r"(y[10]), "r"(y[11]));
  bool ge = sub_p(r.w, d.w);
  return (top != 0u || ge) ? d : r;
}

}  // namespace fq

template <int W>
__device__ __forceinline__ FeT<W> fe_zero() {
  FeT<W> r;
#pragma unroll
  for (int j = 0; j < W; ++j) r.w[j] = 0u;
  return r;
}

// 2 W int32 limbs (< 2^16 each) -> packed element: W / 2 16-byte loads.
// src must be 16-byte aligned (every (..., L) int32 row is).
template <int W>
__device__ __forceinline__ FeT<W> load_limbs(const int32_t* src) {
  const int4* s = reinterpret_cast<const int4*>(src);
  FeT<W> r;
#pragma unroll
  for (int q = 0; q < W / 2; ++q) {
    int4 v = s[q];
    r.w[2 * q] = (uint32_t)v.x | ((uint32_t)v.y << 16);
    r.w[2 * q + 1] = (uint32_t)v.z | ((uint32_t)v.w << 16);
  }
  return r;
}

template <int W>
__device__ __forceinline__ void store_limbs(int32_t* dst, const FeT<W>& a) {
  int4* d = reinterpret_cast<int4*>(dst);
#pragma unroll
  for (int q = 0; q < W / 2; ++q) {
    d[q] = make_int4((int)(a.w[2 * q] & 0xffffu), (int)(a.w[2 * q] >> 16),
                     (int)(a.w[2 * q + 1] & 0xffffu),
                     (int)(a.w[2 * q + 1] >> 16));
  }
}

// packed element (W words, 16-byte aligned): W / 4 16-byte accesses
template <int W>
__device__ __forceinline__ FeT<W> load_packed(const uint32_t* src) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  FeT<W> r;
#pragma unroll
  for (int q = 0; q < W / 4; ++q) {
    const uint4 v = s[q];
    r.w[4 * q] = v.x;
    r.w[4 * q + 1] = v.y;
    r.w[4 * q + 2] = v.z;
    r.w[4 * q + 3] = v.w;
  }
  return r;
}

template <int W>
__device__ __forceinline__ void store_packed(uint32_t* dst, const FeT<W>& a) {
  uint4* d = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int q = 0; q < W / 4; ++q)
    d[q] = make_uint4(a.w[4 * q], a.w[4 * q + 1], a.w[4 * q + 2],
                      a.w[4 * q + 3]);
}

// The field traits the kernels are instantiated for.  ID is the field
// argument of every C entry point (engine/cuda_build.py: KERNEL_FIELDS).
struct Bn254Fr {
  static constexpr int W = fr::W, L = fr::L, ID = 0;
  using Fe = fr::Fe;
  static __device__ __forceinline__ Fe add(const Fe& a, const Fe& b) {
    return fr::fe_add(a, b);
  }
  static __device__ __forceinline__ Fe sub(const Fe& a, const Fe& b) {
    return fr::fe_sub(a, b);
  }
  static __device__ __forceinline__ Fe mul(const Fe& a, const Fe& b) {
    return fr::fe_mont_mul(a, b);
  }
};

struct Bls12377Fq {
  static constexpr int W = fq::W, L = fq::L, ID = 1;
  using Fe = fq::Fe;
  static __device__ __forceinline__ Fe add(const Fe& a, const Fe& b) {
    return fq::fe_add(a, b);
  }
  static __device__ __forceinline__ Fe sub(const Fe& a, const Fe& b) {
    return fq::fe_sub(a, b);
  }
  static __device__ __forceinline__ Fe mul(const Fe& a, const Fe& b) {
    return fq::fe_mont_mul(a, b);
  }
};

// Runs body(F{}) for the trait of field id `field`; cudaErrorInvalidValue
// for an id no kernel is built for.
template <class Body>
__host__ int with_field(int field, Body body) {
  switch (field) {
    case Bn254Fr::ID:
      return (int)body(Bn254Fr{});
    case Bls12377Fq::ID:
      return (int)body(Bls12377Fq{});
    default:
      return (int)cudaErrorInvalidValue;
  }
}
