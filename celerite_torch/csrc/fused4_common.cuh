// Shared device code of the fused4 kernels (fused4_primal.cu, fused4_grad.cu),
// the exact-mode kernels (dsfused.cu) and, through lanes_common.cuh, the
// lane-stream kernels (which take the scalar helpers and the row-parallel
// reductions).
//
// The scalar helpers (fma, exp, log, sincos overloaded on float / double,
// the exact two_sum / two_prod and the double-single angle reduction), the
// per-lane coefficient load and a complex pair's rotation of the in-kernel
// lowering (fused4._lower_step); for the exact-mode kernels also the
// raw-jitter coefficient load and the decoding of a tangent's seed.  In the
// row-parallel kernels (fused4's kernels among them) a group of G threads
// owns one lane, a row of the state each.
//
// Numerics.  No --use_fast_math.  two_prod takes its exact error from one
// fma.  In float32, exp and sincos are evaluated in float64 and rounded
// once (the JAX package's compensated exp exists for the TPU's ~30-ulp
// exp; here native float64 does the job).
//
// Compiled into each source once per padded width: -DCELERITE_P=<P>.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#ifndef CELERITE_P
#error "compile with -DCELERITE_P=<padded width>"
#endif

constexpr int P = CELERITE_P;
// The fused4 and exact-mode sources take P <= 12; adjoint.cu P <= 16.
static_assert(P >= 1 && P <= 16, "padded width must be in [1, 16]");
constexpr int PP = P * P;

// ---------------------------------------------------------------------------
// Scalar helpers, overloaded on float / double
// ---------------------------------------------------------------------------

__device__ __forceinline__ float dfma(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double dfma(double a, double b, double c) { return __fma_rn(a, b, c); }
// float32 exp and sincos are evaluated in float64 and rounded once: expf
// and sincosf are within 2 ulp but biased enough that the cancelling pivots
// amplify it (ops/ds.py; PERF.md).  The card computes float64 natively.
__device__ __forceinline__ float dexp(float x) { return static_cast<float>(exp(static_cast<double>(x))); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }
__device__ __forceinline__ float dlog(float x) { return logf(x); }
__device__ __forceinline__ double dlog(double x) { return log(x); }
__device__ __forceinline__ float drint(float x) { return rintf(x); }
__device__ __forceinline__ double drint(double x) { return rint(x); }
__device__ __forceinline__ void dsincos(float x, float* s, float* c) {
    double sd, cd;
    sincos(static_cast<double>(x), &sd, &cd);
    *s = static_cast<float>(sd);
    *c = static_cast<float>(cd);
}
__device__ __forceinline__ void dsincos(double x, double* s, double* c) { sincos(x, s, c); }

template <typename T> struct TwoPi;
template <> struct TwoPi<float> {
    // 2 pi split into the nearest float and the float of the remainder.
    static constexpr float hi = static_cast<float>(6.283185307179586);
    static constexpr float lo = static_cast<float>(
        6.283185307179586 - static_cast<double>(static_cast<float>(6.283185307179586)));
};
template <> struct TwoPi<double> {
    static constexpr double hi = 6.283185307179586;
    static constexpr double lo = 0.0;
};

template <typename T>
__device__ __forceinline__ void two_sum(T a, T b, T& s, T& e) {
    s = a + b;
    T v = s - a;
    e = (a - (s - v)) + (b - v);
}

template <typename T>
__device__ __forceinline__ void two_prod(T a, T b, T& p, T& e) {
    p = a * b;
    e = dfma(a, b, -p);  // exact: p + e == a * b
}

// (d * t) mod 2 pi as a double-single pair (ops/ds.py:reduced_angle).
template <typename T>
__device__ __forceinline__ void reduced_angle(T d, T t_hi, T t_lo, T& r_hi, T& r_lo) {
    T p_hi, p_lo;
    two_prod(d, t_hi, p_hi, p_lo);
    p_lo = p_lo + d * t_lo;
    T k = drint(p_hi / TwoPi<T>::hi);
    T q_hi, q_lo;
    two_prod(k, TwoPi<T>::hi, q_hi, q_lo);
    T s, e;
    two_sum(p_hi, -q_hi, s, e);
    T lo = e + p_lo - q_lo - k * TwoPi<T>::lo;
    two_sum(s, lo, r_hi, r_lo);
}

// ---------------------------------------------------------------------------
// Copies and barriers of the warp-specialised kernels (dsfused.cu and
// tangent.cu's jac sweeps): a value warp and direction warps hand tiles of
// steps over through shared memory.
// ---------------------------------------------------------------------------

// One word from device memory into shared memory, asynchronously.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src),
                 "n"((int)sizeof(T))
                 : "memory");
}
// 16 bytes from device memory into shared memory, both 16-byte aligned.
template <typename T>
__device__ __forceinline__ void cp_async16(T* dst, const T* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// The tile hand-off: every warp of the block, from either role's code.
__device__ __forceinline__ void tile_barrier() { asm volatile("bar.sync 1;\n" ::: "memory"); }

// ---------------------------------------------------------------------------
// Per-lane coefficients and in-kernel lowering (fused4._lower_step)
// ---------------------------------------------------------------------------

// Column k of the padded model: real columns k < jr carry (a, c); complex
// pairs carry (a, b, c, d) on both of their columns.
template <typename T>
struct Coeffs {
    T c0[P], c1[P], c2[P], c3[P];
    T total;
};

template <typename T>
__device__ __forceinline__ void load_coeffs(const T* __restrict__ cf, int jr, Coeffs<T>& k) {
    const int jc = (P - jr) / 2;
#pragma unroll
    for (int col = 0; col < P; ++col) {
        if (col < jr) {
            k.c0[col] = cf[col];
            k.c1[col] = cf[jr + col];
            k.c2[col] = T(0);
            k.c3[col] = T(0);
        } else {
            const int j = (col - jr) >> 1;
            k.c0[col] = cf[2 * jr + j];
            k.c1[col] = cf[2 * jr + jc + j];
            k.c2[col] = cf[2 * jr + 2 * jc + j];
            k.c3[col] = cf[2 * jr + 3 * jc + j];
        }
    }
    k.total = cf[2 * jr + 4 * jc];
}

// A complex pair's (cos, sin) of its angle d t, times m, the angle reduced
// in double-single (t + tl), and its decay exp(-c dt).
template <typename T>
__device__ __forceinline__ void pair_rot(T c, T d, T t, T tl, T dt, T m, T& cm, T& sm, T& p) {
    T r_hi, r_lo, sh, ch;
    reduced_angle(d, t, tl, r_hi, r_lo);
    dsincos(r_hi, &sh, &ch);
    cm = (ch - r_lo * sh) * m;
    sm = (sh + r_lo * ch) * m;
    p = dexp(-c * dt);
}

// The exact-mode layout (dsfused.pack_cf_ds): the last slot is the raw
// jitter and the diagonal total is re-summed here, a_real then a_comp then
// the jitter, so the total stays coherent with the streams.
template <typename T>
__device__ __forceinline__ void load_coeffs_ds(const T* __restrict__ cf, int jr, Coeffs<T>& k) {
    load_coeffs(cf, jr, k);
    const int jc = (P - jr) / 2;
    T s = T(0);
#pragma unroll
    for (int col = 0; col < P; ++col)
        if (col < jr) s += k.c0[col];
    for (int j = 0; j < jc; ++j) s += cf[2 * jr + j];
    k.total = s + cf[2 * jr + 4 * jc];
}

// A forward-mode seed: a unit tangent on one packed coefficient, named by
// what it moves.  kind: -1 none, 0 a_real, 1 c_real, 2 a_comp, 3 b_comp,
// 4 c_comp, 5 d_comp, 6 the jitter; col: its column (a complex pair's
// first column).
struct Seed {
    int kind, col;
};

__device__ __forceinline__ Seed decode_seed(int kk, int jr) {
    const int jc = (P - jr) / 2;
    Seed s{-1, -1};
    if (kk < 0) return s;
    if (kk < jr) {
        s.kind = 0;
        s.col = kk;
    } else if (kk < 2 * jr) {
        s.kind = 1;
        s.col = kk - jr;
    } else if (kk < 2 * jr + 4 * jc) {
        const int q = kk - 2 * jr;
        s.kind = 2 + q / jc;
        s.col = jr + 2 * (q % jc);
    } else if (kk == 2 * jr + 4 * jc) {
        s.kind = 6;
    }
    return s;
}

// ---------------------------------------------------------------------------
// Row-parallel form: a group of G threads (a power of two >= P)
// shares one lane, thread r owning row r of every P x P state; rows r >= P
// are padding and hold zeros.  Sums over rows are xor-shuffle reductions
// within the group, which every thread of the group receives.
// ---------------------------------------------------------------------------

constexpr int G = P <= 1 ? 1 : P <= 2 ? 2 : P <= 4 ? 4 : P <= 8 ? 8 : 16;

template <typename T>
__device__ __forceinline__ T group_sum(T x) {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o, G);
    return x;
}

// x[r] without a runtime index into a register array; 0 for r >= P.
template <typename T>
__device__ __forceinline__ T pick(const T (&x)[P], int r) {
    T o = T(0);
#pragma unroll
    for (int j = 0; j < P; ++j) o = j == r ? x[j] : o;
    return o;
}

// Every row's w_r, gathered from the group.
template <typename T>
__device__ __forceinline__ void gather(T wr, T (&w)[P]) {
#pragma unroll
    for (int j = 0; j < P; ++j) w[j] = __shfl_sync(0xffffffffu, wr, j, G);
}
