// Shared device code of the fused4 kernels (fused4_primal.cu, fused4_grad.cu).
//
// The scalar helpers (fma, exp, log, sincos overloaded on float / double,
// the exact two_sum / two_prod and the double-single angle reduction), the
// per-lane coefficient load, the in-kernel lowering of one step
// (fused4._lower_step) and the Riccati step both phases share.  One thread
// owns one lane; THREADS lanes a block.
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
static_assert(P >= 1 && P <= 12, "padded width must be in [1, 12]");
constexpr int PP = P * P;
// Threads a block, one lane a thread.  Few heavy lanes at P = 8 run faster
// spread over many SMs; at P = 2 the block size does not matter (PERF.md).
constexpr int THREADS = 32;

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

template <typename T>
__device__ __forceinline__ void lower_step(const Coeffs<T>& k, int jr, T t, T tl, T dt, T dg,
                                           T m, T (&u)[P], T (&v)[P], T (&ph)[P], T& a) {
#pragma unroll
    for (int col = 0; col < P; ++col) {
        if (col < jr) {
            u[col] = k.c0[col] * m;
            v[col] = m;
            ph[col] = dexp(-k.c1[col] * dt);
        } else if (((col - jr) & 1) == 0) {
            // First column of a complex pair; its partner is col + 1.
            T r_hi, r_lo, sh, ch;
            reduced_angle(k.c3[col], t, tl, r_hi, r_lo);
            dsincos(r_hi, &sh, &ch);
            const T cm = (ch - r_lo * sh) * m;
            const T sm = (sh + r_lo * ch) * m;
            const T p = dexp(-k.c2[col] * dt);
            u[col] = k.c0[col] * cm + k.c1[col] * sm;
            v[col] = cm;
            ph[col] = p;
            if (col + 1 < P) {
                u[col + 1] = k.c0[col] * sm - k.c1[col] * cm;
                v[col + 1] = sm;
                ph[col + 1] = p;
            }
        }
    }
    a = m * (dg + k.total) + (T(1) - m);
}

// One Riccati step shared by both phases: Sh <- phi Sh phi + d w w^T.
// Returns d; leaves w.
template <typename T>
__device__ __forceinline__ T riccati_step(T (&Sh)[P][P], const T (&u)[P], const T (&v)[P],
                                          const T (&ph)[P], T a, T (&w)[P]) {
    T su[P];
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
        for (int j = 0; j < P; ++j) Sh[i][j] = ph[i] * Sh[i][j] * ph[j];
#pragma unroll
    for (int i = 0; i < P; ++i) {
        T s = T(0);
#pragma unroll
        for (int j = 0; j < P; ++j) s += Sh[i][j] * u[j];
        su[i] = s;
    }
    T us = T(0);
#pragma unroll
    for (int i = 0; i < P; ++i) us += u[i] * su[i];
    const T d = a - us;
#pragma unroll
    for (int i = 0; i < P; ++i) w[i] = (v[i] - su[i]) / d;
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
        for (int j = 0; j < P; ++j) Sh[i][j] = Sh[i][j] + d * w[i] * w[j];
    return d;
}
