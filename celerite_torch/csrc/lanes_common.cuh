// Shared device code of the kernels on pre-lowered (L, P, B) streams
// (adjoint.cu, pallas_solver.cu), padded widths 1..16.
//
// A group of G threads (the power of two at or above P; fused4_common.cuh)
// owns one lane, thread r row r of every P x P state, so a thread holds a
// few P-vectors; rows r >= P are padding that holds zeros.  Sums over rows
// are xor-shuffle reductions within the group (group_sum).  Every thread
// reads the step's stream vectors (u, ph) whole; they are (L, P, B), lane
// fastest.  Per-lane outputs are (P, P, B) and (P, B).
//
// Also the elements sweep both sources run: each lane's Riccati element
// (A, J, C) from a zero seed, with per-step saves in adjoint.cu and
// without in pallas_solver.cu.

#pragma once

#include "fused4_common.cuh"

// Threads a block, whole groups of G.
constexpr int BLOCK = 128;
static_assert(BLOCK % G == 0, "a block holds whole groups");
constexpr int NSV0 = 2 * PP;       // elements saves a step: Shin, A_in

// The lane of this thread's group and its row; threads past the last lane
// run lane 0 for the group's shuffles and write nothing.
struct Lane {
    int l, r;
    bool live;
};

__device__ __forceinline__ Lane lane_of(int B) {
    const size_t g = ((size_t)blockIdx.x * BLOCK + threadIdx.x) / G;
    Lane ln;
    ln.live = g < (size_t)B;
    ln.l = ln.live ? (int)g : 0;
    ln.r = (int)(threadIdx.x % G);
    return ln;
}

// x[s, :, l] of an (L, P, B) stream, whole.
template <typename T>
__device__ __forceinline__ void load_vec(const T* __restrict__ x, int s, int B, int l,
                                         T (&out)[P]) {
    const T* p = x + (size_t)s * P * B + l;
#pragma unroll
    for (int j = 0; j < P; ++j) out[j] = p[(size_t)j * B];
}

// Row r of a column-major saved matrix at `base`; nothing for r >= P.
template <typename T>
__device__ __forceinline__ void save_row(T* __restrict__ base, int r, const T (&x)[P]) {
    if (r >= P) return;
#pragma unroll
    for (int j = 0; j < P; ++j) base[j * P + r] = x[j];
}

// Row r of a (P, P, B) per-lane matrix.
template <typename T>
__device__ __forceinline__ void put_mat(T* __restrict__ out, int r, int B, int l,
                                        const T (&x)[P]) {
#pragma unroll
    for (int j = 0; j < P; ++j) out[((size_t)r * P + j) * B + l] = x[j];
}

template <typename T>
__device__ __forceinline__ void get_mat(const T* __restrict__ in, int r, int B, int l,
                                        T (&x)[P]) {
#pragma unroll
    for (int j = 0; j < P; ++j) x[j] = r < P ? in[((size_t)r * P + j) * B + l] : T(0);
}

// The step's intermediates, row r: S = Phi Shin Phi, su = S u, d = a -
// u.su, w = (v - su) / d (w_r, and every w_j gathered).  Returns d.
template <typename T>
__device__ __forceinline__ T front_row(const T (&Shin)[P], const T (&u)[P], const T (&ph)[P],
                                       T vr, T a, int r, T (&S)[P], T& su, T& wr, T (&w)[P]) {
    const T phr = pick(ph, r);
    su = T(0);
#pragma unroll
    for (int j = 0; j < P; ++j) {
        S[j] = phr * Shin[j] * ph[j];
        su += S[j] * u[j];
    }
    const T d = a - group_sum(pick(u, r) * su);
    wr = r < P ? (vr - su) / d : T(0);
    gather(wr, w);
    return d;
}

// Each lane's Riccati element (A, J, C) from a zero seed (the Pallas
// elements kernels, adjoint.py:63 and pallas_solver.py:62): C by the
// zero-seeded factor recursion, A as a product of closed-loop transitions
// (I - w u^T) Phi, J as a sum of rank-1 terms.  With SAVE, each step's
// input [Sh, A] goes to the save stream sv (NSV0 words a lane and step).
template <bool SAVE, typename T>
__device__ __forceinline__ void elements_sweep(const T* __restrict__ u, const T* __restrict__ v,
                                               const T* __restrict__ ph,
                                               const T* __restrict__ a, int L, int B,
                                               T* __restrict__ A_out, T* __restrict__ J_out,
                                               T* __restrict__ C_out, T* __restrict__ sv) {
    const Lane ln = lane_of(B);
    const int l = ln.l, r = ln.r;
    T Sh[P], A[P], J[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
        Sh[j] = J[j] = T(0);
        A[j] = j == r ? T(1) : T(0);
    }
    for (int s = 0; s < L; ++s) {
        if (SAVE && ln.live) {
            T* svs = sv + ((size_t)s * B + l) * NSV0;
            save_row(svs, r, Sh);
            save_row(svs + PP, r, A);
        }
        T uv[P], pv[P], w[P], uA[P], su, wr;
        load_vec(u, s, B, l, uv);
        load_vec(ph, s, B, l, pv);
        const T vr = r < P ? v[((size_t)s * P + r) * B + l] : T(0);
        const T d = front_row(Sh, uv, pv, vr, a[(size_t)s * B + l], r, Sh, su, wr, w);
#pragma unroll
        for (int j = 0; j < P; ++j) Sh[j] = Sh[j] + d * wr * w[j];
        // uAc = A^T (Phi u): a sum over rows for every column.
        const T phr = pick(pv, r), utr = phr * pick(uv, r);
#pragma unroll
        for (int j = 0; j < P; ++j) uA[j] = group_sum(A[j] * utr);
        const T uAr = pick(uA, r);
#pragma unroll
        for (int j = 0; j < P; ++j) {
            A[j] = phr * A[j] - wr * uA[j];
            J[j] = J[j] - uAr * (uA[j] / d);
        }
    }
    if (!ln.live || r >= P) return;
    put_mat(A_out, r, B, l, A);
    put_mat(J_out, r, B, l, J);
    put_mat(C_out, r, B, l, Sh);
}

// Blocks of BLOCK threads for B lanes of gs threads each.
static inline dim3 grid_for(int B, int gs) {
    return dim3((unsigned)(((size_t)B * gs + BLOCK - 1) / BLOCK));
}
