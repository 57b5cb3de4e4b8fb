// Shared device code of the kernels on pre-lowered (L, P, B) streams
// (adjoint.cu, pallas_solver.cu, fused.cu, tangent.cu, onepass.cu; and
// fused4_grad.cu's and fused4_primal.cu's sweeps, which lower in the
// kernel), padded widths 1..16.
//
// A group of G threads (the power of two at or above P; fused4_common.cuh)
// owns one lane, thread r row r of every P x P state, so a thread holds a
// few P-vectors; rows r >= P are padding that holds zeros.  Sums over rows
// are xor-shuffle reductions within the group (group_sum).  The streams
// are (L, P, B), lane fastest; per-lane outputs are (P, P, B) and (P, B).
//
// Also the value steps that read the step's stream vectors (u, ph) whole
// in every thread, with their butterflies: tangent.cu's sweeps with
// tangents take the factor's (factor_value_step) and the elements'
// (elem_value_step), filling the record their tangent steps read.  The
// sweeps without tangents (adjoint.cu's, fused4_grad.cu's,
// fused4_primal.cu's, pallas_solver.cu's, fused.cu's and onepass.cu's)
// stream their steps through shared memory instead (adjoint_common.cuh).
// fused4_grad.cu's factor_bwd and elem_bwd take a lane a group by lane_of
// in blocks of BLOCK threads (grid_for).

#pragma once

#include "fused4_common.cuh"

// Threads a block, whole groups of G.
constexpr int BLOCK = 128;
static_assert(BLOCK % G == 0, "a block holds whole groups");
constexpr int NSV0 = 2 * PP;       // elements saves a step: Shin, A_in
constexpr int NSV1 = 2 * PP + P;   // factor saves a step: Shin, Mprev, mprev

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

// Row r of a (P, P, B) per-lane matrix (of float64 glue operands too,
// rounded to T); zeros for r >= P.
template <typename T, typename U>
__device__ __forceinline__ void get_mat(const U* __restrict__ in, int r, int B, int l,
                                        T (&x)[P]) {
#pragma unroll
    for (int j = 0; j < P; ++j)
        x[j] = r < P ? static_cast<T>(in[((size_t)r * P + j) * B + l]) : T(0);
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

// A value step's record: what the forward-mode tangent steps of that step
// read of the value (tangent.cu), field f at rec[f * S].  d, 1 / d and z0;
// rows r of su, w, u, phi and of uA (elements) or g (factor) after the
// step; at the step's start m_r (factor) and the rows of Sh and of A or M,
// a column's rows together (entry (r, j) at QS + j * P + r).
constexpr int QD = 0, QRD = 1, QZ = 2, QSU = 3, QW = QSU + P, QU = QW + P, QPH = QU + P,
              QG = QPH + P, QM = QG + P, QS = QM + P, QA = QS + PP, NQ = QA + PP;

template <typename T, int S>
struct Rec {
    T* p;
    __device__ __forceinline__ T& operator[](int f) const { return p[f * S]; }
};

// A record that is not kept (the sweeps without tangents).
template <typename T>
__device__ __forceinline__ Rec<T, 0> no_rec() {
    return Rec<T, 0>{nullptr};
}

// A Kahan-compensated sum.
template <typename T>
struct Kahan {
    T s, c;
    __device__ __forceinline__ void add(T x) {
        const T y = x - c;
        const T t = s + y;
        c = (t - s) - y;
        s = t;
    }
    __device__ __forceinline__ double total() const { return (double)s + (double)c; }
};

// The elements sweep's value step, row r, from the step's streams (u, ph
// whole, v_r, a): Sh <- Phi Sh Phi + d w w^T, A <- Phi A - w uA^T and
// J <- J - uA uA^T / d with uA = A^T Phi u.  With PUB it fills the step's
// record.
template <bool PUB, typename T, int S>
__device__ __forceinline__ void elem_value_step(const T (&uv)[P], const T (&pv)[P], T vr, T a,
                                                int r, T (&Sh)[P], T (&A)[P], T (&J)[P],
                                                Rec<T, S> rec) {
    if (PUB && r < P) {
#pragma unroll
        for (int j = 0; j < P; ++j) {
            rec[QS + j * P + r] = Sh[j];
            rec[QA + j * P + r] = A[j];
        }
    }
    T w[P], uA[P], su, wr;
    const T d = front_row(Sh, uv, pv, vr, a, r, Sh, su, wr, w);
#pragma unroll
    for (int j = 0; j < P; ++j) Sh[j] = Sh[j] + d * wr * w[j];
    // uAc = A^T (Phi u): a sum over rows for every column.
    const T phr = pick(pv, r), utr = phr * pick(uv, r);
#pragma unroll
    for (int j = 0; j < P; ++j) uA[j] = group_sum(A[j] * utr);
    // uA_j / d from thread j: one division a thread, the same words as
    // dividing every column (a butterfly's sum is alike in every thread).
    const T uAr = pick(uA, r), qr = uAr / d;
#pragma unroll
    for (int j = 0; j < P; ++j) {
        A[j] = phr * A[j] - wr * uA[j];
        J[j] = J[j] - uAr * __shfl_sync(0xffffffffu, qr, j, G);
    }
    if (!PUB) return;
    if (r == 0) {
        rec[QD] = d;
        rec[QRD] = T(1) / d;
    }
    if (r < P) {
        rec[QSU + r] = su;
        rec[QW + r] = wr;
        rec[QU + r] = pick(uv, r);
        rec[QPH + r] = phr;
        rec[QG + r] = uAr;
    }
}

// The factor sweep's value step, row r, from the step's streams (u, ph
// whole, v_r, a, y): the Riccati step, M <- Phi M - w g^T with g = (Phi
// M)^T u, m <- Phi m + w z0 with z0 = y - u . Phi m, and the statistics
// Qm, qv, the Kahan-summed quad and log-det, the minimum pivot.  With PUB
// it fills the step's record.
template <bool PUB, typename T, int S>
__device__ __forceinline__ void factor_value_step(const T (&uv)[P], const T (&pv)[P], T vr, T a,
                                                  T y, int r, T (&Sh)[P], T (&M)[P], T (&Qm)[P],
                                                  T& mr, T& qvr, Kahan<T>& q0, Kahan<T>& ld,
                                                  T& mind, Rec<T, S> rec) {
    if (PUB && r < P) {
#pragma unroll
        for (int j = 0; j < P; ++j) {
            rec[QS + j * P + r] = Sh[j];
            rec[QA + j * P + r] = M[j];
        }
        rec[QM + r] = mr;
    }
    T w[P], g[P], su, wr;
    const T d = front_row(Sh, uv, pv, vr, a, r, Sh, su, wr, w);
#pragma unroll
    for (int j = 0; j < P; ++j) Sh[j] = Sh[j] + d * wr * w[j];
    // M <- Phi M - w g^T with g = (Phi M)^T u.
    const T phr = pick(pv, r), ur = pick(uv, r);
#pragma unroll
    for (int j = 0; j < P; ++j) M[j] = phr * M[j];
#pragma unroll
    for (int j = 0; j < P; ++j) g[j] = group_sum(M[j] * ur);
    const T gr = pick(g, r);
#pragma unroll
    for (int j = 0; j < P; ++j) M[j] = M[j] - wr * g[j];
    // m <- Phi m + w z0 with z0 = y - u . Phi m.
    const T mh = phr * mr;
    const T z0 = y - group_sum(ur * mh);
    mr = mh + wr * z0;
    // Kahan-compensated quad and log-det.
    q0.add(z0 * z0 / d);
    ld.add(dlog(d));
    qvr = qvr + (z0 / d) * gr;
    const T qr = gr / d;  // g_j / d from thread j, as uA_j / d above
#pragma unroll
    for (int j = 0; j < P; ++j) Qm[j] = Qm[j] + gr * __shfl_sync(0xffffffffu, qr, j, G);
    // NaN-propagating min, like torch.minimum.
    mind = (d < mind || d != d) ? d : mind;
    if (!PUB) return;
    if (r == 0) {
        rec[QD] = d;
        rec[QRD] = T(1) / d;
        rec[QZ] = z0;
    }
    if (r < P) {
        rec[QSU + r] = su;
        rec[QW + r] = wr;
        rec[QU + r] = ur;
        rec[QPH + r] = phr;
        rec[QG + r] = gr;
    }
}

// Blocks of BLOCK threads for B lanes of gs threads each.
static inline dim3 grid_for(int B, int gs) {
    return dim3((unsigned)(((size_t)B * gs + BLOCK - 1) / BLOCK));
}
