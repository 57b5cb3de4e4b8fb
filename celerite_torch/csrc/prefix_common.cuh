// The cross-lane prefixes on the card, in float64 whatever the streams'
// dtype: those of the tangent route's jac call (tangent.cu), the chunked
// scans of the single-sweep value (fused.cu) and the compositions on a
// lane group that those and fused4_primal.cu's block scans take.
//
// The Pallas kernels fused.py:130, tangent.py:591 and fused4.py:275 compose
// each lane's Riccati element (A, J, C) into every lane's seed S-hat, and
// each lane's affine map (M, m) into its incoming state h, by Hillis-Steele
// scans over the lane axis inside the kernel (in VMEM between the two
// phases); the port's other routes run those scans as float64 torch glue,
// a few dozen launches a round (fused4.prefix_sh0, prefix_h0).
//
// tangent.cu's scans are one launch each, a block per (segment, direction)
// walking the segment's lanes in order:
//
// - seed_scan: only C of the running prefix is needed for the seeds, and
//   composing the running prefix (A1, J1, C1) with lane l's element (A2,
//   J2, C2) gives C = A2 (I + C1 J2)^-1 C1 A2^T + C2, which reads no A1 or
//   J1.  So the block carries C (and dC), a P x P matrix, one entry a
//   thread (P^2 threads); the inverse is an unrolled Gauss-Jordan
//   elimination without pivoting (fused.py _inv) on [X | I] in shared
//   memory.  Lane l's seed is the prefix before it (0 for the segment's
//   first lane).  Tangent: with X = I + C1 J2 and K = X^-1 C1,
//   dK = X^-1 (dC1 - dX K), dX = dC1 J2 + C1 dJ2, and
//   dC = dA2 K A2^T + A2 dK A2^T + A2 K dA2^T + dC2.
// - assemble_scan: h starts at 0 in each segment and steps h <- M h + m
//   over its lanes (P threads, a row each); each lane adds quad_l = q0 -
//   2 qv.h + h^T Qm h to the segment's sum, with the log-dets and the
//   minimum pivot; the tangent carries dh <- dM h + M dh + dm and
//   d quad_l = dq0 - 2 (dqv.h + qv.dh) + dh^T Qm h + h^T Qm dh + h^T dQm h.
//
// Their walks take a segment's lanes one by one with a handful of block
// barriers each (4.6 us a lane at P = 8, PERF.md).  fused.cu's chunked scans
// (below) cut each segment into chunks and walk on a lane group with no
// block barrier: three passes for the seeds, the middle one seed_scan's
// step on chunk totals (cstep_rows), and two for the sums, each chunk's
// statistics a quadratic form in the state entering it.
//
// Every scan composes the same elements in another order than the plain
// versions (the torch glue), so seeds and sums differ from theirs by
// rounding alone.
//
// Include after adjoint_common.cuh (P, PP, TS, mac).

#pragma once

#include <math.h>

// Block of the seed scan: one thread an entry of the P x P state.
constexpr int SCAN_THREADS = PP;

// Direction k of a (T, P, P, B) array, entry e = i * P + j, lane l.
__device__ __forceinline__ size_t tan_at(int k, int e, int B, int l) {
    return ((size_t)k * PP + e) * B + l;
}

// Seeds sh0 (P, P, B) (and, with TAN, direction blockIdx.y's dsh0 (T, P,
// P, B)) from the elements (A, J, C) (and their tangents), over segments
// of `seg` lanes: blockIdx.x is the segment, P^2 threads.  The block of
// direction 0 writes the seeds.
template <bool TAN, typename T>
__device__ __forceinline__ void seed_scan(const T* __restrict__ A, const T* __restrict__ J,
                                          const T* __restrict__ Cin, const T* __restrict__ dA,
                                          const T* __restrict__ dJ, const T* __restrict__ dCin,
                                          int B, int seg, T* __restrict__ sh0,
                                          T* __restrict__ dsh0) {
    __shared__ double C[PP], Al[PP], Jl[PP], Cl[PP], K[PP], AK[PP];
    __shared__ double aug[2 * PP];
    __shared__ double dC[TAN ? PP : 1], dAl[TAN ? PP : 1], dJl[TAN ? PP : 1],
        dCl[TAN ? PP : 1], dK[TAN ? PP : 1], X1[TAN ? PP : 1], dAK[TAN ? PP : 1];
    const int e = threadIdx.x, i = e / P, j = e % P;
    const int k = blockIdx.y;
    C[e] = 0.0;
    if constexpr (TAN) dC[e] = 0.0;
    for (int q = 0; q < seg; ++q) {
        const int l = blockIdx.x * seg + q;
        const size_t o = (size_t)e * B + l;
        __syncthreads();  // C (dC) of the prefix before lane l
        if (k == 0) sh0[o] = static_cast<T>(C[e]);
        Al[e] = static_cast<double>(A[o]);
        Jl[e] = static_cast<double>(J[o]);
        Cl[e] = static_cast<double>(Cin[o]);
        if constexpr (TAN) {
            const size_t od = tan_at(k, e, B, l);
            dsh0[od] = static_cast<T>(dC[e]);
            dAl[e] = static_cast<double>(dA[od]);
            dJl[e] = static_cast<double>(dJ[od]);
            dCl[e] = static_cast<double>(dCin[od]);
        }
        __syncthreads();
        // [X | I] with X = I + C Jl.
        double x = i == j ? 1.0 : 0.0;
#pragma unroll
        for (int m = 0; m < P; ++m) x += C[i * P + m] * Jl[m * P + j];
        aug[i * 2 * P + j] = x;
        aug[i * 2 * P + P + j] = i == j ? 1.0 : 0.0;
        if constexpr (TAN) {
            double dx = 0.0;
#pragma unroll
            for (int m = 0; m < P; ++m) dx += dC[i * P + m] * Jl[m * P + j] + C[i * P + m] * dJl[m * P + j];
            X1[e] = dx;
        }
        __syncthreads();
        // Gauss-Jordan: aug <- [I | X^-1].
#pragma unroll 1
        for (int kk = 0; kk < P; ++kk) {
            const double piv = aug[kk * 2 * P + kk];
            const double f = aug[i * 2 * P + kk];
            const double r0 = aug[kk * 2 * P + j] / piv;
            const double r1 = aug[kk * 2 * P + P + j] / piv;
            __syncthreads();
            if (i == kk) {
                aug[i * 2 * P + j] = r0;
                aug[i * 2 * P + P + j] = r1;
            } else {
                aug[i * 2 * P + j] -= f * r0;
                aug[i * 2 * P + P + j] -= f * r1;
            }
            __syncthreads();
        }
        const double* Xi = aug + P;  // row i of X^-1 at Xi[i * 2 * P + m]
        // K = X^-1 C.
        double kx = 0.0;
#pragma unroll
        for (int m = 0; m < P; ++m) kx += Xi[i * 2 * P + m] * C[m * P + j];
        K[e] = kx;
        __syncthreads();
        if constexpr (TAN) {
            // R = dC - dX K into aug's left half (free now), then dK = X^-1 R.
            double rr = dC[e];
#pragma unroll
            for (int m = 0; m < P; ++m) rr -= X1[i * P + m] * K[m * P + j];
            aug[i * 2 * P + j] = rr;
            __syncthreads();
            double dk = 0.0;
#pragma unroll
            for (int m = 0; m < P; ++m) dk += Xi[i * 2 * P + m] * aug[m * 2 * P + j];
            dK[e] = dk;
            __syncthreads();
        }
        double ak = 0.0;
#pragma unroll
        for (int m = 0; m < P; ++m) ak += Al[i * P + m] * K[m * P + j];
        AK[e] = ak;
        if constexpr (TAN) {
            double dak = 0.0;
#pragma unroll
            for (int m = 0; m < P; ++m) dak += dAl[i * P + m] * K[m * P + j] + Al[i * P + m] * dK[m * P + j];
            dAK[e] = dak;
        }
        __syncthreads();
        // C <- (A K) A^T + Cl; dC <- dAK A^T + AK dA^T + dCl.
        double cn = Cl[e];
#pragma unroll
        for (int m = 0; m < P; ++m) cn += AK[i * P + m] * Al[j * P + m];
        C[e] = cn;  // nothing reads C between the barriers above and below
        if constexpr (TAN) {
            double dcn = dCl[e];
#pragma unroll
            for (int m = 0; m < P; ++m)
                dcn += dAK[i * P + m] * Al[j * P + m] + AK[i * P + m] * dAl[j * P + m];
            dC[e] = dcn;
        }
    }
}

// Each segment's quad and log-det sums and minimum pivot (and, with TAN,
// direction blockIdx.y's tangents of the sums) from the lanes' maps (M, m)
// and statistics (Qm, qv, q0, ld, mind): blockIdx.x is the segment, P
// threads.  The block of direction 0 writes the value; dquad and dld are
// (T, n_seg).
template <bool TAN, typename T>
__device__ __forceinline__ void assemble_scan(
    const T* __restrict__ M, const T* __restrict__ mv, const T* __restrict__ Qm,
    const T* __restrict__ qv, const double* __restrict__ q0, const double* __restrict__ ld,
    const T* __restrict__ mind, const T* __restrict__ dM, const T* __restrict__ dmv,
    const T* __restrict__ dQm, const T* __restrict__ dqv, const double* __restrict__ dq0,
    const double* __restrict__ dld, int B, int seg, double* __restrict__ quad_out,
    double* __restrict__ ld_out, T* __restrict__ mind_out, double* __restrict__ dquad_out,
    double* __restrict__ dld_out) {
    __shared__ double h[P], c[P];
    __shared__ double dh[TAN ? P : 1], dc[TAN ? P : 1];
    const int i = threadIdx.x, k = blockIdx.y;
    h[i] = 0.0;
    if constexpr (TAN) dh[i] = 0.0;
    double quad = 0.0, lds = 0.0, dquad = 0.0, dlds = 0.0;
    T mn = T(INFINITY);
    for (int q = 0; q < seg; ++q) {
        const int l = blockIdx.x * seg + q;
        __syncthreads();  // h (dh) before lane l; c (dc) read
        double hn = static_cast<double>(mv[(size_t)i * B + l]), qh = 0.0;
        double dhn = 0.0, qdh = 0.0, dqh = 0.0;
#pragma unroll
        for (int j = 0; j < P; ++j) {
            const size_t o = ((size_t)i * P + j) * B + l;
            const double Mij = static_cast<double>(M[o]), Qij = static_cast<double>(Qm[o]);
            hn += Mij * h[j];
            qh += Qij * h[j];
            if constexpr (TAN) {
                const size_t od = tan_at(k, i * P + j, B, l);
                dhn += static_cast<double>(dM[od]) * h[j] + Mij * dh[j];
                qdh += Qij * dh[j];
                dqh += static_cast<double>(dQm[od]) * h[j];
            }
        }
        const double qvi = static_cast<double>(qv[(size_t)i * B + l]);
        c[i] = h[i] * qh - 2.0 * qvi * h[i];
        if constexpr (TAN) {
            const size_t ov = ((size_t)k * P + i) * B + l;
            dhn += static_cast<double>(dmv[ov]);
            dc[i] = -2.0 * (static_cast<double>(dqv[ov]) * h[i] + qvi * dh[i]) + dh[i] * qh +
                    h[i] * qdh + h[i] * dqh;
        }
        __syncthreads();
        h[i] = hn;
        if constexpr (TAN) dh[i] = dhn;
        if (i == 0) {
            double s = q0[l];
            for (int j = 0; j < P; ++j) s += c[j];
            quad += s;
            lds += ld[l];
            const T d = mind[l];
            // NaN-propagating min, like torch.minimum.
            mn = (d < mn || d != d) ? d : mn;
            if constexpr (TAN) {
                double ds = dq0[(size_t)k * B + l];
                for (int j = 0; j < P; ++j) ds += dc[j];
                dquad += ds;
                dlds += dld[(size_t)k * B + l];
            }
        }
    }
    if (i != 0) return;
    if (k == 0) {
        quad_out[blockIdx.x] = quad;
        ld_out[blockIdx.x] = lds;
        mind_out[blockIdx.x] = mn;
    }
    if constexpr (TAN) {
        dquad_out[(size_t)k * gridDim.x + blockIdx.x] = dquad;
        dld_out[(size_t)k * gridDim.x + blockIdx.x] = dlds;
    }
}

// ---------------------------------------------------------------------------
// Compositions on a lane group (fused.cu's chunked scans, fused4_primal.cu's
// block scans): G threads, thread r row r of every operand, in float64.
// An element (A, J, C) or an affine map (M, m) waits in shared memory, row
// i of each matrix at i * TS, m after M; a product reads its right operand
// there by rows (the same word in every thread) and a transpose by columns;
// the unpivoted Gauss-Jordan elimination (fused4._inv's) takes each pivot
// row from its thread by shuffles.  A group may leave early or loop apart
// from the others of its warp: its shuffles and __syncwarp() name its own
// threads only (group_mask), and no block barrier is taken inside.
// ---------------------------------------------------------------------------

constexpr int EL_NS = 3 * P * TS;   // words of an element's slot: A, J, C (a map's M, m fit)
constexpr int EL_NR = 3 * PP;       // words of an element's record: A, J, C row-major
constexpr int AF_NR = PP + P;       // ... of an affine map's: M, then m

// The threads of this thread's group.
__device__ __forceinline__ unsigned group_mask() {
    return G == 32 ? 0xffffffffu : ((1u << G) - 1u) << ((threadIdx.x & 31) & ~(G - 1));
}

__device__ __forceinline__ double gsum(unsigned gm, double x) {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) x += __shfl_xor_sync(gm, x, o, G);
    return x;
}

// 1 / x within an ulp: the approximate reciprocal and a cubic Newton step,
// with no call to the division's slow path, whose saved registers spilled
// (PERF.md); 0, infinity and NaN keep the approximation's infinity, 0, NaN.
__device__ __forceinline__ double recip(double x) {
    double r;
    asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(x));
    const double e = __fma_rn(-x, r, 1.0);
    return e == e ? __fma_rn(r, __fma_rn(e, e, e), r) : r;
}

// [X | R] <- [I | X^-1 R] by Gauss-Jordan elimination without pivoting,
// row r of X and of R (NR words) in this thread's registers; pivot k's row,
// scaled by one reciprocal, comes from thread k by shuffles.  Rows r >= P
// hold zeros and stay so.
template <int NR>
__device__ __forceinline__ void gj_rows(unsigned gm, int r, double (&x)[P], double (&b)[NR]) {
#pragma unroll
    for (int k = 0; k < P; ++k) {
        const double rp = recip(__shfl_sync(gm, x[k], k, G));
        const double f = x[k];
        const bool pk = r == k;
#pragma unroll
        for (int j = k + 1; j < P; ++j) {
            const double pj = __shfl_sync(gm, x[j], k, G) * rp;
            x[j] = pk ? pj : mac(-f, pj, x[j]);
        }
#pragma unroll
        for (int j = 0; j < NR; ++j) {
            const double pj = __shfl_sync(gm, b[j], k, G) * rp;
            b[j] = pk ? pj : mac(-f, pj, b[j]);
        }
    }
}

// The seed scan's step (seed_scan above, there one entry a thread): the
// running prefix's C, row r in c, composed with the element e2 in shared
// memory, C <- A2 (I + C J2)^-1 C A2^T + C2; tk is the group's tile.
__device__ __forceinline__ void cstep_rows(unsigned gm, int r, double (&c)[P],
                                           const double* e2, double* tk) {
    const double *A2 = e2, *J2 = e2 + P * TS, *C2 = e2 + 2 * P * TS;
    const bool in = r < P;
    double x[P], ak[P];
#pragma unroll
    for (int j = 0; j < P; ++j) x[j] = j == r ? 1.0 : 0.0;
#pragma unroll
    for (int m = 0; m < P; ++m)
#pragma unroll
        for (int j = 0; j < P; ++j) x[j] = mac(c[m], J2[m * TS + j], x[j]);
    gj_rows(gm, r, x, c);  // c: row r of K = X^-1 C
    __syncwarp(gm);
    if (in) {
#pragma unroll
        for (int j = 0; j < P; ++j) tk[r * TS + j] = c[j];
    }
    __syncwarp(gm);
#pragma unroll
    for (int j = 0; j < P; ++j) ak[j] = 0.0;
    if (in) {
#pragma unroll
        for (int m = 0; m < P; ++m) {
            const double a = A2[r * TS + m];
#pragma unroll
            for (int j = 0; j < P; ++j) ak[j] = mac(a, tk[m * TS + j], ak[j]);
        }
    }
#pragma unroll
    for (int j = 0; j < P; ++j) c[j] = in ? C2[r * TS + j] : 0.0;
#pragma unroll
    for (int m = 0; m < P; ++m)
#pragma unroll
        for (int j = 0; j < P; ++j) c[j] = mac(ak[m], A2[j * TS + m], c[j]);
}

// The element composition (fused4._compose_elem, e1 first) with E = (I +
// C1 J2)^-1: A = A2 E A1, C = A2 E C1 A2^T + C2, J = J1 + A1^T J2 E A1, row
// r into Ao, Jo, Co; t0 and t1 are the group's tiles.  One elimination
// gives E A1 and E C1 together.
__device__ __forceinline__ void compose_rows(unsigned gm, int r, const double* e1,
                                             const double* e2, double* t0, double* t1,
                                             double (&Ao)[P], double (&Jo)[P], double (&Co)[P]) {
    const double *A1 = e1, *J1 = e1 + P * TS, *C1 = e1 + 2 * P * TS;
    const double *A2 = e2, *J2 = e2 + P * TS, *C2 = e2 + 2 * P * TS;
    const bool in = r < P;
    double x[P], b[2 * P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
        x[j] = j == r ? 1.0 : 0.0;
        b[j] = in ? A1[r * TS + j] : 0.0;
        b[P + j] = in ? C1[r * TS + j] : 0.0;
    }
#pragma unroll
    for (int m = 0; m < P; ++m)
#pragma unroll
        for (int j = 0; j < P; ++j) x[j] = mac(b[P + m], J2[m * TS + j], x[j]);
    gj_rows(gm, r, x, b);  // b: rows r of E A1 and of K = E C1
    __syncwarp(gm);
    if (in) {
#pragma unroll
        for (int j = 0; j < P; ++j) {
            t0[r * TS + j] = b[j];
            t1[r * TS + j] = b[P + j];
        }
    }
    __syncwarp(gm);
    double ak[P], tr[P];
#pragma unroll
    for (int j = 0; j < P; ++j) ak[j] = tr[j] = Ao[j] = 0.0;
    if (in) {
#pragma unroll
        for (int m = 0; m < P; ++m) {
            const double a = A2[r * TS + m], jm = J2[r * TS + m];
#pragma unroll
            for (int j = 0; j < P; ++j) {
                ak[j] = mac(a, t1[m * TS + j], ak[j]);
                Ao[j] = mac(a, t0[m * TS + j], Ao[j]);
                tr[j] = mac(jm, t0[m * TS + j], tr[j]);
            }
        }
    }
#pragma unroll
    for (int j = 0; j < P; ++j) Co[j] = in ? C2[r * TS + j] : 0.0;
#pragma unroll
    for (int m = 0; m < P; ++m)
#pragma unroll
        for (int j = 0; j < P; ++j) Co[j] = mac(ak[m], A2[j * TS + m], Co[j]);
    // J2 E A1 through t1, once every row has read K.
    __syncwarp(gm);
    if (in) {
#pragma unroll
        for (int j = 0; j < P; ++j) t1[r * TS + j] = tr[j];
    }
    __syncwarp(gm);
#pragma unroll
    for (int j = 0; j < P; ++j) Jo[j] = in ? J1[r * TS + j] : 0.0;
    if (in) {
#pragma unroll
        for (int m = 0; m < P; ++m) {
            const double a = A1[m * TS + r];
#pragma unroll
            for (int j = 0; j < P; ++j) Jo[j] = mac(a, t1[m * TS + j], Jo[j]);
        }
    }
}

// The affine composition (e1 first): M = M2 M1, m = M2 m1 + m2, row r.
__device__ __forceinline__ void compose_aff_rows(int r, const double* e1, const double* e2,
                                                 double (&Mo)[P], double& mo) {
    const double *M1 = e1, *m1 = e1 + P * TS, *M2 = e2, *m2 = e2 + P * TS;
#pragma unroll
    for (int j = 0; j < P; ++j) Mo[j] = 0.0;
    mo = 0.0;
    if (r >= P) return;
    mo = m2[r];
#pragma unroll
    for (int m = 0; m < P; ++m) {
        const double a = M2[r * TS + m];
#pragma unroll
        for (int j = 0; j < P; ++j) Mo[j] = mac(a, M1[m * TS + j], Mo[j]);
        mo = mac(a, m1[m], mo);
    }
}

// Rows r of three matrices into an element's slot.
__device__ __forceinline__ void put_el(double* e, int r, const double (&A)[P],
                                       const double (&J)[P], const double (&C)[P]) {
    if (r >= P) return;
#pragma unroll
    for (int j = 0; j < P; ++j) {
        e[r * TS + j] = A[j];
        e[P * TS + r * TS + j] = J[j];
        e[2 * P * TS + r * TS + j] = C[j];
    }
}

// Rows r of lane l's element from three (P, P, B) arrays into registers,
// and from there into a slot.
template <typename T>
struct ElRows {
    T a[P], j[P], c[P];
    __device__ __forceinline__ void fetch(const T* __restrict__ A, const T* __restrict__ J,
                                          const T* __restrict__ C, int r, int B, int l) {
#pragma unroll
        for (int k = 0; k < P; ++k) {
            const size_t o = ((size_t)r * P + k) * B + l;
            a[k] = r < P ? A[o] : T(0);
            j[k] = r < P ? J[o] : T(0);
            c[k] = r < P ? C[o] : T(0);
        }
    }
    __device__ __forceinline__ void put(double* e, int r) const {
        if (r >= P) return;
#pragma unroll
        for (int k = 0; k < P; ++k) {
            e[r * TS + k] = static_cast<double>(a[k]);
            e[P * TS + r * TS + k] = static_cast<double>(j[k]);
            e[2 * P * TS + r * TS + k] = static_cast<double>(c[k]);
        }
    }
};

// Rows r of NM matrices (and, with VEC, entry r of the vector after them)
// between a slot and a record.
template <int NM, bool VEC>
__device__ __forceinline__ void slot_to_rec(const double* e, double* __restrict__ x, int r) {
    if (r >= P) return;
#pragma unroll
    for (int q = 0; q < NM; ++q)
#pragma unroll
        for (int j = 0; j < P; ++j) x[q * PP + r * P + j] = e[q * P * TS + r * TS + j];
    if (VEC) x[NM * PP + r] = e[NM * P * TS + r];
}

template <int NM, bool VEC>
__device__ __forceinline__ void rec_to_slot(const double* __restrict__ x, double* e, int r) {
    if (r >= P) return;
#pragma unroll
    for (int q = 0; q < NM; ++q)
#pragma unroll
        for (int j = 0; j < P; ++j) e[q * P * TS + r * TS + j] = x[q * PP + r * P + j];
    if (VEC) e[NM * P * TS + r] = x[NM * PP + r];
}

// ---------------------------------------------------------------------------
// The chunked scans of the single-sweep value (fused.cu), over segments of
// `seg` lanes cut into chunks of c lanes (the last of a segment shorter);
// chunk k is chunk k % nck of segment k / nck.  A group a chunk or a
// segment, blocks of one warp.
//
// Seeds, in three passes: chunk_totals composes each chunk's elements
// into its total (A, J, C), all chunks at once; seed_spine walks each
// segment's chunk totals carrying C only and writes each chunk's seed;
// chunk_seeds walks each chunk's lanes again from its seed, carrying C
// only, and writes every lane's seed.  Both walks take cstep_rows.
//
// Sums, in two passes: chunk_quads gives each chunk its lanes' statistics
// as a quadratic form in the state h entering it, sum_l quad_l = c0 - 2 q.h
// + h^T Q h, beside its composite map h -> Mc h + mc, its log-det sum and
// its minimum pivot; quad_spine walks each segment's chunks with h.  With
// lane l's incoming state h_l = Pl h + pl (P1 = I, p1 = 0) and quad_l(h_l) =
// q0 - 2 qv.h_l + h_l^T Qm h_l: Q += Pl^T Qm Pl, q += Pl^T (qv - Qm pl),
// c0 += q0 - 2 qv.pl + pl^T Qm pl, then Pl <- M Pl, pl <- M pl + m.  No
// lane's h is written.
// ---------------------------------------------------------------------------

constexpr int CGW = 32 / G;                   // groups a one-warp block
// A chunk's sums, NQR words: Q, Mc (row-major), q, mc, c0, the log-det sum
// and the minimum pivot.
struct QF {
    enum { Q = 0, M = PP, V = 2 * PP, MV = 2 * PP + P, C0 = 2 * PP + 2 * P, LD, MN };
};
constexpr int NQR = 2 * PP + 2 * P + 3;

struct Chunk {
    int l0, l1;
    bool last;
};

__device__ __forceinline__ Chunk chunk_of(int k, int seg, int c, int nck) {
    const int s = k / nck, i = k % nck;
    Chunk ch;
    ch.l0 = s * seg + i * c;
    ch.l1 = min(ch.l0 + c, (s + 1) * seg);
    ch.last = i == nck - 1;
    return ch;
}

// Each chunk's total (A, J, C) into tot (EL_NR words a chunk); the last
// chunk of a segment has none, since no seed follows it.
template <typename T>
__device__ __forceinline__ void chunk_totals(const T* __restrict__ A, const T* __restrict__ J,
                                             const T* __restrict__ C, int B, int seg, int c,
                                             int nck, int nch, double* __restrict__ tot) {
    constexpr int W = 2 * EL_NS + 2 * P * TS;
    __shared__ double sm[CGW * W];
    const int q = threadIdx.x / G, r = threadIdx.x % G, k = blockIdx.x * CGW + q;
    if (k >= nch) return;
    const Chunk ch = chunk_of(k, seg, c, nck);
    if (ch.last) return;
    const unsigned gm = group_mask();
    double *run = sm + q * W, *nxt = run + EL_NS, *t0 = nxt + EL_NS, *t1 = t0 + P * TS;
    ElRows<T> in;
    in.fetch(A, J, C, r, B, ch.l0);
    in.put(run, r);
    if (ch.l0 + 1 < ch.l1) in.fetch(A, J, C, r, B, ch.l0 + 1);
    for (int l = ch.l0 + 1; l < ch.l1; ++l) {
        __syncwarp(gm);
        in.put(nxt, r);
        __syncwarp(gm);
        if (l + 1 < ch.l1) in.fetch(A, J, C, r, B, l + 1);
        double Ao[P], Jo[P], Co[P];
        compose_rows(gm, r, run, nxt, t0, t1, Ao, Jo, Co);
        __syncwarp(gm);
        put_el(run, r, Ao, Jo, Co);
    }
    __syncwarp(gm);
    slot_to_rec<3, false>(run, tot + (size_t)k * EL_NR, r);
}

// Each segment's walk over its chunk totals from C = 0: chunk i's seed
// (the C before it) into seeds (PP words a chunk).
__device__ __forceinline__ void seed_spine(const double* __restrict__ tot, int nseg, int nck,
                                           double* __restrict__ seeds) {
    constexpr int W = EL_NS + P * TS;
    __shared__ double sm[CGW * W];
    const int q = threadIdx.x / G, r = threadIdx.x % G, s = blockIdx.x * CGW + q;
    if (s >= nseg) return;
    const unsigned gm = group_mask();
    double *e = sm + q * W, *tk = e + EL_NS;
    double c[P], x[3 * P];  // x: rows r of the next chunk total, read ahead
    const auto fetch = [&](size_t k) {
#pragma unroll
        for (int f = 0; f < 3; ++f)
#pragma unroll
            for (int j = 0; j < P; ++j)
                x[f * P + j] = r < P ? tot[k * EL_NR + f * PP + r * P + j] : 0.0;
    };
#pragma unroll
    for (int j = 0; j < P; ++j) c[j] = 0.0;
    if (nck > 1) fetch((size_t)s * nck);
    for (int i = 0; i < nck; ++i) {
        const size_t k = (size_t)s * nck + i;
        if (r < P) {
#pragma unroll
            for (int j = 0; j < P; ++j) seeds[k * PP + r * P + j] = c[j];
        }
        if (i == nck - 1) break;
        __syncwarp(gm);
        if (r < P) {
#pragma unroll
            for (int f = 0; f < 3; ++f)
#pragma unroll
                for (int j = 0; j < P; ++j) e[f * P * TS + r * TS + j] = x[f * P + j];
        }
        __syncwarp(gm);
        if (i + 2 < nck) fetch(k + 1);
        cstep_rows(gm, r, c, e, tk);
    }
}

// Each chunk's walk over its lanes from its seed: every lane's seed, the C
// before it, into sh0 (P, P, B).
template <typename T>
__device__ __forceinline__ void chunk_seeds(const T* __restrict__ A, const T* __restrict__ J,
                                            const T* __restrict__ C,
                                            const double* __restrict__ seeds, int B, int seg,
                                            int c, int nck, int nch, T* __restrict__ sh0) {
    constexpr int W = EL_NS + P * TS;
    __shared__ double sm[CGW * W];
    const int q = threadIdx.x / G, r = threadIdx.x % G, k = blockIdx.x * CGW + q;
    if (k >= nch) return;
    const Chunk ch = chunk_of(k, seg, c, nck);
    const unsigned gm = group_mask();
    double *e = sm + q * W, *tk = e + EL_NS;
    double cr[P];
#pragma unroll
    for (int j = 0; j < P; ++j) cr[j] = r < P ? seeds[(size_t)k * PP + r * P + j] : 0.0;
    ElRows<T> in;
    if (ch.l0 + 1 < ch.l1) in.fetch(A, J, C, r, B, ch.l0);
    for (int l = ch.l0; l < ch.l1; ++l) {
        if (r < P) {
#pragma unroll
            for (int j = 0; j < P; ++j) sh0[((size_t)r * P + j) * B + l] = static_cast<T>(cr[j]);
        }
        if (l + 1 == ch.l1) break;
        __syncwarp(gm);
        in.put(e, r);
        __syncwarp(gm);
        if (l + 2 < ch.l1) in.fetch(A, J, C, r, B, l + 1);
        cstep_rows(gm, r, cr, e, tk);
    }
}

// Each chunk's sums (NQR words a chunk, QF) from its lanes' maps and
// statistics.
template <typename T>
__device__ __forceinline__ void chunk_quads(const T* __restrict__ M, const T* __restrict__ mv,
                                            const T* __restrict__ Qm, const T* __restrict__ qv,
                                            const double* __restrict__ q0,
                                            const double* __restrict__ ld,
                                            const T* __restrict__ mind, int B, int seg, int c,
                                            int nck, int nch, double* __restrict__ rec) {
    constexpr int W = 2 * P * TS;
    __shared__ double sm[CGW * W];
    const int q = threadIdx.x / G, r = threadIdx.x % G, k = blockIdx.x * CGW + q;
    if (k >= nch) return;
    const Chunk ch = chunk_of(k, seg, c, nck);
    const unsigned gm = group_mask();
    const bool in = r < P;
    double *tp = sm + q * W, *tq = tp + P * TS;  // Pl, then Qm Pl
    if (in) {
#pragma unroll
        for (int j = 0; j < P; ++j) tp[r * TS + j] = j == r ? 1.0 : 0.0;
    }
    double Q[P], qr = 0.0, pr = 0.0, c0 = 0.0, lds = 0.0, mn = INFINITY;
#pragma unroll
    for (int j = 0; j < P; ++j) Q[j] = 0.0;
    // Lane l's rows r of M and Qm, its qv_r and m_r, q0, ld and minimum
    // pivot, read a lane ahead.
    struct LaneSums {
        double M[P], Q[P], qv, m, q0, ld, d;
    };
    const auto fetch = [&](int l) {
        LaneSums f;
#pragma unroll
        for (int j = 0; j < P; ++j) {
            const size_t o = ((size_t)r * P + j) * B + l;
            f.M[j] = in ? static_cast<double>(M[o]) : 0.0;
            f.Q[j] = in ? static_cast<double>(Qm[o]) : 0.0;
        }
        f.qv = in ? static_cast<double>(qv[(size_t)r * B + l]) : 0.0;
        f.m = in ? static_cast<double>(mv[(size_t)r * B + l]) : 0.0;
        f.q0 = q0[l];
        f.ld = ld[l];
        f.d = static_cast<double>(mind[l]);
        return f;
    };
    LaneSums nxt = fetch(ch.l0);
    for (int l = ch.l0; l < ch.l1; ++l) {
        const LaneSums cur = nxt;
        if (l + 1 < ch.l1) nxt = fetch(l + 1);
        const double(&Mr)[P] = cur.M;
        const double(&Qr)[P] = cur.Q;
        const double qvr = cur.qv, mr = cur.m, d = cur.d;
        double pv[P], t[P], x[P];
        lds += cur.ld;
        mn = (d < mn || d != d) ? d : mn;
#pragma unroll
        for (int j = 0; j < P; ++j) pv[j] = __shfl_sync(gm, pr, j, G);
        double qp = 0.0;  // (Qm pl)_r
#pragma unroll
        for (int j = 0; j < P; ++j) qp = mac(Qr[j], pv[j], qp);
        c0 += cur.q0 + gsum(gm, pr * qp) - 2.0 * gsum(gm, qvr * pr);
        const double tr_ = qvr - qp;
#pragma unroll
        for (int j = 0; j < P; ++j) t[j] = __shfl_sync(gm, tr_, j, G);
        __syncwarp(gm);
        // q += Pl^T t (column r of Pl); Qm Pl by rows into tq.
#pragma unroll
        for (int j = 0; j < P; ++j) x[j] = 0.0;
        if (in) {
#pragma unroll
            for (int m = 0; m < P; ++m) {
                qr = mac(tp[m * TS + r], t[m], qr);
#pragma unroll
                for (int j = 0; j < P; ++j) x[j] = mac(Qr[m], tp[m * TS + j], x[j]);
            }
#pragma unroll
            for (int j = 0; j < P; ++j) tq[r * TS + j] = x[j];
        }
        __syncwarp(gm);
        // Q += Pl^T (Qm Pl); Pl <- M Pl, pl <- M pl + m.
#pragma unroll
        for (int j = 0; j < P; ++j) x[j] = 0.0;
        double pn = mr;
        if (in) {
#pragma unroll
            for (int m = 0; m < P; ++m) {
                const double pm = tp[m * TS + r];
#pragma unroll
                for (int j = 0; j < P; ++j) {
                    Q[j] = mac(pm, tq[m * TS + j], Q[j]);
                    x[j] = mac(Mr[m], tp[m * TS + j], x[j]);
                }
                pn = mac(Mr[m], pv[m], pn);
            }
        }
        pr = pn;
        __syncwarp(gm);
        if (in) {
#pragma unroll
            for (int j = 0; j < P; ++j) tp[r * TS + j] = x[j];
        }
        __syncwarp(gm);
    }
    if (!in) return;
    double* x = rec + (size_t)k * NQR;
#pragma unroll
    for (int j = 0; j < P; ++j) {
        x[QF::Q + r * P + j] = Q[j];
        x[QF::M + r * P + j] = tp[r * TS + j];
    }
    x[QF::V + r] = qr;
    x[QF::MV + r] = pr;
    if (r == 0) {
        x[QF::C0] = c0;
        x[QF::LD] = lds;
        x[QF::MN] = mn;
    }
}

// Each segment's walk over its chunks' sums with h from 0: its quad and
// log-det sums and minimum pivot.
template <typename T>
__device__ __forceinline__ void quad_spine(const double* __restrict__ rec, int nseg, int nck,
                                           double* __restrict__ quad_out,
                                           double* __restrict__ ld_out, T* __restrict__ mind_out) {
    const int q = threadIdx.x / G, r = threadIdx.x % G, s = blockIdx.x * CGW + q;
    if (s >= nseg) return;
    const unsigned gm = group_mask();
    const bool in = r < P;
    double hr = 0.0, quad = 0.0, lds = 0.0, mn = INFINITY;
    // Rows r of chunk i's Q and Mc, its q_r and mc_r, and its c0, log-det
    // and minimum pivot, read a chunk ahead.
    struct Sums {
        double Q[P], M[P], q, mc, c0, ld, mn;
    };
    const auto fetch = [&](int i) {
        const double* x = rec + ((size_t)s * nck + i) * NQR;
        Sums f;
#pragma unroll
        for (int j = 0; j < P; ++j) {
            f.Q[j] = in ? x[QF::Q + r * P + j] : 0.0;
            f.M[j] = in ? x[QF::M + r * P + j] : 0.0;
        }
        f.q = in ? x[QF::V + r] : 0.0;
        f.mc = in ? x[QF::MV + r] : 0.0;
        f.c0 = x[QF::C0];
        f.ld = x[QF::LD];
        f.mn = x[QF::MN];
        return f;
    };
    Sums nxt = fetch(0);
    for (int i = 0; i < nck; ++i) {
        const Sums x = nxt;
        if (i + 1 < nck) nxt = fetch(i + 1);
        double hv[P], qh = 0.0, hn = x.mc;
#pragma unroll
        for (int j = 0; j < P; ++j) hv[j] = __shfl_sync(gm, hr, j, G);
#pragma unroll
        for (int j = 0; j < P; ++j) {
            qh = mac(x.Q[j], hv[j], qh);
            hn = mac(x.M[j], hv[j], hn);
        }
        quad += x.c0 + gsum(gm, hr * qh) - 2.0 * gsum(gm, x.q * hr);
        lds += x.ld;
        mn = (x.mn < mn || x.mn != x.mn) ? x.mn : mn;
        hr = hn;
    }
    if (r != 0) return;
    quad_out[s] = quad;
    ld_out[s] = lds;
    mind_out[s] = static_cast<T>(mn);
}
