// The cross-lane prefixes of the single-sweep value (fused.cu) and of its
// forward-mode tangents (tangent.cu), on the card, in float64 whatever the
// streams' dtype.
//
// The Pallas kernels fused.py:130 and tangent.py:591 compose each lane's
// Riccati element (A, J, C) into every lane's seed S-hat, and each lane's
// affine map (M, m) into its incoming state h, by Hillis-Steele scans over
// the lane axis inside the kernel (in VMEM between the two phases); the
// port's other routes run those scans as float64 torch glue, a few dozen
// launches a round (fused4.prefix_sh0, prefix_h0).  Here each scan is one
// launch, a block per segment (chain) of lanes, and with tangents a block
// per (segment, direction), walking the segment's lanes in order:
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
// The Hillis-Steele rounds compose the same elements in another order, so
// the seeds and sums differ from the plain versions' (the torch glue) by
// rounding alone.  A segment's lanes are sequential: the work is ~8 P^3
// flops a lane for the seeds, ~4 P^2 for the sums, a handful of
// __syncthreads() each, small beside the sweeps' L steps a lane.
//
// Include after lanes_common.cuh (P, PP).

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
