// Fused primal GP log-likelihood for Hopper (sm_90a).
//
// Replaces: celerite_tpu/ops/fused4.py:_primal_kernel (the Pallas kernel
// launched by run_primal).  Same mathematics: each virtual lane owns a
// contiguous chunk of L points.  Phase 0 lowers the packed coefficients per
// step (u, v, phi, a from t, t_lo, dt, diag, mask) and accumulates the
// lane's Riccati element (A, J, C).  A segmented Hillis-Steele prefix over
// lanes composes the elements; the exclusive prefix seeds each lane.
// Phase 1 reruns the lane seeded and accumulates the affine map (M, m) and
// the statistics (Kahan-summed quad and log-det, qv, Qm, min pivot).  A
// second prefix over (M, m) gives each lane its incoming state h, and
//   quad_l = q0 - 2 qv.h + h^T Qm h.
// The host sums quad and ld per segment (fused4.run_primal).
//
// Design.  On the TPU the grid (2, L) runs in order on one core and the
// state stays in VMEM between grid steps.  Here one thread owns one lane
// and loops over its L steps, so the P x P state lives in registers (it
// spills to local memory at P = 8 in float64; registers and spills are in
// PERF.md).  Nothing carries between thread blocks, so the cross-lane work
// is separate launches on the caller's stream: elements -> log2(seg)
// element-prefix rounds -> factor/statistics -> log2(seg) affine rounds ->
// assembly.  The streams are (L, B) with step i of lane l at i*B + l, so a
// warp reads 32 neighbouring words per stream and step.  Segments of `seg`
// lanes (chain folding) never exchange state.
//
// Bound.  The function reads 6 streams of N words once: 24 MB at N = 1e6
// in float32, ~7 us at 3.35 TB/s (this kernel reads them twice, once per
// phase, 48 MB).  The arithmetic is a few hundred operations per point.
// Both are far below the time of the 2 log2(seg) + 3 dependent launches
// and of the per-lane sequential recursion, so in practice the kernel is
// bound by latency.
//
// Numerics: fused4_common.cuh.  Compiled once per padded width:
// nvcc -DCELERITE_P=<P> (1 <= P <= 12).

#include "fused4_common.cuh"

static_assert(P <= 12, "padded width must be in [1, 12]");

struct Streams {
    const void* t;
    const void* tl;
    const void* dt;
    const void* dg;
    const void* m;
    const void* y;
};

// ---------------------------------------------------------------------------
// Phase 0: each lane's Riccati element (A, J, C)
// Element buffer layout: ((e * P + i) * P + j) * B + l, e = 0 (A), 1 (J), 2 (C).
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
elem_kernel(const T* __restrict__ cf, int seg, const T* __restrict__ t,
            const T* __restrict__ tl, const T* __restrict__ dt, const T* __restrict__ dg,
            const T* __restrict__ msk, int L, int B, int jr, double* __restrict__ el) {
    const int l = blockIdx.x * blockDim.x + threadIdx.x;
    if (l >= B) return;
    Coeffs<T> k;
    load_coeffs(cf + (size_t)(l / seg) * (2 * P + 1), jr, k);

    T Sh[P][P], A[P][P], J[P][P];
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
        for (int j = 0; j < P; ++j) {
            Sh[i][j] = T(0);
            A[i][j] = i == j ? T(1) : T(0);
            J[i][j] = T(0);
        }

    for (int s = 0; s < L; ++s) {
        const size_t o = (size_t)s * B + l;
        T u[P], v[P], ph[P], w[P], a;
        lower_step(k, jr, t[o], tl[o], dt[o], dg[o], msk[o], u, v, ph, a);
        const T d = riccati_step(Sh, u, v, ph, a, w);
        T uA[P];
#pragma unroll
        for (int j = 0; j < P; ++j) {
            T acc = T(0);
#pragma unroll
            for (int i = 0; i < P; ++i) acc += A[i][j] * (ph[i] * u[i]);
            uA[j] = acc;
        }
#pragma unroll
        for (int i = 0; i < P; ++i)
#pragma unroll
            for (int j = 0; j < P; ++j) {
                A[i][j] = ph[i] * A[i][j] - w[i] * uA[j];
                J[i][j] = J[i][j] - uA[i] * (uA[j] / d);
            }
    }
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
        for (int j = 0; j < P; ++j) {
            el[(size_t)(0 * PP + i * P + j) * B + l] = A[i][j];
            el[(size_t)(1 * PP + i * P + j) * B + l] = J[i][j];
            el[(size_t)(2 * PP + i * P + j) * B + l] = Sh[i][j];
        }
}

// ---------------------------------------------------------------------------
// Element prefix: one Hillis-Steele round, out[l] = e[l - s] o e[l]
// (fused4._compose_elem: e1 = the left neighbour comes first).  The
// cross-lane work (both prefixes and the assembly) runs in float64 for
// float32 streams too: composing float32 elements through the unpivoted
// inverse of (I + C1 J2) lost whole runs of lanes to non-positive pivots
// on the card (PERF.md), and it is a small share of the work.
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void load_mat(const T* __restrict__ buf, int e, int B, int l, T (&X)[P][P]) {
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
        for (int j = 0; j < P; ++j) X[i][j] = buf[(size_t)(e * PP + i * P + j) * B + l];
}

template <typename T>
__device__ __forceinline__ void store_mat(T* __restrict__ buf, int e, int B, int l, const T (&X)[P][P]) {
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
        for (int j = 0; j < P; ++j) buf[(size_t)(e * PP + i * P + j) * B + l] = X[i][j];
}

// Z = X Y, or X^T Y with tx.
template <typename T, bool tx = false, bool ty = false>
__device__ __forceinline__ void matmul(const T (&X)[P][P], const T (&Y)[P][P], T (&Z)[P][P]) {
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
        for (int j = 0; j < P; ++j) {
            T acc = (tx ? X[0][i] : X[i][0]) * (ty ? Y[j][0] : Y[0][j]);
#pragma unroll
            for (int q = 1; q < P; ++q) acc += (tx ? X[q][i] : X[i][q]) * (ty ? Y[j][q] : Y[q][j]);
            Z[i][j] = acc;
        }
}

// In-place Gauss-Jordan inverse without pivoting (fused4._inv).
template <typename T>
__device__ __forceinline__ void invert(T (&M)[P][P], T (&E)[P][P]) {
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
        for (int j = 0; j < P; ++j) E[i][j] = i == j ? T(1) : T(0);
#pragma unroll
    for (int q = 0; q < P; ++q) {
        const T piv = M[q][q];
        T rm[P], re[P];
#pragma unroll
        for (int c = 0; c < P; ++c) {
            rm[c] = M[q][c] / piv;
            re[c] = E[q][c] / piv;
        }
#pragma unroll
        for (int r = 0; r < P; ++r) {
            if (r == q) continue;
            const T f = M[r][q];
#pragma unroll
            for (int c = 0; c < P; ++c) {
                M[r][c] = M[r][c] - f * rm[c];
                E[r][c] = E[r][c] - f * re[c];
            }
        }
#pragma unroll
        for (int c = 0; c < P; ++c) {
            M[q][c] = rm[c];
            E[q][c] = re[c];
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
elem_round(const T* __restrict__ in, T* __restrict__ out, int B, int s, int seg) {
    const int l = blockIdx.x * blockDim.x + threadIdx.x;
    if (l >= B) return;
    if ((l % seg) < s) {
        for (int q = 0; q < 3 * PP; ++q) out[(size_t)q * B + l] = in[(size_t)q * B + l];
        return;
    }
    const int l1 = l - s;
    T X[P][P], Y[P][P], E[P][P], Z[P][P];
    // E = (I + C1 J2)^-1
    {
        T C1[P][P], J2[P][P];
        load_mat(in, 2, B, l1, C1);
        load_mat(in, 1, B, l, J2);
        matmul(C1, J2, X);
#pragma unroll
        for (int i = 0; i < P; ++i) X[i][i] = T(1) + X[i][i];
        invert(X, E);
    }
    // A12 = A2 (E A1)
    {
        T A1[P][P], A2[P][P];
        load_mat(in, 0, B, l1, A1);
        load_mat(in, 0, B, l, A2);
        matmul(E, A1, X);
        matmul(A2, X, Z);
        store_mat(out, 0, B, l, Z);
        // C12 = (A2 E) (C1 A2^T) + C2
        T C1[P][P];
        load_mat(in, 2, B, l1, C1);
        matmul(A2, E, X);
        matmul<T, false, true>(C1, A2, Y);
        matmul(X, Y, Z);
        load_mat(in, 2, B, l, Y);
#pragma unroll
        for (int i = 0; i < P; ++i)
#pragma unroll
            for (int j = 0; j < P; ++j) Z[i][j] = Z[i][j] + Y[i][j];
        store_mat(out, 2, B, l, Z);
        // J12 = J1 + A1^T ((J2 E) A1)
        load_mat(in, 1, B, l, Y);
        matmul(Y, E, X);
        matmul(X, A1, Y);
        matmul<T, true, false>(A1, Y, Z);
        load_mat(in, 1, B, l1, Y);
#pragma unroll
        for (int i = 0; i < P; ++i)
#pragma unroll
            for (int j = 0; j < P; ++j) Z[i][j] = Y[i][j] + Z[i][j];
        store_mat(out, 1, B, l, Z);
    }
}

// ---------------------------------------------------------------------------
// Phase 1: seeded factorization, affine map (M, m) and statistics.
// Affine buffer: M at (i * P + j) * B + l, m at (PP + i) * B + l.
// Statistics:    Qm at (i * P + j) * B + l, qv at (PP + i) * B + l,
//                q0 + cq0, ld + cld, min pivot at (PP + P + 0/1/2) * B + l.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
factor_kernel(const T* __restrict__ cf, int seg, const T* __restrict__ t,
              const T* __restrict__ tl, const T* __restrict__ dt, const T* __restrict__ dg,
              const T* __restrict__ msk, const T* __restrict__ y, int L, int B, int jr,
              const double* __restrict__ el, double* __restrict__ aff,
              double* __restrict__ st) {
    const int l = blockIdx.x * blockDim.x + threadIdx.x;
    if (l >= B) return;
    Coeffs<T> k;
    load_coeffs(cf + (size_t)(l / seg) * (2 * P + 1), jr, k);

    // Exclusive seed: the inclusive prefix C of the previous lane.
    T Sh[P][P], M[P][P], Qm[P][P], mv[P], qv[P];
    const bool first = (l % seg) == 0;
#pragma unroll
    for (int i = 0; i < P; ++i) {
#pragma unroll
        for (int j = 0; j < P; ++j) {
            Sh[i][j] = first ? T(0) : static_cast<T>(el[(size_t)(2 * PP + i * P + j) * B + (l - 1)]);
            M[i][j] = i == j ? T(1) : T(0);
            Qm[i][j] = T(0);
        }
        mv[i] = T(0);
        qv[i] = T(0);
    }
    T q0 = T(0), cq0 = T(0), ld = T(0), cld = T(0);
    T mind = T(INFINITY);

    for (int s = 0; s < L; ++s) {
        const size_t o = (size_t)s * B + l;
        T u[P], v[P], ph[P], w[P], a;
        lower_step(k, jr, t[o], tl[o], dt[o], dg[o], msk[o], u, v, ph, a);
        const T yo = y[o];
        const T d = riccati_step(Sh, u, v, ph, a, w);

        T g[P];
#pragma unroll
        for (int i = 0; i < P; ++i)
#pragma unroll
            for (int j = 0; j < P; ++j) M[i][j] = ph[i] * M[i][j];
#pragma unroll
        for (int j = 0; j < P; ++j) {
            T acc = T(0);
#pragma unroll
            for (int i = 0; i < P; ++i) acc += M[i][j] * u[i];
            g[j] = acc;
        }
#pragma unroll
        for (int i = 0; i < P; ++i)
#pragma unroll
            for (int j = 0; j < P; ++j) M[i][j] = M[i][j] - w[i] * g[j];

        T um = T(0);
#pragma unroll
        for (int i = 0; i < P; ++i) {
            mv[i] = ph[i] * mv[i];
            um += u[i] * mv[i];
        }
        const T z0 = yo - um;
#pragma unroll
        for (int i = 0; i < P; ++i) mv[i] = mv[i] + w[i] * z0;

        // Kahan-compensated quad and log-det accumulators.
        const T x1 = z0 * z0 / d - cq0;
        const T t1 = q0 + x1;
        cq0 = (t1 - q0) - x1;
        q0 = t1;
        const T x2 = dlog(d) - cld;
        const T t2 = ld + x2;
        cld = (t2 - ld) - x2;
        ld = t2;

        const T zd = z0 / d;
#pragma unroll
        for (int i = 0; i < P; ++i) qv[i] = qv[i] + zd * g[i];
#pragma unroll
        for (int i = 0; i < P; ++i)
#pragma unroll
            for (int j = 0; j < P; ++j) Qm[i][j] = Qm[i][j] + g[i] * (g[j] / d);
        // NaN-propagating min, like torch.minimum / jnp.minimum.
        mind = (d < mind || d != d) ? d : mind;
    }

#pragma unroll
    for (int i = 0; i < P; ++i) {
#pragma unroll
        for (int j = 0; j < P; ++j) {
            aff[(size_t)(i * P + j) * B + l] = M[i][j];
            st[(size_t)(i * P + j) * B + l] = Qm[i][j];
        }
        aff[(size_t)(PP + i) * B + l] = mv[i];
        st[(size_t)(PP + i) * B + l] = qv[i];
    }
    st[(size_t)(PP + P) * B + l] = static_cast<double>(q0) + static_cast<double>(cq0);
    st[(size_t)(PP + P + 1) * B + l] = static_cast<double>(ld) + static_cast<double>(cld);
    st[(size_t)(PP + P + 2) * B + l] = mind;
}

// ---------------------------------------------------------------------------
// Affine prefix round: (M, m)[l] <- (M_l M_{l-s}, M_l m_{l-s} + m_l).
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
affine_round(const T* __restrict__ in, T* __restrict__ out, int B, int s, int seg) {
    const int l = blockIdx.x * blockDim.x + threadIdx.x;
    if (l >= B) return;
    if ((l % seg) < s) {
        for (int q = 0; q < PP + P; ++q) out[(size_t)q * B + l] = in[(size_t)q * B + l];
        return;
    }
    const int l1 = l - s;
    T M1[P][P], Ms[P][P], Z[P][P];
    load_mat(in, 0, B, l1, M1);
    load_mat(in, 0, B, l, Ms);
    matmul(Ms, M1, Z);
    store_mat(out, 0, B, l, Z);
#pragma unroll
    for (int i = 0; i < P; ++i) {
        T acc = T(0);
#pragma unroll
        for (int j = 0; j < P; ++j) acc += Ms[i][j] * in[(size_t)(PP + j) * B + l1];
        out[(size_t)(PP + i) * B + l] = acc + in[(size_t)(PP + i) * B + l];
    }
}

// quad_l = q0 - 2 qv.h + h^T Qm h with h the exclusive affine prefix.
template <typename T>
__global__ void __launch_bounds__(THREADS)
assemble(const double* __restrict__ aff, const double* __restrict__ st, int B, int seg,
         T* __restrict__ quad, T* __restrict__ ld, T* __restrict__ mind) {
    const int l = blockIdx.x * blockDim.x + threadIdx.x;
    if (l >= B) return;
    const bool first = (l % seg) == 0;
    double h[P];
#pragma unroll
    for (int i = 0; i < P; ++i) h[i] = first ? 0.0 : aff[(size_t)(PP + i) * B + (l - 1)];
    double qvh = 0.0, hQh = 0.0;
#pragma unroll
    for (int i = 0; i < P; ++i) {
        double Qh = 0.0;
#pragma unroll
        for (int j = 0; j < P; ++j) Qh += st[(size_t)(i * P + j) * B + l] * h[j];
        qvh += st[(size_t)(PP + i) * B + l] * h[i];
        hQh += h[i] * Qh;
    }
    quad[l] = static_cast<T>(st[(size_t)(PP + P) * B + l] - 2.0 * qvh + hQh);
    ld[l] = static_cast<T>(st[(size_t)(PP + P + 1) * B + l]);
    mind[l] = static_cast<T>(st[(size_t)(PP + P + 2) * B + l]);
}

// ---------------------------------------------------------------------------
// Host launcher: every launch on the caller's stream, nothing allocated.
// Workspace (doubles): 2 x 3PP B (element ping-pong), 2 x (PP + P) B
// (affine ping-pong), (PP + P + 3) B (statistics).  cf holds one row of
// 2P + 1 coefficients per segment of `seg` lanes.
// ---------------------------------------------------------------------------

template <typename T>
static int launch(const void* cf_, const Streams& sm, int L, int B, int jr, int seg,
                  void* ws_, void* quad, void* ld, void* mind, cudaStream_t stream) {
    const T* cf = static_cast<const T*>(cf_);
    const T* t = static_cast<const T*>(sm.t);
    const T* tl = static_cast<const T*>(sm.tl);
    const T* dt = static_cast<const T*>(sm.dt);
    const T* dg = static_cast<const T*>(sm.dg);
    const T* m = static_cast<const T*>(sm.m);
    const T* y = static_cast<const T*>(sm.y);
    double* e0 = static_cast<double*>(ws_);
    double* e1 = e0 + (size_t)3 * PP * B;
    double* f0 = e1 + (size_t)3 * PP * B;
    double* f1 = f0 + (size_t)(PP + P) * B;
    double* stats = f1 + (size_t)(PP + P) * B;
    const dim3 grid((B + THREADS - 1) / THREADS), block(THREADS);
    cudaError_t err;

    elem_kernel<T><<<grid, block, 0, stream>>>(cf, seg, t, tl, dt, dg, m, L, B, jr, e0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    for (int s = 1; s < seg; s *= 2) {
        elem_round<double><<<grid, block, 0, stream>>>(e0, e1, B, s, seg);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
        double* tmp = e0; e0 = e1; e1 = tmp;
    }
    factor_kernel<T><<<grid, block, 0, stream>>>(cf, seg, t, tl, dt, dg, m, y, L, B, jr, e0,
                                                 f0, stats);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    for (int s = 1; s < seg; s *= 2) {
        affine_round<double><<<grid, block, 0, stream>>>(f0, f1, B, s, seg);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
        double* tmp = f0; f0 = f1; f1 = tmp;
    }
    assemble<T><<<grid, block, 0, stream>>>(f0, stats, B, seg, static_cast<T*>(quad),
                                            static_cast<T*>(ld), static_cast<T*>(mind));
    return (int)cudaGetLastError();
}

extern "C" {

int celerite_fused4_width() { return P; }

int celerite_fused4_primal_f32(const void* cf, const void* t, const void* tl, const void* dt,
                               const void* dg, const void* m, const void* y, void* ws,
                               void* quad, void* ld, void* mind, int L, int B, int jr,
                               int seg, void* stream) {
    const Streams sm{t, tl, dt, dg, m, y};
    return launch<float>(cf, sm, L, B, jr, seg, ws, quad, ld, mind,
                         static_cast<cudaStream_t>(stream));
}

int celerite_fused4_primal_f64(const void* cf, const void* t, const void* tl, const void* dt,
                               const void* dg, const void* m, const void* y, void* ws,
                               void* quad, void* ld, void* mind, int L, int B, int jr,
                               int seg, void* stream) {
    const Streams sm{t, tl, dt, dg, m, y};
    return launch<double>(cf, sm, L, B, jr, seg, ws, quad, ld, mind,
                          static_cast<cudaStream_t>(stream));
}

}  // extern "C"
