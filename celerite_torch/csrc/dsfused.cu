// Exact mode for Hopper (sm_90a): the log-likelihood's per-lane sweeps with
// forward-mode tangents, in float64.
//
// Replaces the Pallas kernels of celerite_tpu/ops/dsfused.py:
//   elem_ds_kernel    <- _elem_kernel   (dsfused.py:379)
//   factor_ds_kernel  <- _factor_kernel (dsfused.py:432)
// The JAX kernels carry every stream and recursion as a dual of
// double-single words because the TPU has no float64.  The card computes
// float64 natively, so these carry a float64 value and one float64 tangent:
// the value is the fused4 sweep (fused4_grad.cu's elem_fwd / factor_fwd
// without saves) on the raw-jitter coefficient layout, the tangent its
// derivative along a unit seed on packed coefficient toff + j.  The
// cross-lane prefixes between the two kernels and the assembly after them
// run as float64 torch glue in forward mode (celerite_torch/ops/dsfused.py).
//
// Design.  A group of G threads (G = 1, 2, 4, 8 for P <= 8; 16 up to
// P = 12) runs one (lane, direction) item: item i of a launch of T
// directions is lane i % B along direction i / B, and thread r of the group
// owns row r of every P x P state (value and tangent), so a thread holds
// 6 P values of state, not the 6 P^2 that no thread's registers hold at
// P = 8 (one thread an item spilled heavily).  Each thread lowers the
// whole step itself (the stream vectors are P long); sums over rows are
// xor-shuffle reductions within the group (fused4_common.cuh).  Each item
// recomputes the lane's value recursion beside its tangent, as each
// direction chunk of the JAX pipeline reruns the value per launch; the item
// of direction 0 also writes the value.  T = 0 launches the value alone (no
// tangent arithmetic).  Outputs carry a word axis: word 0 the value, word
// 1 + j direction j, at ((w * P + i) * P + j) * B + l.
//
// Bound.  Bytes: each of the (1 + T) words of the per-lane outputs once, and
// the five or six (L, B) streams once (the factor also reads the 1 + T seed
// words): at config[2]'s exact-mode plan (16 chains x 128 lanes, 782
// steps, P = 8, T = 17) ~64 MB of streams and ~57 MB of output words a
// kernel, ~0.04 ms at 3.35 TB/s.  Operations: the value step once a point
// and the tangent step T times, ~1.1 x 10^3 and ~2.7 x 10^3 flops a point
// and direction at P = 8 (chip_smoke.ds_bound_ms), ~7.6 x 10^10 a launch,
// ~2.2 ms at 34 TFLOP/s float64: the function is bound by operations.
// These kernels also redo the value step T times, and a lane's recursion
// is a chain of dependent steps.
//
// Rounding: the default fma contraction.  The float64 bar against the plain
// versions is 1e-10; a contraction moves a step by ~1e-16 relative, which
// the solver's cancelling pivots amplify ~1e3 times at most.
//
// Compiled once per padded width: nvcc -DCELERITE_P=<P> (1 <= P <= 12).

#include "fused4_common.cuh"

static_assert(P <= 12, "padded width must be in [1, 12]");

typedef double R;

// Threads a block: BLOCK / G items.
constexpr int BLOCK = 128;
static_assert(BLOCK % G == 0, "a block holds whole groups");

// Row r of word w of a (1 + T, P, P, B) output, lane l.
__device__ __forceinline__ void put_row(R* __restrict__ out, int w, int r, int B, int l,
                                        const R (&a)[P]) {
    R* p = out + ((size_t)w * PP + (size_t)r * P) * B + l;
#pragma unroll
    for (int j = 0; j < P; ++j) p[(size_t)j * B] = a[j];
}

__device__ __forceinline__ void get_row(const R* __restrict__ in, int w, int r, int B, int l,
                                        R (&a)[P]) {
#pragma unroll
    for (int j = 0; j < P; ++j) a[j] = R(0);
    if (r >= P) return;
    const R* p = in + ((size_t)w * PP + (size_t)r * P) * B + l;
#pragma unroll
    for (int j = 0; j < P; ++j) a[j] = p[(size_t)j * B];
}

// The item of this thread; threads past the launch's items run lane 0 for
// the group's shuffles and write nothing.
struct Item {
    int l, jd, r;
    bool live;
};

__device__ __forceinline__ Item item_of(int B, int T) {
    const size_t g = (size_t)blockIdx.x * BLOCK + threadIdx.x;
    const size_t i = g / G;
    Item it;
    it.live = i < (size_t)B * (T > 0 ? T : 1);
    it.l = it.live ? (int)(i % B) : 0;
    it.jd = it.live ? (int)(i / B) : 0;
    it.r = (int)(threadIdx.x % G);
    return it;
}

// ---------------------------------------------------------------------------
// elem_ds: phase 0 (each lane's Riccati element A, J, C) with a tangent.
// ---------------------------------------------------------------------------

template <bool TAN>
__global__ void __launch_bounds__(BLOCK)
elem_ds_kernel(const R* __restrict__ cf, int seg, const R* __restrict__ t,
               const R* __restrict__ tl, const R* __restrict__ dt, const R* __restrict__ dg,
               const R* __restrict__ msk, int L, int B, int jr, int toff, int T,
               R* __restrict__ A_out, R* __restrict__ J_out, R* __restrict__ C_out) {
    const Item it = item_of(B, TAN ? T : 0);
    const int l = it.l, r = it.r;
    Coeffs<R> k;
    load_coeffs_ds(cf + (size_t)(l / seg) * (2 * P + 1), jr, k);
    const Seed sd = decode_seed(TAN ? toff + it.jd : -1, jr);

    // Row r of Sh, A, J and of their tangents.
    R Sh[P], A[P], J[P], dSh[P], dA[P], dJ[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
        Sh[j] = J[j] = dSh[j] = dA[j] = dJ[j] = R(0);
        A[j] = j == r ? R(1) : R(0);
    }

    for (int s = 0; s < L; ++s) {
        const size_t o = (size_t)s * B + l;
        const R ts = t[o], tls = tl[o], dts = dt[o], ms = msk[o];
        R u[P], v[P], ph[P], w[P], a, wr, uA[P];
        R du[P], dv[P], dph[P], dw[P], da, dwr, dd, duA[P];
        lower_step(k, jr, ts, tls, dts, dg[o], ms, u, v, ph, a);
        if constexpr (TAN) lower_tangent(k, jr, sd, ts, tls, dts, ms, v, ph, du, dv, dph, da);
        const R d = riccati_row<TAN>(Sh, dSh, r, u, du, v, dv, ph, dph, a, da, wr, w, dwr, dw,
                                     dd);
        // uA = A^T (Phi u): a sum over rows for every column.
        const R phr = pick(ph, r), utr = phr * pick(u, r);
        R dphr = R(0), dutr = R(0);
        if constexpr (TAN) {
            dphr = pick(dph, r);
            dutr = dphr * pick(u, r) + phr * pick(du, r);
        }
#pragma unroll
        for (int j = 0; j < P; ++j) {
            uA[j] = group_sum(A[j] * utr);
            if constexpr (TAN) duA[j] = group_sum(dA[j] * utr + A[j] * dutr);
        }
        const R uAr = pick(uA, r);
#pragma unroll
        for (int j = 0; j < P; ++j) {
            if constexpr (TAN) {
                const R duAr = pick(duA, r);
                dA[j] = dphr * A[j] + phr * dA[j] - dwr * uA[j] - wr * duA[j];
                dJ[j] = dJ[j] - (duAr * uA[j] + uAr * duA[j]) / d + uAr * uA[j] * (dd / (d * d));
            }
            A[j] = phr * A[j] - wr * uA[j];
            J[j] = J[j] - uAr * (uA[j] / d);
        }
    }
    if (!it.live || r >= P) return;
    if (it.jd == 0) {
        put_row(A_out, 0, r, B, l, A);
        put_row(J_out, 0, r, B, l, J);
        put_row(C_out, 0, r, B, l, Sh);
    }
    if constexpr (TAN) {
        put_row(A_out, 1 + it.jd, r, B, l, dA);
        put_row(J_out, 1 + it.jd, r, B, l, dJ);
        put_row(C_out, 1 + it.jd, r, B, l, dSh);
    }
}

// ---------------------------------------------------------------------------
// factor_ds: phase 1 from the dual seed sh0 (1 + T, P, P, B): the affine map
// (M, m) and the statistics (Qm, qv, Kahan-summed q0 and ld) with a tangent,
// and the value's minimum pivot.
// ---------------------------------------------------------------------------

template <bool TAN>
__global__ void __launch_bounds__(BLOCK)
factor_ds_kernel(const R* __restrict__ cf, int seg, const R* __restrict__ t,
                 const R* __restrict__ tl, const R* __restrict__ dt, const R* __restrict__ dg,
                 const R* __restrict__ msk, const R* __restrict__ y, int L, int B, int jr,
                 int toff, int T, const R* __restrict__ sh0, R* __restrict__ M_out,
                 R* __restrict__ m_out, R* __restrict__ Qm_out, R* __restrict__ qv_out,
                 R* __restrict__ q0_out, R* __restrict__ ld_out, R* __restrict__ mind_out) {
    const Item it = item_of(B, TAN ? T : 0);
    const int l = it.l, r = it.r;
    Coeffs<R> k;
    load_coeffs_ds(cf + (size_t)(l / seg) * (2 * P + 1), jr, k);
    const Seed sd = decode_seed(TAN ? toff + it.jd : -1, jr);

    // Row r of Sh, M, Qm, entry r of m, qv, and their tangents; the scalar
    // statistics are kept alike in every thread of the group.
    R Sh[P], M[P], Qm[P], dSh[P], dM[P], dQm[P];
    get_row(sh0, 0, r, B, l, Sh);
    if constexpr (TAN) get_row(sh0, 1 + it.jd, r, B, l, dSh);
#pragma unroll
    for (int j = 0; j < P; ++j) {
        M[j] = j == r ? R(1) : R(0);
        Qm[j] = dM[j] = dQm[j] = R(0);
    }
    R mvr = R(0), qvr = R(0), dmvr = R(0), dqvr = R(0);
    R q0 = R(0), cq0 = R(0), ld = R(0), cld = R(0);
    R dq0 = R(0), dcq0 = R(0), dld = R(0), dcld = R(0);
    R mind = R(INFINITY);

    for (int s = 0; s < L; ++s) {
        const size_t o = (size_t)s * B + l;
        const R ts = t[o], tls = tl[o], dts = dt[o], ms = msk[o];
        const R yo = y[o];
        R u[P], v[P], ph[P], w[P], a, wr, gv[P];
        R du[P], dv[P], dph[P], dw[P], da, dwr, dd, dgv[P];
        lower_step(k, jr, ts, tls, dts, dg[o], ms, u, v, ph, a);
        if constexpr (TAN) lower_tangent(k, jr, sd, ts, tls, dts, ms, v, ph, du, dv, dph, da);
        const R d = riccati_row<TAN>(Sh, dSh, r, u, du, v, dv, ph, dph, a, da, wr, w, dwr, dw,
                                     dd);
        const R phr = pick(ph, r), ur = pick(u, r);
        R dphr = R(0), dur = R(0);
        if constexpr (TAN) {
            dphr = pick(dph, r);
            dur = pick(du, r);
        }
        // M <- (I - w u^T) Phi M with g = (Phi M)^T u.
#pragma unroll
        for (int j = 0; j < P; ++j) {
            if constexpr (TAN) dM[j] = dphr * M[j] + phr * dM[j];
            M[j] = phr * M[j];
        }
#pragma unroll
        for (int j = 0; j < P; ++j) {
            gv[j] = group_sum(M[j] * ur);
            if constexpr (TAN) dgv[j] = group_sum(dM[j] * ur + M[j] * dur);
        }
#pragma unroll
        for (int j = 0; j < P; ++j) {
            if constexpr (TAN) dM[j] = dM[j] - dwr * gv[j] - wr * dgv[j];
            M[j] = M[j] - wr * gv[j];
        }
        // m <- Phi m + w z0 with z0 = y - u . Phi m.
        const R mh = phr * mvr;
        const R z0 = yo - group_sum(ur * mh);
        const R zd = z0 / d;
        const R gr = pick(gv, r);
        if constexpr (TAN) {
            const R dmh = dphr * mvr + phr * dmvr;
            const R dz0 = -group_sum(dur * mh + ur * dmh);
            dmvr = dmh + dwr * z0 + wr * dz0;
            // The tangents of the Kahan-summed quad and log-det.
            const R dzd = (dz0 - zd * dd) / d;
            const R y1 = dz0 * zd + z0 * dzd - dcq0;
            const R s1 = dq0 + y1;
            dcq0 = (s1 - dq0) - y1;
            dq0 = s1;
            const R y2 = dd / d - dcld;
            const R s2 = dld + y2;
            dcld = (s2 - dld) - y2;
            dld = s2;
            const R dgr = pick(dgv, r);
            dqvr = dqvr + dzd * gr + zd * dgr;
#pragma unroll
            for (int j = 0; j < P; ++j)
                dQm[j] = dQm[j] + (dgr * gv[j] + gr * dgv[j]) / d - gr * gv[j] * (dd / (d * d));
        }
        mvr = mh + wr * z0;
        // Kahan-compensated quad and log-det of the value.
        const R x1 = z0 * z0 / d - cq0;
        const R t1 = q0 + x1;
        cq0 = (t1 - q0) - x1;
        q0 = t1;
        const R x2 = dlog(d) - cld;
        const R t2 = ld + x2;
        cld = (t2 - ld) - x2;
        ld = t2;
        qvr = qvr + zd * gr;
#pragma unroll
        for (int j = 0; j < P; ++j) Qm[j] = Qm[j] + gr * (gv[j] / d);
        // NaN-propagating min, like torch.minimum.
        mind = (d < mind || d != d) ? d : mind;
    }

    if (!it.live || r >= P) return;
    if (it.jd == 0) {
        put_row(M_out, 0, r, B, l, M);
        put_row(Qm_out, 0, r, B, l, Qm);
        m_out[(size_t)r * B + l] = mvr;
        qv_out[(size_t)r * B + l] = qvr;
        if (r == 0) {
            q0_out[l] = q0 + cq0;
            ld_out[l] = ld + cld;
            mind_out[l] = mind;
        }
    }
    if constexpr (TAN) {
        const size_t w = 1 + it.jd;
        put_row(M_out, (int)w, r, B, l, dM);
        put_row(Qm_out, (int)w, r, B, l, dQm);
        m_out[(w * P + r) * B + l] = dmvr;
        qv_out[(w * P + r) * B + l] = dqvr;
        if (r == 0) {
            q0_out[w * B + l] = dq0 + dcq0;
            ld_out[w * B + l] = dld + dcld;
        }
    }
}

// ---------------------------------------------------------------------------
// Host entry points: one launch each on the caller's stream, nothing
// allocated; cf holds one row of 2P + 1 coefficients (pack_cf_ds) per
// segment of `seg` lanes.  T = 0 launches the value alone.  Each returns
// cudaGetLastError() after its launch.
// ---------------------------------------------------------------------------

static inline dim3 grid_for(int B, int T) {
    const size_t n = (size_t)B * (T > 0 ? T : 1) * G;
    return dim3((unsigned)((n + BLOCK - 1) / BLOCK));
}

extern "C" {

int celerite_dsfused_elem(const void* cf, const void* t, const void* tl, const void* dt,
                          const void* dg, const void* m, void* A, void* J, void* C, int L,
                          int B, int jr, int seg, int toff, int T, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const R* args[6] = {static_cast<const R*>(cf), static_cast<const R*>(t),
                        static_cast<const R*>(tl), static_cast<const R*>(dt),
                        static_cast<const R*>(dg), static_cast<const R*>(m)};
    if (T > 0)
        elem_ds_kernel<true><<<grid_for(B, T), BLOCK, 0, st>>>(
            args[0], seg, args[1], args[2], args[3], args[4], args[5], L, B, jr, toff, T,
            static_cast<R*>(A), static_cast<R*>(J), static_cast<R*>(C));
    else
        elem_ds_kernel<false><<<grid_for(B, 0), BLOCK, 0, st>>>(
            args[0], seg, args[1], args[2], args[3], args[4], args[5], L, B, jr, toff, 0,
            static_cast<R*>(A), static_cast<R*>(J), static_cast<R*>(C));
    return (int)cudaGetLastError();
}

int celerite_dsfused_factor(const void* cf, const void* t, const void* tl, const void* dt,
                            const void* dg, const void* m, const void* y, const void* sh0,
                            void* M, void* mv, void* Qm, void* qv, void* q0, void* ld,
                            void* mind, int L, int B, int jr, int seg, int toff, int T,
                            void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const R* args[7] = {static_cast<const R*>(cf), static_cast<const R*>(t),
                        static_cast<const R*>(tl), static_cast<const R*>(dt),
                        static_cast<const R*>(dg), static_cast<const R*>(m),
                        static_cast<const R*>(y)};
    if (T > 0)
        factor_ds_kernel<true><<<grid_for(B, T), BLOCK, 0, st>>>(
            args[0], seg, args[1], args[2], args[3], args[4], args[5], args[6], L, B, jr, toff,
            T, static_cast<const R*>(sh0), static_cast<R*>(M), static_cast<R*>(mv),
            static_cast<R*>(Qm), static_cast<R*>(qv), static_cast<R*>(q0), static_cast<R*>(ld),
            static_cast<R*>(mind));
    else
        factor_ds_kernel<false><<<grid_for(B, 0), BLOCK, 0, st>>>(
            args[0], seg, args[1], args[2], args[3], args[4], args[5], args[6], L, B, jr, toff,
            0, static_cast<const R*>(sh0), static_cast<R*>(M), static_cast<R*>(mv),
            static_cast<R*>(Qm), static_cast<R*>(qv), static_cast<R*>(q0), static_cast<R*>(ld),
            static_cast<R*>(mind));
    return (int)cudaGetLastError();
}

}  // extern "C"
