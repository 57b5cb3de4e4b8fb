// The gradient pipeline of the fused GP log-likelihood for Hopper (sm_90a):
// four per-lane sweeps with per-step saves.
//
// Replaces the Pallas kernels of celerite_tpu/ops/fused4.py that
// build_ll_and_grad launches:
//   elem_fwd_kernel    <- _elem_fwd_kernel   (fused4.py:499)
//   factor_fwd_kernel  <- _factor_fwd_kernel (fused4.py:619)
//   factor_bwd_kernel  <- _factor_bwd_kernel (fused4.py:686)
//   elem_bwd_kernel    <- _elem_bwd_kernel   (fused4.py:533)
// The forward pair is the primal's two phases (fused4_primal.cu) split at
// the element prefix, each writing its per-step input state to a save
// stream.  The backward pair walks the steps in reverse, recomputes each
// step's lowering and Riccati intermediates from the saves, transposes the
// step by hand (the F1-F9 / E1-E12 comments follow the Pallas bodies) and
// accumulates the packed-coefficient cotangent per lane (chain_row).  The
// cross-lane prefixes and their VJP run between the launches as float64
// torch glue (celerite_torch/ops/fused4.py); cotangents and seeds that come
// from the glue arrive in float64 and are rounded to T here on load.
//
// Design.  Each kernel carries more state than one thread's registers hold
// (one thread a lane spilled 7.2 KB at P = 8 in float64 in elem_fwd, 5.4
// KB in factor_fwd), so each gives a lane a group of G threads (the power
// of two at or above P; 16 at P = 9..12), thread r owning row r of every P
// x P state (no spills at P <= 12; registers and spills are in PERF.md).
// Thread r lowers its own column of each step (u_r, v_r, phi_r; the two
// rows of a complex pair compute their shared exp and sincos each) from its
// coefficients in shared memory (Col), and the group gathers u and phi by
// shuffles.  The forward pair runs adjoint.cu's forward steps (elem_fwd
// runs elements_fwd's elem_fwd_step, factor_fwd factor_fwd's
// factor_fwd_step; adjoint_common.cuh), their scalar streams copied three
// steps ahead into a ring in shared memory (cp.async), in blocks of four
// warps where that still gives every SM a block, else of one (the one-theta
// plan's 512 lanes at P = 8: 128 blocks of 4 lanes); a four-warp block
// writes each step's saves together from shared memory.  The backward pair,
// BLOCK threads a block, two blocks an SM, runs the adjoint and one-pass
// transposes' steps (factor_bwd_step, elem_bwd_step): the front and the
// back of each step one after the other in the group's threads, through a
// record, a tile and a vector a group in shared memory; the constant
// cotangent (hQm, hJ) waits in a second tile.  Thread r reads row r of the
// step's saves; its share of the coefficient cotangent is its column's
// only, in shared memory beside its coefficients, and a pair's two rows are
// added at the end.  One coefficient row per segment of `seg` lanes.  The
// streams and saves are stored with the lane fastest, step s of lane l at s
// * B + l and save word q at (s * NSV + q) * B + l, so a warp reads and
// writes neighbouring words.
//
// Bound.  Bytes: the saves, 2P^2 + (2P^2 + P) words a point, are written
// once and read once; at config[2] (N = 1e5, P = 8, float64) that is 211 MB
// a chain, ~0.13 ms at 3.35 TB/s, well above the streams' 6-7 words a
// point.  Operations: a few thousand a point for P = 8 (each sweep
// recomputes the step and its O(P^2) products).  In practice the kernels
// are bound by the latency of the per-lane dependent recursion (the
// backward pair: of its shuffle reductions and shared-memory round trips).
//
// Numerics: fused4_common.cuh.  Compiled once per padded width:
// nvcc -DCELERITE_P=<P> (1 <= P <= 12).

#include "fused4_fwd.cuh"

// ---------------------------------------------------------------------------
// factor_bwd: reversed phase 1, a group of G threads a lane.  Cotangents of
// the outputs (float64): hM0, hm0 seed the sweep; hQm, hqv, hq0, hld are
// constant through it.  Writes the per-lane coefficient rows hcf (C, B),
// the data cotangent hy (L, B) and the seed cotangent hsh0 (P, P, B).
// ---------------------------------------------------------------------------

// Row r of chain_step: the step's stream cotangents (hu_r, hv_r, hph_r,
// ha) onto the coefficients.  A pair's cm, sm are its columns of v and its
// decay is phi, so d(phi)/d(c) = -dt phi and d(angle)/d(d) = t + t_lo.
template <typename T>
__device__ __forceinline__ void chain_row(const Col<T>& k, T hu, T hv, T hph, T ha, T ph, T cm,
                                          T sm, T t, T tl, T dt, T m) {
    if (k.kind == 0) {
        k[GA] += hu * m;
        k[GB] += hph * ph * (-dt);
    } else if (k.kind > 0) {
        // u = (a cm + b sm, a sm - b cm), v = (cm, sm) on the pair's rows;
        // d cm / d ang = -sm, d sm / d ang = cm.
        const T ang = t + tl, a = k[CA], b = k[CB];
        k[GC] += hph * ph * (-dt);
        if (k.kind == 1) {
            k[GA] += hu * cm;
            k[GB] += hu * sm;
            k[GD] += (b * hu * cm - (a * hu + hv) * sm) * ang;
        } else {
            k[GA] += hu * sm;
            k[GB] -= hu * cm;
            k[GD] += ((a * hu + hv) * cm + b * hu * sm) * ang;
        }
    }
    k[GT] += ha * m;
}

// The packed layout of load_coeffs, hcf[k * B + l]: a pair's second row
// hands its terms to the first.  Every thread of the warp calls it.
template <typename T>
__device__ __forceinline__ void store_col_grad(const Col<T>& k, int jr, int r, int B, int l,
                                               bool live, T* __restrict__ hcf) {
    const int mate = k.kind == 1 ? r + 1 : (k.kind == 2 ? r - 1 : r);
    T g[4], m[4];
#pragma unroll
    for (int f = 0; f < 4; ++f) {
        g[f] = k[GA + f];
        m[f] = __shfl_sync(0xffffffffu, g[f], mate, G);
    }
    if (!live) return;
    const int jc = (P - jr) / 2;
    if (k.kind == 0) {
        hcf[(size_t)r * B + l] = g[0];
        hcf[(size_t)(jr + r) * B + l] = g[1];
    } else if (k.kind == 1) {
        const int j = (r - jr) >> 1;
#pragma unroll
        for (int f = 0; f < 4; ++f) hcf[(size_t)(2 * jr + f * jc + j) * B + l] = g[f] + m[f];
    }
    if (r == 0) hcf[(size_t)(2 * jr + 4 * jc) * B + l] = k[GT];
}

// Two blocks an SM, up to 255 registers a thread: left to itself ptxas
// held the kernel at 168 registers and spilled at P = 8 in float64, 1.34x
// slower (PERF.md).
template <typename T>
__global__ void __launch_bounds__(BLOCK, 2)
factor_bwd_kernel(const T* __restrict__ cf, int seg, const T* __restrict__ t,
                  const T* __restrict__ tl, const T* __restrict__ dt, const T* __restrict__ dg,
                  const T* __restrict__ msk, const T* __restrict__ y, int L, int B, int jr,
                  const T* __restrict__ sv, const double* __restrict__ hM0,
                  const double* __restrict__ hm0, const double* __restrict__ hQm0,
                  const double* __restrict__ hqv0, const double* __restrict__ hq0_,
                  const double* __restrict__ hld_, T* __restrict__ hcf, T* __restrict__ hy_out,
                  T* __restrict__ hsh0) {
    // Each group's tiles (its transposes', then hQm's), its step's record
    // and its P words of a vector.
    __shared__ T tiles[2 * LANES * P * TS];
    __shared__ T recs[NX * LANES];
    __shared__ T vecs[LANES * P];
    __shared__ T cols[NCOL * BLOCK];
    const Lane ln = lane_of(B);
    const int l = ln.l, r = ln.r, grp = threadIdx.x / G;
    T* tile = tiles + grp * 2 * P * TS;
    T* hq = tile + P * TS;
    const Rec<T, LANES> rec{recs + grp};
    const Col<T> k = load_col(cols, cf + (size_t)(l / seg) * (2 * P + 1), jr, r);

    // The cotangents, rounded to T; hQm waits in the group's tile.
    T hM[P], hSh[P];
    load_tile(hq, hQm0, r, B, l);
    __syncwarp();
    get_mat(hM0, r, B, l, hM);
#pragma unroll
    for (int j = 0; j < P; ++j) hSh[j] = T(0);
    T hm = r < P ? static_cast<T>(hm0[(size_t)r * B + l]) : T(0);
    const T hqv = r < P ? static_cast<T>(hqv0[(size_t)r * B + l]) : T(0);
    const T hq0 = static_cast<T>(hq0_[l]), hld = static_cast<T>(hld_[l]);

    for (int s = L - 1; s >= 0; --s) {
        const size_t o = (size_t)s * B + l;
        const T ts = t[o], tls = tl[o], dts = dt[o], ms = msk[o];
        T ur, vr, phr, cm, sm, uv[P], pv[P];
        lower_row(k, ts, tls, dts, ms, ur, vr, phr, cm, sm);
        gather(ur, uv);
        gather(phr, pv);
        const T a = ms * (dg[o] + k[CT]) + (T(1) - ms);
        // Row r of the step's saves [Shin, Mprev, mprev].
        const T* sp = sv + (size_t)s * NSV1 * B + l;
        T Shin[P], Mprev[P];
#pragma unroll
        for (int j = 0; j < P; ++j) {
            Shin[j] = r < P ? sp[(size_t)(r * P + j) * B] : T(0);
            Mprev[j] = r < P ? sp[(size_t)(PP + r * P + j) * B] : T(0);
        }
        const T mprev = r < P ? sp[(size_t)(2 * PP + r) * B] : T(0);
        T hu, hv, hph, ha, hy;
        const RegStep<T> in{uv, pv, Shin, Mprev, ur, phr, vr, a, y[o], mprev};
        factor_bwd_step(tile, hq, vecs + grp * P, rec, r, in, hqv, hq0, hld, hM, hm, hSh, hu,
                        hv, hph, ha, hy);
        if (ln.live && r == 0) hy_out[o] = hy;
        chain_row(k, hu, hv, hph, ha, phr, cm, sm, ts, tls, dts, ms);
    }
    store_col_grad(k, jr, r, B, l, ln.live, hcf);
    if (ln.live && r < P) put_mat(hsh0, r, B, l, hSh);
}

// ---------------------------------------------------------------------------
// elem_bwd: reversed phase 0, laid out as factor_bwd: a group of G threads
// a lane, thread r row r.  Cotangents of the lane's element (float64, from
// the prefix VJP): hA0 and hC0 seed the sweep, hJ0 is constant and waits in
// the group's tile.  Writes the per-lane coefficient rows hcf (C, B).
// ---------------------------------------------------------------------------

// Two blocks an SM, as factor_bwd.
template <typename T>
__global__ void __launch_bounds__(BLOCK, 2)
elem_bwd_kernel(const T* __restrict__ cf, int seg, const T* __restrict__ t,
                const T* __restrict__ tl, const T* __restrict__ dt, const T* __restrict__ dg,
                const T* __restrict__ msk, int L, int B, int jr, const T* __restrict__ sv,
                const double* __restrict__ hA0, const double* __restrict__ hJ0,
                const double* __restrict__ hC0, T* __restrict__ hcf) {
    // Each group's tiles (its transposes', then hJ's), its step's record
    // and its P words of a vector.
    __shared__ T tiles[2 * LANES * P * TS];
    __shared__ T recs[NX * LANES];
    __shared__ T vecs[LANES * P];
    __shared__ T cols[NCOL * BLOCK];
    const Lane ln = lane_of(B);
    const int l = ln.l, r = ln.r, grp = threadIdx.x / G;
    T* tile = tiles + grp * 2 * P * TS;
    T* hj = tile + P * TS;
    const Rec<T, LANES> rec{recs + grp};
    const Col<T> k = load_col(cols, cf + (size_t)(l / seg) * (2 * P + 1), jr, r);

    // The carried cotangents, rounded to T; hJ waits in the group's tile.
    T hA[P], hSh[P];
    load_tile(hj, hJ0, r, B, l);
    __syncwarp();
    get_mat(hA0, r, B, l, hA);
    get_mat(hC0, r, B, l, hSh);

    for (int s = L - 1; s >= 0; --s) {
        const size_t o = (size_t)s * B + l;
        const T ts = t[o], tls = tl[o], dts = dt[o], ms = msk[o];
        T ur, vr, phr, cm, sm, uv[P], pv[P];
        lower_row(k, ts, tls, dts, ms, ur, vr, phr, cm, sm);
        gather(ur, uv);
        gather(phr, pv);
        const T a = ms * (dg[o] + k[CT]) + (T(1) - ms);
        // Row r of the step's saves [Shin, A_in].
        const T* sp = sv + (size_t)s * NSV0 * B + l;
        T Shin[P], Ain[P];
#pragma unroll
        for (int j = 0; j < P; ++j) {
            Shin[j] = r < P ? sp[(size_t)(r * P + j) * B] : T(0);
            Ain[j] = r < P ? sp[(size_t)(PP + r * P + j) * B] : T(0);
        }
        T hu, hv, hph, ha;
        const RegStep<T> in{uv, pv, Shin, Ain, ur, phr, vr, a, T(0), T(0)};
        elem_bwd_step(tile, hj, vecs + grp * P, rec, r, in, hA, hSh, hu, hv, hph, ha);
        chain_row(k, hu, hv, hph, ha, phr, cm, sm, ts, tls, dts, ms);
    }
    store_col_grad(k, jr, r, B, l, ln.live, hcf);
}

// ---------------------------------------------------------------------------
// Host entry points: one launch each on the caller's stream, nothing
// allocated; cf holds one row of 2P + 1 coefficients per segment of `seg`
// lanes.  Each returns cudaGetLastError() after its launch.
// ---------------------------------------------------------------------------

#define CELERITE_GRAD_ENTRIES(T, SFX)                                                            \
    int celerite_fused4_elem_fwd_##SFX(const void* cf, const void* t, const void* tl,           \
                                       const void* dt, const void* dg, const void* m, void* A,   \
                                       void* J, void* C, void* sv, int L, int B, int jr,         \
                                       int seg, void* stream) {                                  \
        return launch_fwd(                                                                       \
            elem_fwd_kernel<T, 4>, elem_fwd_kernel<T, 1>, B, stream,                             \
            static_cast<const T*>(cf), seg, static_cast<const T*>(t),                            \
            static_cast<const T*>(tl), static_cast<const T*>(dt), static_cast<const T*>(dg),     \
            static_cast<const T*>(m), L, B, jr, static_cast<T*>(A), static_cast<T*>(J),          \
            static_cast<T*>(C), static_cast<T*>(sv));                                            \
    }                                                                                            \
    int celerite_fused4_factor_fwd_##SFX(                                                        \
        const void* cf, const void* t, const void* tl, const void* dt, const void* dg,           \
        const void* m, const void* y, const void* sh0, void* M, void* mv, void* Qm, void* qv,    \
        void* q0, void* ld, void* mind, void* sv, int L, int B, int jr, int seg, void* stream) { \
        return launch_fwd(                                                                       \
            factor_fwd_kernel<T, 4>, factor_fwd_kernel<T, 1>, B, stream,                         \
            static_cast<const T*>(cf), seg, static_cast<const T*>(t),                            \
            static_cast<const T*>(tl), static_cast<const T*>(dt), static_cast<const T*>(dg),     \
            static_cast<const T*>(m), static_cast<const T*>(y), L, B, jr,                        \
            static_cast<const double*>(sh0), static_cast<T*>(M), static_cast<T*>(mv),            \
            static_cast<T*>(Qm), static_cast<T*>(qv), static_cast<double*>(q0),                  \
            static_cast<double*>(ld), static_cast<T*>(mind), static_cast<T*>(sv));               \
    }                                                                                            \
    int celerite_fused4_factor_bwd_##SFX(                                                        \
        const void* cf, const void* t, const void* tl, const void* dt, const void* dg,           \
        const void* m, const void* y, const void* sv, const void* hM, const void* hm,            \
        const void* hQm, const void* hqv, const void* hq0, const void* hld, void* hcf,           \
        void* hy, void* hsh0, int L, int B, int jr, int seg, void* stream) {                     \
        factor_bwd_kernel<T><<<grid_for(B, G), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(  \
            static_cast<const T*>(cf), seg, static_cast<const T*>(t),                            \
            static_cast<const T*>(tl), static_cast<const T*>(dt), static_cast<const T*>(dg),     \
            static_cast<const T*>(m), static_cast<const T*>(y), L, B, jr,                        \
            static_cast<const T*>(sv), static_cast<const double*>(hM),                           \
            static_cast<const double*>(hm), static_cast<const double*>(hQm),                     \
            static_cast<const double*>(hqv), static_cast<const double*>(hq0),                    \
            static_cast<const double*>(hld), static_cast<T*>(hcf), static_cast<T*>(hy),          \
            static_cast<T*>(hsh0));                                                              \
        return (int)cudaGetLastError();                                                          \
    }                                                                                            \
    int celerite_fused4_elem_bwd_##SFX(const void* cf, const void* t, const void* tl,           \
                                       const void* dt, const void* dg, const void* m,            \
                                       const void* sv, const void* hA, const void* hJ,           \
                                       const void* hC, void* hcf, int L, int B, int jr,          \
                                       int seg, void* stream) {                                  \
        elem_bwd_kernel<T><<<grid_for(B, G), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(   \
            static_cast<const T*>(cf), seg, static_cast<const T*>(t),                            \
            static_cast<const T*>(tl), static_cast<const T*>(dt), static_cast<const T*>(dg),     \
            static_cast<const T*>(m), L, B, jr, static_cast<const T*>(sv),                       \
            static_cast<const double*>(hA), static_cast<const double*>(hJ),                      \
            static_cast<const double*>(hC), static_cast<T*>(hcf));                               \
        return (int)cudaGetLastError();                                                          \
    }

extern "C" {

CELERITE_GRAD_ENTRIES(float, f32)
CELERITE_GRAD_ENTRIES(double, f64)

}  // extern "C"
