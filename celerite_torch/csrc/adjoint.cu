// The adjoint pipeline for Hopper (sm_90a): the log-likelihood's per-lane
// sweeps and their reversed transposes on pre-lowered streams, padded
// widths 1..16.
//
// Replaces the Pallas kernels of celerite_tpu/ops/adjoint.py:
//   adjoint_elements_fwd_kernel <- _elements_fwd_kernel (adjoint.py:63)
//   adjoint_elements_bwd_kernel <- _elements_bwd_kernel (adjoint.py:98)
//   adjoint_factor_fwd_kernel   <- _factor_fwd_kernel   (adjoint.py:188)
//   adjoint_factor_bwd_kernel   <- _factor_bwd_kernel   (adjoint.py:253)
// The forward pair gives each lane's Riccati element (A, J, C) and, from
// the lane's seed, its affine map (M, m) and statistics (Qm, qv,
// Kahan-summed q0 and log-det, min pivot), each writing its per-step input
// state to a save stream.  The backward pair walks the steps in reverse,
// recomputes each step's intermediates from the saves and the streams, and
// transposes the step by hand (the F1-F9 / E1-E12 comments follow the
// Pallas bodies), writing the per-step stream cotangents (hu, hv, hph, ha,
// hy) that autograd chains through the lowering.  The cross-lane prefixes
// and their VJP run between the launches as float64 torch glue
// (celerite_torch/ops/fused4.py).
//
// Design.  The state is the problem at P = 16: a lane carries three P x P
// matrices forward (Sh, A, J or Sh, M, Qm) and, backward, three adjoints
// beside the recomputed S and the loaded saves, 768 and more doubles.  One
// thread a lane cannot hold that (fused4_grad.cu's factor_bwd spills 14,452
// bytes a thread at P = 8).  As in dsfused.cu, a group of G threads (the
// power of two at or above P; 16 for P = 13..16) owns one lane, thread r
// row r of every P x P state, so a thread holds a few P-vectors; rows r >=
// P are padding that holds zeros.  Row sums are thread-local; sums over
// rows are xor-shuffle reductions within the group (group_sum); the
// transposes of the backward bodies (hJ + hJ^T, hSh + hSh^T, X + X^T with
// X = hS * Shin, hQm + hQm^T) and the column sums of S go through a
// per-group tile in shared memory, since a register array indexed by
// another thread's row would spill.  Every thread reads the step's stream
// vectors (u, ph) whole; they are (L, P, B), lane fastest.  The group
// helpers and the elements sweep are in lanes_common.cuh, shared with
// pallas_solver.cu.
//
// Saves, (L, B, NSV): step s of lane l holds NSV consecutive words, each
// saved matrix column-major (word j * P + i is entry (i, j)) and then the
// saved vector, so at a given column the group's threads write and read P
// consecutive words.
//
// Bound.  Bytes: per point the streams (3P + 1 or 2 words read) and the
// saves (2P^2 or 2P^2 + P words, written forward and read backward); the
// backward kernels write 3P + 1 or 2 cotangent words.  At P = 16 that is
// ~2,380 words a point over the four kernels: for 16 chains of N = 1e5 in
// float64, ~30 GB, ~9 ms at 3.35 TB/s.  Operations: ~120 P^2 a point over
// the four, ~1.4 ms at 34 TFLOP/s float64.  So the function is bound by
// bytes; the kernels are also bound by the latency of each lane's chain of
// dependent steps, each with a few dozen shuffle reductions.
//
// Rounding: -fmad=false (_build.SOURCE_FLAGS), so that float32 rounds as
// the plain versions, which keep every multiply and add separate; sums
// over rows run in another order than theirs.
//
// Compiled once per padded width: nvcc -DCELERITE_P=<P> (1 <= P <= 16).

#include "lanes_common.cuh"

// Lane groups of a block, and a group's tile.
constexpr int LANES = BLOCK / G;
constexpr int TS = P + 1;          // row stride of a group's tile

// Row r of a column-major saved matrix at `base`; zeros for r >= P.
template <typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ base, int r, T (&x)[P]) {
#pragma unroll
    for (int j = 0; j < P; ++j) x[j] = r < P ? base[j * P + r] : T(0);
}

// Row r of x^T (column r of x) through the group's tile; zeros for r >= P.
template <typename T>
__device__ __forceinline__ void transpose_row(T* tile, int r, const T (&x)[P], T (&xt)[P]) {
    if (r < P) {
#pragma unroll
        for (int j = 0; j < P; ++j) tile[r * TS + j] = x[j];
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < P; ++j) xt[j] = r < P ? tile[j * TS + r] : T(0);
    __syncwarp();
}

// Steps 5-1 of both backward sweeps (F5-F1 = E5-E1, fused4._riccati_adjoint),
// row r: the transposes of Sh_out = S + d w w^T, w = (v - su)/d, d = a -
// u.su, su = S u and S = Phi Shin Phi.  hSh comes in as the output's
// cotangent and leaves as Shin's; hw, hd, hu, hph come in with the step's
// other contributions; writes hv and ha.
template <typename T>
__device__ __forceinline__ void riccati_adjoint_row(T* tile, int r, const T (&Shin)[P],
                                                    const T (&S)[P], T su, T d, T wr,
                                                    const T (&w)[P], const T (&u)[P],
                                                    const T (&ph)[P], T (&hSh)[P], T hw, T hd,
                                                    T& hu, T& hph, T& hv, T& ha) {
    const T ur = pick(u, r), phr = pick(ph, r);
    T tmp[P];
    // F5: Sh_out = S + d w w^T
    T q = T(0);
#pragma unroll
    for (int j = 0; j < P; ++j) q += hSh[j] * wr * w[j];
    hd = hd + group_sum(q);
    transpose_row(tile, r, hSh, tmp);
    T t = T(0);
#pragma unroll
    for (int j = 0; j < P; ++j) t += (hSh[j] + tmp[j]) * w[j];
    hw = hw + d * t;
    // F4: w = (v - su)/d
    hv = hw / d;
    T hsu = -hw / d;
    hd = hd - group_sum(hw * wr) / d;
    // F3: d = a - u.su
    ha = hd;
    hu = hu - hd * su;
    hsu = hsu - hd * ur;
    // F2: su = S u (hu gains column r of S against hsu)
    transpose_row(tile, r, S, tmp);
    T hsuv[P];
    gather(hsu, hsuv);
    T c = T(0);
#pragma unroll
    for (int i = 0; i < P; ++i) c += tmp[i] * hsuv[i];
    hu = hu + c;
#pragma unroll
    for (int j = 0; j < P; ++j) hSh[j] = hSh[j] + hsu * u[j];  // hS
    // F1: S = Phi Shin Phi
    T X[P];
#pragma unroll
    for (int j = 0; j < P; ++j) X[j] = hSh[j] * Shin[j];
    transpose_row(tile, r, X, tmp);
    T e = T(0);
#pragma unroll
    for (int j = 0; j < P; ++j) e += (X[j] + tmp[j]) * ph[j];
    hph = hph + e;
#pragma unroll
    for (int j = 0; j < P; ++j) hSh[j] = phr * hSh[j] * ph[j];
}

// ---------------------------------------------------------------------------
// elements_fwd: each lane's Riccati element (A, J, C) with saves.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(BLOCK)
adjoint_elements_fwd_kernel(const T* __restrict__ u, const T* __restrict__ v,
                            const T* __restrict__ ph, const T* __restrict__ a, int L, int B,
                            T* __restrict__ A_out, T* __restrict__ J_out, T* __restrict__ C_out,
                            T* __restrict__ sv) {
    elements_sweep<true>(u, v, ph, a, L, B, A_out, J_out, C_out, sv);
}

// ---------------------------------------------------------------------------
// elements_bwd: the transpose of elements_fwd, streamed in reverse.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(BLOCK)
adjoint_elements_bwd_kernel(const T* __restrict__ u, const T* __restrict__ v,
                            const T* __restrict__ ph, const T* __restrict__ a,
                            const T* __restrict__ sv, const T* __restrict__ hA0,
                            const T* __restrict__ hJ0, const T* __restrict__ hC0, int L, int B,
                            T* __restrict__ hu_out, T* __restrict__ hv_out,
                            T* __restrict__ hph_out, T* __restrict__ ha_out) {
    __shared__ T tiles[LANES * P * TS];
    const Lane ln = lane_of(B);
    const int l = ln.l, r = ln.r;
    T* tile = tiles + (threadIdx.x / G) * P * TS;
    T hA[P], hJ[P], hJs[P], hSh[P];
    get_mat(hA0, r, B, l, hA);
    get_mat(hJ0, r, B, l, hJ);
    get_mat(hC0, r, B, l, hSh);
    // J_in enters additively: hJ is constant, and enters symmetrised.
    transpose_row(tile, r, hJ, hJs);
#pragma unroll
    for (int j = 0; j < P; ++j) hJs[j] = hJ[j] + hJs[j];

    for (int s = L - 1; s >= 0; --s) {
        const T* svs = sv + ((size_t)s * B + l) * NSV0;
        T Shin[P], Ain[P], uv[P], pv[P], S[P], w[P], uAc[P], huAc[P], su, wr;
        load_row(svs, r, Shin);
        load_row(svs + PP, r, Ain);
        load_vec(u, s, B, l, uv);
        load_vec(ph, s, B, l, pv);
        const size_t o = ((size_t)s * P + r) * B + l;
        const T vr = r < P ? v[o] : T(0);
        const T d = front_row(Shin, uv, pv, vr, a[(size_t)s * B + l], r, S, su, wr, w);
        const T phr = pick(pv, r), ur = pick(uv, r), utr = phr * ur;
#pragma unroll
        for (int j = 0; j < P; ++j) uAc[j] = group_sum(Ain[j] * utr);
        const T uAr = pick(uAc, r);

        // F9: J_out = J_in - uAc (uAc/d)^T
        T t = T(0), q = T(0);
#pragma unroll
        for (int j = 0; j < P; ++j) {
            t += hJs[j] * uAc[j];
            q += hJ[j] * uAr * uAc[j];
        }
        const T huAr = -t / d;
        T hd = group_sum(q) / (d * d);
        // F8: A_out = Phi A_in - w uAc^T
        T hph = T(0), hw = T(0);
#pragma unroll
        for (int j = 0; j < P; ++j) {
            hph += hA[j] * Ain[j];
            hw += hA[j] * uAc[j];
        }
        hw = -hw;
        gather(huAr, huAc);
#pragma unroll
        for (int k = 0; k < P; ++k) huAc[k] = huAc[k] - group_sum(hA[k] * wr);
        // F7: uAc = A_in^T ut
        T hut = T(0);
#pragma unroll
        for (int j = 0; j < P; ++j) {
            hut += Ain[j] * huAc[j];
            hA[j] = phr * hA[j] + utr * huAc[j];
        }
        // F6: ut = ph * u
        hph = hph + hut * ur;
        T hu = hut * phr, hv, ha;
        // F5-F1: the Riccati step.
        riccati_adjoint_row(tile, r, Shin, S, su, d, wr, w, uv, pv, hSh, hw, hd, hu, hph, hv,
                            ha);
        if (ln.live && r < P) {
            hu_out[o] = hu;
            hv_out[o] = hv;
            hph_out[o] = hph;
            if (r == 0) ha_out[(size_t)s * B + l] = ha;
        }
    }
}

// ---------------------------------------------------------------------------
// factor_fwd: the seeded factor, affine map and statistics with saves.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(BLOCK)
adjoint_factor_fwd_kernel(const T* __restrict__ u, const T* __restrict__ v,
                          const T* __restrict__ ph, const T* __restrict__ a,
                          const T* __restrict__ y, const T* __restrict__ sh0, int L, int B,
                          T* __restrict__ M_out, T* __restrict__ m_out, T* __restrict__ Qm_out,
                          T* __restrict__ qv_out, double* __restrict__ q0_out,
                          double* __restrict__ ld_out, T* __restrict__ mind_out,
                          T* __restrict__ sv) {
    factor_sweep<true>(u, v, ph, a, y, sh0, L, B, M_out, m_out, Qm_out, qv_out, q0_out, ld_out,
                       mind_out, sv);
}

// ---------------------------------------------------------------------------
// factor_bwd: the transpose of factor_fwd, streamed in reverse.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(BLOCK)
adjoint_factor_bwd_kernel(const T* __restrict__ u, const T* __restrict__ v,
                          const T* __restrict__ ph, const T* __restrict__ a,
                          const T* __restrict__ y, const T* __restrict__ sv,
                          const T* __restrict__ hM0, const T* __restrict__ hm0,
                          const T* __restrict__ hQm0, const T* __restrict__ hqv0,
                          const T* __restrict__ hq00, const T* __restrict__ hld0, int L, int B,
                          T* __restrict__ hu_out, T* __restrict__ hv_out, T* __restrict__ hph_out,
                          T* __restrict__ ha_out, T* __restrict__ hy_out,
                          T* __restrict__ hsh0_out) {
    __shared__ T tiles[LANES * P * TS];
    const Lane ln = lane_of(B);
    const int l = ln.l, r = ln.r;
    T* tile = tiles + (threadIdx.x / G) * P * TS;
    // The statistics' cotangents are constant; hQm enters symmetrised too.
    T hM[P], hQm[P], hQs[P], hSh[P];
    get_mat(hM0, r, B, l, hM);
    get_mat(hQm0, r, B, l, hQm);
    transpose_row(tile, r, hQm, hQs);
#pragma unroll
    for (int j = 0; j < P; ++j) {
        hQs[j] = hQm[j] + hQs[j];
        hSh[j] = T(0);
    }
    T hm = r < P ? hm0[(size_t)r * B + l] : T(0);
    const T hqv = r < P ? hqv0[(size_t)r * B + l] : T(0);
    const T hq0 = hq00[l], hld = hld0[l];

    for (int s = L - 1; s >= 0; --s) {
        const T* svs = sv + ((size_t)s * B + l) * NSV1;
        T Shin[P], Mprev[P], uv[P], pv[P], S[P], w[P], g[P], hg[P], su, wr;
        load_row(svs, r, Shin);
        load_row(svs + PP, r, Mprev);
        const T mprev = r < P ? svs[2 * PP + r] : T(0);
        load_vec(u, s, B, l, uv);
        load_vec(ph, s, B, l, pv);
        const size_t o = ((size_t)s * P + r) * B + l, o1 = (size_t)s * B + l;
        const T vr = r < P ? v[o] : T(0);
        const T d = front_row(Shin, uv, pv, vr, a[o1], r, S, su, wr, w);
        const T phr = pick(pv, r), ur = pick(uv, r);
#pragma unroll
        for (int j = 0; j < P; ++j) g[j] = group_sum(phr * Mprev[j] * ur);  // (Phi Mprev)^T u
        const T gr = pick(g, r);
        const T mh = phr * mprev;
        const T z0 = y[o1] - group_sum(ur * mh);

        // E12: the statistics (constant cotangents, one term a step).
        const T hqv_g = group_sum(hqv * gr);
        T q = T(0), t = T(0);
#pragma unroll
        for (int j = 0; j < P; ++j) {
            q += hQm[j] * gr * g[j];
            t += hQs[j] * g[j];
        }
        const T gQg = group_sum(q);
        T hz0 = hq0 * (T(2) * z0 / d) + hqv_g / d;
        T hd = -hq0 * z0 * z0 / (d * d) + hld / d - hqv_g * z0 / (d * d) - gQg / (d * d);
        const T hgr = hqv * (z0 / d) + t / d;
        // E11: m_out = mh + w z0
        T hw = hm * z0;
        hz0 = hz0 + group_sum(hm * wr);
        // E10: z0 = y - u . mh
        const T hy = hz0;
        T hu = -hz0 * mh;
        const T hmh = hm - hz0 * ur;
        // E9: mh = ph * mprev
        T hph = hmh * mprev;
        hm = hmh * phr;
        // E8: M_out = PhM - w g^T
        t = T(0);
#pragma unroll
        for (int j = 0; j < P; ++j) t += hM[j] * g[j];
        hw = hw - t;
        gather(hgr, hg);
#pragma unroll
        for (int k = 0; k < P; ++k) hg[k] = hg[k] - group_sum(hM[k] * wr);
        // E7: g = PhM^T u
        t = T(0);
#pragma unroll
        for (int j = 0; j < P; ++j) {
            t += phr * Mprev[j] * hg[j];
            hM[j] = hM[j] + ur * hg[j];  // hPhM
        }
        hu = hu + t;
        // E6: PhM = Phi Mprev (row scale)
        t = T(0);
#pragma unroll
        for (int j = 0; j < P; ++j) {
            t += hM[j] * Mprev[j];
            hM[j] = phr * hM[j];
        }
        hph = hph + t;
        // E5-E1: the Riccati step.
        T hv, ha;
        riccati_adjoint_row(tile, r, Shin, S, su, d, wr, w, uv, pv, hSh, hw, hd, hu, hph, hv,
                            ha);
        if (ln.live && r < P) {
            hu_out[o] = hu;
            hv_out[o] = hv;
            hph_out[o] = hph;
            if (r == 0) {
                ha_out[o1] = ha;
                hy_out[o1] = hy;
            }
        }
    }
    if (ln.live && r < P) put_mat(hsh0_out, r, B, l, hSh);
}

// ---------------------------------------------------------------------------
// Host entry points: one launch each on the caller's stream, nothing
// allocated.  Each returns cudaGetLastError() after its launch.
// ---------------------------------------------------------------------------

#define CELERITE_ADJOINT_ENTRIES(T, SFX)                                                        \
    int celerite_adjoint_elements_fwd_##SFX(const void* u, const void* v, const void* ph,      \
                                            const void* a, void* A, void* J, void* C,          \
                                            void* sv, int L, int B, void* stream) {            \
        adjoint_elements_fwd_kernel<T>                                                          \
            <<<grid_for(B, G), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(                 \
            static_cast<const T*>(u), static_cast<const T*>(v), static_cast<const T*>(ph),     \
            static_cast<const T*>(a), L, B, static_cast<T*>(A), static_cast<T*>(J),            \
            static_cast<T*>(C), static_cast<T*>(sv));                                          \
        return (int)cudaGetLastError();                                                        \
    }                                                                                          \
    int celerite_adjoint_elements_bwd_##SFX(                                                   \
        const void* u, const void* v, const void* ph, const void* a, const void* sv,          \
        const void* hA, const void* hJ, const void* hC, void* hu, void* hv, void* hph,        \
        void* ha, int L, int B, void* stream) {                                                \
        adjoint_elements_bwd_kernel<T>                                                          \
            <<<grid_for(B, G), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(                 \
            static_cast<const T*>(u), static_cast<const T*>(v), static_cast<const T*>(ph),     \
            static_cast<const T*>(a), static_cast<const T*>(sv), static_cast<const T*>(hA),    \
            static_cast<const T*>(hJ), static_cast<const T*>(hC), L, B, static_cast<T*>(hu),   \
            static_cast<T*>(hv), static_cast<T*>(hph), static_cast<T*>(ha));                   \
        return (int)cudaGetLastError();                                                        \
    }                                                                                          \
    int celerite_adjoint_factor_fwd_##SFX(                                                     \
        const void* u, const void* v, const void* ph, const void* a, const void* y,           \
        const void* sh0, void* M, void* m, void* Qm, void* qv, void* q0, void* ld, void* mind, \
        void* sv, int L, int B, void* stream) {                                                \
        adjoint_factor_fwd_kernel<T>                                                            \
            <<<grid_for(B, G), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(                 \
            static_cast<const T*>(u), static_cast<const T*>(v), static_cast<const T*>(ph),     \
            static_cast<const T*>(a), static_cast<const T*>(y), static_cast<const T*>(sh0), L, \
            B, static_cast<T*>(M), static_cast<T*>(m), static_cast<T*>(Qm),                    \
            static_cast<T*>(qv), static_cast<double*>(q0), static_cast<double*>(ld),           \
            static_cast<T*>(mind), static_cast<T*>(sv));                                       \
        return (int)cudaGetLastError();                                                        \
    }                                                                                          \
    int celerite_adjoint_factor_bwd_##SFX(                                                     \
        const void* u, const void* v, const void* ph, const void* a, const void* y,           \
        const void* sv, const void* hM, const void* hm, const void* hQm, const void* hqv,     \
        const void* hq0, const void* hld, void* hu, void* hv, void* hph, void* ha, void* hy,  \
        void* hsh0, int L, int B, void* stream) {                                              \
        adjoint_factor_bwd_kernel<T>                                                            \
            <<<grid_for(B, G), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(                 \
            static_cast<const T*>(u), static_cast<const T*>(v), static_cast<const T*>(ph),     \
            static_cast<const T*>(a), static_cast<const T*>(y), static_cast<const T*>(sv),     \
            static_cast<const T*>(hM), static_cast<const T*>(hm), static_cast<const T*>(hQm),  \
            static_cast<const T*>(hqv), static_cast<const T*>(hq0),                            \
            static_cast<const T*>(hld), L, B, static_cast<T*>(hu), static_cast<T*>(hv),        \
            static_cast<T*>(hph), static_cast<T*>(ha), static_cast<T*>(hy),                    \
            static_cast<T*>(hsh0));                                                            \
        return (int)cudaGetLastError();                                                        \
    }

extern "C" {

CELERITE_ADJOINT_ENTRIES(float, f32)
CELERITE_ADJOINT_ENTRIES(double, f64)

}  // extern "C"
