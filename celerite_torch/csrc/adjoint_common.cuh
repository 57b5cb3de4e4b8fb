// Shared device code of the reversed sweeps (adjoint.cu, onepass.cu): the
// per-group shared tile, the hand-written transpose of one Riccati step, and
// the transpose of the seeded factor sweep.
//
// A group of G threads owns a lane, thread r row r (lanes_common.cuh).  The
// transposes of the backward bodies (hSh + hSh^T, X + X^T with X = hS *
// Shin, hQm + hQm^T) and the column sums of S go through a per-group tile in
// shared memory, since a register array indexed by another thread's row
// would spill.

#pragma once

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

// The transpose of the seeded factor sweep (factor_sweep<true>), streamed in
// reverse (the Pallas bodies adjoint.py:253 and onepass.py:219): from the
// saves [Shin, Mprev, mprev] and the streams, each step's intermediates are
// recomputed and the step transposed by hand (E12-E1 follow the Pallas
// body), writing the per-step stream cotangents (hu, hv, hph, ha, hy).  The
// carried S-hat cotangent starts from hC0, the end state's cotangent (zero
// when null); with a non-null hsh0_out the seed's cotangent is written.
// `tiles` is the block's shared tile array (LANES * P * TS words).
template <typename T>
__device__ __forceinline__ void factor_bwd_sweep(
    T* tiles, const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ ph,
    const T* __restrict__ a, const T* __restrict__ y, const T* __restrict__ sv,
    const T* __restrict__ hC0, const T* __restrict__ hM0, const T* __restrict__ hm0,
    const T* __restrict__ hQm0, const T* __restrict__ hqv0, const T* __restrict__ hq00,
    const T* __restrict__ hld0, int L, int B, T* __restrict__ hu_out, T* __restrict__ hv_out,
    T* __restrict__ hph_out, T* __restrict__ ha_out, T* __restrict__ hy_out,
    T* __restrict__ hsh0_out) {
    const Lane ln = lane_of(B);
    const int l = ln.l, r = ln.r;
    T* tile = tiles + (threadIdx.x / G) * P * TS;
    // The statistics' cotangents are constant; hQm enters symmetrised too.
    // hSh enters as the end state's cotangent hC, zero without one.
    T hM[P], hQm[P], hQs[P], hSh[P];
    get_mat(hM0, r, B, l, hM);
    get_mat(hQm0, r, B, l, hQm);
    if (hC0 != nullptr) get_mat(hC0, r, B, l, hSh);
    transpose_row(tile, r, hQm, hQs);
#pragma unroll
    for (int j = 0; j < P; ++j) {
        hQs[j] = hQm[j] + hQs[j];
        if (hC0 == nullptr) hSh[j] = T(0);
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
    if (hsh0_out != nullptr && ln.live && r < P) put_mat(hsh0_out, r, B, l, hSh);
}

