// Shared device code of the reversed sweeps (adjoint.cu, onepass.cu and
// fused4_grad.cu's factor_bwd): the per-group shared tile, the hand-written
// transpose of one Riccati step, and one step of the transpose of the
// seeded factor sweep, which all three call.  adjoint.cu and onepass.cu
// load each step's streams (factor_bwd_sweep); fused4's factor_bwd lowers
// them in the kernel and reads its own save layout.
//
// A group of G threads owns a lane, thread r row r (lanes_common.cuh).  The
// transposes of the backward bodies (hSh + hSh^T, X + X^T with X = hS *
// Shin, hQm + hQm^T) and the column sums of S go through a per-group tile in
// shared memory, since a register array indexed by another thread's row
// would spill; the constant hQm waits in a second tile a group.

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

// A factor transpose's shared memory: each group's transpose tile, then
// its tile of the constant cotangent hQm (row i at i * TS), read by row and
// by column where the step needs hQm + hQm^T, so that neither lives in
// registers through the sweep.
constexpr int FACTOR_BWD_TILES = 2 * LANES * P * TS;

// Row r of x into a group's tile; nothing for r >= P.
template <typename T>
__device__ __forceinline__ void put_tile_row(T* tile, int r, const T (&x)[P]) {
    if (r >= P) return;
#pragma unroll
    for (int j = 0; j < P; ++j) tile[r * TS + j] = x[j];
}

// One step of the transpose of the seeded factor sweep, row r: E12-E1 of
// the Pallas bodies adjoint.py:253, onepass.py:219 and fused4.py:686.  From
// the step's streams (u and ph whole, v_r, a, y), its saves (rows r of
// Shin and Mprev, entry r of mprev) and the statistics' constant
// cotangents (hQm in the group's tile hq; entry r of hqv; hq0, hld), the
// step's intermediates are recomputed and the step transposed by hand:
// hM, hm and hSh come in as the cotangents of the step's outputs (rows r
// of M and S-hat, entry r of m) and leave as its inputs'; the stream
// cotangents hu_r, hv_r, hph_r, ha and hy are written.
template <typename T>
__device__ __forceinline__ void factor_bwd_step(T* tile, const T* hq, int r, const T (&uv)[P],
                                                const T (&pv)[P], T vr, T a, T y,
                                                const T (&Shin)[P], const T (&Mprev)[P],
                                                T mprev, T hqv, T hq0, T hld, T (&hM)[P],
                                                T& hm, T (&hSh)[P], T& hu, T& hv, T& hph,
                                                T& ha, T& hy) {
    T S[P], w[P], g[P], hg[P], su, wr;
    const T d = front_row(Shin, uv, pv, vr, a, r, S, su, wr, w);
    const T phr = pick(pv, r), ur = pick(uv, r);
#pragma unroll
    for (int j = 0; j < P; ++j) g[j] = group_sum(phr * Mprev[j] * ur);  // (Phi Mprev)^T u
    const T gr = pick(g, r);
    const T mh = phr * mprev;
    const T z0 = y - group_sum(ur * mh);

    // E12: the statistics (constant cotangents, one term a step); hQm
    // enters symmetrised too.
    const T hqv_g = group_sum(hqv * gr);
    T q = T(0), t = T(0);
#pragma unroll
    for (int j = 0; j < P; ++j) {
        const T hqm = r < P ? hq[r * TS + j] : T(0);
        const T hqs = r < P ? hqm + hq[j * TS + r] : T(0);
        q += hqm * gr * g[j];
        t += hqs * g[j];
    }
    const T gQg = group_sum(q);
    T hz0 = hq0 * (T(2) * z0 / d) + hqv_g / d;
    T hd = -hq0 * z0 * z0 / (d * d) + hld / d - hqv_g * z0 / (d * d) - gQg / (d * d);
    const T hgr = hqv * (z0 / d) + t / d;
    // E11: m_out = mh + w z0
    T hw = hm * z0;
    hz0 = hz0 + group_sum(hm * wr);
    // E10: z0 = y - u . mh
    hy = hz0;
    hu = -hz0 * mh;
    const T hmh = hm - hz0 * ur;
    // E9: mh = ph * mprev
    hph = hmh * mprev;
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
    riccati_adjoint_row(tile, r, Shin, S, su, d, wr, w, uv, pv, hSh, hw, hd, hu, hph, hv, ha);
}

// The transpose of the seeded factor sweep (factor_sweep<true>) on
// pre-lowered streams, streamed in reverse: each step's streams and saves
// [Shin, Mprev, mprev] are loaded and factor_bwd_step writes the per-step
// stream cotangents (hu, hv, hph, ha, hy).  The carried S-hat cotangent
// starts from hC0, the end state's cotangent (zero when null); with a
// non-null hsh0_out the seed's cotangent is written.  `tiles` is the
// block's FACTOR_BWD_TILES words of shared memory.
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
    T* tile = tiles + (threadIdx.x / G) * 2 * P * TS;
    T* hq = tile + P * TS;
    // hSh enters as the end state's cotangent hC, zero without one.
    T hM[P], hSh[P];
    get_mat(hM0, r, B, l, hM);
    get_mat(hQm0, r, B, l, hSh);
    put_tile_row(hq, r, hSh);
    __syncwarp();
    if (hC0 != nullptr) get_mat(hC0, r, B, l, hSh);
#pragma unroll
    for (int j = 0; j < P; ++j)
        if (hC0 == nullptr) hSh[j] = T(0);
    T hm = r < P ? hm0[(size_t)r * B + l] : T(0);
    const T hqv = r < P ? hqv0[(size_t)r * B + l] : T(0);
    const T hq0 = hq00[l], hld = hld0[l];

    for (int s = L - 1; s >= 0; --s) {
        const T* svs = sv + ((size_t)s * B + l) * NSV1;
        T Shin[P], Mprev[P], uv[P], pv[P];
        load_row(svs, r, Shin);
        load_row(svs + PP, r, Mprev);
        const T mprev = r < P ? svs[2 * PP + r] : T(0);
        load_vec(u, s, B, l, uv);
        load_vec(ph, s, B, l, pv);
        const size_t o = ((size_t)s * P + r) * B + l, o1 = (size_t)s * B + l;
        const T vr = r < P ? v[o] : T(0);
        T hu, hv, hph, ha, hy;
        factor_bwd_step(tile, hq, r, uv, pv, vr, a[o1], y[o1], Shin, Mprev, mprev, hqv, hq0,
                        hld, hM, hm, hSh, hu, hv, hph, ha, hy);
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
