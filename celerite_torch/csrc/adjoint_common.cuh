// Shared device code of the streamed sweeps: the reversed sweeps (adjoint.cu's
// elements_bwd and factor_bwd, onepass.cu's sweep_bwd, fused4_grad.cu's
// factor_bwd and elem_bwd), their transposed steps, each split into a front
// and a back, and the pipeline that runs the streamed reversed sweeps; the
// forward sweeps (adjoint.cu's elements_fwd and factor_fwd, fused4_grad.cu's
// elem_fwd and factor_fwd, pallas_solver.cu's three kernels, fused.cu's
// two sweeps, onepass.cu's sweep and sweep_fwd), their steps
// and their ring of streams (at the end); and the copy of a step's streams
// into shared memory that both kinds share.
//
// A group of G threads owns a lane, thread r row r (lanes_common.cuh).  A
// step's front is what the step computes of its saves and streams alone:
// S = Phi Shin Phi, su = S u, d, 1 / d, w, the column sums (g = (Phi
// Mprev)^T u, or uAc = A_in^T (Phi u)) and the terms of the constant
// cotangents (E12, F9).  It writes them to the step's record in shared
// memory.  The back is the transpose proper: it carries the cotangents
// from the step's outputs to its inputs in registers and reads the
// record, the step's streams and row r of its saves where it uses them.
// One reciprocal of d a step, in the front; the back divides nowhere.
// Column sums and transposes go through the group's tile in shared memory
// (row r written, __syncwarp, column r read), since a register array
// indexed by another thread's row would spill; the constant cotangent (hQm
// or hJ) waits in a tile of its own, read by row and by column.  Sums of
// P terms run in four partial sums (Acc4), and in float64 as fused
// multiply-adds (mac); float32 keeps each multiply and add apart, as its
// plain version does.
//
// fused4_grad.cu's factor_bwd and elem_bwd lower their streams in the
// kernel and read their own save layout: they run the front and the back of
// each step one after the other in their own threads (factor_bwd_step,
// elem_bwd_step).  The streamed sweeps run them in front warps and back
// warps (bwd_ticks below).  The forward sweeps run one step of the
// recursion a tick in a group a lane, their streams copied ahead
// (fwd_ticks); adjoint.cu's factor_fwd and fused4_grad.cu's factor_fwd take
// the same step (factor_fwd_step; pallas_solver.cu's factor takes it
// without the statistics), adjoint.cu's elements_fwd and
// fused4_grad.cu's elem_fwd the same elements step (elem_fwd_step), each
// from a ring slot (RingStep<T, 0>) or from the kernel's own lowering
// (LowStep), and the two steps share their Riccati front
// (riccati_fwd_front).  adjoint.cu's elements_fwd, pallas_solver.cu's
// elements and fused.cu's elements are one sweep (elements_fwd_sweep), the
// latter two without saves; adjoint.cu's factor_fwd, fused.cu's factor and
// onepass.cu's sweep and sweep_fwd are one sweep (factor_fwd_sweep<SAVE,
// T, W, ZERO>), fused.cu's and onepass.cu's sweep without saves, onepass.cu's
// two from a zero seed with their end state; pallas_solver.cu's subst runs
// its own step on the same ring.

#pragma once

#include "lanes_common.cuh"

// Lane groups of a BLOCK-thread block, and a group's tile.
constexpr int LANES = BLOCK / G;
constexpr int TS = P + 1;          // row stride of a group's tile

// A transposed step's record, field f at rec[f * S]: d, 1 / d, z0 (factor)
// and the constant cotangents' terms of hz0 (E12) and of hd (E12, F9);
// rows r of su, w, g (factor) or uAc (elements), and of the constant term
// of hg (E12) or huAc (F9).
constexpr int XD = 0, XRD = 1, XZ = 2, XHZ = 3, XHD = 4, XSU = 5, XW = XSU + P, XG = XW + P,
              XHG = XG + P, NX = XHG + P;

// Row r's view of a step's inputs: u_j and phi_j; row r of the saved
// matrices x0 (Shin) and x1 (Mprev or A_in); the row's scalars u_r, phi_r,
// v_r, a, y and x_r (entry r of the saved vector, mprev).  Rows r >= P
// read zeros.  From registers (fused4_grad.cu's factor_bwd), j known at
// compile time:
template <typename T>
struct RegStep {
    const T (&uv)[P];
    const T (&pv)[P];
    const T (&s0)[P];
    const T (&s1)[P];
    T ur, phr, vr, a, y, xr;
    __device__ __forceinline__ T u(int j) const { return uv[j]; }
    __device__ __forceinline__ T ph(int j) const { return pv[j]; }
    __device__ __forceinline__ T x0(int j) const { return s0[j]; }
    __device__ __forceinline__ T x1(int j) const { return s1[j]; }
};

// ... or from a lane's words in a ring slot: its NSV save words as saved
// (each matrix column-major, entry (i, j) at word j * P + i), then the
// step's streams at NSV + RU + j etc.
constexpr int RU = 0, RPH = P, RV = 2 * P, RA = 3 * P, RY = 3 * P + 1, NRS = 3 * P + 2;

template <typename T, int NSV>
struct RingStep {
    const T* w;
    int r;
    T ur, phr, vr, a, y, xr;
    __device__ __forceinline__ RingStep(const T* words, int row) : w(words), r(row) {
        const T* st = w + NSV;
        const bool in = r < P;
        ur = in ? st[RU + r] : T(0);
        phr = in ? st[RPH + r] : T(0);
        vr = in ? st[RV + r] : T(0);
        a = st[RA];
        y = st[RY];
        xr = (NSV > 2 * PP && in) ? w[2 * PP + r] : T(0);
    }
    __device__ __forceinline__ T u(int j) const { return w[NSV + RU + j]; }
    __device__ __forceinline__ T ph(int j) const { return w[NSV + RPH + j]; }
    __device__ __forceinline__ T x0(int j) const { return r < P ? w[j * P + r] : T(0); }
    __device__ __forceinline__ T x1(int j) const { return r < P ? w[PP + j * P + r] : T(0); }
};

// a * b + c: one fused multiply-add in float64; in float32 a multiply and
// an add, which round as the plain versions do (-fmad=false).
__device__ __forceinline__ double mac(double a, double b, double c) { return __fma_rn(a, b, c); }
__device__ __forceinline__ float mac(float a, float b, float c) { return a * b + c; }

// A sum of P terms in four interleaved partial sums (term j into j % 4), so
// that its chain of dependent adds is a quarter as long.
template <typename T>
struct Acc4 {
    T s[4] = {T(0), T(0), T(0), T(0)};
    __device__ __forceinline__ void fma(int j, T a, T b) { s[j & 3] = mac(a, b, s[j & 3]); }
    __device__ __forceinline__ void add(int j, T x) { s[j & 3] += x; }
    __device__ __forceinline__ T sum() const { return (s[0] + s[1]) + (s[2] + s[3]); }
};

// Row r of a (P, P, B) per-lane matrix into a group's tile (row i at i *
// TS); nothing for r >= P.
template <typename T, typename U>
__device__ __forceinline__ void load_tile(T* tile, const U* __restrict__ in, int r, int B,
                                          int l) {
    if (r >= P) return;
#pragma unroll
    for (int j = 0; j < P; ++j) tile[r * TS + j] = static_cast<T>(in[((size_t)r * P + j) * B + l]);
}

// Thread r's sum over the group's rows i of x_i(r), row i's terms x(j)
// given by a functor, through the group's tile (0 for r >= P).  The caller
// syncs the warp before the tile is written again.
template <typename T, class X>
__device__ __forceinline__ T column_sum(T* tile, int r, X&& x) {
    if (r < P) {
#pragma unroll
        for (int j = 0; j < P; ++j) tile[r * TS + j] = x(j);
    }
    __syncwarp();
    Acc4<T> c;
    if (r < P) {
#pragma unroll
        for (int i = 0; i < P; ++i) c.add(i, tile[i * TS + r]);
    }
    return c.sum();
}

// ---------------------------------------------------------------------------
// Fronts: what a step computes of its inputs alone, into its record
// ---------------------------------------------------------------------------

// The Riccati step's front (fused4._front), row r: su = S u with S = Phi
// Shin Phi, d = a - u.su, 1 / d and w_r = (v_r - su) / d.  Returns 1 / d.
template <typename T, class In, int S>
__device__ __forceinline__ T riccati_front(int r, const In& in, Rec<T, S> rec) {
    Acc4<T> sa;
#pragma unroll
    for (int j = 0; j < P; ++j) sa.fma(j, in.x0(j) * in.ph(j), in.u(j));
    const T su = in.phr * sa.sum();
    const T d = in.a - group_sum(in.ur * su);
    const T rd = T(1) / d;
    if (r == 0) {
        rec[XD] = d;
        rec[XRD] = rd;
    }
    if (r < P) {
        rec[XSU + r] = su;
        rec[XW + r] = (in.vr - su) * rd;
    }
    return rd;
}

// The factor transpose's front (E12 of adjoint.py:253, onepass.py:219,
// fused4.py:686): the Riccati front, g = (Phi Mprev)^T u, z0 = y - u . Phi
// mprev and the statistics' constant cotangents (hQm in the tile hq, read
// symmetrised; entry r of hqv; hq0, hld) as their terms of hz0, hd and hg.
template <typename T, class In, int S>
__device__ __forceinline__ void factor_front(T* tile, const T* hq, int r, const In& in,
                                             Rec<T, S> rec, T hqv, T hq0, T hld) {
    const T rd = riccati_front(r, in, rec);
    const T phr = in.phr, ur = in.ur, pu = phr * ur;
    const T gr = column_sum(tile, r, [&](int j) { return in.x1(j) * pu; });
    if (r < P) rec[XG + r] = gr;
    __syncwarp();
    const T z0 = in.y - group_sum(ur * (phr * in.xr));
    const T hqv_g = group_sum(hqv * gr);
    Acc4<T> qa, ta;
#pragma unroll
    for (int j = 0; j < P; ++j) {
        const T gj = rec[XG + j];
        const T hqm = r < P ? hq[r * TS + j] : T(0);
        const T hqs = r < P ? hqm + hq[j * TS + r] : T(0);
        qa.fma(j, hqm, gj);
        ta.fma(j, hqs, gj);
    }
    const T t = ta.sum();
    const T gQg = group_sum(gr * qa.sum()), rd2 = rd * rd;
    if (r == 0) {
        rec[XZ] = z0;
        rec[XHZ] = hq0 * (T(2) * z0 * rd) + hqv_g * rd;
        rec[XHD] = -hq0 * z0 * z0 * rd2 + hld * rd - hqv_g * z0 * rd2 - gQg * rd2;
    }
    if (r < P) rec[XHG + r] = hqv * (z0 * rd) + t * rd;
}

// The elements transpose's front (adjoint.py:98): the Riccati front, uAc =
// A_in^T (Phi u) and F9, J_out = J_in - uAc (uAc / d)^T, whose cotangent
// hJ is constant (in the tile hj, entering symmetrised).
template <typename T, class In, int S>
__device__ __forceinline__ void elem_front(T* tile, const T* hj, int r, const In& in,
                                           Rec<T, S> rec) {
    const T rd = riccati_front(r, in, rec);
    const T utr = in.phr * in.ur;
    const T uAr = column_sum(tile, r, [&](int j) { return in.x1(j) * utr; });
    if (r < P) rec[XG + r] = uAr;
    __syncwarp();
    Acc4<T> ta, qa;
#pragma unroll
    for (int j = 0; j < P; ++j) {
        const T uj = rec[XG + j];
        const T hjm = r < P ? hj[r * TS + j] : T(0);
        const T hjs = r < P ? hjm + hj[j * TS + r] : T(0);
        ta.fma(j, hjs, uj);
        qa.fma(j, hjm, uj);
    }
    const T hd = group_sum(uAr * qa.sum()) * (rd * rd);
    if (r == 0) rec[XHD] = hd;
    if (r < P) rec[XHG + r] = -ta.sum() * rd;
}

// ---------------------------------------------------------------------------
// Backs: the transposes proper, carrying the cotangents in registers.
// `vec` is the group's P words for a vector all its threads read.
// ---------------------------------------------------------------------------

// F5-F1 of both transposes (fused4._riccati_adjoint), row r: the
// transposes of Sh_out = S + d w w^T, w = (v - su)/d, d = a - u.su, su = S
// u and S = Phi Shin Phi.  hSh comes in as the output's cotangent and
// leaves as Shin's; hw, hd, hu, hph come in with the step's other
// contributions; writes hv and ha.
template <typename T, class In, int S>
__device__ __forceinline__ void riccati_back(T* tile, int r, const In& in, Rec<T, S> rec, T wr,
                                             T (&hSh)[P], T hw, T hd, T& hu, T& hph, T& hv,
                                             T& ha) {
    const T d = rec[XD], rd = rec[XRD], su = r < P ? rec[XSU + r] : T(0);
    const T phr = in.phr, ur = in.ur;
    // F5: Sh_out = S + d w w^T, through (hSh w)_r and (hSh^T w)_r (a
    // column sum).
    const T ct = column_sum(tile, r, [&](int j) { return hSh[j] * wr; });
    Acc4<T> aa;
#pragma unroll
    for (int j = 0; j < P; ++j) aa.fma(j, hSh[j], rec[XW + j]);
    __syncwarp();
    const T a = aa.sum();
    hd = hd + group_sum(wr * a);
    hw = hw + d * (a + ct);
    // F4: w = (v - su)/d
    hv = hw * rd;
    T hsu = -hw * rd;
    hd = hd - group_sum(hw * wr) * rd;
    // F3: d = a - u.su
    ha = hd;
    hu = hu - hd * su;
    hsu = hsu - hd * ur;
    // F2: su = S u: hu gains (S^T hsu)_r = phi_r sum_i Shin_ir (phi_i
    // hsu_i), a column sum through the tile; and X = hS * Shin of F1.
    T X[P];
    const T hp = phr * hsu;
#pragma unroll
    for (int j = 0; j < P; ++j) {
        const T x0j = in.x0(j);
        if (r < P) tile[r * TS + j] = x0j * hp;
        hSh[j] = mac(hsu, in.u(j), hSh[j]);  // hS
        X[j] = hSh[j] * x0j;
    }
    __syncwarp();
    Acc4<T> c;
    if (r < P) {
#pragma unroll
        for (int i = 0; i < P; ++i) c.add(i, tile[i * TS + r]);
    }
    __syncwarp();
    hu = hu + phr * c.sum();
    // F1: S = Phi Shin Phi
    Acc4<T> e;
    if (r < P) {
#pragma unroll
        for (int j = 0; j < P; ++j) tile[r * TS + j] = X[j];
    }
    __syncwarp();
#pragma unroll
    for (int j = 0; j < P; ++j) {
        const T phj = in.ph(j);
        e.fma(j, X[j] + (r < P ? tile[j * TS + r] : T(0)), phj);
        hSh[j] = phr * hSh[j] * phj;
    }
    __syncwarp();
    hph = hph + e.sum();
}

// E11-E1 of the factor transpose, row r: hM, hm and hSh come in as the
// cotangents of the step's outputs (rows r of M and S-hat, entry r of m)
// and leave as its inputs'; the stream cotangents hu_r, hv_r, hph_r, ha
// and hy are returned.
template <typename T, class In, int S>
__device__ __forceinline__ void factor_back(T* tile, T* vec, int r, const In& in, Rec<T, S> rec,
                                            T (&hM)[P], T& hm, T (&hSh)[P], T& hu, T& hv,
                                            T& hph, T& ha, T& hy) {
    const T phr = in.phr, ur = in.ur, z0 = rec[XZ];
    const T wr = r < P ? rec[XW + r] : T(0);
    // E11: m_out = mh + w z0
    T hw = hm * z0;
    const T hz0 = rec[XHZ] + group_sum(hm * wr);
    // E10: z0 = y - u . mh
    hy = hz0;
    hu = -hz0 * (phr * in.xr);
    const T hmh = hm - hz0 * ur;
    // E9: mh = ph * mprev
    hph = hmh * in.xr;
    hm = hmh * phr;
    // E8: M_out = PhM - w g^T; hg's column sums through the tile.
    Acc4<T> t8;
#pragma unroll
    for (int j = 0; j < P; ++j) t8.fma(j, hM[j], rec[XG + j]);
    hw = hw - t8.sum();
    const T c = column_sum(tile, r, [&](int j) { return hM[j] * wr; });
    if (r < P) vec[r] = rec[XHG + r] - c;
    __syncwarp();
    // E7: g = PhM^T u, and E6: PhM = Phi Mprev (row scale)
    Acc4<T> t7, t6;
#pragma unroll
    for (int j = 0; j < P; ++j) {
        const T hg = vec[j], mj = in.x1(j);
        t7.fma(j, mj, hg);
        hM[j] = mac(ur, hg, hM[j]);  // hPhM
        t6.fma(j, hM[j], mj);
        hM[j] = phr * hM[j];
    }
    hu = hu + phr * t7.sum();
    hph = hph + t6.sum();
    // E5-E1: the Riccati step.
    riccati_back(tile, r, in, rec, wr, hSh, hw, rec[XHD], hu, hph, hv, ha);
}

// F8-F1 of the elements transpose, row r: hA and hSh come in as the
// cotangents of the step's outputs (rows r of A and S-hat) and leave as
// its inputs'; the stream cotangents hu_r, hv_r, hph_r and ha are
// returned.
template <typename T, class In, int S>
__device__ __forceinline__ void elem_back(T* tile, T* vec, int r, const In& in, Rec<T, S> rec,
                                          T (&hA)[P], T (&hSh)[P], T& hu, T& hv, T& hph,
                                          T& ha) {
    const T phr = in.phr, ur = in.ur, utr = phr * ur;
    const T wr = r < P ? rec[XW + r] : T(0);
    // F8: A_out = Phi A_in - w uAc^T; huAc's column sums through the tile.
    Acc4<T> hpa, hwa;
#pragma unroll
    for (int j = 0; j < P; ++j) {
        hpa.fma(j, hA[j], in.x1(j));
        hwa.fma(j, hA[j], rec[XG + j]);
    }
    const T hp = hpa.sum(), hw = -hwa.sum();
    const T c = column_sum(tile, r, [&](int j) { return hA[j] * wr; });
    if (r < P) vec[r] = rec[XHG + r] - c;
    __syncwarp();
    // F7: uAc = A_in^T ut
    Acc4<T> huta;
#pragma unroll
    for (int j = 0; j < P; ++j) {
        const T h = vec[j];
        huta.fma(j, in.x1(j), h);
        hA[j] = mac(utr, h, phr * hA[j]);
    }
    const T hut = huta.sum();
    // F6: ut = ph * u
    hph = hp + hut * ur;
    hu = hut * phr;
    // F5-F1: the Riccati step.
    riccati_back(tile, r, in, rec, wr, hSh, hw, rec[XHD], hu, hph, hv, ha);
}

// One step of the transpose of the seeded factor sweep, front then back in
// the same threads (fused4_grad.cu's factor_bwd): `tile` and `hq` are the
// group's tiles, `vec` its P words, `rec` its record.
template <typename T, int S>
__device__ __forceinline__ void factor_bwd_step(T* tile, const T* hq, T* vec, Rec<T, S> rec,
                                                int r, const RegStep<T>& in, T hqv, T hq0,
                                                T hld, T (&hM)[P], T& hm, T (&hSh)[P], T& hu,
                                                T& hv, T& hph, T& ha, T& hy) {
    factor_front(tile, hq, r, in, rec, hqv, hq0, hld);
    __syncwarp();
    factor_back(tile, vec, r, in, rec, hM, hm, hSh, hu, hv, hph, ha, hy);
}

// One step of the transpose of the elements sweep, front then back in the
// same threads (fused4_grad.cu's elem_bwd), as factor_bwd_step: `hj` is
// the group's tile of the constant cotangent hJ.
template <typename T, int S>
__device__ __forceinline__ void elem_bwd_step(T* tile, const T* hj, T* vec, Rec<T, S> rec,
                                              int r, const RegStep<T>& in, T (&hA)[P],
                                              T (&hSh)[P], T& hu, T& hv, T& hph, T& ha) {
    elem_front(tile, hj, r, in, rec);
    __syncwarp();
    elem_back(tile, vec, r, in, rec, hA, hSh, hu, hv, hph, ha);
}

// ---------------------------------------------------------------------------
// The streamed reversed sweeps: a block of BWD_LB lanes and two roles of
// BWD_RW warps each, a group of G threads a lane in each role.  The front
// warps copy each lane's saves and streams BWD_AHEAD steps ahead, in
// reverse step order, into a ring in shared memory (cp.async), and run
// each step's front into a record; the back warps run the back of the step
// before, reading the ring and the record.  One block barrier a step
// hands the step over, so a step costs the longer of the two halves.
// ---------------------------------------------------------------------------

// Warps a role: at least four lanes a block, so that a block's stream
// cotangents of a step fill 16 bytes (float32) or a 32-byte sector
// (float64) of each row; blocks of 2 lanes took 1.13-1.26x as long on
// main path E's 16 chains (PERF.md).
constexpr int BWD_RW = G >= 8 ? G / 8 : 1;
constexpr int BWD_LB = BWD_RW * 32 / G;   // lanes a block
constexpr int BWD_THREADS = 64 * BWD_RW;  // the back warps, then the front warps
constexpr int BWD_AHEAD = 2;              // steps copied ahead of the front
constexpr int BWD_RING = BWD_AHEAD + 2;   // the back's step, the front's, those in flight
// Blocks an SM the register budget is set for: at P = 16 an SM's shared
// memory holds two blocks in float64 (255 registers a thread) and four in
// float32 (128 registers a thread), so main path E's 16 chains (512
// blocks) take one wave in float32 and two in float64.
template <typename T>
struct BwdBlocks {
    static constexpr int value = (sizeof(T) == 4 ? 8 : 4) / BWD_RW;
};

// Dynamic shared memory of a sweep whose steps save NSV words, in words:
// the ring (BWD_RING slots of BWD_LB lanes' words), two record slots, each
// lane's tiles (the constant cotangent, the front's, the back's) and its
// vector.
template <int NSV>
struct BwdSmem {
    static constexpr int LW = (NSV + NRS + 3) / 4 * 4;  // a lane's words in a slot, 16-byte aligned
    static constexpr int RING = BWD_RING * BWD_LB * LW;
    static constexpr int REC = 2 * NX * BWD_LB;
    static constexpr int TILE = BWD_LB * P * TS;
    static constexpr int WORDS = RING + REC + 3 * TILE + BWD_LB * P;
};

extern __shared__ __align__(16) unsigned char bwd_smem[];

// A lane's streams of step s into NRS words at `st`, by the lane's group:
// u, phi and v (a word a row), a and y (y may be null).  cp.async, not
// committed.
template <typename T>
__device__ __forceinline__ void copy_streams(T* st, const T* __restrict__ u,
                                             const T* __restrict__ v, const T* __restrict__ ph,
                                             const T* __restrict__ a, const T* __restrict__ y,
                                             int s, int B, int l, int r) {
    if (r < P) {
        const size_t o = ((size_t)s * P + r) * B + l;
        cp_async(st + RU + r, u + o);
        cp_async(st + RPH + r, ph + o);
        cp_async(st + RV + r, v + o);
    }
    if (r == 0) {
        cp_async(st + RA, a + (size_t)s * B + l);
        if (y != nullptr) cp_async(st + RY, y + (size_t)s * B + l);
    }
}

// A lane's step s into its words of a ring slot, by the lane's group: the
// NSV save words (16 bytes a copy where `wide`, the saves 16-byte aligned
// and NSV words a multiple of 16 bytes), then u, phi and v (a word a row),
// a and y (y may be null).  One cp.async group a call, empty for s < 0.
template <typename T, int NSV>
__device__ __forceinline__ void copy_step(T* dst, const T* __restrict__ sv,
                                          const T* __restrict__ u, const T* __restrict__ v,
                                          const T* __restrict__ ph, const T* __restrict__ a,
                                          const T* __restrict__ y, int s, int B, int l, int r,
                                          bool wide) {
    constexpr int V = 16 / sizeof(T);
    if (s >= 0) {
        const T* src = sv + ((size_t)s * B + l) * NSV;
        if (NSV % V == 0 && wide) {
            for (int i = r * V; i < NSV; i += G * V) cp_async16(dst + i, src + i);
        } else {
            for (int i = r; i < NSV; i += G) cp_async(dst + i, src + i);
        }
        copy_streams(dst + NSV, u, v, ph, a, y, s, B, l, r);
    }
    cp_async_commit();
}

// A sweep's block: this thread's lane (q in the block, l in the launch,
// the lane whose words it copies), row, warp and its shared memory.
template <typename T, int NSV>
struct BwdCtx {
    int q, r, l, ls;
    bool live, front, wide;
    T *ring, *recs, *cst, *ftile, *btile, *vec;
    __device__ __forceinline__ BwdCtx(int B, const T* sv) {
        using Sm = BwdSmem<NSV>;
        q = (threadIdx.x % (32 * BWD_RW)) / G;
        r = threadIdx.x % G;
        l = blockIdx.x * BWD_LB + q;
        live = l < B;
        ls = live ? l : B - 1;  // a dead lane runs the last lane and writes nothing
        front = threadIdx.x >= 32 * BWD_RW;
        wide = (reinterpret_cast<size_t>(sv) & 15) == 0;
        T* sm = reinterpret_cast<T*>(bwd_smem);
        ring = sm;
        recs = sm + Sm::RING;
        cst = recs + Sm::REC + q * P * TS;
        ftile = cst + Sm::TILE;
        btile = cst + 2 * Sm::TILE;
        vec = sm + Sm::RING + Sm::REC + 3 * Sm::TILE + q * P;
    }
    __device__ __forceinline__ T* words(int k) const {
        return ring + ((k % BWD_RING) * BWD_LB + q) * BwdSmem<NSV>::LW;
    }
    __device__ __forceinline__ Rec<T, BWD_LB> rec(int k) const {
        return Rec<T, BWD_LB>{recs + (k & 1) * NX * BWD_LB + q};
    }
};

// The sweep's ticks: at tick k the front warp runs front(words, rec) on
// step L - 1 - k (its words arrived) and copies step L - 1 - k -
// BWD_AHEAD; the back warp runs back(words, rec, s) on step s = L - k, the
// front's step of the tick before.  A barrier ends each tick.
template <typename T, int NSV, class Copy, class Front, class Back>
__device__ __forceinline__ void bwd_ticks(const BwdCtx<T, NSV>& c, int L, Copy&& copy,
                                          Front&& front, Back&& back) {
    if (c.front) {
        for (int k = 0; k < BWD_AHEAD; ++k) copy(c.words(k), L - 1 - k);
    }
    for (int k = 0; k <= L; ++k) {
        if (c.front) {
            if (k < L) {
                cp_async_wait<BWD_AHEAD - 1>();
                __syncwarp();
                front(c.words(k), c.rec(k));
                copy(c.words(k + BWD_AHEAD), L - 1 - k - BWD_AHEAD);
            }
        } else if (k > 0) {
            back(c.words(k - 1), c.rec(k - 1), L - k);
        }
        __syncthreads();
    }
    if (c.front) cp_async_wait<0>();
}

// The transpose of the seeded factor sweep (factor_fwd_sweep<true>) on
// pre-lowered streams, streamed in reverse from the saves [Shin, Mprev,
// mprev]: writes the per-step stream cotangents (hu, hv, hph, ha, hy).
// The carried S-hat cotangent starts from hC0, the end state's cotangent
// (zero when null); with a non-null hsh0_out the seed's cotangent is
// written.  Launched as BWD_THREADS threads a block, BwdSmem<NSV1> words
// of dynamic shared memory.
template <typename T>
__device__ __forceinline__ void factor_bwd_sweep(
    const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ ph,
    const T* __restrict__ a, const T* __restrict__ y, const T* __restrict__ sv,
    const T* __restrict__ hC0, const T* __restrict__ hM0, const T* __restrict__ hm0,
    const T* __restrict__ hQm0, const T* __restrict__ hqv0, const T* __restrict__ hq00,
    const T* __restrict__ hld0, int L, int B, T* __restrict__ hu_out, T* __restrict__ hv_out,
    T* __restrict__ hph_out, T* __restrict__ ha_out, T* __restrict__ hy_out,
    T* __restrict__ hsh0_out) {
    const BwdCtx<T, NSV1> c(B, sv);
    const int r = c.r, l = c.l;
    // The front warp's constants: hQm in the lane's tile, hqv_r, hq0, hld.
    if (c.front) load_tile(c.cst, hQm0, r, B, c.ls);
    const T hqv = r < P ? hqv0[(size_t)r * B + c.ls] : T(0);
    const T hq0 = hq00[c.ls], hld = hld0[c.ls];
    // The back warp's carried cotangents; hSh enters as hC, zero without.
    T hM[P], hSh[P];
    get_mat(hM0, r, B, c.ls, hM);
    if (hC0 != nullptr) get_mat(hC0, r, B, c.ls, hSh);
#pragma unroll
    for (int j = 0; j < P; ++j)
        if (hC0 == nullptr) hSh[j] = T(0);
    T hm = r < P ? hm0[(size_t)r * B + c.ls] : T(0);
    __syncwarp();
    bwd_ticks(
        c, L,
        [&](T* w, int s) { copy_step<T, NSV1>(w, sv, u, v, ph, a, y, s, B, c.ls, r, c.wide); },
        [&](const T* w, Rec<T, BWD_LB> rec) {
            factor_front(c.ftile, c.cst, r, RingStep<T, NSV1>(w, r), rec, hqv, hq0, hld);
        },
        [&](const T* w, Rec<T, BWD_LB> rec, int s) {
            T hu, hv, hph, ha, hy;
            factor_back(c.btile, c.vec, r, RingStep<T, NSV1>(w, r), rec, hM, hm, hSh, hu, hv,
                        hph, ha, hy);
            if (c.live && r < P) {
                const size_t o = ((size_t)s * P + r) * B + l, o1 = (size_t)s * B + l;
                hu_out[o] = hu;
                hv_out[o] = hv;
                hph_out[o] = hph;
                if (r == 0) {
                    ha_out[o1] = ha;
                    hy_out[o1] = hy;
                }
            }
        });
    if (!c.front && hsh0_out != nullptr && c.live && r < P) put_mat(hsh0_out, r, B, l, hSh);
}

// A sweep's dynamic shared memory in bytes.
template <typename T, int NSV>
constexpr size_t bwd_smem_bytes() {
    return sizeof(T) * (size_t)BwdSmem<NSV>::WORDS;
}

// A sweep kernel's shared memory settings: its dynamic limit raised to
// `bytes`, and an SM's L1 given to shared memory, so that as many blocks
// fit an SM as its shared memory holds.
template <typename K>
static cudaError_t bwd_prepare(K kernel, size_t bytes) {
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e == cudaSuccess)
        e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
    return e;
}

// A sweep kernel's launch on the caller's stream: BWD_THREADS threads
// and BWD_LB lanes a block.  Returns the error of its settings or of its
// launch.
template <typename K, typename... A>
static int launch_bwd(K kernel, size_t bytes, int B, void* stream, A... args) {
    const cudaError_t e = bwd_prepare(kernel, bytes);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((unsigned)((B + BWD_LB - 1) / BWD_LB));
    kernel<<<grid, BWD_THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(args...);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The streamed forward sweeps (adjoint.cu's elements_fwd and factor_fwd,
// fused4_grad.cu's elem_fwd and factor_fwd, pallas_solver.cu's kernels): a
// block of W warps, a group of G threads a lane (32 W / G lanes a block),
// thread r row r of the state.  Each group
// copies its lane's streams FWD_AHEAD steps ahead into a ring in shared
// memory (cp.async), so that a step never waits on device memory.  A
// step's column sum (g = (Phi M)^T u, or uA = A^T (Phi u)) goes through the
// group's tile, and w and the column sum reach every row through the
// group's vector in shared memory (one __syncwarp each): one butterfly for
// d (and one for z0), no broadcast shuffles, one reciprocal of d.
// ---------------------------------------------------------------------------

constexpr int FWD_AHEAD = 3;             // steps copied ahead of the step computed
constexpr int FWD_RING = FWD_AHEAD + 2;  // those, the step's and the step before's

// Row r's view of a step lowered in the kernel (fused4_grad.cu's
// elem_fwd and factor_fwd): u_j and phi_j gathered from the group into registers, and
// the row's scalars, as RingStep<T, 0> views them in a ring slot.
template <typename T>
struct LowStep {
    const T (&uv)[P];
    const T (&pv)[P];
    T ur, phr, vr, a, y;
    __device__ __forceinline__ T u(int j) const { return uv[j]; }
    __device__ __forceinline__ T ph(int j) const { return pv[j]; }
};

// A forward sweep's group: its lane (q in the block, l in the launch; a
// dead group runs the last lane and writes nothing) and row, its ring
// slots of NW words a step, its tile and its vector (w at wv, then the
// column sum at gv).  The kernel declares the shared arrays, RING, TILES
// and VECS words; a sweep that carries only a vector (pallas_solver.cu's
// subst) declares the ring alone and has no tile or vector.
template <typename T, int W, int NW>
struct FwdCtx {
    static constexpr int LB = 32 * W / G;
    static constexpr int RING = FWD_RING * LB * NW, TILES = LB * P * TS, VECS = LB * 2 * P;
    int q, r, l;
    bool live;
    T *ring, *tile = nullptr, *wv = nullptr, *gv = nullptr;
    __device__ __forceinline__ FwdCtx(int B, T* ring_) {
        q = threadIdx.x / G;
        r = threadIdx.x % G;
        const int lane = blockIdx.x * LB + q;
        live = lane < B;
        l = live ? lane : B - 1;
        ring = ring_;
    }
    __device__ __forceinline__ FwdCtx(int B, T* ring_, T* tiles, T* vecs) : FwdCtx(B, ring_) {
        tile = tiles + q * P * TS;
        wv = vecs + q * 2 * P;
        gv = wv + P;
    }
    __device__ __forceinline__ T* slot(int s) const {
        return ring + ((s % FWD_RING) * LB + q) * NW;
    }
};

// The sweep's ticks: copy(slot, s) issues the cp.async of step s into its
// slot.  At step s the group commits the copy of step s + FWD_AHEAD, runs
// save(s) (the step's input state to device memory), waits for step s's
// words, syncs the warp and runs step(slot).
template <typename T, int W, int NW, class Copy, class Save, class Step>
__device__ __forceinline__ void fwd_ticks(const FwdCtx<T, W, NW>& c, int L, Copy&& copy,
                                          Save&& save, Step&& step) {
    for (int k = 0; k < FWD_AHEAD; ++k) {
        if (k < L) copy(c.slot(k), k);
        cp_async_commit();
    }
    for (int s = 0; s < L; ++s) {
        if (s + FWD_AHEAD < L) copy(c.slot(s + FWD_AHEAD), s + FWD_AHEAD);
        cp_async_commit();
        save(s);
        cp_async_wait<FWD_AHEAD>();
        __syncwarp();
        step(c.slot(s));
    }
}

// The forward steps' Riccati front, row r (fused4._riccati): Sh <- S = Phi
// Sh Phi, su = S u, d = a - u.su and w_r = (v_r - su) / d, which also goes
// to the group's vector wv, for every row to read after the caller's next
// __syncwarp (riccati_fwd_close).  Returns 1 / d; sets d and w_r, which
// is (v_r - su) times 1 / d, or with DIV divided by d as the plain
// versions do.
template <bool DIV = false, typename T, class In>
__device__ __forceinline__ T riccati_fwd_front(int r, const In& in, T (&Sh)[P], T* wv, T& d,
                                               T& wr) {
    Acc4<T> sa;
#pragma unroll
    for (int j = 0; j < P; ++j) {
        Sh[j] = in.phr * Sh[j] * in.ph(j);
        sa.fma(j, Sh[j], in.u(j));
    }
    const T su = sa.sum();
    d = in.a - group_sum(in.ur * su);
    const T rd = T(1) / d;
    wr = r < P ? (DIV ? (in.vr - su) / d : (in.vr - su) * rd) : T(0);
    if (r < P) wv[r] = wr;
    return rd;
}

// ... and its close, row r: Sh <- S + d w w^T, w from the group's vector.
template <typename T>
__device__ __forceinline__ void riccati_fwd_close(T d, T wr, const T* wv, T (&Sh)[P]) {
    const T dw = d * wr;
#pragma unroll
    for (int j = 0; j < P; ++j) Sh[j] = Sh[j] + dw * wv[j];
}

// One step of the elements sweep (elem_value_step's arithmetic), row r:
// the Riccati step, A <- Phi A - w uA^T and J <- J - uA uA^T / d with uA =
// A^T (Phi u), a column sum through the group's tile.
template <typename T, class In>
__device__ __forceinline__ void elem_fwd_step(T* tile, T* wv, T* gv, int r, const In& in,
                                              T (&Sh)[P], T (&A)[P], T (&J)[P]) {
    T d, wr;
    const T rd = riccati_fwd_front(r, in, Sh, wv, d, wr);
    const T phr = in.phr, utr = phr * in.ur;
    const T uAr = column_sum(tile, r, [&](int j) { return A[j] * utr; });
    if (r < P) gv[r] = uAr;
    riccati_fwd_close(d, wr, wv, Sh);
    __syncwarp();
    const T uArd = uAr * rd;
#pragma unroll
    for (int j = 0; j < P; ++j) {
        const T uj = gv[j];
        A[j] = phr * A[j] - wr * uj;
        J[j] = J[j] - uArd * uj;
    }
}

// Each lane's Riccati element (A, J, C) from a zero seed, streamed: a
// group a lane, thread r row r of Sh, A and J, one elem_fwd_step a tick.
// C is the zero-seeded factor recursion, A a product of closed-loop
// transitions (I - w u^T) Phi, J a sum of rank-1 terms.  With a non-null
// sv each step's input [Sh, A] goes to the save stream (NSV0 words a lane
// and step, the layout adjoint.cu's elements_bwd reads): adjoint.cu's
// elements_fwd; pallas_solver.cu's and fused.cu's elements pass null and
// save nothing.
// The kernel runs W warps a block (launch_fwd).
template <typename T, int W>
__device__ __forceinline__ void elements_fwd_sweep(const T* __restrict__ u,
                                                   const T* __restrict__ v,
                                                   const T* __restrict__ ph,
                                                   const T* __restrict__ a, int L, int B,
                                                   T* __restrict__ A_out, T* __restrict__ J_out,
                                                   T* __restrict__ C_out, T* __restrict__ sv) {
    using Ctx = FwdCtx<T, W, NRS>;
    __shared__ T ring[Ctx::RING], tiles[Ctx::TILES], vecs[Ctx::VECS];
    const Ctx c(B, ring, tiles, vecs);
    const int r = c.r, l = c.l;
    T Sh[P], A[P], J[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
        Sh[j] = J[j] = T(0);
        A[j] = j == r ? T(1) : T(0);
    }
    fwd_ticks(
        c, L,
        [&](T* st, int s) {
            copy_streams(st, u, v, ph, a, static_cast<const T*>(nullptr), s, B, l, r);
        },
        [&](int s) {
            if (sv == nullptr || !c.live) return;
            T* svs = sv + ((size_t)s * B + l) * NSV0;
            save_row(svs, r, Sh);
            save_row(svs + PP, r, A);
        },
        [&](const T* st) {
            elem_fwd_step(c.tile, c.wv, c.gv, r, RingStep<T, 0>(st, r), Sh, A, J);
        });
    if (!c.live || r >= P) return;
    put_mat(A_out, r, B, l, A);
    put_mat(J_out, r, B, l, J);
    put_mat(C_out, r, B, l, Sh);
}

// One step of the seeded factor sweep (factor_value_step's arithmetic),
// row r: the Riccati step, M <- Phi M - w g^T with g = (Phi M)^T u (a
// column sum through the group's tile), m <- Phi m + w z0 with z0 = y - u
// . Phi m, Qm <- Qm + g g^T / d, qv, the Kahan-summed quad and log-det and
// the NaN-propagating minimum pivot (like torch.minimum); the scalar
// statistics are kept alike in every thread of the group.  Without STATS
// (pallas_solver.cu's factor, whose d and w streams are outputs) the
// statistics are left as they are, m rounds as that kernel's plain
// version, (mh - w (u . mh)) + w y, and in float32 so does w, (v - su) /
// d: a w one ulp apart moved float32 m by 1.8e-3 of its largest value on
// bench.py's blocks of 512 steps at N = 1e6, while float64 stays within
// 2e-13 of plain multiplying by 1 / d, which a division would slow by up
// to 20% (PERF.md).  Returns d; w stays in the group's vector wv until the
// next step's front.
template <bool STATS = true, typename T, class In>
__device__ __forceinline__ T factor_fwd_step(T* tile, T* wv, T* gv, int r, const In& in,
                                             T (&Sh)[P], T (&M)[P], T (&Qm)[P], T& mr, T& qvr,
                                             Kahan<T>& q0, Kahan<T>& ld, T& mind) {
    const T phr = in.phr, ur = in.ur, mh = phr * mr;
    const T umh = group_sum(ur * mh), z0 = in.y - umh;
    T d, wr;
    const T rd = riccati_fwd_front<!STATS && sizeof(T) == 4>(r, in, Sh, wv, d, wr);
#pragma unroll
    for (int j = 0; j < P; ++j) M[j] = phr * M[j];
    const T gr = column_sum(tile, r, [&](int j) { return M[j] * ur; });
    if (r < P) gv[r] = gr;
    riccati_fwd_close(d, wr, wv, Sh);
    __syncwarp();
    const T grd = gr * rd;
#pragma unroll
    for (int j = 0; j < P; ++j) {
        const T gj = gv[j];
        M[j] = M[j] - wr * gj;
        if (STATS) Qm[j] = Qm[j] + grd * gj;
    }
    if (!STATS) {
        mr = (mh - wr * umh) + wr * in.y;
        return d;
    }
    mr = mh + wr * z0;
    q0.add(z0 * z0 * rd);
    ld.add(dlog(d));
    qvr = qvr + (z0 * rd) * gr;
    mind = (d < mind || d != d) ? d : mind;
    return d;
}

// ... and the step without its statistics (pallas_solver.cu's factor):
// Sh, M and m.  Returns d.
template <typename T, class In>
__device__ __forceinline__ T factor_fwd_step(T* tile, T* wv, T* gv, int r, const In& in,
                                             T (&Sh)[P], T (&M)[P], T& mr) {
    T Qm[P], qvr, mind;  // never read or written
    Kahan<T> q0, ld;
    return factor_fwd_step<false>(tile, wv, gv, r, in, Sh, M, Qm, mr, qvr, q0, ld, mind);
}

// Each lane's seeded factor from sh0 (P, P, B; float64 glue operands too,
// rounded to T), its affine map (M, m) and statistics (Qm, qv,
// Kahan-summed q0 and log-det, min pivot), streamed: a group a lane,
// thread r row r of Sh, M and Qm and entry r of m and qv, one
// factor_fwd_step a tick.  With SAVE each step's input [Sh, M, m] goes to
// the save stream sv (NSV1 words a lane and step, the layout adjoint.cu's
// factor_bwd and onepass.cu's sweep_bwd read): adjoint.cu's factor_fwd;
// fused.cu's factor saves nothing and passes a null sv.  With ZERO the
// seed is zero (sh0 is not read) and the end state Sh goes to C_out (P, P,
// B): onepass.cu's sweep, and with SAVE its sweep_fwd.  A run-time test of
// sv in the hook cost adjoint.cu's float32 instance at P = 16 8-32 bytes
// of spills (PERF.md), so both choices are made at compile time.
// The kernel runs W warps a block (launch_fwd).
template <bool SAVE, typename T, int W, bool ZERO = false, typename U>
__device__ __forceinline__ void factor_fwd_sweep(
    const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ ph,
    const T* __restrict__ a, const T* __restrict__ y, const U* __restrict__ sh0, int L, int B,
    T* __restrict__ M_out, T* __restrict__ m_out, T* __restrict__ Qm_out, T* __restrict__ qv_out,
    double* __restrict__ q0_out, double* __restrict__ ld_out, T* __restrict__ mind_out,
    T* __restrict__ sv, T* __restrict__ C_out = nullptr) {
    using Ctx = FwdCtx<T, W, NRS>;
    __shared__ T ring[Ctx::RING], tiles[Ctx::TILES], vecs[Ctx::VECS];
    const Ctx c(B, ring, tiles, vecs);
    const int r = c.r, l = c.l;
    T Sh[P], M[P], Qm[P];
    if (!ZERO) get_mat(sh0, r, B, l, Sh);
#pragma unroll
    for (int j = 0; j < P; ++j) {
        if (ZERO) Sh[j] = T(0);
        M[j] = j == r ? T(1) : T(0);
        Qm[j] = T(0);
    }
    T mr = T(0), qvr = T(0), mind = T(INFINITY);
    Kahan<T> q0{T(0), T(0)}, ld{T(0), T(0)};
    fwd_ticks(
        c, L, [&](T* st, int s) { copy_streams(st, u, v, ph, a, y, s, B, l, r); },
        [&](int s) {
            if (!SAVE || !c.live) return;
            T* svs = sv + ((size_t)s * B + l) * NSV1;
            save_row(svs, r, Sh);
            save_row(svs + PP, r, M);
            if (r < P) svs[2 * PP + r] = mr;
        },
        [&](const T* st) {
            factor_fwd_step(c.tile, c.wv, c.gv, r, RingStep<T, 0>(st, r), Sh, M, Qm, mr, qvr, q0,
                            ld, mind);
        });
    if (!c.live || r >= P) return;
    put_mat(M_out, r, B, l, M);
    put_mat(Qm_out, r, B, l, Qm);
    if (ZERO) put_mat(C_out, r, B, l, Sh);
    m_out[(size_t)r * B + l] = mr;
    qv_out[(size_t)r * B + l] = qvr;
    if (r == 0) {
        q0_out[l] = q0.total();
        ld_out[l] = ld.total();
        mind_out[l] = mind;
    }
}

// Warps a block of a forward sweep: four where that still gives every SM
// of the card a block, else one.  adjoint.cu's factor_fwd takes four on E's
// 16 chains (2048 lanes at G = 16: 256 blocks) and one on sampler_E's 4
// chains (512 lanes: 256 blocks of 2 lanes); on those two plans two warps
// were never faster than both (PERF.md).
static inline int fwd_warps(int B) {
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    constexpr int lb = 4 * 32 / G;
    return (B + lb - 1) / lb >= sms ? 4 : 1;
}

// A forward sweep's launch on the caller's stream: k4, its four-warp
// instantiation, or k1, its one-warp one, by fwd_warps.  Returns
// cudaGetLastError().
template <typename K, typename... A>
static int launch_fwd(K k4, K k1, int B, void* stream, A... args) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int w = fwd_warps(B), lb = 32 * w / G;
    const dim3 grid((unsigned)((B + lb - 1) / lb));
    if (w == 4)
        k4<<<grid, 128, 0, st>>>(args...);
    else
        k1<<<grid, 32, 0, st>>>(args...);
    return (int)cudaGetLastError();
}
