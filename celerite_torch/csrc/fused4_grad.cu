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

#include "adjoint_common.cuh"

static_assert(P <= 12, "padded width must be in [1, 12]");

// ---------------------------------------------------------------------------
// The coefficients a thread lowers, and the lowering of its row
// ---------------------------------------------------------------------------

// Column r's words: its coefficients (a column of Coeffs: a real column's
// a, c; a complex pair's a, b, c, d on both of its columns) and the total,
// then row r's share of the coefficient cotangent (a real column's; a
// pair's row's terms, which the pair's first row adds up at the end; the
// total's, alike in every thread).  They wait in shared memory, a word of
// each a thread at [f * S + threadIdx.x] (S threads a block), out of the sweep's registers.
enum { CA, CB, CC, CD, CT, GA, GB, GC, GD, GT, NCOL };

// kind: 0 a real column, 1 a pair's first column, 2 its second, -1 a
// padding row.
template <typename T, int S = BLOCK>
struct Col {
    T* w;
    int kind;
    __device__ __forceinline__ T& operator[](int f) const { return w[f * S]; }
};

// A block of S threads: thread r's column of a lane's coefficient row cf.
template <typename T, int S = BLOCK>
__device__ __forceinline__ Col<T, S> load_col(T* cols, const T* __restrict__ cf, int jr, int r) {
    const int jc = (P - jr) / 2;
    Col<T, S> k{cols + threadIdx.x, -1};
#pragma unroll
    for (int f = 0; f < NCOL; ++f) k[f] = T(0);
    if (r < jr) {
        k[CA] = cf[r];
        k[CB] = cf[jr + r];
        k.kind = 0;
    } else if (r < P) {
        const int j = (r - jr) >> 1;
        k[CA] = cf[2 * jr + j];
        k[CB] = cf[2 * jr + jc + j];
        k[CC] = cf[2 * jr + 2 * jc + j];
        k[CD] = cf[2 * jr + 3 * jc + j];
        k.kind = 1 + ((r - jr) & 1);
    }
    k[CT] = cf[2 * jr + 4 * jc];
    return k;
}

// Row r of lower_step: u_r, v_r, phi_r, and a pair's (cos, sin) * m (cm,
// sm), which its coefficient chain takes; zeros on a padding row.
template <typename T, int S>
__device__ __forceinline__ void lower_row(const Col<T, S>& k, T t, T tl, T dt, T m, T& u, T& v,
                                          T& ph, T& cm, T& sm) {
    cm = sm = T(0);
    if (k.kind == 0) {
        u = k[CA] * m;
        v = m;
        ph = dexp(-k[CB] * dt);
    } else if (k.kind > 0) {
        pair_rot(k[CC], k[CD], t, tl, dt, m, cm, sm, ph);
        u = k.kind == 1 ? k[CA] * cm + k[CB] * sm : k[CA] * sm - k[CB] * cm;
        v = k.kind == 1 ? cm : sm;
    } else {
        u = v = ph = T(0);
    }
}

// A lane's scalar streams of a step in its ring slot.
enum { ZT, ZTL, ZDT, ZDG, ZMK, ZY, NZ };

// Step s's saves of a forward kernel: rows r of X and Y at words r * P + j
// and PP + r * P + j of NS, and, where NS > 2 PP, z at word 2 PP + r; word
// q of lane l at (s * NS + q) * B + l.  Four-warp blocks pass them through
// shared memory (NS words of LB lanes, a word's lanes padded to LB + 1) and
// the block writes each word's LB lanes together, where a warp's own 32 / G
// lanes fill half of each 32-byte sector in float32 (C's 16 chains, row 4:
// 2.54 -> 0.60 ms in float32, 1.19 -> 0.84 in float64).  One-warp blocks
// write their own: the two barriers a step took 1.8x as long at one theta.
template <int NS, int W, typename T, class Ctx>
__device__ __forceinline__ void put_saves(const Ctx& c, T* stage, T* __restrict__ sv, int s,
                                          int B, const T (&X)[P], const T (&Y)[P], T z) {
    constexpr int LB = Ctx::LB, LBP = LB + 1;
    const int r = c.r;
    if (W == 4) {
        __syncthreads();  // the block's write of step s - 1 has read the stage
        if (r < P) {
#pragma unroll
            for (int j = 0; j < P; ++j) {
                stage[(r * P + j) * LBP + c.q] = X[j];
                stage[(PP + r * P + j) * LBP + c.q] = Y[j];
            }
            if (NS > 2 * PP) stage[(2 * PP + r) * LBP + c.q] = z;
        }
        __syncthreads();
        const int l0 = blockIdx.x * LB;
        for (int i = threadIdx.x; i < NS * LB; i += 32 * W) {
            const int w = i / LB, lk = i % LB;
            if (l0 + lk < B) sv[((size_t)s * NS + w) * B + l0 + lk] = stage[w * LBP + lk];
        }
    } else if (c.live && r < P) {
        T* sp = sv + (size_t)s * NS * B + c.l;
#pragma unroll
        for (int j = 0; j < P; ++j) {
            sp[(size_t)(r * P + j) * B] = X[j];
            sp[(size_t)(PP + r * P + j) * B] = Y[j];
        }
        if (NS > 2 * PP) sp[(size_t)(2 * PP + r) * B] = z;
    }
}

// ---------------------------------------------------------------------------
// elem_fwd: phase 0 with saves [Sh_in, A_in] a step (NSV0 words), streamed
// as factor_fwd below: a group of G threads a lane, thread r row r of Sh,
// A and J, its five scalar streams (ZT .. ZMK; no y) in the cp.async ring
// FWD_AHEAD steps ahead, its own column of the step lowered from shared
// memory and u, phi gathered by shuffles; the step is adjoint.cu's
// elements_fwd's (elem_fwd_step): one reciprocal of d, uA = A^T (Phi u) a
// column sum through the group's tile.  Outputs A, J, C at (i * P + j) * B
// + l, written by row.
// ---------------------------------------------------------------------------

template <typename T, int W>
__global__ void __launch_bounds__(32 * W)
elem_fwd_kernel(const T* __restrict__ cf, int seg, const T* __restrict__ t,
                const T* __restrict__ tl, const T* __restrict__ dt, const T* __restrict__ dg,
                const T* __restrict__ msk, int L, int B, int jr, T* __restrict__ A_out,
                T* __restrict__ J_out, T* __restrict__ C_out, T* __restrict__ sv) {
    using Ctx = FwdCtx<T, W, ZY>;
    __shared__ T ring[Ctx::RING], tiles[Ctx::TILES], vecs[Ctx::VECS], cols[NCOL * 32 * W],
        stage[W == 4 ? NSV0 * (Ctx::LB + 1) : 1];
    const Ctx c(B, ring, tiles, vecs);
    const int r = c.r, l = c.l;
    const Col<T, 32 * W> k =
        load_col<T, 32 * W>(cols, cf + (size_t)(l / seg) * (2 * P + 1), jr, r);
    T Sh[P], A[P], J[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
        Sh[j] = J[j] = T(0);
        A[j] = j == r ? T(1) : T(0);
    }
    fwd_ticks(
        c, L,
        [&](T* st, int s) {
            if (r != 0) return;
            const size_t o = (size_t)s * B + l;
            cp_async(st + ZT, t + o);
            cp_async(st + ZTL, tl + o);
            cp_async(st + ZDT, dt + o);
            cp_async(st + ZDG, dg + o);
            cp_async(st + ZMK, msk + o);
        },
        [&](int s) { put_saves<NSV0, W>(c, stage, sv, s, B, Sh, A, T(0)); },
        [&](const T* st) {
            const T ms = st[ZMK];
            T ur, vr, phr, cm, sm, uv[P], pv[P];
            lower_row(k, st[ZT], st[ZTL], st[ZDT], ms, ur, vr, phr, cm, sm);
            gather(ur, uv);
            gather(phr, pv);
            const T a = ms * (st[ZDG] + k[CT]) + (T(1) - ms);
            elem_fwd_step(c.tile, c.wv, c.gv, r, LowStep<T>{uv, pv, ur, phr, vr, a, T(0)}, Sh, A,
                          J);
        });
    if (!c.live || r >= P) return;
    put_mat(A_out, r, B, l, A);
    put_mat(J_out, r, B, l, J);
    put_mat(C_out, r, B, l, Sh);
}

// ---------------------------------------------------------------------------
// factor_fwd: phase 1 from the float64 seed sh0 (P, P, B), with saves
// [Sh_in, M_in, m_in] a step, streamed (adjoint_common.cuh's forward
// sweeps): a group of G threads a lane, thread r row r of Sh, M and Qm and
// entry r of m and qv.  Each group copies its lane's scalar streams
// FWD_AHEAD steps ahead into a ring in shared memory (cp.async); thread r
// lowers its own column of the step from its coefficients in shared memory
// and the group gathers u and phi by shuffles; the step is adjoint.cu's
// factor_fwd's (factor_fwd_step).  Outputs M, m, Qm, qv, mind in T and the
// Kahan pairs q0, ld added in float64, written by thread 0.
// ---------------------------------------------------------------------------

template <typename T, int W>
__global__ void __launch_bounds__(32 * W)
factor_fwd_kernel(const T* __restrict__ cf, int seg, const T* __restrict__ t,
                  const T* __restrict__ tl, const T* __restrict__ dt, const T* __restrict__ dg,
                  const T* __restrict__ msk, const T* __restrict__ y, int L, int B, int jr,
                  const double* __restrict__ sh0, T* __restrict__ M_out, T* __restrict__ m_out,
                  T* __restrict__ Qm_out, T* __restrict__ qv_out, double* __restrict__ q0_out,
                  double* __restrict__ ld_out, T* __restrict__ mind_out, T* __restrict__ sv) {
    using Ctx = FwdCtx<T, W, NZ>;
    __shared__ T ring[Ctx::RING], tiles[Ctx::TILES], vecs[Ctx::VECS], cols[NCOL * 32 * W],
        stage[W == 4 ? NSV1 * (Ctx::LB + 1) : 1];
    const Ctx c(B, ring, tiles, vecs);
    const int r = c.r, l = c.l;
    const Col<T, 32 * W> k =
        load_col<T, 32 * W>(cols, cf + (size_t)(l / seg) * (2 * P + 1), jr, r);
    T Sh[P], M[P], Qm[P];
    get_mat(sh0, r, B, l, Sh);
#pragma unroll
    for (int j = 0; j < P; ++j) {
        M[j] = j == r ? T(1) : T(0);
        Qm[j] = T(0);
    }
    T mr = T(0), qvr = T(0), mind = T(INFINITY);
    Kahan<T> q0{T(0), T(0)}, ld{T(0), T(0)};
    fwd_ticks(
        c, L,
        [&](T* st, int s) {
            if (r != 0) return;
            const size_t o = (size_t)s * B + l;
            cp_async(st + ZT, t + o);
            cp_async(st + ZTL, tl + o);
            cp_async(st + ZDT, dt + o);
            cp_async(st + ZDG, dg + o);
            cp_async(st + ZMK, msk + o);
            cp_async(st + ZY, y + o);
        },
        [&](int s) { put_saves<NSV1, W>(c, stage, sv, s, B, Sh, M, mr); },
        [&](const T* st) {
            const T ms = st[ZMK];
            T ur, vr, phr, cm, sm, uv[P], pv[P];
            lower_row(k, st[ZT], st[ZTL], st[ZDT], ms, ur, vr, phr, cm, sm);
            gather(ur, uv);
            gather(phr, pv);
            const T a = ms * (st[ZDG] + k[CT]) + (T(1) - ms);
            factor_fwd_step(c.tile, c.wv, c.gv, r, LowStep<T>{uv, pv, ur, phr, vr, a, st[ZY]}, Sh,
                            M, Qm, mr, qvr, q0, ld, mind);
        });
    if (!c.live || r >= P) return;
    put_mat(M_out, r, B, l, M);
    put_mat(Qm_out, r, B, l, Qm);
    m_out[(size_t)r * B + l] = mr;
    qv_out[(size_t)r * B + l] = qvr;
    if (r == 0) {
        q0_out[l] = q0.total();
        ld_out[l] = ld.total();
        mind_out[l] = mind;
    }
}

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
