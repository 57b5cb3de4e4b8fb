// The forward sweeps of the fused4 kernels that lower their streams in the
// kernel: fused4_grad.cu's elem_fwd and factor_fwd, which write each
// step's saves, and fused4_primal.cu's two phases, which are the same
// kernels launched with a null save stream (put_saves does nothing then).
// One copy of the in-kernel lowering (Col, lower_row) and of the launch;
// the steps are adjoint_common.cuh's (elem_fwd_step, factor_fwd_step).
//
// A group of G threads owns a lane, thread r row r of every P x P state;
// thread r lowers its own column of each step (u_r, v_r, phi_r; the two
// rows of a complex pair compute their shared exp and sincos each) from its
// coefficients in shared memory, and the group gathers u and phi by
// shuffles.  The six scalar streams (t, t_lo, dt, diag, mask, y) are copied
// FWD_AHEAD steps ahead into a ring in shared memory (cp.async), in blocks
// of four warps where that still gives every SM a block, else of one
// (launch_fwd).  Streams are (L, B), step s of lane l at s * B + l; one
// coefficient row per segment of `seg` lanes.
//
// Compiled into each source once per padded width: -DCELERITE_P=<P>
// (1 <= P <= 12).

#pragma once

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

// Row r of fused4._lower_step: u_r, v_r, phi_r, and a pair's (cos, sin) * m (cm,
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
    if (sv == nullptr) return;  // the primal's sweeps save nothing
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

