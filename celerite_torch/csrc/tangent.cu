// The log-likelihood with T forward-mode tangent directions for Hopper
// (sm_90a), on pre-lowered streams and their tangent streams.
//
// Replaces the Pallas kernels of celerite_tpu/ops/tangent.py:
//   tangent_elements_kernel <- _elements_jvp_kernel (tangent.py:71)
//   tangent_factor_kernel   <- _factor_jvp_kernel   (tangent.py:138)
//   jac_* (four launches)   <- _jac_kernel          (tangent.py:591)
// The first two are the split pair of wide models (the port runs them at
// padded width 9-16): each lane's Riccati element (A, J, C) with its T
// tangents, then from each lane's seed (and its tangents) the affine map
// (M, m), the statistics (Qm, qv, Kahan-summed q0 and log-det, min pivot)
// and their tangents; the cross-lane prefixes and the assembly between and
// after them are float64 torch glue in forward mode
// (celerite_torch/ops/tangent.py).  _jac_kernel is fused.cu's four
// launches with T tangent copies of the state: the same two sweeps, and
// the two scans of prefix_common.cuh with their tangents, with no torch
// work between them (the port runs it at padded width 8 or less).
// Tangent streams are (L, T, P, B) and (L, T, 1, B), the direction axis
// ahead of the small dims, as in the Pallas kernels.
//
// Design.  A group of G threads (the power of two at or above P) runs one
// (lane, direction) item, as in dsfused.cu: item i of a launch is lane
// i % B along direction i / B, thread r owns row r of every P x P state
// (value and tangent), so a thread holds 6 P values of state whatever T
// is; the direction chunk is therefore not bounded by registers or shared
// memory, and a launch takes all T directions (ops/tangent.py).  Each item
// recomputes its lane's value recursion beside its tangent, as each
// direction chunk of the JAX pipeline reruns the value: carrying the value
// once a lane would hold T tangent copies of three P x P states in one
// group (3 T P^2 words, 80 KB at P = 16, T = 13 in float64) and barrier
// the directions at every step, while the recursion is a chain of
// dependent steps whose latency the value's repeat does not lengthen.  The
// item of direction 0 also writes the value.  The scans give a
// (segment, direction) pair one block (prefix_common.cuh), which redoes
// the segment's value scan beside its tangent for the same reason.
//
// Bound.  Bytes: the value streams once an item a sweep would be (3P + 1)
// words a point and direction; counted once, each input read once (the
// value streams and the T tangent streams, (3P + 1)(1 + T) words a point
// for the elements, (3P + 2)(1 + T) for the factor) and each output
// written once.  At config[2] (P = 8, T = 7) over 16 chains of N = 1e5 in
// float64 that is ~2.6 GB a sweep, ~0.8 ms at 3.35 TB/s.  Operations: the
// value step once and the tangent step T times a point (~15 P^2 + 41 T P^2
// flops a point and sweep; chip_smoke.tangent_bound_ms counts them from
// the code), ~3 x 10^10 a sweep there, ~0.9 ms at 34 TFLOP/s float64; with
// the scans the jac launches are bound by operations (1.8 ms).  The
// kernels also redo the value step T times (not counted in the bound) and
// are a chain of dependent steps a lane.
//
// Rounding: -fmad=false (_build.SOURCE_FLAGS), so that float32 rounds as
// the plain versions (torch.func.jvp of ops/pallas_solver's and
// ops/adjoint's plain sweeps), which keep every multiply and add separate.
// The tangents of the Kahan sums are Kahan sums, as the jvp of the plain
// version's compensated sums is; the Pallas kernels sum them plainly.
//
// Compiled once per padded width: nvcc -DCELERITE_P=<P> (1 <= P <= 16).

#include "lanes_common.cuh"
#include "prefix_common.cuh"

// The (lane, direction) item of this thread's group; threads past the
// launch's items run item 0 for the group's shuffles and write nothing.
struct Item {
    int l, k, r;
    bool live;
};

__device__ __forceinline__ Item item_of(int B, int nT) {
    const size_t g = ((size_t)blockIdx.x * BLOCK + threadIdx.x) / G;
    Item it;
    it.live = g < (size_t)B * nT;
    const size_t gi = it.live ? g : 0;
    it.l = (int)(gi % B);
    it.k = (int)(gi / B);
    it.r = (int)(threadIdx.x % G);
    return it;
}

// x[s, k, :, l] of an (L, T, P, B) tangent stream, whole.
template <typename T>
__device__ __forceinline__ void load_tvec(const T* __restrict__ x, int s, int k, int nT, int B,
                                          int l, T (&out)[P]) {
    const T* p = x + ((size_t)s * nT + k) * P * B + l;
#pragma unroll
    for (int j = 0; j < P; ++j) out[j] = p[(size_t)j * B];
}

// Entry r of x[s, k, :, l] (0 for r >= P), and x[s, k, 0, l] of an
// (L, T, 1, B) stream.
template <typename T>
__device__ __forceinline__ T tvec_row(const T* __restrict__ x, int s, int k, int nT, int B,
                                      int l, int r) {
    return r < P ? x[(((size_t)s * nT + k) * P + r) * B + l] : T(0);
}

template <typename T>
__device__ __forceinline__ T tscal(const T* __restrict__ x, int s, int k, int nT, int B, int l) {
    return x[((size_t)s * nT + k) * B + l];
}

// Row r of direction k of a (T, P, P, B) array.
template <typename T>
__device__ __forceinline__ void put_tmat(T* __restrict__ out, int k, int r, int B, int l,
                                         const T (&x)[P]) {
#pragma unroll
    for (int j = 0; j < P; ++j) out[tan_at(k, r * P + j, B, l)] = x[j];
}

template <typename T>
__device__ __forceinline__ void get_tmat(const T* __restrict__ in, int k, int r, int B, int l,
                                         T (&x)[P]) {
#pragma unroll
    for (int j = 0; j < P; ++j) x[j] = r < P ? in[tan_at(k, r * P + j, B, l)] : T(0);
}

// Row r of the Riccati step Sh <- Phi Sh Phi + d w w^T and its tangent,
// from the step's value and tangent streams (u, ph whole, v and dv at row
// r).  Returns d; leaves w_r, every w_j, dw_r, every dw_j and dd.
template <typename T>
__device__ __forceinline__ T riccati_tan_row(T (&Sh)[P], T (&dSh)[P], int r, const T (&u)[P],
                                             const T (&du)[P], const T (&ph)[P],
                                             const T (&dph)[P], T vr, T dvr, T a, T da, T& wr,
                                             T (&w)[P], T& dwr, T (&dw)[P], T& dd) {
    const T phr = pick(ph, r), dphr = pick(dph, r), ur = pick(u, r), dur = pick(du, r);
    T su = T(0), dsu = T(0);
#pragma unroll
    for (int j = 0; j < P; ++j) {
        dSh[j] = dphr * Sh[j] * ph[j] + phr * dSh[j] * ph[j] + phr * Sh[j] * dph[j];
        Sh[j] = phr * Sh[j] * ph[j];
        su += Sh[j] * u[j];
        dsu += dSh[j] * u[j] + Sh[j] * du[j];
    }
    const T d = a - group_sum(ur * su);
    dd = da - group_sum(dur * su + ur * dsu);
    wr = r < P ? (vr - su) / d : T(0);
    dwr = r < P ? ((dvr - dsu) - wr * dd) / d : T(0);
    gather(wr, w);
    gather(dwr, dw);
#pragma unroll
    for (int j = 0; j < P; ++j) {
        dSh[j] = dSh[j] + dd * wr * w[j] + d * (dwr * w[j] + wr * dw[j]);
        Sh[j] = Sh[j] + d * wr * w[j];
    }
    return d;
}

// ---------------------------------------------------------------------------
// The elements sweep with tangents: each lane's (A, J, C) from a zero seed
// and direction k's (dA, dJ, dC).
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void elements_jvp_sweep(
    const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ ph,
    const T* __restrict__ a, const T* __restrict__ du, const T* __restrict__ dv,
    const T* __restrict__ dph, const T* __restrict__ da, int L, int B, int nT,
    T* __restrict__ A_out, T* __restrict__ J_out, T* __restrict__ C_out, T* __restrict__ DA_out,
    T* __restrict__ DJ_out, T* __restrict__ DC_out) {
    const Item it = item_of(B, nT);
    const int l = it.l, k = it.k, r = it.r;
    T Sh[P], A[P], J[P], dSh[P], dA[P], dJ[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
        Sh[j] = J[j] = dSh[j] = dA[j] = dJ[j] = T(0);
        A[j] = j == r ? T(1) : T(0);
    }
    for (int s = 0; s < L; ++s) {
        T uv[P], pv[P], duv[P], dpv[P], w[P], dw[P], uA[P], duA[P], wr, dwr, dd;
        load_vec(u, s, B, l, uv);
        load_vec(ph, s, B, l, pv);
        load_tvec(du, s, k, nT, B, l, duv);
        load_tvec(dph, s, k, nT, B, l, dpv);
        const T vr = r < P ? v[((size_t)s * P + r) * B + l] : T(0);
        const T dvr = tvec_row(dv, s, k, nT, B, l, r);
        const T d = riccati_tan_row(Sh, dSh, r, uv, duv, pv, dpv, vr, dvr,
                                    a[(size_t)s * B + l], tscal(da, s, k, nT, B, l), wr, w, dwr,
                                    dw, dd);
        // uA = A^T (Phi u): a sum over rows for every column.
        const T phr = pick(pv, r), dphr = pick(dpv, r);
        const T utr = phr * pick(uv, r), dutr = dphr * pick(uv, r) + phr * pick(duv, r);
#pragma unroll
        for (int j = 0; j < P; ++j) {
            uA[j] = group_sum(A[j] * utr);
            duA[j] = group_sum(dA[j] * utr + A[j] * dutr);
        }
        const T uAr = pick(uA, r), duAr = pick(duA, r);
#pragma unroll
        for (int j = 0; j < P; ++j) {
            dA[j] = dphr * A[j] + phr * dA[j] - dwr * uA[j] - wr * duA[j];
            dJ[j] = dJ[j] - (duAr * (uA[j] / d) + uAr * (duA[j] / d - uA[j] * dd / (d * d)));
            A[j] = phr * A[j] - wr * uA[j];
            J[j] = J[j] - uAr * (uA[j] / d);
        }
    }
    if (!it.live || r >= P) return;
    if (k == 0) {
        put_mat(A_out, r, B, l, A);
        put_mat(J_out, r, B, l, J);
        put_mat(C_out, r, B, l, Sh);
    }
    put_tmat(DA_out, k, r, B, l, dA);
    put_tmat(DJ_out, k, r, B, l, dJ);
    put_tmat(DC_out, k, r, B, l, dSh);
}

// ---------------------------------------------------------------------------
// The factor sweep with tangents: from each lane's seed sh0 and direction
// k's dsh0, the affine map, the statistics and their tangents.
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void factor_jvp_sweep(
    const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ ph,
    const T* __restrict__ a, const T* __restrict__ y, const T* __restrict__ du,
    const T* __restrict__ dv, const T* __restrict__ dph, const T* __restrict__ da,
    const T* __restrict__ dy, const T* __restrict__ sh0, const T* __restrict__ dsh0, int L,
    int B, int nT, T* __restrict__ M_out, T* __restrict__ m_out, T* __restrict__ Qm_out,
    T* __restrict__ qv_out, double* __restrict__ q0_out, double* __restrict__ ld_out,
    T* __restrict__ mind_out, T* __restrict__ DM_out, T* __restrict__ Dm_out,
    T* __restrict__ DQm_out, T* __restrict__ Dqv_out, double* __restrict__ Dq0_out,
    double* __restrict__ Dld_out) {
    const Item it = item_of(B, nT);
    const int l = it.l, k = it.k, r = it.r;
    // Row r of Sh, M, Qm, entry r of m and qv, and their tangents; the
    // scalar statistics are kept alike in every thread of the group.
    T Sh[P], dSh[P], M[P], dM[P], Qm[P], dQm[P];
    get_mat(sh0, r, B, l, Sh);
    get_tmat(dsh0, k, r, B, l, dSh);
#pragma unroll
    for (int j = 0; j < P; ++j) {
        M[j] = j == r ? T(1) : T(0);
        dM[j] = Qm[j] = dQm[j] = T(0);
    }
    T mr = T(0), dmr = T(0), qvr = T(0), dqvr = T(0);
    T q0 = T(0), cq0 = T(0), ld = T(0), cld = T(0);
    T dq0 = T(0), dcq0 = T(0), dld = T(0), dcld = T(0);
    T mind = T(INFINITY);
    for (int s = 0; s < L; ++s) {
        T uv[P], pv[P], duv[P], dpv[P], w[P], dw[P], g[P], dg[P], wr, dwr, dd;
        load_vec(u, s, B, l, uv);
        load_vec(ph, s, B, l, pv);
        load_tvec(du, s, k, nT, B, l, duv);
        load_tvec(dph, s, k, nT, B, l, dpv);
        const size_t o = (size_t)s * B + l;
        const T vr = r < P ? v[((size_t)s * P + r) * B + l] : T(0);
        const T dvr = tvec_row(dv, s, k, nT, B, l, r);
        const T d = riccati_tan_row(Sh, dSh, r, uv, duv, pv, dpv, vr, dvr, a[o],
                                    tscal(da, s, k, nT, B, l), wr, w, dwr, dw, dd);
        // M <- Phi M - w g^T with g = (Phi M)^T u.
        const T phr = pick(pv, r), dphr = pick(dpv, r), ur = pick(uv, r), dur = pick(duv, r);
#pragma unroll
        for (int j = 0; j < P; ++j) {
            dM[j] = dphr * M[j] + phr * dM[j];
            M[j] = phr * M[j];
        }
#pragma unroll
        for (int j = 0; j < P; ++j) {
            g[j] = group_sum(M[j] * ur);
            dg[j] = group_sum(dM[j] * ur + M[j] * dur);
        }
#pragma unroll
        for (int j = 0; j < P; ++j) {
            dM[j] = dM[j] - dwr * g[j] - wr * dg[j];
            M[j] = M[j] - wr * g[j];
        }
        // m <- Phi m + w z0 with z0 = y - u . Phi m.
        const T mh = phr * mr, dmh = dphr * mr + phr * dmr;
        const T z0 = y[o] - group_sum(ur * mh);
        const T dz0 = tscal(dy, s, k, nT, B, l) - group_sum(dur * mh + ur * dmh);
        dmr = dmh + dwr * z0 + wr * dz0;
        mr = mh + wr * z0;
        // The Kahan-compensated quad and log-det, and their tangents.
        const T zd = z0 / d, dzd = (dz0 - zd * dd) / d;
        const T x1 = z0 * z0 / d - cq0;
        const T t1 = q0 + x1;
        cq0 = (t1 - q0) - x1;
        q0 = t1;
        const T x2 = dlog(d) - cld;
        const T t2 = ld + x2;
        cld = (t2 - ld) - x2;
        ld = t2;
        const T y1 = dz0 * zd + z0 * dzd - dcq0;
        const T s1 = dq0 + y1;
        dcq0 = (s1 - dq0) - y1;
        dq0 = s1;
        const T y2 = dd / d - dcld;
        const T s2 = dld + y2;
        dcld = (s2 - dld) - y2;
        dld = s2;
        const T gr = pick(g, r), dgr = pick(dg, r);
        qvr = qvr + zd * gr;
        dqvr = dqvr + dzd * gr + zd * dgr;
#pragma unroll
        for (int j = 0; j < P; ++j) {
            dQm[j] = dQm[j] + (dgr * (g[j] / d) + gr * (dg[j] / d - g[j] * dd / (d * d)));
            Qm[j] = Qm[j] + gr * (g[j] / d);
        }
        // NaN-propagating min, like torch.minimum.
        mind = (d < mind || d != d) ? d : mind;
    }
    if (!it.live || r >= P) return;
    if (k == 0) {
        put_mat(M_out, r, B, l, M);
        put_mat(Qm_out, r, B, l, Qm);
        m_out[(size_t)r * B + l] = mr;
        qv_out[(size_t)r * B + l] = qvr;
        if (r == 0) {
            q0_out[l] = (double)q0 + (double)cq0;
            ld_out[l] = (double)ld + (double)cld;
            mind_out[l] = mind;
        }
    }
    put_tmat(DM_out, k, r, B, l, dM);
    put_tmat(DQm_out, k, r, B, l, dQm);
    Dm_out[((size_t)k * P + r) * B + l] = dmr;
    Dqv_out[((size_t)k * P + r) * B + l] = dqvr;
    if (r == 0) {
        Dq0_out[(size_t)k * B + l] = (double)dq0 + (double)dcq0;
        Dld_out[(size_t)k * B + l] = (double)dld + (double)dcld;
    }
}

// ---------------------------------------------------------------------------
// The kernels: the split pair, and the four launches of _jac_kernel.
// ---------------------------------------------------------------------------

#define ELEMENTS_JVP_PARAMS                                                                    \
    const T *__restrict__ u, const T *__restrict__ v, const T *__restrict__ ph,               \
        const T *__restrict__ a, const T *__restrict__ du, const T *__restrict__ dv,          \
        const T *__restrict__ dph, const T *__restrict__ da, int L, int B, int nT,            \
        T *__restrict__ A, T *__restrict__ J, T *__restrict__ C, T *__restrict__ DA,          \
        T *__restrict__ DJ, T *__restrict__ DC
#define ELEMENTS_JVP_ARGS u, v, ph, a, du, dv, dph, da, L, B, nT, A, J, C, DA, DJ, DC

#define FACTOR_JVP_PARAMS                                                                      \
    const T *__restrict__ u, const T *__restrict__ v, const T *__restrict__ ph,               \
        const T *__restrict__ a, const T *__restrict__ y, const T *__restrict__ du,           \
        const T *__restrict__ dv, const T *__restrict__ dph, const T *__restrict__ da,        \
        const T *__restrict__ dy, const T *__restrict__ sh0, const T *__restrict__ dsh0,      \
        int L, int B, int nT, T *__restrict__ M, T *__restrict__ m, T *__restrict__ Qm,       \
        T *__restrict__ qv, double *__restrict__ q0, double *__restrict__ ld,                 \
        T *__restrict__ mind, T *__restrict__ DM, T *__restrict__ Dm, T *__restrict__ DQm,    \
        T *__restrict__ Dqv, double *__restrict__ Dq0, double *__restrict__ Dld
#define FACTOR_JVP_ARGS                                                                        \
    u, v, ph, a, y, du, dv, dph, da, dy, sh0, dsh0, L, B, nT, M, m, Qm, qv, q0, ld, mind, DM, \
        Dm, DQm, Dqv, Dq0, Dld

template <typename T>
__global__ void __launch_bounds__(BLOCK) tangent_elements_kernel(ELEMENTS_JVP_PARAMS) {
    elements_jvp_sweep(ELEMENTS_JVP_ARGS);
}

template <typename T>
__global__ void __launch_bounds__(BLOCK) tangent_factor_kernel(FACTOR_JVP_PARAMS) {
    factor_jvp_sweep(FACTOR_JVP_ARGS);
}

template <typename T>
__global__ void __launch_bounds__(BLOCK) jac_elements_kernel(ELEMENTS_JVP_PARAMS) {
    elements_jvp_sweep(ELEMENTS_JVP_ARGS);
}

template <typename T>
__global__ void __launch_bounds__(SCAN_THREADS)
jac_seed_kernel(const T* __restrict__ A, const T* __restrict__ J, const T* __restrict__ C,
                const T* __restrict__ DA, const T* __restrict__ DJ, const T* __restrict__ DC,
                int B, int seg, T* __restrict__ sh0, T* __restrict__ dsh0) {
    seed_scan<true, T>(A, J, C, DA, DJ, DC, B, seg, sh0, dsh0);
}

template <typename T>
__global__ void __launch_bounds__(BLOCK) jac_factor_kernel(FACTOR_JVP_PARAMS) {
    factor_jvp_sweep(FACTOR_JVP_ARGS);
}

template <typename T>
__global__ void __launch_bounds__(P)
jac_assemble_kernel(const T* __restrict__ M, const T* __restrict__ m, const T* __restrict__ Qm,
                    const T* __restrict__ qv, const double* __restrict__ q0,
                    const double* __restrict__ ld, const T* __restrict__ mind,
                    const T* __restrict__ DM, const T* __restrict__ Dm,
                    const T* __restrict__ DQm, const T* __restrict__ Dqv,
                    const double* __restrict__ Dq0, const double* __restrict__ Dld, int B,
                    int seg, double* __restrict__ quad_out, double* __restrict__ ld_out,
                    T* __restrict__ mind_out, double* __restrict__ dquad_out,
                    double* __restrict__ dld_out) {
    assemble_scan<true, T>(M, m, Qm, qv, q0, ld, mind, DM, Dm, DQm, Dqv, Dq0, Dld, B, seg,
                           quad_out, ld_out, mind_out, dquad_out, dld_out);
}

// ---------------------------------------------------------------------------
// Host entry points: launches on the caller's stream, nothing allocated.
// Each returns the first nonzero cudaGetLastError() after a launch.
//
// elements: in u, v, ph (L, P, B), a (L, 1, B), du, dv, dph (L, T, P, B),
//   da (L, T, 1, B); out A, J, C (P, P, B), DA, DJ, DC (T, P, P, B).
// factor: in those, y (L, 1, B), dy (L, T, 1, B), sh0 (P, P, B), dsh0
//   (T, P, P, B); out M, Qm (P, P, B), m, qv (P, B), q0, ld (B,) float64,
//   mind (B,), DM, DQm (T, P, P, B), Dm, Dqv (T, P, B), Dq0, Dld (T, B)
//   float64.
// jac: the elements' and the factor's inputs; as scratch their outputs
//   (w[0..5] the elements', w[6..7] sh0 and dsh0, w[8..20] the factor's);
//   out quad, ld (B / seg,) float64, mind (B / seg,), dquad, dld
//   (T, B / seg) float64.
// ---------------------------------------------------------------------------

template <typename T>
static int jac_launch(const T* u, const T* v, const T* ph, const T* a, const T* y, const T* du,
                      const T* dv, const T* dph, const T* da, const T* dy, void** w,
                      double* quad, double* ldo, T* mindo, double* dquad, double* dldo, int L,
                      int B, int seg, int nT, cudaStream_t st) {
    T *A = (T*)w[0], *J = (T*)w[1], *C = (T*)w[2], *DA = (T*)w[3], *DJ = (T*)w[4],
      *DC = (T*)w[5], *sh0 = (T*)w[6], *dsh0 = (T*)w[7], *M = (T*)w[8], *m = (T*)w[9],
      *Qm = (T*)w[10], *qv = (T*)w[11], *mind = (T*)w[14], *DM = (T*)w[15], *Dm = (T*)w[16],
      *DQm = (T*)w[17], *Dqv = (T*)w[18];
    double *q0 = (double*)w[12], *ld = (double*)w[13], *Dq0 = (double*)w[19],
           *Dld = (double*)w[20];
    const dim3 sweep = grid_for(B * nT, G), scans((unsigned)(B / seg), (unsigned)nT);
    int err;
    jac_elements_kernel<T><<<sweep, BLOCK, 0, st>>>(ELEMENTS_JVP_ARGS);
    if ((err = (int)cudaGetLastError())) return err;
    jac_seed_kernel<T><<<scans, SCAN_THREADS, 0, st>>>(A, J, C, DA, DJ, DC, B, seg, sh0, dsh0);
    if ((err = (int)cudaGetLastError())) return err;
    jac_factor_kernel<T><<<sweep, BLOCK, 0, st>>>(FACTOR_JVP_ARGS);
    if ((err = (int)cudaGetLastError())) return err;
    jac_assemble_kernel<T><<<scans, P, 0, st>>>(M, m, Qm, qv, q0, ld, mind, DM, Dm, DQm, Dqv,
                                                Dq0, Dld, B, seg, quad, ldo, mindo, dquad,
                                                dldo);
    return (int)cudaGetLastError();
}

#define CELERITE_TANGENT_ENTRIES(T, SFX)                                                       \
    int celerite_tangent_elements_##SFX(const void* u, const void* v, const void* ph,          \
                                        const void* a, const void* du, const void* dv,         \
                                        const void* dph, const void* da, void* A, void* J,     \
                                        void* C, void* DA, void* DJ, void* DC, int L, int B,   \
                                        int nT, void* stream) {                                \
        tangent_elements_kernel<T>                                                             \
            <<<grid_for(B * nT, G), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(           \
            (const T*)u, (const T*)v, (const T*)ph, (const T*)a, (const T*)du, (const T*)dv,  \
            (const T*)dph, (const T*)da, L, B, nT, (T*)A, (T*)J, (T*)C, (T*)DA, (T*)DJ,       \
            (T*)DC);                                                                          \
        return (int)cudaGetLastError();                                                       \
    }                                                                                         \
    int celerite_tangent_factor_##SFX(                                                        \
        const void* u, const void* v, const void* ph, const void* a, const void* y,          \
        const void* du, const void* dv, const void* dph, const void* da, const void* dy,     \
        const void* sh0, const void* dsh0, void* M, void* m, void* Qm, void* qv, void* q0,   \
        void* ld, void* mind, void* DM, void* Dm, void* DQm, void* Dqv, void* Dq0, void* Dld, \
        int L, int B, int nT, void* stream) {                                                 \
        tangent_factor_kernel<T>                                                              \
            <<<grid_for(B * nT, G), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(           \
            (const T*)u, (const T*)v, (const T*)ph, (const T*)a, (const T*)y, (const T*)du,   \
            (const T*)dv, (const T*)dph, (const T*)da, (const T*)dy, (const T*)sh0,           \
            (const T*)dsh0, L, B, nT, (T*)M, (T*)m, (T*)Qm, (T*)qv, (double*)q0,              \
            (double*)ld, (T*)mind, (T*)DM, (T*)Dm, (T*)DQm, (T*)Dqv, (double*)Dq0,            \
            (double*)Dld);                                                                    \
        return (int)cudaGetLastError();                                                       \
    }                                                                                         \
    int celerite_tangent_jac_##SFX(const void* u, const void* v, const void* ph,              \
                                   const void* a, const void* y, const void* du,              \
                                   const void* dv, const void* dph, const void* da,           \
                                   const void* dy, void** w, void* quad, void* ld,            \
                                   void* mind, void* dquad, void* dld, int L, int B, int seg, \
                                   int nT, void* stream) {                                    \
        return jac_launch<T>((const T*)u, (const T*)v, (const T*)ph, (const T*)a,             \
                             (const T*)y, (const T*)du, (const T*)dv, (const T*)dph,          \
                             (const T*)da, (const T*)dy, w, (double*)quad, (double*)ld,       \
                             (T*)mind, (double*)dquad, (double*)dld, L, B, seg, nT,           \
                             static_cast<cudaStream_t>(stream));                              \
    }

extern "C" {

CELERITE_TANGENT_ENTRIES(float, f32)
CELERITE_TANGENT_ENTRIES(double, f64)

}  // extern "C"
