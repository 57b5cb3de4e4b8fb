// The three-pass primal for Hopper (sm_90a): the block-parallel solver's
// passes on pre-lowered streams, padded widths 1..16, any lane count B.
//
// Replaces the Pallas kernels of celerite_tpu/ops/pallas_solver.py:
//   solver_elements_kernel <- _elements_kernel (pallas_solver.py:62)
//   solver_factor_kernel   <- _factor_kernel   (pallas_solver.py:114)
//   solver_subst_kernel    <- _subst_kernel    (pallas_solver.py:154)
// elements gives each lane's Riccati element (A, J, C) from a zero seed;
// factor reruns each lane from its seed sh0 and streams out every step's
// pivot d and gain w with the lane's affine map (M, m); subst runs the
// forward substitution from each lane's incoming state h0, with the
// Kahan-compensated quad and log-det and the minimum pivot.  The
// cross-lane prefixes between them (seeds from the elements, h0 from the
// maps) are float64 torch glue (celerite_torch/ops/fused4.py).  On the TPU
// the grid walked the steps in order with the state in VMEM scratch and
// all B lanes in one vector; here each lane's chain of steps is a loop
// inside the kernel and the lanes spread over threads.
//
// Design.  elements and factor carry P x P state (Sh with A and J, or with
// M): a group of G threads a lane, a row of every state each, as in
// adjoint.cu.  elements is lanes_common.cuh's elements sweep without
// saves.  factor is adjoint.cu's streamed forward sweep (adjoint_common.cuh)
// without its saves and statistics: each group copies its lane's streams
// FWD_AHEAD steps ahead into a cp.async ring in shared memory, so that no
// step waits on device memory; g = (Phi M)^T u is a column sum through the
// group's tile, w and g reach every row through its vector, one reciprocal
// (float32: division) of d a step (factor_fwd_step<false>); step s's d and
// w go out at step s + 1's hook; blocks of four warps where that still
// gives every SM a block, else of one (launch_fwd).  subst carries a
// P-vector and two Kahan pairs, on lanes_common.cuh's groups, a row of h a
// thread: on one thread a lane with all of h (each row's loads coalesced
// across lanes, G times fewer threads) it took 1.4-3.1 times as long on
// every plan chip_smoke.py timed (PERF.md).  Threads of a group past the
// last lane run a live lane for the shuffles and write nothing.
//
// Bound.  Bytes, per point: elements reads u, v, ph, a (3P + 1 words),
// factor those and y and writes d and w (3P + 2 read, P + 1 written),
// subst reads u, ph, w, y, d (3P + 2); per lane the P x P states and
// vectors in and out.  At P = 16, N = 1e5 in float64 that is ~0.012,
// ~0.021 and ~0.012 ms at 3.35 TB/s; the operations (~11 P^2 a point for
// elements and factor, ~5 P for subst) take less at 34 TFLOP/s.  The
// kernels are bound instead by the latency of each lane's chain of L
// dependent steps (782 on F's value plan of 128 lanes, which fill a
// fraction of the card).
//
// Rounding: -fmad=false (_build.SOURCE_FLAGS): the compensated sums of
// subst break under fma contraction, and float32 then rounds as the plain
// versions (ops/blocked.py), which keep every multiply and add separate;
// sums over rows run in another order than theirs, factor's in four
// partial sums (float64: fused multiply-adds); factor's m rounds as
// theirs, and in float32 its w too (factor_fwd_step<false>), since m
// carries a 1-ulp change of w far in float32.
//
// Compiled once per padded width: nvcc -DCELERITE_P=<P> (1 <= P <= 16).

#include "adjoint_common.cuh"

// ---------------------------------------------------------------------------
// elements: each lane's Riccati element (A, J, C), no saves.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(BLOCK)
solver_elements_kernel(const T* __restrict__ u, const T* __restrict__ v,
                       const T* __restrict__ ph, const T* __restrict__ a, int L, int B,
                       T* __restrict__ A_out, T* __restrict__ J_out, T* __restrict__ C_out) {
    elements_sweep(u, v, ph, a, L, B, A_out, J_out, C_out);
}

// ---------------------------------------------------------------------------
// factor: the seeded factor, its (d, w) streams and the lane's affine map,
// streamed (adjoint_common.cuh's forward sweeps): thread r row r of Sh and
// M and entry r of m.
// ---------------------------------------------------------------------------

template <typename T, int W>
__global__ void __launch_bounds__(32 * W)
solver_factor_kernel(const T* __restrict__ u, const T* __restrict__ v,
                     const T* __restrict__ ph, const T* __restrict__ a,
                     const T* __restrict__ y, const T* __restrict__ sh0, int L, int B,
                     T* __restrict__ d_out, T* __restrict__ w_out, T* __restrict__ M_out,
                     T* __restrict__ m_out) {
    using Ctx = FwdCtx<T, W, NRS>;
    __shared__ T ring[Ctx::RING], tiles[Ctx::TILES], vecs[Ctx::VECS];
    const Ctx c(B, ring, tiles, vecs);
    const int r = c.r, l = c.l;
    T Sh[P], M[P];
    get_mat(sh0, r, B, l, Sh);
#pragma unroll
    for (int j = 0; j < P; ++j) M[j] = j == r ? T(1) : T(0);
    T mr = T(0), d = T(0);
    // Step s's pivot and gain, w_r where the step left it in the vector.
    const auto put_dw = [&](int s) {
        if (!c.live) return;
        if (r < P) w_out[((size_t)s * P + r) * B + l] = c.wv[r];
        if (r == 0) d_out[(size_t)s * B + l] = d;
    };
    fwd_ticks(
        c, L, [&](T* st, int s) { copy_streams(st, u, v, ph, a, y, s, B, l, r); },
        [&](int s) {
            if (s > 0) put_dw(s - 1);
        },
        [&](const T* st) {
            d = factor_fwd_step(c.tile, c.wv, c.gv, r, RingStep<T, 0>(st, r), Sh, M, mr);
        });
    if (L > 0) put_dw(L - 1);
    if (!c.live || r >= P) return;
    put_mat(M_out, r, B, l, M);
    m_out[(size_t)r * B + l] = mr;
}

// ---------------------------------------------------------------------------
// subst: forward substitution with Kahan-compensated sums, a row of h a
// thread.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(BLOCK)
solver_subst_kernel(const T* __restrict__ u, const T* __restrict__ ph,
                    const T* __restrict__ w, const T* __restrict__ y,
                    const T* __restrict__ d, const T* __restrict__ h0, int L, int B,
                    double* __restrict__ quad_out, double* __restrict__ logdet_out,
                    T* __restrict__ mind_out) {
    const Lane ln = lane_of(B);
    const int l = ln.l, r = ln.r;
    T h = r < P ? h0[(size_t)r * B + l] : T(0);
    // The scalar sums are kept alike in every thread of the group.
    T quad = T(0), cq = T(0), ld = T(0), cl = T(0), mind = T(INFINITY);
    for (int s = 0; s < L; ++s) {
        const size_t o = ((size_t)s * P + r) * B + l, o1 = (size_t)s * B + l;
        T f = T(0), uf = T(0);
        if (r < P) {
            f = ph[o] * h;
            uf = u[o] * f;
        }
        const T z = y[o1] - group_sum(uf);
        if (r < P) h = f + w[o] * z;
        const T dd = d[o1];
        const T x1 = z * z / dd - cq;
        const T t1 = quad + x1;
        cq = (t1 - quad) - x1;
        quad = t1;
        const T x2 = dlog(dd) - cl;
        const T t2 = ld + x2;
        cl = (t2 - ld) - x2;
        ld = t2;
        // NaN-propagating min, like torch.minimum.
        mind = (dd < mind || dd != dd) ? dd : mind;
    }
    if (!ln.live || r != 0) return;
    quad_out[l] = (double)quad + (double)cq;
    logdet_out[l] = (double)ld + (double)cl;
    mind_out[l] = mind;
}

// ---------------------------------------------------------------------------
// Host entry points: one launch each on the caller's stream, nothing
// allocated.  Each returns cudaGetLastError() after its launch (factor's
// block shape chosen by launch_fwd).
// ---------------------------------------------------------------------------

#define CELERITE_SOLVER_ENTRIES(T, SFX)                                                         \
    int celerite_solver_elements_##SFX(const void* u, const void* v, const void* ph,           \
                                       const void* a, void* A, void* J, void* C, int L, int B, \
                                       void* stream) {                                         \
        solver_elements_kernel<T>                                                               \
            <<<grid_for(B, G), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(                 \
            static_cast<const T*>(u), static_cast<const T*>(v), static_cast<const T*>(ph),     \
            static_cast<const T*>(a), L, B, static_cast<T*>(A), static_cast<T*>(J),            \
            static_cast<T*>(C));                                                               \
        return (int)cudaGetLastError();                                                        \
    }                                                                                          \
    int celerite_solver_factor_##SFX(const void* u, const void* v, const void* ph,             \
                                     const void* a, const void* y, const void* sh0, void* d,   \
                                     void* w, void* M, void* m, int L, int B, void* stream) {  \
        return launch_fwd(                                                                     \
            solver_factor_kernel<T, 4>, solver_factor_kernel<T, 1>, B, stream,                 \
            static_cast<const T*>(u), static_cast<const T*>(v), static_cast<const T*>(ph),     \
            static_cast<const T*>(a), static_cast<const T*>(y), static_cast<const T*>(sh0), L, \
            B, static_cast<T*>(d), static_cast<T*>(w), static_cast<T*>(M),                     \
            static_cast<T*>(m));                                                               \
    }                                                                                          \
    int celerite_solver_subst_##SFX(const void* u, const void* ph, const void* w,              \
                                    const void* y, const void* d, const void* h0, void* quad,  \
                                    void* logdet, void* mind, int L, int B, void* stream) {    \
        solver_subst_kernel<T>                                                                  \
            <<<grid_for(B, G), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(                 \
            static_cast<const T*>(u), static_cast<const T*>(ph), static_cast<const T*>(w),     \
            static_cast<const T*>(y), static_cast<const T*>(d), static_cast<const T*>(h0), L,  \
            B, static_cast<double*>(quad), static_cast<double*>(logdet),                       \
            static_cast<T*>(mind));                                                            \
        return (int)cudaGetLastError();                                                        \
    }

extern "C" {

CELERITE_SOLVER_ENTRIES(float, f32)
CELERITE_SOLVER_ENTRIES(double, f64)

}  // extern "C"
