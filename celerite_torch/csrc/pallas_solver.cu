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
// Design.  All three kernels are streamed forward sweeps
// (adjoint_common.cuh): a group of G threads a lane, thread r row r of the
// state, each group copying its lane's streams FWD_AHEAD steps ahead into a
// cp.async ring in shared memory, so that no step waits on device memory;
// blocks of four warps where that still gives every SM a block, else of
// one (launch_fwd).  Threads of a group past the last lane run the last
// lane for the shuffles and write nothing.  elements and factor carry P x
// P state (Sh with A and J, or with M).  elements is adjoint.cu's
// elements_fwd without its saves (elements_fwd_sweep, one copy of the
// loop): uA = A^T (Phi u) a column sum through the group's tile, w and uA
// reach every row through its vector, one reciprocal of d a step
// (elem_fwd_step).  factor is adjoint.cu's factor_fwd without its saves
// and statistics: g = (Phi M)^T u through the tile, one reciprocal
// (float32: division) of d a step (factor_fwd_step<false>); step s's d and
// w go out at step s + 1's hook.  subst carries only h, a row a thread,
// and the scalar sums: its ring slot holds u, phi and w (in v's words) and
// y and d (in a's), and the chain from one h to the next is one butterfly,
// z = y - u . (Phi h).  The sums' terms z^2 / d and log d are taken in
// batches of G steps, a step a thread, once a batch, and added in order a
// batch later, a shuffle a term: the f64 log (a branch for special inputs
// around ~30 dependent operations) after every butterfly took 0.32 ms on
// F's value plan against 0.21 batched and 0.18 with no sums (PERF.md).
//
// Bound.  Bytes, per point: elements reads u, v, ph, a (3P + 1 words),
// factor those and y and writes d and w (3P + 2 read, P + 1 written),
// subst reads u, ph, w, y, d (3P + 2); per lane the P x P states and
// vectors in and out.  At P = 16, N = 1e5 in float64 that is ~0.012,
// ~0.021 and ~0.012 ms at 3.35 TB/s; the operations (~11 P^2 a point for
// elements and factor, ~5 P for subst) take less at 34 TFLOP/s.  The
// kernels are bound instead by the latency of each lane's chain of L
// dependent steps (782 on F's value plan of 128 lanes, which fill a
// fraction of the card): a step of elements or factor is a butterfly for
// d, a column sum and two warp syncs, a step of subst one butterfly.  A
// ring six steps ahead instead of three left subst's time as it was.
//
// Rounding: -fmad=false (_build.SOURCE_FLAGS): the compensated sums of
// subst break under fma contraction, and float32 then rounds as the plain
// versions (ops/blocked.py), which keep every multiply and add separate;
// sums over rows run in another order than theirs, elements' and factor's
// in four partial sums (float64: fused multiply-adds); elements multiplies
// by 1 / d for w and uA / d where the plain version divides; factor's m
// rounds as theirs, and in float32 its w too (factor_fwd_step<false>),
// since m carries a 1-ulp change of w far in float32.  subst takes the
// plain version's arithmetic in its order: z z / d divided, the Kahan
// updates, the NaN-propagating minimum.
//
// Compiled once per padded width: nvcc -DCELERITE_P=<P> (1 <= P <= 16).

#include "adjoint_common.cuh"

// ---------------------------------------------------------------------------
// elements: each lane's Riccati element (A, J, C), adjoint.cu's
// elements_fwd without saves (adjoint_common.cuh's elements_fwd_sweep).
// ---------------------------------------------------------------------------

template <typename T, int W>
__global__ void __launch_bounds__(32 * W)
solver_elements_kernel(const T* __restrict__ u, const T* __restrict__ v,
                       const T* __restrict__ ph, const T* __restrict__ a, int L, int B,
                       T* __restrict__ A_out, T* __restrict__ J_out, T* __restrict__ C_out) {
    elements_fwd_sweep<T, W>(u, v, ph, a, L, B, A_out, J_out, C_out, static_cast<T*>(nullptr));
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
// subst: forward substitution with Kahan-compensated sums, streamed: thread
// r row r of h; the scalar sums are kept alike in every thread of the
// group.
// ---------------------------------------------------------------------------

template <typename T, int W>
__global__ void __launch_bounds__(32 * W)
solver_subst_kernel(const T* __restrict__ u, const T* __restrict__ ph,
                    const T* __restrict__ w, const T* __restrict__ y,
                    const T* __restrict__ d, const T* __restrict__ h0, int L, int B,
                    double* __restrict__ quad_out, double* __restrict__ logdet_out,
                    T* __restrict__ mind_out) {
    using Ctx = FwdCtx<T, W, NRS>;
    __shared__ T ring[Ctx::RING];
    const Ctx c(B, ring);
    const int r = c.r, l = c.l;
    T h = r < P ? h0[(size_t)r * B + l] : T(0);
    // The sums' terms go in batches of G steps, a step a thread: thread k
    // keeps the z and d of the batch's step k; after the batch's last step
    // each thread takes its step's terms, z z / d and log d, and the next
    // batch's steps add them in order, step k's term at its own step k,
    // read from thread k.  So the division and the log run once a batch,
    // and a step adds two terms that wait on nothing.  The first batch adds
    // zeros, which leave the sums at zero.
    Kahan<T> quad{T(0), T(0)}, ld{T(0), T(0)};
    T mind = T(INFINITY), zk = T(0), dk = T(1), tq = T(0), tl = T(0);
    const auto add = [&](int k) {
        quad.add(__shfl_sync(0xffffffffu, tq, k, G));
        ld.add(__shfl_sync(0xffffffffu, tl, k, G));
    };
    const auto take_terms = [&] {
        tq = zk * zk / dk;
        tl = dlog(dk);
    };
    int step = 0;
    fwd_ticks(
        c, L,
        // w goes into v's words of the slot and d into a's, so RingStep
        // reads w_r back as vr and d as a.
        [&](T* st, int s) { copy_streams(st, u, w, ph, d, y, s, B, l, r); },
        [](int) {},
        [&](const T* st) {
            const RingStep<T, 0> in(st, r);
            const T f = in.phr * h;
            const T z = in.y - group_sum(in.ur * f);
            if (r < P) h = f + in.vr * z;
            const int k = step++ % G;
            add(k);
            // NaN-propagating min, like torch.minimum.
            mind = (in.a < mind || in.a != in.a) ? in.a : mind;
            if (r == k) {
                zk = z;
                dk = in.a;
            }
            if (k == G - 1) take_terms();
        });
    // The last batch's terms: those of a whole batch were taken at its last
    // step; a partial batch of n steps first adds the batch before's
    // remaining terms (zeros if there was none), then takes its own.
    const int n = L % G;
    if (n > 0) {
        for (int k = n; k < G; ++k) add(k);
        take_terms();
    }
    for (int k = 0; k < (n > 0 ? n : G); ++k) add(k);
    if (!c.live || r != 0) return;
    quad_out[l] = quad.total();
    logdet_out[l] = ld.total();
    mind_out[l] = mind;
}

// ---------------------------------------------------------------------------
// Host entry points: one launch each on the caller's stream, nothing
// allocated, the block shape chosen by launch_fwd.  Each returns
// cudaGetLastError() after its launch.
// ---------------------------------------------------------------------------

#define CELERITE_SOLVER_ENTRIES(T, SFX)                                                         \
    int celerite_solver_elements_##SFX(const void* u, const void* v, const void* ph,           \
                                       const void* a, void* A, void* J, void* C, int L, int B, \
                                       void* stream) {                                         \
        return launch_fwd(                                                                     \
            solver_elements_kernel<T, 4>, solver_elements_kernel<T, 1>, B, stream,             \
            static_cast<const T*>(u), static_cast<const T*>(v), static_cast<const T*>(ph),     \
            static_cast<const T*>(a), L, B, static_cast<T*>(A), static_cast<T*>(J),            \
            static_cast<T*>(C));                                                               \
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
        return launch_fwd(                                                                     \
            solver_subst_kernel<T, 4>, solver_subst_kernel<T, 1>, B, stream,                   \
            static_cast<const T*>(u), static_cast<const T*>(ph), static_cast<const T*>(w),     \
            static_cast<const T*>(y), static_cast<const T*>(d), static_cast<const T*>(h0), L,  \
            B, static_cast<double*>(quad), static_cast<double*>(logdet),                       \
            static_cast<T*>(mind));                                                            \
    }

extern "C" {

CELERITE_SOLVER_ENTRIES(float, f32)
CELERITE_SOLVER_ENTRIES(double, f64)

}  // extern "C"
