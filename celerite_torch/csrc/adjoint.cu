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
// beside the recomputed S and the loaded saves, 768 and more doubles, which
// one thread a lane cannot hold.  As in dsfused.cu, a group of G threads (the
// power of two at or above P; 16 for P = 13..16) owns one lane, thread r
// row r of every P x P state, so a thread holds a few P-vectors; rows r >=
// P are padding that holds zeros.  Row sums are thread-local; sums over
// rows are xor-shuffle reductions within the group (group_sum), column
// sums and transposes go through a per-group tile in shared memory.
// The forward kernels stream (adjoint_common.cuh's forward sweeps): each
// group copies its lane's streams three steps ahead into a ring in shared
// memory (cp.async), sums uA = A^T (Phi u) or g = (Phi M)^T u by columns
// through its tile and hands w and that sum to every row through shared
// memory, one reciprocal of d a step, in blocks of four warps where that
// still gives every SM a block, else of one (sampler_E's 512 lanes at P =
// 16: 256 blocks of 2 lanes).  Both share their Riccati front
// (riccati_fwd_front), and factor_fwd's step is fused4_grad.cu's
// (factor_fwd_step).  elements_fwd's sweep (elements_fwd_sweep) is also
// pallas_solver.cu's and fused.cu's elements, and factor_fwd's
// (factor_fwd_sweep) fused.cu's factor, which pass no save stream.
//
// The backward kernels are a chain of dependent steps a lane, so a step's
// latency is their time.  Each step is split in two (adjoint_common.cuh):
// the front, what the step computes of its saves and streams alone (S, su,
// d, one reciprocal 1 / d, w, the column sums g or uAc, the constant
// cotangents' terms), and the back, the transpose that carries the
// cotangents.  A block holds 4 lanes at P = 16 and two roles of two
// warps, a group a lane in each: the front warps copy each lane's saves
// and streams two steps ahead into a ring in shared memory (cp.async,
// reverse step order) and write each step's front to a record; the back
// warps transpose the step before, reading the ring and the record where
// they use them and holding only the carried cotangents (two P-vectors)
// in registers; one block barrier a step.  So no step waits on device
// memory, the front runs beside the back instead of before it, the back
// divides nowhere, and nothing spills.  The constant cotangent (hJ, or
// hQm) waits in a tile the front reads by row and by column.  Four lanes
// a block write 32 bytes of each row of the stream cotangents a step in
// float64; at sampler_E's 512 lanes that is 128 blocks of 128 threads
// (blocks of 2 lanes would reach all 132 SMs, but an SM's step time is set
// by its 4 lanes either way: they were 1-4% faster on 4 chains and took
// 1.13-1.26x as long on 16).
// The ring makes ~103 KB of dynamic shared memory a block in float64 at P
// = 16, two blocks an SM.  factor_bwd's sweep is also onepass.cu's
// transpose, and its step, run front then back in the same threads, is
// fused4_grad.cu's.
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
// dependent steps and, with several blocks an SM, by their shared-memory
// and float64 instructions.
//
// Rounding: -fmad=false (_build.SOURCE_FLAGS), so that float32 rounds as
// the plain versions, which keep every multiply and add separate; sums
// over rows run in another order than theirs.
//
// Compiled once per padded width: nvcc -DCELERITE_P=<P> (1 <= P <= 16).

#include "adjoint_common.cuh"
// ---------------------------------------------------------------------------
// elements_fwd: each lane's Riccati element (A, J, C) from a zero seed, with
// saves, streamed (adjoint_common.cuh's elements_fwd_sweep): a group a
// lane, thread r row r of Sh, A and J.  Each step's input [Sh, A] goes to
// the save stream (NSV0 words a lane and step, the layout elements_bwd
// reads).
// ---------------------------------------------------------------------------

template <typename T, int W>
__global__ void __launch_bounds__(32 * W)
adjoint_elements_fwd_kernel(const T* __restrict__ u, const T* __restrict__ v,
                            const T* __restrict__ ph, const T* __restrict__ a, int L, int B,
                            T* __restrict__ A_out, T* __restrict__ J_out, T* __restrict__ C_out,
                            T* __restrict__ sv) {
    elements_fwd_sweep<T, W>(u, v, ph, a, L, B, A_out, J_out, C_out, sv);
}

// ---------------------------------------------------------------------------
// elements_bwd: the transpose of elements_fwd, streamed in reverse.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS, BwdBlocks<T>::value)
adjoint_elements_bwd_kernel(const T* __restrict__ u, const T* __restrict__ v,
                            const T* __restrict__ ph, const T* __restrict__ a,
                            const T* __restrict__ sv, const T* __restrict__ hA0,
                            const T* __restrict__ hJ0, const T* __restrict__ hC0, int L, int B,
                            T* __restrict__ hu_out, T* __restrict__ hv_out,
                            T* __restrict__ hph_out, T* __restrict__ ha_out) {
    const BwdCtx<T, NSV0> c(B, sv);
    const int r = c.r, l = c.l;
    // The front warp's constant: hJ in the lane's tile.
    if (c.front) load_tile(c.cst, hJ0, r, B, c.ls);
    // The back warp's carried cotangents.
    T hA[P], hSh[P];
    get_mat(hA0, r, B, c.ls, hA);
    get_mat(hC0, r, B, c.ls, hSh);
    __syncwarp();
    bwd_ticks(
        c, L,
        [&](T* w, int s) {
            copy_step<T, NSV0>(w, sv, u, v, ph, a, static_cast<const T*>(nullptr), s, B, c.ls,
                               r, c.wide);
        },
        [&](const T* w, Rec<T, BWD_LB> rec) {
            elem_front(c.ftile, c.cst, r, RingStep<T, NSV0>(w, r), rec);
        },
        [&](const T* w, Rec<T, BWD_LB> rec, int s) {
            T hu, hv, hph, ha;
            elem_back(c.btile, c.vec, r, RingStep<T, NSV0>(w, r), rec, hA, hSh, hu, hv, hph,
                      ha);
            if (c.live && r < P) {
                const size_t o = ((size_t)s * P + r) * B + l;
                hu_out[o] = hu;
                hv_out[o] = hv;
                hph_out[o] = hph;
                if (r == 0) ha_out[(size_t)s * B + l] = ha;
            }
        });
}

// ---------------------------------------------------------------------------
// factor_fwd: the seeded factor, affine map and statistics with saves,
// streamed (adjoint_common.cuh's factor_fwd_sweep): a group a lane, thread
// r row r of Sh, M and Qm and entry r of m and qv.  Each step's input [Sh,
// M, m] goes to the save stream (NSV1 words a lane and step, the layout
// factor_bwd reads).
// ---------------------------------------------------------------------------

template <typename T, int W>
__global__ void __launch_bounds__(32 * W)
adjoint_factor_fwd_kernel(const T* __restrict__ u, const T* __restrict__ v,
                          const T* __restrict__ ph, const T* __restrict__ a,
                          const T* __restrict__ y, const T* __restrict__ sh0, int L, int B,
                          T* __restrict__ M_out, T* __restrict__ m_out, T* __restrict__ Qm_out,
                          T* __restrict__ qv_out, double* __restrict__ q0_out,
                          double* __restrict__ ld_out, T* __restrict__ mind_out,
                          T* __restrict__ sv) {
    factor_fwd_sweep<true, T, W>(u, v, ph, a, y, sh0, L, B, M_out, m_out, Qm_out, qv_out,
                                 q0_out, ld_out, mind_out, sv);
}

// ---------------------------------------------------------------------------
// factor_bwd: the transpose of factor_fwd, streamed in reverse.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS, BwdBlocks<T>::value)
adjoint_factor_bwd_kernel(const T* __restrict__ u, const T* __restrict__ v,
                          const T* __restrict__ ph, const T* __restrict__ a,
                          const T* __restrict__ y, const T* __restrict__ sv,
                          const T* __restrict__ hM0, const T* __restrict__ hm0,
                          const T* __restrict__ hQm0, const T* __restrict__ hqv0,
                          const T* __restrict__ hq00, const T* __restrict__ hld0, int L, int B,
                          T* __restrict__ hu_out, T* __restrict__ hv_out, T* __restrict__ hph_out,
                          T* __restrict__ ha_out, T* __restrict__ hy_out,
                          T* __restrict__ hsh0_out) {
    factor_bwd_sweep(u, v, ph, a, y, sv, static_cast<const T*>(nullptr), hM0, hm0, hQm0, hqv0,
                     hq00, hld0, L, B, hu_out, hv_out, hph_out, ha_out, hy_out, hsh0_out);
}

// ---------------------------------------------------------------------------
// Host entry points: one launch each on the caller's stream, nothing
// allocated.  Each returns cudaGetLastError() after its launch (or the
// error of a backward kernel's shared memory settings, bwd_prepare).
// ---------------------------------------------------------------------------

#define CELERITE_ADJOINT_ENTRIES(T, SFX)                                                        \
    int celerite_adjoint_elements_fwd_##SFX(const void* u, const void* v, const void* ph,      \
                                            const void* a, void* A, void* J, void* C,          \
                                            void* sv, int L, int B, void* stream) {            \
        return launch_fwd(adjoint_elements_fwd_kernel<T, 4>, adjoint_elements_fwd_kernel<T, 1>, \
                          B, stream, static_cast<const T*>(u), static_cast<const T*>(v),       \
                          static_cast<const T*>(ph), static_cast<const T*>(a), L, B,          \
                          static_cast<T*>(A), static_cast<T*>(J), static_cast<T*>(C),         \
                          static_cast<T*>(sv));                                               \
    }                                                                                          \
    int celerite_adjoint_elements_bwd_##SFX(                                                   \
        const void* u, const void* v, const void* ph, const void* a, const void* sv,          \
        const void* hA, const void* hJ, const void* hC, void* hu, void* hv, void* hph,        \
        void* ha, int L, int B, void* stream) {                                                \
        return launch_bwd(                                                                     \
            adjoint_elements_bwd_kernel<T>, bwd_smem_bytes<T, NSV0>(), B, stream,             \
            static_cast<const T*>(u), static_cast<const T*>(v), static_cast<const T*>(ph),     \
            static_cast<const T*>(a), static_cast<const T*>(sv), static_cast<const T*>(hA),    \
            static_cast<const T*>(hJ), static_cast<const T*>(hC), L, B, static_cast<T*>(hu),   \
            static_cast<T*>(hv), static_cast<T*>(hph), static_cast<T*>(ha));                   \
    }                                                                                          \
    int celerite_adjoint_factor_fwd_##SFX(                                                     \
        const void* u, const void* v, const void* ph, const void* a, const void* y,           \
        const void* sh0, void* M, void* m, void* Qm, void* qv, void* q0, void* ld, void* mind, \
        void* sv, int L, int B, void* stream) {                                                \
        return launch_fwd(                                                                     \
            adjoint_factor_fwd_kernel<T, 4>, adjoint_factor_fwd_kernel<T, 1>, B, stream,       \
            static_cast<const T*>(u), static_cast<const T*>(v), static_cast<const T*>(ph),     \
            static_cast<const T*>(a), static_cast<const T*>(y), static_cast<const T*>(sh0), L, \
            B, static_cast<T*>(M), static_cast<T*>(m), static_cast<T*>(Qm),                    \
            static_cast<T*>(qv), static_cast<double*>(q0), static_cast<double*>(ld),           \
            static_cast<T*>(mind), static_cast<T*>(sv));                                       \
    }                                                                                          \
    int celerite_adjoint_factor_bwd_##SFX(                                                     \
        const void* u, const void* v, const void* ph, const void* a, const void* y,           \
        const void* sv, const void* hM, const void* hm, const void* hQm, const void* hqv,     \
        const void* hq0, const void* hld, void* hu, void* hv, void* hph, void* ha, void* hy,  \
        void* hsh0, int L, int B, void* stream) {                                              \
        return launch_bwd(                                                                     \
            adjoint_factor_bwd_kernel<T>, bwd_smem_bytes<T, NSV1>(), B, stream,               \
            static_cast<const T*>(u), static_cast<const T*>(v), static_cast<const T*>(ph),     \
            static_cast<const T*>(a), static_cast<const T*>(y), static_cast<const T*>(sv),     \
            static_cast<const T*>(hM), static_cast<const T*>(hm), static_cast<const T*>(hQm),  \
            static_cast<const T*>(hqv), static_cast<const T*>(hq0),                            \
            static_cast<const T*>(hld), L, B, static_cast<T*>(hu), static_cast<T*>(hv),        \
            static_cast<T*>(hph), static_cast<T*>(ha), static_cast<T*>(hy),                    \
            static_cast<T*>(hsh0));                                                            \
    }                                                                                          \
    /* The backward kernels' launch shape: out[0] threads and out[1] lanes a                   \
       block, out[2] bytes of dynamic shared memory, out[3] blocks an SM at                    \
       most (the occupancy API); which 0 is elements_bwd, 1 factor_bwd. */                     \
    int celerite_adjoint_bwd_layout_##SFX(int which, int* out) {                              \
        const void* k = which ? (const void*)adjoint_factor_bwd_kernel<T>                      \
                              : (const void*)adjoint_elements_bwd_kernel<T>;                   \
        const size_t bytes = which ? bwd_smem_bytes<T, NSV1>() : bwd_smem_bytes<T, NSV0>();   \
        cudaError_t e = bwd_prepare(k, bytes);                                                 \
        int blocks = 0;                                                                        \
        if (e == cudaSuccess)                                                                  \
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, BWD_THREADS, bytes); \
        out[0] = BWD_THREADS;                                                                  \
        out[1] = BWD_LB;                                                                       \
        out[2] = (int)bytes;                                                                   \
        out[3] = blocks;                                                                       \
        return (int)e;                                                                         \
    }

extern "C" {

CELERITE_ADJOINT_ENTRIES(float, f32)
CELERITE_ADJOINT_ENTRIES(double, f64)

}  // extern "C"
