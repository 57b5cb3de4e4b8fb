// The one-pass solver for Hopper (sm_90a): one zero-seeded sweep of each
// lane's factor, affine solve map and statistics, its save-emitting twin,
// and the reversed transpose, on pre-lowered streams, padded widths 1..16.
//
// Replaces the Pallas kernels of celerite_tpu/ops/onepass.py:
//   onepass_sweep_kernel <- _onepass_kernel     (onepass.py:111)
//   onepass_fwd_kernel   <- _onepass_fwd_kernel (onepass.py:162)
//   onepass_bwd_kernel   <- _onepass_bwd_kernel (onepass.py:219)
// The sweep runs each lane's factor recursion from a zero seed and gives
// the end state C, the affine map (M0, m0) and the statistics (Qm, qv,
// Kahan-summed q0 and log-det, min pivot); the seeded quantities follow in
// closed form in the torch assembly (celerite_torch/ops/onepass.py).  The
// fwd kernel also writes each step's input state [Sh, M, m] to a save
// stream (NSV1 words a lane and step); the bwd kernel walks the steps in
// reverse and transposes each by hand, with the carried S-hat cotangent
// seeded from the C output's cotangent and no seed cotangent to emit.
//
// Design.  The arithmetic is the seeded factor sweep's and its transpose,
// not a copy.  The sweep and the fwd kernel are adjoint_common.cuh's
// streamed factor_fwd_sweep (adjoint.cu's factor_fwd, fused.cu's factor)
// with ZERO: a zero seed and the end state written, the fwd kernel with
// its saves.  A group of G threads (the power of two at or above P) owns a
// lane, thread r row r of every P x P state; each group copies its lane's
// streams FWD_AHEAD steps ahead into a cp.async ring in shared memory, so
// that a step never waits on device memory; a step's column sum goes
// through the group's tile, w and the column sum reach every row through
// the group's vector in shared memory, and d has one reciprocal.  Both run
// in blocks of four warps where that still gives every SM a block, else
// one (launch_fwd).  The transpose is adjoint.cu's factor_bwd sweep
// (factor_bwd_sweep) with hC as the carried cotangent's start: a front
// warp copies the saves and streams ahead into shared memory and computes
// each step's front, a back warp carries the cotangents (BWD_LB lanes a
// block).
//
// Bound.  Bytes: per point the streams (3P + 2 words read), and for the
// fwd / bwd pair the saves (2P^2 + P words, written then read) and the
// stream cotangents (3P + 2 words written); per lane the summaries (3P^2 +
// 2P + 3 words).  Operations: ~30 P^2 a point for the sweep, ~50 P^2 for
// the transpose.  So all three are bound by bytes at the card's rate, but
// in practice the sweep by the latency of each lane's chain of dependent
// steps, and the fwd kernel also by its save writes.
//
// Rounding: -fmad=false (_build.SOURCE_FLAGS), so that float32 rounds as
// the plain versions, which keep every multiply and add separate.  The
// float32 instantiation computes what the TPU computed, which the closed-form
// correction makes ill-conditioned (onepass.py:36-49).
//
// Compiled once per padded width: nvcc -DCELERITE_P=<P> (1 <= P <= 16).

#include "adjoint_common.cuh"

template <typename T, int W>
__global__ void __launch_bounds__(32 * W)
onepass_sweep_kernel(const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ ph,
                     const T* __restrict__ a, const T* __restrict__ y, int L, int B,
                     T* __restrict__ C_out, T* __restrict__ M_out, T* __restrict__ m_out,
                     T* __restrict__ Qm_out, T* __restrict__ qv_out, double* __restrict__ q0_out,
                     double* __restrict__ ld_out, T* __restrict__ mind_out) {
    factor_fwd_sweep<false, T, W, true>(u, v, ph, a, y, static_cast<const T*>(nullptr), L, B,
                                        M_out, m_out, Qm_out, qv_out, q0_out, ld_out, mind_out,
                                        static_cast<T*>(nullptr), C_out);
}

template <typename T, int W>
__global__ void __launch_bounds__(32 * W)
onepass_fwd_kernel(const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ ph,
                   const T* __restrict__ a, const T* __restrict__ y, int L, int B,
                   T* __restrict__ C_out, T* __restrict__ M_out, T* __restrict__ m_out,
                   T* __restrict__ Qm_out, T* __restrict__ qv_out, double* __restrict__ q0_out,
                   double* __restrict__ ld_out, T* __restrict__ mind_out, T* __restrict__ sv) {
    factor_fwd_sweep<true, T, W, true>(u, v, ph, a, y, static_cast<const T*>(nullptr), L, B,
                                       M_out, m_out, Qm_out, qv_out, q0_out, ld_out, mind_out,
                                       sv, C_out);
}

template <typename T>
__global__ void __launch_bounds__(BWD_THREADS, BwdBlocks<T>::value)
onepass_bwd_kernel(const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ ph,
                   const T* __restrict__ a, const T* __restrict__ y, const T* __restrict__ sv,
                   const T* __restrict__ hC0, const T* __restrict__ hM0,
                   const T* __restrict__ hm0, const T* __restrict__ hQm0,
                   const T* __restrict__ hqv0, const T* __restrict__ hq00,
                   const T* __restrict__ hld0, int L, int B, T* __restrict__ hu_out,
                   T* __restrict__ hv_out, T* __restrict__ hph_out, T* __restrict__ ha_out,
                   T* __restrict__ hy_out) {
    factor_bwd_sweep(u, v, ph, a, y, sv, hC0, hM0, hm0, hQm0, hqv0, hq00, hld0, L, B, hu_out,
                     hv_out, hph_out, ha_out, hy_out, static_cast<T*>(nullptr));
}

// ---------------------------------------------------------------------------
// Host entry points: one launch each on the caller's stream, nothing
// allocated.  Each returns cudaGetLastError() after its launch.
// ---------------------------------------------------------------------------

#define CELERITE_ONEPASS_ENTRIES(T, SFX)                                                        \
    int celerite_onepass_sweep_##SFX(const void* u, const void* v, const void* ph,             \
                                     const void* a, const void* y, void* C, void* M, void* m,  \
                                     void* Qm, void* qv, void* q0, void* ld, void* mind,       \
                                     int L, int B, void* stream) {                             \
        return launch_fwd(                                                                     \
            onepass_sweep_kernel<T, 4>, onepass_sweep_kernel<T, 1>, B, stream,                 \
            static_cast<const T*>(u), static_cast<const T*>(v), static_cast<const T*>(ph),     \
            static_cast<const T*>(a), static_cast<const T*>(y), L, B, static_cast<T*>(C),      \
            static_cast<T*>(M), static_cast<T*>(m), static_cast<T*>(Qm), static_cast<T*>(qv),  \
            static_cast<double*>(q0), static_cast<double*>(ld), static_cast<T*>(mind));        \
    }                                                                                          \
    int celerite_onepass_fwd_##SFX(const void* u, const void* v, const void* ph, const void* a, \
                                   const void* y, void* C, void* M, void* m, void* Qm,         \
                                   void* qv, void* q0, void* ld, void* mind, void* sv, int L,  \
                                   int B, void* stream) {                                      \
        return launch_fwd(                                                                     \
            onepass_fwd_kernel<T, 4>, onepass_fwd_kernel<T, 1>, B, stream,                     \
            static_cast<const T*>(u), static_cast<const T*>(v), static_cast<const T*>(ph),     \
            static_cast<const T*>(a), static_cast<const T*>(y), L, B, static_cast<T*>(C),      \
            static_cast<T*>(M), static_cast<T*>(m), static_cast<T*>(Qm), static_cast<T*>(qv),  \
            static_cast<double*>(q0), static_cast<double*>(ld), static_cast<T*>(mind),         \
            static_cast<T*>(sv));                                                              \
    }                                                                                          \
    int celerite_onepass_bwd_##SFX(                                                            \
        const void* u, const void* v, const void* ph, const void* a, const void* y,           \
        const void* sv, const void* hC, const void* hM, const void* hm, const void* hQm,      \
        const void* hqv, const void* hq0, const void* hld, void* hu, void* hv, void* hph,     \
        void* ha, void* hy, int L, int B, void* stream) {                                      \
        return launch_bwd(                                                                     \
            onepass_bwd_kernel<T>, bwd_smem_bytes<T, NSV1>(), B, stream,                      \
            static_cast<const T*>(u), static_cast<const T*>(v), static_cast<const T*>(ph),     \
            static_cast<const T*>(a), static_cast<const T*>(y), static_cast<const T*>(sv),     \
            static_cast<const T*>(hC), static_cast<const T*>(hM), static_cast<const T*>(hm),   \
            static_cast<const T*>(hQm), static_cast<const T*>(hqv), static_cast<const T*>(hq0), \
            static_cast<const T*>(hld), L, B, static_cast<T*>(hu), static_cast<T*>(hv),        \
            static_cast<T*>(hph), static_cast<T*>(ha), static_cast<T*>(hy));                   \
    }

extern "C" {

CELERITE_ONEPASS_ENTRIES(float, f32)
CELERITE_ONEPASS_ENTRIES(double, f64)

}  // extern "C"
