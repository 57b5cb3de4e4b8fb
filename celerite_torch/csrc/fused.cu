// The single-sweep value for Hopper (sm_90a): the log-likelihood on
// pre-lowered streams in four launches with nothing between them.
//
// Replaces the Pallas kernel celerite_tpu/ops/fused.py:130 (_kernel), the
// JAX package's value at padded width 8 or less: one pallas_call over a
// grid of (2 phases, L steps) whose phase 0 accumulates each lane's
// Riccati element (A, J, C), whose phase boundary composes the elements
// into every lane's seed S-hat by a Hillis-Steele scan over the lanes in
// VMEM, whose phase 1 reruns each lane from its seed for the affine map
// (M, m) and the statistics (Qm, qv, Kahan-summed q0 and log-det, min
// pivot), and whose last step scans the maps into each lane's incoming
// state h and assembles quad = sum q0 - 2 qv.h + h^T Qm h.  Here:
//   fused_elements_kernel  phase 0: lanes_common.cuh's elements sweep,
//                          without saves (as pallas_solver.cu's);
//   fused_seed_kernel      the seed scan (prefix_common.cuh);
//   fused_factor_kernel    phase 1: lanes_common.cuh's factor sweep without
//                          saves (adjoint.cu's factor_fwd arithmetic);
//   fused_assemble_kernel  the affine scan, the assembly and the sums
//                          (prefix_common.cuh);
// one after another on the caller's stream from one host call, with no
// torch work between them.  On the TPU the grid ran in order on one core
// with the state in VMEM scratch; Hopper's blocks run in no order, so the
// phase boundaries are launch boundaries, and the per-lane states cross
// them through device memory (3 P^2 words a lane, then 2 P^2 + 2 P + 3).
//
// Design.  The sweeps give a lane a group of G threads, a row of every
// P x P state each (lanes_common.cuh); the scans give a segment of lanes
// (a chain of a folded plan, else all B lanes) one block that walks its
// lanes in order, in float64 whatever the streams' dtype, as the port's
// torch glue does (a float32 prefix loses runs of lanes to non-positive
// pivots, PERF.md).  A cooperative single launch (grid-wide barriers at
// the phase boundaries) would save three launches of ~5 us each but needs
// every block co-resident; the sweeps' grids are sized by the lane count,
// not by the card.
//
// Bound.  Bytes: each stream once a sweep (u, v, ph, a: 3P + 1 words a
// point, read by both phases; y once), the per-lane states once each way:
// at config[2] (P = 8), N = 1e5 in float64, ~20 MB, ~0.006 ms at 3.35
// TB/s.  Operations: ~30 P^2 a point over the two phases (~2 x 10^8 at
// that size, ~0.006 ms at 34 TFLOP/s; chip_smoke.tangent_bound_ms counts
// them from the code), and the scans' ~8 P^3 a lane.  So the function is
// bound by bytes and operations alike; the kernels are bound instead by the
// latency of each lane's chain of L dependent steps (a few dozen shuffle
// reductions each), and the scans by their segment's chain of lanes.
//
// Rounding: -fmad=false (_build.SOURCE_FLAGS), so that float32 rounds as
// the plain versions (ops/fused.kernel_reference), which keep every
// multiply and add separate; sums over rows, and the scans' compositions,
// run in another order than theirs.
//
// Compiled once per padded width: nvcc -DCELERITE_P=<P> (1 <= P <= 16;
// the port takes it at P <= 8, pallas_solver.cu above).

#include "lanes_common.cuh"
#include "prefix_common.cuh"

template <typename T>
__global__ void __launch_bounds__(BLOCK)
fused_elements_kernel(const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ ph,
                      const T* __restrict__ a, int L, int B, T* __restrict__ A_out,
                      T* __restrict__ J_out, T* __restrict__ C_out) {
    elements_sweep(u, v, ph, a, L, B, A_out, J_out, C_out);
}

template <typename T>
__global__ void __launch_bounds__(SCAN_THREADS)
fused_seed_kernel(const T* __restrict__ A, const T* __restrict__ J, const T* __restrict__ C,
                  int B, int seg, T* __restrict__ sh0) {
    seed_scan<false, T>(A, J, C, nullptr, nullptr, nullptr, B, seg, sh0, nullptr);
}

template <typename T>
__global__ void __launch_bounds__(BLOCK)
fused_factor_kernel(const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ ph,
                    const T* __restrict__ a, const T* __restrict__ y,
                    const T* __restrict__ sh0, int L, int B, T* __restrict__ M_out,
                    T* __restrict__ m_out, T* __restrict__ Qm_out, T* __restrict__ qv_out,
                    double* __restrict__ q0_out, double* __restrict__ ld_out,
                    T* __restrict__ mind_out) {
    factor_sweep<false>(u, v, ph, a, y, sh0, L, B, M_out, m_out, Qm_out, qv_out, q0_out, ld_out,
                        mind_out, static_cast<T*>(nullptr));
}

template <typename T>
__global__ void __launch_bounds__(P)
fused_assemble_kernel(const T* __restrict__ M, const T* __restrict__ m, const T* __restrict__ Qm,
                      const T* __restrict__ qv, const double* __restrict__ q0,
                      const double* __restrict__ ld, const T* __restrict__ mind, int B, int seg,
                      double* __restrict__ quad_out, double* __restrict__ ld_out,
                      T* __restrict__ mind_out) {
    assemble_scan<false, T>(M, m, Qm, qv, q0, ld, mind, nullptr, nullptr, nullptr, nullptr,
                            nullptr, nullptr, B, seg, quad_out, ld_out, mind_out, nullptr,
                            nullptr);
}

// ---------------------------------------------------------------------------
// Host entry point: the four launches on the caller's stream, nothing
// allocated.  Scratch: A, J, C, sh0, M, Qm (P, P, B), m, qv (P, B), q0l, ldl
// (B,) float64, mindl (B,).  Out: quad, ld (B / seg,) float64, mind
// (B / seg,).  Returns the first nonzero cudaGetLastError() after a launch.
// ---------------------------------------------------------------------------

#define CELERITE_FUSED_ENTRY(T, SFX)                                                            \
    int celerite_fused_ll_##SFX(const void* u, const void* v, const void* ph, const void* a,  \
                                const void* y, void* A, void* J, void* C, void* sh0, void* M,  \
                                void* m, void* Qm, void* qv, void* q0l, void* ldl,             \
                                void* mindl, void* quad, void* ld, void* mind, int L, int B,   \
                                int seg, void* stream) {                                       \
        cudaStream_t st = static_cast<cudaStream_t>(stream);                                   \
        const dim3 scans((unsigned)(B / seg));                                                 \
        int err;                                                                               \
        fused_elements_kernel<T><<<grid_for(B, G), BLOCK, 0, st>>>(                            \
            static_cast<const T*>(u), static_cast<const T*>(v), static_cast<const T*>(ph),     \
            static_cast<const T*>(a), L, B, static_cast<T*>(A), static_cast<T*>(J),            \
            static_cast<T*>(C));                                                               \
        if ((err = (int)cudaGetLastError())) return err;                                       \
        fused_seed_kernel<T><<<scans, SCAN_THREADS, 0, st>>>(                                  \
            static_cast<const T*>(A), static_cast<const T*>(J), static_cast<const T*>(C), B,   \
            seg, static_cast<T*>(sh0));                                                        \
        if ((err = (int)cudaGetLastError())) return err;                                       \
        fused_factor_kernel<T><<<grid_for(B, G), BLOCK, 0, st>>>(                              \
            static_cast<const T*>(u), static_cast<const T*>(v), static_cast<const T*>(ph),     \
            static_cast<const T*>(a), static_cast<const T*>(y), static_cast<const T*>(sh0), L, \
            B, static_cast<T*>(M), static_cast<T*>(m), static_cast<T*>(Qm),                    \
            static_cast<T*>(qv), static_cast<double*>(q0l), static_cast<double*>(ldl),         \
            static_cast<T*>(mindl));                                                           \
        if ((err = (int)cudaGetLastError())) return err;                                       \
        fused_assemble_kernel<T><<<scans, P, 0, st>>>(                                         \
            static_cast<const T*>(M), static_cast<const T*>(m), static_cast<const T*>(Qm),     \
            static_cast<const T*>(qv), static_cast<const double*>(q0l),                        \
            static_cast<const double*>(ldl), static_cast<const T*>(mindl), B, seg,             \
            static_cast<double*>(quad), static_cast<double*>(ld), static_cast<T*>(mind));      \
        return (int)cudaGetLastError();                                                        \
    }

extern "C" {

CELERITE_FUSED_ENTRY(float, f32)
CELERITE_FUSED_ENTRY(double, f64)

}  // extern "C"
