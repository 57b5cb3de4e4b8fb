// The single-sweep value for Hopper (sm_90a): the log-likelihood on
// pre-lowered streams in seven launches from one host call, with nothing
// between them.
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
//   fused_elements_kernel  phase 0: adjoint_common.cuh's elements_fwd_sweep
//                          without saves (pallas_solver.cu's elements);
//   fused_chunk_kernel     the seeds, pass 1: each chunk's total element;
//   fused_spine_kernel     pass 2: each chunk's seed;
//   fused_seed_kernel      pass 3: each lane's seed (prefix_common.cuh);
//   fused_factor_kernel    phase 1: adjoint_common.cuh's factor_fwd_sweep
//                          without saves (adjoint.cu's factor_fwd);
//   fused_quad_kernel      the sums, pass 1: each chunk's quadratic form;
//   fused_assemble_kernel  pass 2: each segment's sums;
// one after another on the caller's stream.  On the TPU the grid ran in
// order on one core with the state in VMEM scratch; Hopper's blocks run in
// no order, so the phase boundaries are launch boundaries, and the
// per-lane states cross them through device memory.
//
// Design.  The sweeps are the streamed forward sweeps (a group of G
// threads a lane, thread r row r of the state, each step's streams copied
// three steps ahead into a cp.async ring; blocks of four warps where that
// still gives every SM a block, else of one).  The scans run in float64
// whatever the streams' dtype, as the port's torch glue does (a float32
// prefix loses runs of lanes to non-positive pivots, PERF.md), over
// chunks of c = ceil(sqrt(seg / 3)) lanes (prefix_common.cuh): a group of G
// threads a chunk or a segment, a row each, its pivot rows by shuffles and
// its products through tiles in shared memory, with no block barrier.  A
// segment's chain of seg dependent lane steps, which one block walked lane
// by lane before (4.6 us a lane at P = 8, PERF.md), is cut to c full
// compositions, seg / c and c steps of C alone, and c + seg / c steps of
// the sums.
//
// Bound.  Bytes: each stream once a sweep (u, v, ph, a: 3P + 1 words a
// point, read by both phases; y once), the per-lane states once each way:
// at config[2] (P = 8), N = 1e5 in float64, ~20 MB, ~0.006 ms at 3.35
// TB/s.  Operations: ~30 P^2 a point over the two phases (~2 x 10^8 at
// that size, ~0.006 ms at 34 TFLOP/s; chip_smoke.tangent_bound_ms counts
// them from the code), and the scans' ~8 P^3 a lane.  So the function is
// bound by bytes and operations alike; the kernels are bound instead by the
// latency of each lane's chain of L dependent steps, and the scans by the
// depth of their walks.
//
// Rounding: -fmad=false (_build.SOURCE_FLAGS), so that float32 rounds as
// the plain versions (ops/fused.kernel_reference), which keep every
// multiply and add separate; sums over rows, and the scans' compositions,
// run in another order than theirs.
//
// Compiled once per padded width: nvcc -DCELERITE_P=<P> (1 <= P <= 16;
// the port takes it at P <= 8, pallas_solver.cu above).

#include <math.h>

#include "adjoint_common.cuh"
#include "prefix_common.cuh"

template <typename T, int W>
__global__ void __launch_bounds__(32 * W)
fused_elements_kernel(const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ ph,
                      const T* __restrict__ a, int L, int B, T* __restrict__ A_out,
                      T* __restrict__ J_out, T* __restrict__ C_out) {
    elements_fwd_sweep<T, W>(u, v, ph, a, L, B, A_out, J_out, C_out, static_cast<T*>(nullptr));
}

// The scans' kernels: blocks of one warp, 32 / G groups.  Their launch
// bounds ask for one block an SM, so that ptxas keeps every value in
// registers (without it, it spilled 4-28 bytes at P = 5-7, PERF.md).
template <typename T>
__global__ void __launch_bounds__(32, 1)
fused_chunk_kernel(const T* __restrict__ A, const T* __restrict__ J, const T* __restrict__ C,
                   int B, int seg, int c, int nck, int nch, double* __restrict__ tot) {
    chunk_totals(A, J, C, B, seg, c, nck, nch, tot);
}

__global__ void __launch_bounds__(32, 1)
fused_spine_kernel(const double* __restrict__ tot, int nseg, int nck,
                   double* __restrict__ seeds) {
    seed_spine(tot, nseg, nck, seeds);
}

template <typename T>
__global__ void __launch_bounds__(32, 1)
fused_seed_kernel(const T* __restrict__ A, const T* __restrict__ J, const T* __restrict__ C,
                  const double* __restrict__ seeds, int B, int seg, int c, int nck, int nch,
                  T* __restrict__ sh0) {
    chunk_seeds(A, J, C, seeds, B, seg, c, nck, nch, sh0);
}

template <typename T, int W>
__global__ void __launch_bounds__(32 * W)
fused_factor_kernel(const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ ph,
                    const T* __restrict__ a, const T* __restrict__ y,
                    const T* __restrict__ sh0, int L, int B, T* __restrict__ M_out,
                    T* __restrict__ m_out, T* __restrict__ Qm_out, T* __restrict__ qv_out,
                    double* __restrict__ q0_out, double* __restrict__ ld_out,
                    T* __restrict__ mind_out) {
    factor_fwd_sweep<false, T, W>(u, v, ph, a, y, sh0, L, B, M_out, m_out, Qm_out, qv_out,
                                  q0_out, ld_out, mind_out, static_cast<T*>(nullptr));
}

template <typename T>
__global__ void __launch_bounds__(32, 1)
fused_quad_kernel(const T* __restrict__ M, const T* __restrict__ m, const T* __restrict__ Qm,
                  const T* __restrict__ qv, const double* __restrict__ q0,
                  const double* __restrict__ ld, const T* __restrict__ mind, int B, int seg,
                  int c, int nck, int nch, double* __restrict__ rec) {
    chunk_quads(M, m, Qm, qv, q0, ld, mind, B, seg, c, nck, nch, rec);
}

template <typename T>
__global__ void __launch_bounds__(32, 1)
fused_assemble_kernel(const double* __restrict__ rec, int nseg, int nck,
                      double* __restrict__ quad_out, double* __restrict__ ld_out,
                      T* __restrict__ mind_out) {
    quad_spine(rec, nseg, nck, quad_out, ld_out, mind_out);
}

// ---------------------------------------------------------------------------
// Host entry points: the seven launches on the caller's stream, nothing
// allocated.  Scratch: A, J, C, sh0, M, Qm (P, P, B), m, qv (P, B), q0l, ldl
// (B,) float64, mindl (B,); work, celerite_fused_work(B, seg) float64
// words (the chunks' totals and seeds, then their sums).  Out: quad, ld
// (B / seg,) float64, mind (B / seg,).  Returns the first nonzero
// cudaGetLastError() after a launch.
// ---------------------------------------------------------------------------

// Lanes a chunk of a segment of `seg` lanes, and chunks a segment.  The
// walks take about 7.4 c + 665 / c us at seg = 256, P = 8 (a composition
// ~3.4 us, a step of C alone ~2.5, of the sums ~1.5 and ~0.6; PERF.md), so
// c ~ sqrt(seg / 3).
static inline int chunk_lanes(int seg) {
    int c = (int)ceil(sqrt(seg / 3.0));
    return c < 1 ? 1 : c;
}

static inline int chunks_of(int seg) {
    const int c = chunk_lanes(seg);
    return (seg + c - 1) / c;
}

#define CELERITE_FUSED_ENTRY(T, SFX)                                                            \
    int celerite_fused_ll_##SFX(const void* u, const void* v, const void* ph, const void* a,  \
                                const void* y, void* A, void* J, void* C, void* sh0, void* M,  \
                                void* m, void* Qm, void* qv, void* q0l, void* ldl,             \
                                void* mindl, void* work, void* quad, void* ld, void* mind,     \
                                int L, int B, int seg, void* stream) {                         \
        cudaStream_t st = static_cast<cudaStream_t>(stream);                                   \
        const int nseg = B / seg, c = chunk_lanes(seg), nck = chunks_of(seg);                  \
        const int nch = nseg * nck;                                                            \
        const dim3 gc((unsigned)((nch + CGW - 1) / CGW)), gs((unsigned)((nseg + CGW - 1) / CGW)); \
        double* tot = static_cast<double*>(work);                                              \
        double* seeds = tot + (size_t)nch * EL_NR;                                             \
        int err;                                                                               \
        if ((err = launch_fwd(fused_elements_kernel<T, 4>, fused_elements_kernel<T, 1>, B,     \
                              stream, static_cast<const T*>(u), static_cast<const T*>(v),      \
                              static_cast<const T*>(ph), static_cast<const T*>(a), L, B,       \
                              static_cast<T*>(A), static_cast<T*>(J), static_cast<T*>(C))))    \
            return err;                                                                        \
        fused_chunk_kernel<T><<<gc, 32, 0, st>>>(static_cast<const T*>(A),                     \
                                                 static_cast<const T*>(J),                     \
                                                 static_cast<const T*>(C), B, seg, c, nck,     \
                                                 nch, tot);                                    \
        if ((err = (int)cudaGetLastError())) return err;                                       \
        fused_spine_kernel<<<gs, 32, 0, st>>>(tot, nseg, nck, seeds);                          \
        if ((err = (int)cudaGetLastError())) return err;                                       \
        fused_seed_kernel<T><<<gc, 32, 0, st>>>(                                               \
            static_cast<const T*>(A), static_cast<const T*>(J), static_cast<const T*>(C),      \
            seeds, B, seg, c, nck, nch, static_cast<T*>(sh0));                                 \
        if ((err = (int)cudaGetLastError())) return err;                                       \
        if ((err = launch_fwd(fused_factor_kernel<T, 4>, fused_factor_kernel<T, 1>, B, stream, \
                              static_cast<const T*>(u), static_cast<const T*>(v),              \
                              static_cast<const T*>(ph), static_cast<const T*>(a),             \
                              static_cast<const T*>(y), static_cast<const T*>(sh0), L, B,      \
                              static_cast<T*>(M), static_cast<T*>(m), static_cast<T*>(Qm),     \
                              static_cast<T*>(qv), static_cast<double*>(q0l),                  \
                              static_cast<double*>(ldl), static_cast<T*>(mindl))))             \
            return err;                                                                        \
        fused_quad_kernel<T><<<gc, 32, 0, st>>>(                                               \
            static_cast<const T*>(M), static_cast<const T*>(m), static_cast<const T*>(Qm),     \
            static_cast<const T*>(qv), static_cast<const double*>(q0l),                        \
            static_cast<const double*>(ldl), static_cast<const T*>(mindl), B, seg, c, nck,     \
            nch, static_cast<double*>(work));                                                  \
        if ((err = (int)cudaGetLastError())) return err;                                       \
        fused_assemble_kernel<T><<<gs, 32, 0, st>>>(static_cast<const double*>(work), nseg,    \
                                                    nck, static_cast<double*>(quad),           \
                                                    static_cast<double*>(ld),                  \
                                                    static_cast<T*>(mind));                    \
        return (int)cudaGetLastError();                                                        \
    }

extern "C" {

// float64 words of the entry points' work for B lanes in segments of seg.
long long celerite_fused_work(int B, int seg) {
    const long long nch = (long long)(B / seg) * chunks_of(seg);
    const long long per = EL_NR + PP > NQR ? EL_NR + PP : NQR;
    return nch * per;
}

CELERITE_FUSED_ENTRY(float, f32)
CELERITE_FUSED_ENTRY(double, f64)

}  // extern "C"
