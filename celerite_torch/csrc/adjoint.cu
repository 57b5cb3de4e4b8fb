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
// elements_fwd steps through the streams with each thread reading the
// step's u and phi whole (lanes_common.cuh's sweep, shared with
// pallas_solver.cu, fused.cu and tangent.cu).  factor_fwd streams instead:
// each group copies its lane's streams three steps ahead into a ring in
// shared memory (cp.async), sums g = (Phi M)^T u by columns through its
// tile and hands w and g to every row through shared memory, in blocks of
// four warps where that still gives every SM a block, else of one
// (sampler_E's 512 lanes at P = 16: 256 blocks of 2 lanes).
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
// elements_fwd: each lane's Riccati element (A, J, C) with saves.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(BLOCK)
adjoint_elements_fwd_kernel(const T* __restrict__ u, const T* __restrict__ v,
                            const T* __restrict__ ph, const T* __restrict__ a, int L, int B,
                            T* __restrict__ A_out, T* __restrict__ J_out, T* __restrict__ C_out,
                            T* __restrict__ sv) {
    elements_sweep<true>(u, v, ph, a, L, B, A_out, J_out, C_out, sv);
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
// streamed.  A block of W warps, a group of G threads a lane (LB = 32 W / G
// lanes), thread r row r of Sh, M and Qm.  Each group copies its lane's
// streams FWD_AHEAD steps ahead into a ring in shared memory (cp.async), so
// a step reads u_j and phi_j there and never waits on device memory.  g =
// (Phi M)^T u is a column sum through the group's tile, and w and g reach
// every row through the group's vector in shared memory (one __syncwarp
// each), so a step takes two butterflies (d and z0) and no broadcast
// shuffles; one reciprocal of d a step.  Each step's input [Sh, M, m] goes
// to the save stream (NSV1 words a lane and step, the layout elements_bwd
// and factor_bwd read).
// ---------------------------------------------------------------------------

constexpr int FWD_AHEAD = 3;             // steps copied ahead of the step computed
constexpr int FWD_RING = FWD_AHEAD + 2;  // those, the step's and the step before's

template <typename T, int W>
__global__ void __launch_bounds__(32 * W)
adjoint_factor_fwd_kernel(const T* __restrict__ u, const T* __restrict__ v,
                          const T* __restrict__ ph, const T* __restrict__ a,
                          const T* __restrict__ y, const T* __restrict__ sh0, int L, int B,
                          T* __restrict__ M_out, T* __restrict__ m_out, T* __restrict__ Qm_out,
                          T* __restrict__ qv_out, double* __restrict__ q0_out,
                          double* __restrict__ ld_out, T* __restrict__ mind_out,
                          T* __restrict__ sv) {
    constexpr int LB = 32 * W / G;
    // Each lane's ring of steps, tile, and vector (w, then g).
    __shared__ T ring[FWD_RING * LB * NRS];
    __shared__ T tiles[LB * P * TS];
    __shared__ T vecs[LB * 2 * P];
    const int q = threadIdx.x / G, r = threadIdx.x % G;
    const bool live = blockIdx.x * LB + q < B;
    // A dead lane runs the last lane and writes nothing.
    const int l = live ? blockIdx.x * LB + q : B - 1;
    T* tile = tiles + q * P * TS;
    T* wv = vecs + q * 2 * P;
    T* gv = wv + P;
    auto slot = [&](int s) { return ring + ((s % FWD_RING) * LB + q) * NRS; };
    auto copy = [&](int s) {
        if (s < L) copy_streams(slot(s), u, v, ph, a, y, s, B, l, r);
        cp_async_commit();
    };

    // Row r of Sh, M, Qm, entry r of m and qv; the scalar statistics are
    // kept alike in every thread of the group.
    T Sh[P], M[P], Qm[P];
    get_mat(sh0, r, B, l, Sh);
#pragma unroll
    for (int j = 0; j < P; ++j) {
        M[j] = j == r ? T(1) : T(0);
        Qm[j] = T(0);
    }
    T mr = T(0), qvr = T(0), mind = T(INFINITY);
    Kahan<T> q0{T(0), T(0)}, ld{T(0), T(0)};
    for (int k = 0; k < FWD_AHEAD; ++k) copy(k);
    for (int s = 0; s < L; ++s) {
        copy(s + FWD_AHEAD);
        if (live) {
            T* svs = sv + ((size_t)s * B + l) * NSV1;
            save_row(svs, r, Sh);
            save_row(svs + PP, r, M);
            if (r < P) svs[2 * PP + r] = mr;
        }
        cp_async_wait<FWD_AHEAD>();
        __syncwarp();
        const T* st = slot(s);
        const bool in = r < P;
        const T ur = in ? st[RU + r] : T(0), phr = in ? st[RPH + r] : T(0);
        const T vr = in ? st[RV + r] : T(0);
        // The Riccati step: S = Phi Sh Phi, su = S u, d = a - u.su, w =
        // (v - su) / d, Sh <- S + d w w^T.
        T S[P];
        Acc4<T> sa;
#pragma unroll
        for (int j = 0; j < P; ++j) {
            S[j] = phr * Sh[j] * st[RPH + j];
            sa.fma(j, S[j], st[RU + j]);
        }
        const T su = sa.sum(), mh = phr * mr;
        const T d = st[RA] - group_sum(ur * su);
        const T z0 = st[RY] - group_sum(ur * mh);
        const T rd = T(1) / d;
        const T wr = in ? (vr - su) * rd : T(0);
        if (in) wv[r] = wr;
        // M <- Phi M - w g^T with g = (Phi M)^T u, a column sum.
#pragma unroll
        for (int j = 0; j < P; ++j) M[j] = phr * M[j];
        const T gr = column_sum(tile, r, [&](int j) { return M[j] * ur; });
        if (in) gv[r] = gr;
        const T dw = d * wr;
#pragma unroll
        for (int j = 0; j < P; ++j) Sh[j] = S[j] + dw * wv[j];
        __syncwarp();
        // M <- M - w g^T and Qm <- Qm + g g^T / d.
        const T grd = gr * rd;
#pragma unroll
        for (int j = 0; j < P; ++j) {
            const T gj = gv[j];
            M[j] = M[j] - wr * gj;
            Qm[j] = Qm[j] + grd * gj;
        }
        // m <- Phi m + w z0; the Kahan-compensated quad and log-det, qv and
        // the NaN-propagating minimum pivot (like torch.minimum).
        mr = mh + wr * z0;
        q0.add(z0 * z0 * rd);
        ld.add(dlog(d));
        qvr = qvr + (z0 * rd) * gr;
        mind = (d < mind || d != d) ? d : mind;
    }
    if (!live || r >= P) return;
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

// Warps a block of factor_fwd: four where that still gives every SM of the
// card a block (E's 16 chains, 2048 lanes at G = 16: 256 blocks), else one
// (sampler_E's 4 chains, 512 lanes: 256 blocks of 2 lanes).  On those two
// plans two warps were never faster than both (PERF.md).
static int fwd_warps(int B) {
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    constexpr int lb = 4 * 32 / G;
    return (B + lb - 1) / lb >= sms ? 4 : 1;
}

template <typename T>
static int launch_factor_fwd(const T* u, const T* v, const T* ph, const T* a, const T* y,
                             const T* sh0, int L, int B, T* M, T* m, T* Qm, T* qv, double* q0,
                             double* ld, T* mind, T* sv, void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int w = fwd_warps(B), lb = 32 * w / G;
    const dim3 grid((unsigned)((B + lb - 1) / lb));
    if (w == 4)
        adjoint_factor_fwd_kernel<T, 4><<<grid, 128, 0, st>>>(u, v, ph, a, y, sh0, L, B, M, m,
                                                              Qm, qv, q0, ld, mind, sv);
    else
        adjoint_factor_fwd_kernel<T, 1><<<grid, 32, 0, st>>>(u, v, ph, a, y, sh0, L, B, M, m,
                                                             Qm, qv, q0, ld, mind, sv);
    return (int)cudaGetLastError();
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
        adjoint_elements_fwd_kernel<T>                                                          \
            <<<grid_for(B, G), BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(                 \
            static_cast<const T*>(u), static_cast<const T*>(v), static_cast<const T*>(ph),     \
            static_cast<const T*>(a), L, B, static_cast<T*>(A), static_cast<T*>(J),            \
            static_cast<T*>(C), static_cast<T*>(sv));                                          \
        return (int)cudaGetLastError();                                                        \
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
        return launch_factor_fwd(                                                              \
            static_cast<const T*>(u), static_cast<const T*>(v), static_cast<const T*>(ph),     \
            static_cast<const T*>(a), static_cast<const T*>(y), static_cast<const T*>(sh0), L, \
            B, static_cast<T*>(M), static_cast<T*>(m), static_cast<T*>(Qm),                    \
            static_cast<T*>(qv), static_cast<double*>(q0), static_cast<double*>(ld),           \
            static_cast<T*>(mind), static_cast<T*>(sv), stream);                               \
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
