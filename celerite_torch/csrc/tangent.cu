// The log-likelihood with T forward-mode tangent directions for Hopper
// (sm_90a), on pre-lowered streams and their tangent streams.
//
// Replaces the Pallas kernels of celerite_tpu/ops/tangent.py:
//   jac_elements_kernel     <- _elements_jvp_kernel (tangent.py:71)
//   jac_factor_kernel       <- _factor_jvp_kernel   (tangent.py:138)
//   jac_* (four launches)   <- _jac_kernel          (tangent.py:591)
// The first two are the split pair of wide models (the port runs them at
// padded width 9-16): each lane's Riccati element (A, J, C) with its T
// tangents, then from each lane's seed (and its tangents) the affine map
// (M, m), the statistics (Qm, qv, Kahan-summed q0 and log-det, min pivot)
// and their tangents; the cross-lane prefixes and the assembly between and
// after them are float64 torch glue in forward mode
// (celerite_torch/ops/tangent.py).  _jac_kernel is the single-sweep
// value's four launches with T tangent copies of the state: the two
// sweeps, and the two lane-by-lane scans of prefix_common.cuh with their
// tangents (fused.cu's value now takes chunked scans), with no torch work
// between them (the port runs it at padded width 8 or less).
// Tangent streams are (L, T, P, B) and (L, T, 1, B), the direction axis
// ahead of the small dims, as in the Pallas kernels.
//
// Design.  A group of G threads (the power of two at or above P) steps a
// lane, thread r owning row r of every P x P state.  A step is two device
// functions: the value step (elem_value_step, factor_value_step in
// lanes_common.cuh; onepass.cu's sweep takes the latter too) fills a
// record of what the tangents read of it (the step's start rows of Sh and
// of A or M, d, z0, and rows of su, w, u, phi, uA or g); a direction's
// tangent step (elem_tan_step, factor_tan_step below) reads that record and
// its own tangent streams.
//
// The two sweeps (jac_elements_kernel, jac_factor_kernel) carry the value
// once a lane and chunk of directions, at every padded width.  A block
// holds LB = 32 / G lanes (4 at P = 8, 2 at P = 9-16): warp 0 is the value
// warp, warp 1 + j direction j of the block's chunk of at most TCH = 7
// directions (more directions take more chunks, blockIdx.y, each redoing
// the value once; T = 13 runs chunks of 7 and 6).  Steps go by tiles of KT
// (4 at P <= 8, 2 at 9-16): each warp copies its streams of a tile (the
// value's u, v, phi, a, y; a direction's tangents of them) into its own
// ring with cp.async two tiles ahead; the value warp sweeps tile k and
// writes its records into the record ring, which a named barrier hands to
// the direction warps, which sweep tile k while the value warp goes on with
// k + 1.  Each output is written once, the value's by the value warp of
// chunk 0, a direction's by its warp.  A sweep's lanes are chains of
// dependent steps, each bound by its latency (the value warp's: a tangent
// warp's step reads the value's record and needs no division).  At P <= 8
// two blocks share an SM: 128 registers a thread (the launch bound) and
// ~99 KiB of shared memory a block in float64, for which the value warp's
// factor rows of Qm, only accumulated, wait in shared memory.  At P = 9-16
// a thread's rows take up to 255 registers, so one block of eight warps
// fills an SM's registers, and the value warp's rows of J (the elements
// sweep's, only accumulated too) wait in shared memory as Qm's do; a
// direction step there sums by columns through its group's tile and hands
// dw and the sums to every row through its vector (TAN_TILE).  Its shared
// memory, two tiles of records of NQ words (~2P^2 + 7P, 611 at P = 16) for
// 2 lanes, each warp's two tiles of NF = 3P + 2 stream words a lane and
// the direction groups' tiles, is ~101 KiB at P = 16 in float64 (KT = 2).
//
// Bound.  Bytes: each input read once (the value streams and the T tangent
// streams, (3P + 1)(1 + T) words a point for the elements, (3P + 2)(1 + T)
// for the factor) and each output written once.  At config[2] (P = 8,
// T = 7) over 16 chains of N = 1e5 in float64 that is ~2.6 GB a sweep,
// ~0.8 ms at 3.35 TB/s.  Operations: the value step once and the tangent
// step T times a point (~15 P^2 + 41 T P^2 flops a point and sweep;
// chip_smoke.tangent_bound_ms counts them from the code), ~3 x 10^10 a
// sweep there, ~0.9 ms at 34 TFLOP/s float64; with the scans the jac
// launches are bound by operations (1.8 ms).  Each lane's steps are a chain
// of dependent steps, each with a few dozen shuffle reductions, so a sweep
// of few lanes is bound by a step's latency instead.
//
// Rounding: -fmad=false (_build.SOURCE_FLAGS), so that the value rounds as
// the plain versions (torch.func.jvp of ops/pallas_solver's and
// ops/adjoint's plain sweeps), which keep every multiply and add separate;
// the tangent steps multiply by 1 / d where those divide.  The tangents of
// the Kahan sums are Kahan sums, as the jvp of the plain version's
// compensated sums is; the Pallas kernels sum them plainly.
//
// Compiled once per padded width: nvcc -DCELERITE_P=<P> (1 <= P <= 16).

#include "adjoint_common.cuh"
#include "prefix_common.cuh"

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

// ---------------------------------------------------------------------------
// A direction's tangent step, row r, from the value's record of the step
// (Rec, lanes_common.cuh) and the direction's streams of the step in
// shared memory (`in`, field f at in[f * S]: du, dv, dph, da, dy), read
// where they are used rather than held in registers.
// ---------------------------------------------------------------------------

// A step's stream fields: u (or du), v, phi (P each), a, y.
constexpr int FU = 0, FV = P, FPH = 2 * P, FA = 3 * P, FY = 3 * P + 1, NF = 3 * P + 2;

// At P = 9-16 a direction step sums duA (or dg) by columns through its
// group's tile, and dw and those sums reach every row through the group's
// vector (adjoint_common.cuh's column_sum, as elem_fwd_step does), in place
// of P butterflies and P broadcast shuffles: rows 16 and 17 1-2% faster in
// float64, row 16 20-22% in float32 (PERF.md).  At P <= 8 the tiles would
// not leave room for two blocks an SM: the shuffles stay.
constexpr bool TAN_TILE = P > 8;

// The tangent of the Riccati step Sh <- Phi Sh Phi + d w w^T.  Returns dd;
// leaves d, 1 / d, w_r and dw_r (in `vec` too at P = 9-16).  The tangent
// steps multiply by the value's 1 / d where the plain versions divide by d
// (a few ulp, far inside the float64 bar): divisions were most of a
// tangent step's instructions.
template <typename T, int S, int SI>
__device__ __forceinline__ T riccati_tangent_row(Rec<T, S> rec, Rec<T, SI> in, int r, T* vec,
                                                 T (&dSh)[P], T& d, T& rd, T& wr, T& dwr) {
    const bool row = r < P;
    const T phr = row ? rec[QPH + r] : T(0), ur = row ? rec[QU + r] : T(0);
    const T dphr = row ? in[FPH + r] : T(0), dur = row ? in[FU + r] : T(0);
    const T dvr = row ? in[FV + r] : T(0);
    T dsu = T(0);
#pragma unroll
    for (int j = 0; j < P; ++j) {
        const T shj = row ? rec[QS + j * P + r] : T(0);
        const T phj = rec[QPH + j];
        dSh[j] = dphr * shj * phj + phr * dSh[j] * phj + phr * shj * in[FPH + j];
        dsu += dSh[j] * rec[QU + j] + phr * shj * phj * in[FU + j];
    }
    const T su = row ? rec[QSU + r] : T(0);
    d = rec[QD];
    rd = rec[QRD];
    const T dd = in[FA] - group_sum(dur * su + ur * dsu);
    wr = row ? rec[QW + r] : T(0);
    dwr = row ? ((dvr - dsu) - wr * dd) * rd : T(0);
    if (TAN_TILE) {
        if (row) vec[r] = dwr;
        __syncwarp();
    }
#pragma unroll
    for (int j = 0; j < P; ++j) {
        const T wj = rec[QW + j];
        const T dwj = TAN_TILE ? vec[j] : __shfl_sync(0xffffffffu, dwr, j, G);
        dSh[j] = dSh[j] + dd * wr * wj + d * (dwr * wj + wr * dwj);
    }
    return dd;
}

// The elements sweep's tangent step: (dSh, dA, dJ); `tile` is the group's
// tile and then its vector (P words for dw, P for the column sums), used
// at P = 9-16.
template <typename T, int S, int SI>
__device__ __forceinline__ void elem_tan_step(Rec<T, S> rec, Rec<T, SI> in, int r, T* tile,
                                              T (&dSh)[P], T (&dA)[P], T (&dJ)[P]) {
    T d, rd, wr, dwr, duA[P];
    T* vec = tile + P * TS;
    const T dd = riccati_tangent_row(rec, in, r, vec, dSh, d, rd, wr, dwr);
    const bool row = r < P;
    const T phr = row ? rec[QPH + r] : T(0), ur = row ? rec[QU + r] : T(0);
    const T dphr = row ? in[FPH + r] : T(0), dur = row ? in[FU + r] : T(0);
    // uA = A^T (Phi u) and its tangent, sums over rows for every column.
    const T utr = phr * ur, dutr = dphr * ur + phr * dur;
    T duAr;
    if (TAN_TILE) {
        duAr = column_sum(tile, r, [&](int j) {
            return dA[j] * utr + rec[QA + j * P + r] * dutr;
        });
        if (row) vec[P + r] = duAr;
        __syncwarp();
#pragma unroll
        for (int j = 0; j < P; ++j) duA[j] = vec[P + j];
    } else {
#pragma unroll
        for (int j = 0; j < P; ++j) {
            const T aj = row ? rec[QA + j * P + r] : T(0);
            duA[j] = group_sum(dA[j] * utr + aj * dutr);
        }
        duAr = pick(duA, r);
    }
    const T uAr = row ? rec[QG + r] : T(0);
#pragma unroll
    for (int j = 0; j < P; ++j) {
        const T aj = row ? rec[QA + j * P + r] : T(0);
        const T uAj = rec[QG + j];
        dA[j] = dphr * aj + phr * dA[j] - dwr * uAj - wr * duA[j];
        dJ[j] = dJ[j] - (duAr * (uAj * rd) + uAr * (duA[j] * rd - uAj * dd * (rd * rd)));
    }
}

// The factor sweep's tangent step: (dSh, dM, dm) carried, dQm, dqv and
// the Kahan-summed tangents of the quad and the log-det accumulated.
template <typename T, int S, int SI>
__device__ __forceinline__ void factor_tan_step(Rec<T, S> rec, Rec<T, SI> in, int r,
                                                T* tile, T (&dSh)[P], T (&dM)[P], T (&dQm)[P],
                                                T& dmr, T& dqvr, Kahan<T>& dq0, Kahan<T>& dld) {
    T d, rd, wr, dwr, dg[P];
    T* vec = tile + P * TS;
    const T dd = riccati_tangent_row(rec, in, r, vec, dSh, d, rd, wr, dwr);
    const bool row = r < P;
    const T phr = row ? rec[QPH + r] : T(0), ur = row ? rec[QU + r] : T(0);
    const T dphr = row ? in[FPH + r] : T(0), dur = row ? in[FU + r] : T(0);
    // M <- Phi M - w g^T with g = (Phi M)^T u: the tangents of Phi M and g.
    T dgr;
    if (TAN_TILE) {
#pragma unroll
        for (int j = 0; j < P; ++j)
            dM[j] = dphr * (row ? rec[QA + j * P + r] : T(0)) + phr * dM[j];
        dgr = column_sum(tile, r, [&](int j) {
            return dM[j] * ur + phr * rec[QA + j * P + r] * dur;
        });
        if (row) vec[P + r] = dgr;
        __syncwarp();
#pragma unroll
        for (int j = 0; j < P; ++j) dg[j] = vec[P + j];
    } else {
#pragma unroll
        for (int j = 0; j < P; ++j) {
            const T mj = row ? rec[QA + j * P + r] : T(0);
            dM[j] = dphr * mj + phr * dM[j];
            dg[j] = group_sum(dM[j] * ur + phr * mj * dur);
        }
        dgr = pick(dg, r);
    }
    const T gr = row ? rec[QG + r] : T(0);
#pragma unroll
    for (int j = 0; j < P; ++j) dM[j] = dM[j] - dwr * rec[QG + j] - wr * dg[j];
    // m <- Phi m + w z0 with z0 = y - u . Phi m.
    const T mr = row ? rec[QM + r] : T(0);
    const T mh = phr * mr, dmh = dphr * mr + phr * dmr;
    const T z0 = rec[QZ];
    const T dz0 = in[FY] - group_sum(dur * mh + ur * dmh);
    dmr = dmh + dwr * z0 + wr * dz0;
    // The tangents of the Kahan-compensated quad and log-det, qv and Qm.
    const T zd = z0 * rd, dzd = (dz0 - zd * dd) * rd;
    dq0.add(dz0 * zd + z0 * dzd);
    dld.add(dd * rd);
    dqvr = dqvr + dzd * gr + zd * dgr;
#pragma unroll
    for (int j = 0; j < P; ++j) {
        const T gj = rec[QG + j];
        dQm[j] = dQm[j] + (dgr * (gj * rd) + gr * (dg[j] * rd - gj * dd * (rd * rd)));
    }
}

// ---------------------------------------------------------------------------
// The jac sweeps' layout: a block of LB lanes, a value warp and a warp a
// direction of the block's chunk, tiles of KT steps through shared rings.
// ---------------------------------------------------------------------------

constexpr int LB = 32 / G;      // lanes a block
// Steps a tile: four at P <= 8, two at P = 9-16, where a record is ~2P²
// words and two tiles of them for two lanes take ~40 KB in float64.
constexpr int KT = P <= 8 ? 4 : 2;
// Most directions a block.
constexpr int TCH = 7;
constexpr int JAC_THREADS = 32 * (1 + TCH);
// Blocks an SM the launch bound asks for: two at P <= 8 (128 registers a
// thread), one at P = 9-16, where a value warp's rows of Sh and M (or A)
// and the step's u, phi, w and g (or uA), and a direction warp's rows of
// dSh, dM and dQm (or dA and dJ) and dg (or duA), take up to 255 registers
// a thread.
constexpr int JAC_BLOCKS = P <= 8 ? 2 : 1;
// Shared memory in words of T: the value warp's rows of Qm (the factor's)
// or J (the elements', at P = 9-16; P + 1 words a thread, against bank
// conflicts), two tiles of records, each warp's two tiles of streams, and
// at P = 9-16 each direction group's tile and vector: 101,376 bytes at P =
// 8, T >= 7 in float64 (94,720 at T = 16, three chunks of 6, 6 and 4);
// 103,104 at P = 16 (KT = 2: records of NQ = 611 words for 2 lanes) and
// 74,688 at P = 13, T >= 7.
constexpr int SM_QM = 32 * (P + 1);
constexpr int SM_PUB = KT * NQ * LB;
constexpr int SM_STR = KT * NF * LB;
constexpr int SM_TAN = TAN_TILE ? LB * (P * TS + 2 * P) : 0;
__host__ __device__ constexpr int jac_smem_words(int tch) {
    return SM_QM + 2 * SM_PUB + (1 + tch) * 2 * SM_STR + tch * SM_TAN;
}

extern __shared__ __align__(16) unsigned char jac_smem[];

// This thread's place: its warp (0 the value, 1 + j direction j), its lane
// in the block (q; global l, read as lc, which dead lanes past B clamp to
// B - 1 and never write) and row r, and the block's chunk of directions
// (k0, tc of them; tch the launch's chunk, which sizes its rings).
struct JacCtx {
    int warp, q, r, l, lc, l0, k0, tc, tch;
    bool live;
};

__device__ __forceinline__ JacCtx jac_ctx(int B, int nT, int tch) {
    JacCtx c;
    c.warp = threadIdx.x / 32;
    c.q = (threadIdx.x & 31) / G;
    c.r = threadIdx.x % G;
    c.l0 = blockIdx.x * LB;
    c.l = c.l0 + c.q;
    c.live = c.l < B;
    c.lc = c.live ? c.l : B - 1;
    c.k0 = blockIdx.y * tch;
    c.tc = min(tch, nT - c.k0);
    c.tch = tch;
    return c;
}

// The value warp's thread's P words of shared memory for a state only
// accumulated (the factor's Qm, the elements' J at P = 9-16).
template <typename T>
__device__ __forceinline__ T (&jac_rows())[P] {
    return *reinterpret_cast<T(*)[P]>(reinterpret_cast<T*>(jac_smem) + threadIdx.x * (P + 1));
}

// A direction warp's group's tile and vector (at P = 9-16).
template <typename T>
__device__ __forceinline__ T* jac_tan(const JacCtx& c) {
    return reinterpret_cast<T*>(jac_smem) + SM_QM + 2 * SM_PUB + (1 + c.tch) * 2 * SM_STR +
           ((c.warp - 1) * LB + c.q) * (P * TS + 2 * P);
}

template <typename T>
__device__ __forceinline__ T* jac_ring(int warp) {
    return reinterpret_cast<T*>(jac_smem) + SM_QM + 2 * SM_PUB + warp * 2 * SM_STR;
}

// The record of step s of tile `tile` for this thread's lane.
template <typename T>
__device__ __forceinline__ Rec<T, LB> jac_rec(const JacCtx& c, int tile, int s) {
    return Rec<T, LB>{reinterpret_cast<T*>(jac_smem) + SM_QM + (tile & 1) * SM_PUB +
                      s * NQ * LB + c.q};
}

__device__ __forceinline__ int tile_steps(int L, int tile) { return min(KT, L - tile * KT); }

// Tile `tile` of a warp's streams into its ring: (L, n, P, B) vectors x0,
// x1, x2 and (L, n, 1, B) scalars xa, xy (xy may be null) at index kk of n
// (the value's streams: n = 1, kk = 0).  One cp.async group a tile, empty
// past the end.
template <typename T>
__device__ __forceinline__ void prefetch_tile(const JacCtx& c, T* ring, const T* x0,
                                              const T* x1, const T* x2, const T* xa,
                                              const T* xy, int n, int kk, int L, int B,
                                              int tile) {
    T* slot = ring + (tile & 1) * SM_STR;
    const int s0 = tile * KT;
    for (int i = threadIdx.x & 31; i < KT * NF * LB; i += 32) {
        const int q = i % LB, f = (i / LB) % NF, s = s0 + i / (LB * NF);
        const int l = min(c.l0 + q, B - 1);
        if (s >= L) continue;
        const size_t sk = (size_t)s * n + kk;
        if (f < FA) {
            const T* x = f < FV ? x0 : (f < FPH ? x1 : x2);
            cp_async(slot + i, x + (sk * P + f % P) * B + l);
        } else if (f == FA) {
            cp_async(slot + i, xa + sk * B + l);
        } else if (xy != nullptr) {
            cp_async(slot + i, xy + sk * B + l);
        }
    }
    cp_async_commit();
}

// Step s of a tile's streams in a warp's ring, this thread's lane (each
// field LB lanes wide).
template <typename T>
__device__ __forceinline__ Rec<T, LB> ring_step(const JacCtx& c, T* ring, int tile, int s) {
    return Rec<T, LB>{ring + (tile & 1) * SM_STR + s * NF * LB + c.q};
}

// The value's streams of a step: u and phi whole, row r of v.
template <typename T>
__device__ __forceinline__ void value_in(Rec<T, LB> in, int r, T (&uv)[P], T (&pv)[P], T& vr) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
        uv[j] = in[FU + j];
        pv[j] = in[FPH + j];
    }
    vr = r < P ? in[FV + r] : T(0);
}

// A warp's pass over the tiles: its streams copied two tiles ahead, sweep(
// tile, n) over each tile's n steps, and the block's barrier after each.
// The value warp's barrier hands its tile on; a direction warp waits for
// the value's first tile first, so the block's barriers number 1 + tiles
// for both.
template <bool VALUE, typename T, class Sweep>
__device__ __forceinline__ void jac_pass(const JacCtx& c, T* ring, const T* x0, const T* x1,
                                         const T* x2, const T* xa, const T* xy, int n, int kk,
                                         int L, int B, Sweep&& sweep) {
    const int ntiles = (L + KT - 1) / KT;
    prefetch_tile(c, ring, x0, x1, x2, xa, xy, n, kk, L, B, 0);
    prefetch_tile(c, ring, x0, x1, x2, xa, xy, n, kk, L, B, 1);
    if (!VALUE) tile_barrier();
    for (int k = 0; k < ntiles; ++k) {
        cp_async_wait<1>();
        __syncwarp();
        sweep(k, tile_steps(L, k));
        __syncwarp();
        prefetch_tile(c, ring, x0, x1, x2, xa, xy, n, kk, L, B, k + 2);
        tile_barrier();
    }
    if (VALUE) tile_barrier();
    cp_async_wait<0>();
}

template <typename T>
__global__ void __launch_bounds__(JAC_THREADS, JAC_BLOCKS)
jac_elements_kernel(const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ ph,
                    const T* __restrict__ a, const T* __restrict__ du, const T* __restrict__ dv,
                    const T* __restrict__ dph, const T* __restrict__ da, int L, int B, int nT,
                    int tch, T* __restrict__ A_out, T* __restrict__ J_out,
                    T* __restrict__ C_out, T* __restrict__ DA_out, T* __restrict__ DJ_out,
                    T* __restrict__ DC_out) {
    const JacCtx c = jac_ctx(B, nT, tch);
    const int r = c.r;
    T* ring = jac_ring<T>(c.warp);
    if (c.warp == 0) {
        // J is only accumulated: at P = 9-16 its rows wait in shared memory.
        T Sh[P], A[P], Jr[P];
        T(&J)[P] = P > 8 ? jac_rows<T>() : Jr;
#pragma unroll
        for (int j = 0; j < P; ++j) {
            Sh[j] = J[j] = T(0);
            A[j] = j == r ? T(1) : T(0);
        }
        jac_pass<true>(c, ring, u, v, ph, a, static_cast<const T*>(nullptr), 1, 0, L, B,
                       [&](int tile, int n) {
                           for (int s = 0; s < n; ++s) {
                               T uv[P], pv[P], vr;
                               const Rec<T, LB> in = ring_step(c, ring, tile, s);
                               value_in(in, r, uv, pv, vr);
                               elem_value_step<true>(uv, pv, vr, in[FA], r, Sh, A, J,
                                                     jac_rec<T>(c, tile, s));
                           }
                       });
        if (blockIdx.y == 0 && c.live && r < P) {
            put_mat(A_out, r, B, c.l, A);
            put_mat(J_out, r, B, c.l, J);
            put_mat(C_out, r, B, c.l, Sh);
        }
        return;
    }
    const int jd = c.warp - 1, kk = c.k0 + jd;
    if (jd >= c.tc) {
        // A warp past the last chunk's directions keeps the barriers' count.
        for (int k = 0; k * KT < L; ++k) tile_barrier();
        tile_barrier();
        return;
    }
    T dSh[P], dA[P], dJ[P];
#pragma unroll
    for (int j = 0; j < P; ++j) dSh[j] = dA[j] = dJ[j] = T(0);
    jac_pass<false>(c, ring, du, dv, dph, da, static_cast<const T*>(nullptr), nT, kk, L, B,
                    [&](int tile, int n) {
                        for (int s = 0; s < n; ++s)
                            elem_tan_step(jac_rec<T>(c, tile, s), ring_step(c, ring, tile, s),
                                          r, jac_tan<T>(c), dSh, dA, dJ);
                    });
    if (c.live && r < P) {
        put_tmat(DA_out, kk, r, B, c.l, dA);
        put_tmat(DJ_out, kk, r, B, c.l, dJ);
        put_tmat(DC_out, kk, r, B, c.l, dSh);
    }
}

template <typename T>
__global__ void __launch_bounds__(JAC_THREADS, JAC_BLOCKS)
jac_factor_kernel(const T* __restrict__ u, const T* __restrict__ v, const T* __restrict__ ph,
                  const T* __restrict__ a, const T* __restrict__ y, const T* __restrict__ du,
                  const T* __restrict__ dv, const T* __restrict__ dph, const T* __restrict__ da,
                  const T* __restrict__ dy, const T* __restrict__ sh0,
                  const T* __restrict__ dsh0, int L, int B, int nT, int tch,
                  T* __restrict__ M_out, T* __restrict__ m_out, T* __restrict__ Qm_out,
                  T* __restrict__ qv_out, double* __restrict__ q0_out,
                  double* __restrict__ ld_out, T* __restrict__ mind_out,
                  T* __restrict__ DM_out, T* __restrict__ Dm_out, T* __restrict__ DQm_out,
                  T* __restrict__ Dqv_out, double* __restrict__ Dq0_out,
                  double* __restrict__ Dld_out) {
    const JacCtx c = jac_ctx(B, nT, tch);
    const int r = c.r;
    T* ring = jac_ring<T>(c.warp);
    if (c.warp == 0) {
        // Qm is only accumulated: its rows wait in shared memory.
        T(&Qm)[P] = jac_rows<T>();
        T Sh[P], M[P];
        get_mat(sh0, r, B, c.lc, Sh);
#pragma unroll
        for (int j = 0; j < P; ++j) {
            M[j] = j == r ? T(1) : T(0);
            Qm[j] = T(0);
        }
        T mr = T(0), qvr = T(0), mind = T(INFINITY);
        Kahan<T> q0{T(0), T(0)}, ld{T(0), T(0)};
        jac_pass<true>(c, ring, u, v, ph, a, y, 1, 0, L, B, [&](int tile, int n) {
            for (int s = 0; s < n; ++s) {
                T uv[P], pv[P], vr;
                const Rec<T, LB> in = ring_step(c, ring, tile, s);
                value_in(in, r, uv, pv, vr);
                factor_value_step<true>(uv, pv, vr, in[FA], in[FY], r, Sh, M, Qm, mr, qvr, q0,
                                        ld, mind, jac_rec<T>(c, tile, s));
            }
        });
        if (blockIdx.y == 0 && c.live && r < P) {
            put_mat(M_out, r, B, c.l, M);
            put_mat(Qm_out, r, B, c.l, Qm);
            m_out[(size_t)r * B + c.l] = mr;
            qv_out[(size_t)r * B + c.l] = qvr;
            if (r == 0) {
                q0_out[c.l] = q0.total();
                ld_out[c.l] = ld.total();
                mind_out[c.l] = mind;
            }
        }
        return;
    }
    const int jd = c.warp - 1, kk = c.k0 + jd;
    if (jd >= c.tc) {
        for (int k = 0; k * KT < L; ++k) tile_barrier();
        tile_barrier();
        return;
    }
    T dSh[P], dM[P], dQm[P];
    get_tmat(dsh0, kk, r, B, c.lc, dSh);
#pragma unroll
    for (int j = 0; j < P; ++j) dM[j] = dQm[j] = T(0);
    T dmr = T(0), dqvr = T(0);
    Kahan<T> dq0{T(0), T(0)}, dld{T(0), T(0)};
    jac_pass<false>(c, ring, du, dv, dph, da, dy, nT, kk, L, B, [&](int tile, int n) {
        for (int s = 0; s < n; ++s)
            factor_tan_step(jac_rec<T>(c, tile, s), ring_step(c, ring, tile, s), r,
                            jac_tan<T>(c), dSh, dM, dQm, dmr, dqvr, dq0, dld);
    });
    if (c.live && r < P) {
        put_tmat(DM_out, kk, r, B, c.l, dM);
        put_tmat(DQm_out, kk, r, B, c.l, dQm);
        Dm_out[((size_t)kk * P + r) * B + c.l] = dmr;
        Dqv_out[((size_t)kk * P + r) * B + c.l] = dqvr;
        if (r == 0) {
            Dq0_out[(size_t)kk * B + c.l] = dq0.total();
            Dld_out[(size_t)kk * B + c.l] = dld.total();
        }
    }
}

// ---------------------------------------------------------------------------
// The jac scans.
// ---------------------------------------------------------------------------

#define ELEMENTS_JVP_PARAMS                                                                    \
    const T *__restrict__ u, const T *__restrict__ v, const T *__restrict__ ph,               \
        const T *__restrict__ a, const T *__restrict__ du, const T *__restrict__ dv,          \
        const T *__restrict__ dph, const T *__restrict__ da, int L, int B, int nT,            \
        T *__restrict__ A, T *__restrict__ J, T *__restrict__ C, T *__restrict__ DA,          \
        T *__restrict__ DJ, T *__restrict__ DC
#define FACTOR_JVP_PARAMS                                                                      \
    const T *__restrict__ u, const T *__restrict__ v, const T *__restrict__ ph,               \
        const T *__restrict__ a, const T *__restrict__ y, const T *__restrict__ du,           \
        const T *__restrict__ dv, const T *__restrict__ dph, const T *__restrict__ da,        \
        const T *__restrict__ dy, const T *__restrict__ sh0, const T *__restrict__ dsh0,      \
        int L, int B, int nT, T *__restrict__ M, T *__restrict__ m, T *__restrict__ Qm,       \
        T *__restrict__ qv, double *__restrict__ q0, double *__restrict__ ld,                 \
        T *__restrict__ mind, T *__restrict__ DM, T *__restrict__ Dm, T *__restrict__ DQm,    \
        T *__restrict__ Dqv, double *__restrict__ Dq0, double *__restrict__ Dld

template <typename T>
__global__ void __launch_bounds__(SCAN_THREADS)
jac_seed_kernel(const T* __restrict__ A, const T* __restrict__ J, const T* __restrict__ C,
                const T* __restrict__ DA, const T* __restrict__ DJ, const T* __restrict__ DC,
                int B, int seg, T* __restrict__ sh0, T* __restrict__ dsh0) {
    seed_scan<true, T>(A, J, C, DA, DJ, DC, B, seg, sh0, dsh0);
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
//   The jac elements sweep (jac_elements_kernel) at every padded width
//   1-16.
// factor: in those, y (L, 1, B), dy (L, T, 1, B), sh0 (P, P, B), dsh0
//   (T, P, P, B); out M, Qm (P, P, B), m, qv (P, B), q0, ld (B,) float64,
//   mind (B,), DM, DQm (T, P, P, B), Dm, Dqv (T, P, B), Dq0, Dld (T, B)
//   float64: the jac factor sweep (jac_factor_kernel) at every padded
//   width 1-16.
// jac: the elements' and the factor's inputs; as scratch their outputs
//   (w[0..5] the elements', w[6..7] sh0 and dsh0, w[8..20] the factor's);
//   out quad, ld (B / seg,) float64, mind (B / seg,), dquad, dld
//   (T, B / seg) float64; padded widths 1-8.
// The sweeps take the T directions in chunks of at most TCH, as even as
// they go, one row of blocks a chunk, with jac_smem_words of dynamic shared
// memory (above the default 48 KB at P = 8 and 13-16), so each launch
// raises its sweep's limit first.
// ---------------------------------------------------------------------------

// A sweep's launch shape for B lanes and nT directions.
struct JacGrid {
    dim3 blocks, threads;
    int tch;
    size_t bytes;
};

template <typename T>
static JacGrid jac_grid(int B, int nT) {
    const int nch = (nT + TCH - 1) / TCH, tch = (nT + nch - 1) / nch;
    return JacGrid{dim3((unsigned)((B + LB - 1) / LB), (unsigned)nch),
                   dim3((unsigned)(32 * (1 + tch))), tch,
                   sizeof(T) * (size_t)jac_smem_words(tch)};
}

template <typename K>
static int jac_prepare(K kernel, size_t bytes) {
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)bytes);
}

template <typename T>
static int elements_launch(ELEMENTS_JVP_PARAMS, cudaStream_t st) {
    if (nT < 1) return (int)cudaErrorInvalidValue;
    const JacGrid g = jac_grid<T>(B, nT);
    if (const int err = jac_prepare(jac_elements_kernel<T>, g.bytes)) return err;
    jac_elements_kernel<T><<<g.blocks, g.threads, g.bytes, st>>>(
        u, v, ph, a, du, dv, dph, da, L, B, nT, g.tch, A, J, C, DA, DJ, DC);
    return (int)cudaGetLastError();
}

template <typename T>
static int factor_launch(FACTOR_JVP_PARAMS, cudaStream_t st) {
    if (nT < 1) return (int)cudaErrorInvalidValue;
    const JacGrid g = jac_grid<T>(B, nT);
    if (const int err = jac_prepare(jac_factor_kernel<T>, g.bytes)) return err;
    jac_factor_kernel<T><<<g.blocks, g.threads, g.bytes, st>>>(
        u, v, ph, a, y, du, dv, dph, da, dy, sh0, dsh0, L, B, nT, g.tch, M, m, Qm, qv, q0, ld,
        mind, DM, Dm, DQm, Dqv, Dq0, Dld);
    return (int)cudaGetLastError();
}

template <typename T>
static int jac_launch(const T* u, const T* v, const T* ph, const T* a, const T* y, const T* du,
                      const T* dv, const T* dph, const T* da, const T* dy, void** w,
                      double* quad, double* ldo, T* mindo, double* dquad, double* dldo, int L,
                      int B, int seg, int nT, cudaStream_t st) {
    if (P > 8 || nT < 1) return (int)cudaErrorInvalidValue;
    T *A = (T*)w[0], *J = (T*)w[1], *C = (T*)w[2], *DA = (T*)w[3], *DJ = (T*)w[4],
      *DC = (T*)w[5], *sh0 = (T*)w[6], *dsh0 = (T*)w[7], *M = (T*)w[8], *m = (T*)w[9],
      *Qm = (T*)w[10], *qv = (T*)w[11], *mind = (T*)w[14], *DM = (T*)w[15], *Dm = (T*)w[16],
      *DQm = (T*)w[17], *Dqv = (T*)w[18];
    double *q0 = (double*)w[12], *ld = (double*)w[13], *Dq0 = (double*)w[19],
           *Dld = (double*)w[20];
    const dim3 scans((unsigned)(B / seg), (unsigned)nT);
    int err;
    if ((err = elements_launch<T>(u, v, ph, a, du, dv, dph, da, L, B, nT, A, J, C, DA, DJ, DC,
                                  st)))
        return err;
    jac_seed_kernel<T><<<scans, SCAN_THREADS, 0, st>>>(A, J, C, DA, DJ, DC, B, seg, sh0, dsh0);
    if ((err = (int)cudaGetLastError())) return err;
    if ((err = factor_launch<T>(u, v, ph, a, y, du, dv, dph, da, dy, sh0, dsh0, L, B, nT, M, m,
                                Qm, qv, q0, ld, mind, DM, Dm, DQm, Dqv, Dq0, Dld, st)))
        return err;
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
        return elements_launch<T>((const T*)u, (const T*)v, (const T*)ph, (const T*)a,       \
                                  (const T*)du, (const T*)dv, (const T*)dph, (const T*)da, L, \
                                  B, nT, (T*)A, (T*)J, (T*)C, (T*)DA, (T*)DJ, (T*)DC,        \
                                  static_cast<cudaStream_t>(stream));                        \
    }                                                                                         \
    int celerite_tangent_factor_##SFX(                                                        \
        const void* u, const void* v, const void* ph, const void* a, const void* y,          \
        const void* du, const void* dv, const void* dph, const void* da, const void* dy,     \
        const void* sh0, const void* dsh0, void* M, void* m, void* Qm, void* qv, void* q0,   \
        void* ld, void* mind, void* DM, void* Dm, void* DQm, void* Dqv, void* Dq0, void* Dld, \
        int L, int B, int nT, void* stream) {                                                 \
        return factor_launch<T>(                                                              \
            (const T*)u, (const T*)v, (const T*)ph, (const T*)a, (const T*)y, (const T*)du,   \
            (const T*)dv, (const T*)dph, (const T*)da, (const T*)dy, (const T*)sh0,           \
            (const T*)dsh0, L, B, nT, (T*)M, (T*)m, (T*)Qm, (T*)qv, (double*)q0,              \
            (double*)ld, (T*)mind, (T*)DM, (T*)Dm, (T*)DQm, (T*)Dqv, (double*)Dq0,            \
            (double*)Dld, static_cast<cudaStream_t>(stream));                                 \
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
