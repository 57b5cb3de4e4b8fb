// Fused primal GP log-likelihood for Hopper (sm_90a).
//
// Replaces: celerite_tpu/ops/fused4.py:_primal_kernel (the Pallas kernel
// launched by run_primal).  Same mathematics: each virtual lane owns a
// contiguous chunk of L points.  Phase 0 lowers the packed coefficients per
// step (u, v, phi, a from t, t_lo, dt, diag, mask) and accumulates the
// lane's Riccati element (A, J, C).  A segmented prefix over lanes composes
// the elements; the exclusive prefix seeds each lane.  Phase 1 reruns the
// lane seeded and accumulates the affine map (M, m) and the statistics
// (Kahan-summed quad and log-det, qv, Qm, min pivot).  A second prefix over
// (M, m) gives each lane its incoming state h, and
//   quad_l = q0 - 2 qv.h + h^T Qm h.
// The host sums quad and ld per segment (fused4.run_primal).
//
// Design.  On the TPU the grid (2, L) runs in order on one core and the
// state stays in VMEM between grid steps.  Here the two phases are
// fused4_grad.cu's forward sweeps launched without saves (fused4_fwd.cuh:
// elem_fwd_kernel, factor_fwd_kernel): a group of G threads a lane, thread
// r row r of the P x P state, its column of each step lowered in the
// kernel, the scalar streams copied ahead into a cp.async ring.  Nothing
// carries between thread blocks, so each prefix is launches of its own, in
// float64 whatever the streams' dtype (composing float32 elements through
// the unpivoted inverse of (I + C1 J2) lost whole runs of lanes to
// non-positive pivots on the card, PERF.md): primal_scan_kernel scans each
// block of SCAN_LB lanes in shared memory (a Hillis-Steele scan, a lane
// group a lane composing with prefix_common.cuh's compose_rows or
// compose_aff_rows, heads of segments stopping it) and writes the block's
// total; where a segment crosses a block, the same kernel scans the blocks'
// totals in place, a level up, until one block takes a level (one level at
// A's and B's plans); each lane then takes its own prefix from its block's
// and the levels': primal_seed_kernel by a C-only step (cstep_rows) a level
// into the seed, primal_assemble_kernel by an affine step a level into h
// beside the assembly.  Eight launches at A's and B's plans (2 log2(seg) +
// 3 before, 33 at 32768 lanes), two more a level beyond.  A single-pass
// scan with decoupled look-back would take the levels' launches too, but
// waits on flags that blocks of the same launch set, which a fault or a
// scheduling order the card does not promise turns into a hang.  A
// work-efficient block scan (a group a run of four lanes composed in turn,
// Hillis-Steele rounds over the runs' totals, then each run's carry: about
// three compositions a lane, twice as deep) read 5% faster on B's plan and
// 7% slower on A's (PERF.md), so the scan stays Hillis-Steele.  One block
// walking the totals in turns of SCAN_LB, composing each turn's carry, took
// 188-255 registers where the lanes' scan takes 102-140 and spilled at P =
// 6-8 and 10-12, hence the levels.
//
// Bound.  The function reads 6 streams of N words once: 24 MB at N = 1e6
// in float32, ~7 us at 3.35 TB/s (the two sweeps read them once each).  The
// arithmetic is a few hundred operations per point.  Both are far below
// the time of the launches and of the per-lane sequential recursion, so in
// practice the kernel is bound by latency: L dependent steps a lane, and
// log2(SCAN_LB) rounds of compositions a prefix in each block, at P = 8 as
// many at once as an SM's float64 units keep busy.
//
// Numerics: fused4_common.cuh; -fmad=false (_build.SOURCE_FLAGS), so that
// float32 rounds as the plain version (fused4.primal_reference), which
// keeps every multiply and add separate.  Compiled once per padded width:
// nvcc -DCELERITE_P=<P> (1 <= P <= 12).

#include "fused4_fwd.cuh"
#include "prefix_common.cuh"

// Lanes a block of the scan: a lane's slot and the group's two tiles (5 P
// TS words) in at most 200 KB of shared memory, and threads few enough that
// a composition's registers fit (65536 / threads a thread): 512 threads at
// P <= 8 (64 lanes at P = 8, 256 at P = 2), 256 above.
constexpr int scan_lanes() {
    int lb = (P <= 8 ? 512 : 256) / G;
    while (lb > 1 && lb * 5 * P * TS > 200 * 1024 / 8) lb >>= 1;
    return lb;
}
constexpr int SCAN_LB = scan_lanes();
constexpr int MAX_LEVELS = 8;  // SCAN_LB^8 lanes and more

// Dynamic shared memory of a scan block of lb lanes: their words, their
// flags.
static inline size_t scan_bytes(int lb) {
    return (size_t)lb * 5 * P * TS * sizeof(double) + (size_t)lb * sizeof(int);
}

extern __shared__ __align__(16) double scan_smem[];

// The scan's inputs, lane i's rows r into a slot: the sweeps' (P, P, B) and
// (P, B) outputs in T, or the block totals' records.
template <typename T>
struct ElemIn {
    const T *A, *J, *C;
    int B;
    __device__ __forceinline__ void load(double* e, int r, int i) const {
        ElRows<T> x;
        x.fetch(A, J, C, r, B, i);
        x.put(e, r);
    }
};

template <typename T>
struct AffIn {
    const T *M, *m;
    int B;
    __device__ __forceinline__ void load(double* e, int r, int i) const {
        if (r >= P) return;
#pragma unroll
        for (int j = 0; j < P; ++j) e[r * TS + j] = static_cast<double>(M[((size_t)r * P + j) * B + i]);
        e[P * TS + r] = static_cast<double>(m[(size_t)r * B + i]);
    }
};

template <bool AFF>
struct RecIn {
    const double* x;
    __device__ __forceinline__ void load(double* e, int r, int i) const {
        if (AFF)
            rec_to_slot<1, true>(x + (size_t)i * AF_NR, e, r);
        else
            rec_to_slot<3, false>(x + (size_t)i * EL_NR, e, r);
    }
};

// Rows r of e1 o e2 into e (e may be e2, once every group has composed).
template <bool AFF>
struct Composed {
    double a[P], j[P], c[P], mv;
    __device__ __forceinline__ void of(unsigned gm, int r, const double* e1, const double* e2,
                                       double* t0, double* t1) {
        if (AFF)
            compose_aff_rows(r, e1, e2, a, mv);
        else
            compose_rows(gm, r, e1, e2, t0, t1, a, j, c);
    }
    __device__ __forceinline__ void put(double* e, int r) const {
        if (r >= P) return;
        if (AFF) {
#pragma unroll
            for (int k = 0; k < P; ++k) e[r * TS + k] = a[k];
            e[P * TS + r] = mv;
        } else {
            put_el(e, r, a, j, c);
        }
    }
};

// One level of the segmented scan of n elements or maps, a group of G
// threads a lane, lb = blockDim.x / G lanes a block: block b scans lanes
// [b lb, (b + 1) lb) alone (Hillis-Steele rounds in shared memory), each
// lane's prefix from the last head in the block, or the block's first lane,
// into out (records; out may be the input's), and the block's last prefix
// and whether a head lies in the block into agg and fagg.  A lane heads a
// segment where i % seg == 0 (level 0, null flag) or where flag says so,
// and then its flag becomes whether a head lies in its block before it or
// at it.  A group composes only where its lane takes a prefix (a block
// barrier waits for each thread, so the groups of a warp may part there).
template <bool AFF, class In>
__global__ void __launch_bounds__(SCAN_LB * G)
primal_scan_kernel(In in, int n, int seg, int* __restrict__ flag, double* __restrict__ out,
                   double* __restrict__ agg, int* __restrict__ fagg) {
    constexpr int LANE = 5 * P * TS;
    const unsigned gm = group_mask();
    const int lb = blockDim.x / G, q = threadIdx.x / G, r = threadIdx.x % G;
    double *slot = scan_smem + q * LANE, *t0 = slot + EL_NS, *t1 = t0 + P * TS;
    int* flags = reinterpret_cast<int*>(scan_smem + lb * LANE);
    const int i0 = blockIdx.x * lb, i = i0 + q;
    const bool live = i < n;
    if (live) in.load(slot, r, i);
    if (r == 0) flags[q] = live ? (flag != nullptr ? flag[i] : i % seg == 0) : 1;
    for (int s = 1; s < lb; s <<= 1) {
        __syncthreads();
        const bool act = live && q >= s && !flags[q];
        const int f = act ? flags[q - s] : 0;
        Composed<AFF> x;
        if (act) x.of(gm, r, slot - s * LANE, slot, t0, t1);
        __syncthreads();
        if (act) {
            x.put(slot, r);
            if (r == 0) flags[q] = f;
        }
    }
    __syncthreads();
    if (live) {
        if (AFF)
            slot_to_rec<1, true>(slot, out + (size_t)i * AF_NR, r);
        else
            slot_to_rec<3, false>(slot, out + (size_t)i * EL_NR, r);
        if (flag != nullptr && r == 0) flag[i] = flags[q];
    }
    if (agg != nullptr && q == min(i0 + lb, n) - 1 - i0) {
        if (AFF)
            slot_to_rec<1, true>(slot, agg + (size_t)blockIdx.x * AF_NR, r);
        else
            slot_to_rec<3, false>(slot, agg + (size_t)blockIdx.x * EL_NR, r);
        if (r == 0) fagg[blockIdx.x] = flags[q];
    }
}

// A prefix's levels: level 0 the lanes' block prefixes, level j + 1 those
// of level j's block totals, the last level one block.  Lane k's whole
// prefix is its level-0 prefix, composed after the whole prefix of level
// 1's element k / SCAN_LB - 1 where a segment crosses into k's block
// before k, and so on up.
struct Levels {
    const double* pre[MAX_LEVELS];
    const int* flag[MAX_LEVELS];
    int top, seg;
    // Level j's element idx's prefix is whole (a head before it in its block,
    // or the last level).
    __device__ __forceinline__ bool whole(int j, int idx) const {
        if (j == top) return true;
        if (j == 0) return idx / seg * seg >= idx / SCAN_LB * SCAN_LB;
        return flag[j][idx] != 0;
    }
    // The elements whose prefixes make lane k's whole prefix, from level 0
    // up: idx[0 .. returned level].
    __device__ __forceinline__ int chain(int k, int (&idx)[MAX_LEVELS]) const {
        int j = 0;
        idx[0] = k;
        while (!whole(j, idx[j])) {
            idx[j + 1] = idx[j] / SCAN_LB - 1;
            ++j;
        }
        return j;
    }
};

// Each lane's seed sh0 (P, P, B) float64: C of the prefix of the lane
// before it, 0 at a segment's head, by one C-only step (cstep_rows) a level
// down from the highest level its prefix reaches.  A group a lane, 128
// threads a block; the launch bounds ask for one block an SM, so that ptxas
// keeps every value in registers (without it, 8 bytes spilled at P = 7
// and 9, PERF.md).
__global__ void __launch_bounds__(128, 1)
primal_seed_kernel(Levels lv, int B, double* __restrict__ sh0) {
    constexpr int NG = 128 / G, W = EL_NS + P * TS;
    __shared__ double sm[NG * W];
    const int q = threadIdx.x / G, r = threadIdx.x % G, l = blockIdx.x * NG + q;
    if (l >= B) return;
    const unsigned gm = group_mask();
    double *e = sm + q * W, *tk = e + EL_NS;
    double c[P];
#pragma unroll
    for (int j = 0; j < P; ++j) c[j] = 0.0;
    if (l % lv.seg != 0) {
        int idx[MAX_LEVELS];
        const int top = lv.chain(l - 1, idx);
        if (r < P) {
            const double* x = lv.pre[top] + (size_t)idx[top] * EL_NR + 2 * PP + r * P;
#pragma unroll
            for (int j = 0; j < P; ++j) c[j] = x[j];
        }
        for (int j = top - 1; j >= 0; --j) {
            __syncwarp(gm);
            rec_to_slot<3, false>(lv.pre[j] + (size_t)idx[j] * EL_NR, e, r);
            __syncwarp(gm);
            cstep_rows(gm, r, c, e, tk);
        }
    }
    if (r >= P) return;
#pragma unroll
    for (int j = 0; j < P; ++j) sh0[((size_t)r * P + j) * B + l] = c[j];
}

// Each lane's quad_l = q0 - 2 qv.h + h^T Qm h, with h the m of the prefix
// of the lane before it (0 at a segment's head: an affine step a level down
// from the highest level its prefix reaches), and its ld and minimum pivot,
// in T.  A group a lane, 128 threads a block.
template <typename T>
__global__ void __launch_bounds__(128, 1)
primal_assemble_kernel(Levels lv, const T* __restrict__ Qm, const T* __restrict__ qv,
                       const double* __restrict__ q0, const double* __restrict__ ld,
                       const T* __restrict__ mind, int B, T* __restrict__ quad,
                       T* __restrict__ ld_out, T* __restrict__ mind_out) {
    constexpr int NG = 128 / G;
    const int q = threadIdx.x / G, r = threadIdx.x % G, l = blockIdx.x * NG + q;
    if (l >= B) return;
    const unsigned gm = group_mask();
    const bool in = r < P;
    double hr = 0.0;
    if (l % lv.seg != 0) {
        int idx[MAX_LEVELS];
        const int top = lv.chain(l - 1, idx);
        if (in) hr = lv.pre[top][(size_t)idx[top] * AF_NR + PP + r];
        for (int j = top - 1; j >= 0; --j) {
            double hv[P];
#pragma unroll
            for (int c = 0; c < P; ++c) hv[c] = __shfl_sync(gm, hr, c, G);
            if (in) {
                const double* x = lv.pre[j] + (size_t)idx[j] * AF_NR;
                double h = x[PP + r];
#pragma unroll
                for (int c = 0; c < P; ++c) h = mac(x[r * P + c], hv[c], h);
                hr = h;
            }
        }
    }
    double hv[P], qh = 0.0;
#pragma unroll
    for (int j = 0; j < P; ++j) hv[j] = __shfl_sync(gm, hr, j, G);
    if (in) {
#pragma unroll
        for (int j = 0; j < P; ++j)
            qh = mac(static_cast<double>(Qm[((size_t)r * P + j) * B + l]), hv[j], qh);
    }
    const double qvh = gsum(gm, in ? static_cast<double>(qv[(size_t)r * B + l]) * hr : 0.0);
    const double hqh = gsum(gm, hr * qh);
    if (r != 0) return;
    quad[l] = static_cast<T>(q0[l] - 2.0 * qvh + hqh);
    ld_out[l] = static_cast<T>(ld[l]);
    mind_out[l] = mind[l];
}

// ---------------------------------------------------------------------------
// Host launcher: every launch on the caller's stream, nothing allocated.
// The workspace ws (celerite_fused4_primal_ws(B) float64 words): the
// elements A, J, C and the maps and statistics M, Qm, m, qv, mind in T, q0
// and ld and the seeds sh0 in float64, the lanes' block prefixes (records,
// EL_NR words a lane; the maps' AF_NR reuse them), and each level above
// (records and flags).  cf holds one row of 2P + 1 coefficients per
// segment of `seg` lanes.
// ---------------------------------------------------------------------------

// Offsets into the workspace, in float64 words, and each level's count.
struct WsLayout {
    size_t sh0, st, pre, lv[MAX_LEVELS], words;
    int n[MAX_LEVELS];
    explicit WsLayout(int B) {
        const size_t b = (size_t)B;
        sh0 = 3 * PP * b;                               // after A, J, C: 3 PP B words of T
        st = sh0 + PP * b;                              // M, Qm, m, qv, mind in T, then q0, ld
        pre = st + (2 * PP + 2 * P + 1) * b + 2 * b;
        size_t o = pre + EL_NR * b;
        n[0] = B;
        for (int j = 1; j < MAX_LEVELS; ++j) {
            n[j] = (n[j - 1] + SCAN_LB - 1) / SCAN_LB;
            lv[j] = o;
            o += EL_NR * (size_t)n[j] + (n[j] + 1) / 2;  // records, then flags
        }
        words = o;
    }
};

template <class K>
static cudaError_t scan_prepare(K kernel, size_t bytes) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// One prefix: the lanes' blocks (level 0), then, where a segment crosses a
// block, each level's block totals in turn (scanned in place) until one
// block, of the fewest lanes, a power of two, takes a level.  Fills lv.
template <bool AFF, class In>
static int prefix(In in, int B, int seg, double* ws, const WsLayout& o, Levels& lv,
                  cudaStream_t st) {
    cudaError_t err;
    const auto rec = [&](int j) { return ws + o.lv[j]; };
    const auto flg = [&](int j) { return reinterpret_cast<int*>(ws + o.lv[j] + EL_NR * o.n[j]); };
    const bool carries = B > SCAN_LB && SCAN_LB % seg != 0;
    lv.pre[0] = ws + o.pre;
    lv.flag[0] = nullptr;
    lv.top = 0;
    lv.seg = seg;
    auto lanes = primal_scan_kernel<AFF, In>;
    auto totals = primal_scan_kernel<AFF, RecIn<AFF>>;
    if ((err = scan_prepare(lanes, scan_bytes(SCAN_LB))) != cudaSuccess ||
        (err = scan_prepare(totals, scan_bytes(SCAN_LB))) != cudaSuccess)
        return (int)err;
    lanes<<<o.n[1], SCAN_LB * G, scan_bytes(SCAN_LB), st>>>(
        in, B, seg, nullptr, ws + o.pre, carries ? rec(1) : nullptr, carries ? flg(1) : nullptr);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    for (int j = 1; carries; ++j) {
        const bool last = o.n[j] <= SCAN_LB || j + 1 == MAX_LEVELS;
        int lb = SCAN_LB;
        if (last)
            for (lb = 1; lb < o.n[j];) lb <<= 1;
        totals<<<(o.n[j] + lb - 1) / lb, lb * G, scan_bytes(lb), st>>>(
            RecIn<AFF>{rec(j)}, o.n[j], 0, flg(j), rec(j), last ? nullptr : rec(j + 1),
            last ? nullptr : flg(j + 1));
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
        lv.pre[j] = rec(j);
        lv.flag[j] = flg(j);
        lv.top = j;
        if (last) break;
    }
    return 0;
}

template <typename T>
static int launch(const T* cf, const T* t, const T* tl, const T* dt, const T* dg, const T* m,
                  const T* y, int L, int B, int jr, int seg, void* ws_, T* quad, T* ld, T* mind,
                  void* stream) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const size_t b = (size_t)B;
    const WsLayout o(B);
    double* ws = static_cast<double*>(ws_);
    T* A = reinterpret_cast<T*>(ws);
    T *J = A + PP * b, *C = J + PP * b;
    double* sh0 = ws + o.sh0;
    T* M = reinterpret_cast<T*>(ws + o.st);
    T *Qm = M + PP * b, *mv = Qm + PP * b, *qv = mv + P * b, *mn = qv + P * b;
    double* q0 = ws + o.st + (2 * PP + 2 * P + 1) * b;
    double* lds = q0 + b;
    const dim3 groups((unsigned)((b * G + 127) / 128));
    Levels lv;
    int err;
    if ((err = launch_fwd(elem_fwd_kernel<T, 4>, elem_fwd_kernel<T, 1>, B, stream, cf, seg, t,
                          tl, dt, dg, m, L, B, jr, A, J, C, static_cast<T*>(nullptr))))
        return err;
    if ((err = prefix<false>(ElemIn<T>{A, J, C, B}, B, seg, ws, o, lv, st))) return err;
    primal_seed_kernel<<<groups, 128, 0, st>>>(lv, B, sh0);
    if ((err = (int)cudaGetLastError())) return err;
    if ((err = launch_fwd(factor_fwd_kernel<T, 4>, factor_fwd_kernel<T, 1>, B, stream, cf, seg,
                          t, tl, dt, dg, m, y, L, B, jr, static_cast<const double*>(sh0), M, mv,
                          Qm, qv, q0, lds, mn, static_cast<T*>(nullptr))))
        return err;
    if ((err = prefix<true>(AffIn<T>{M, mv, B}, B, seg, ws, o, lv, st))) return err;
    primal_assemble_kernel<T><<<groups, 128, 0, st>>>(lv, Qm, qv, q0, lds, mn, B, quad, ld, mind);
    return (int)cudaGetLastError();
}

extern "C" {

int celerite_fused4_width() { return P; }

// float64 words of the primal's workspace for B lanes.
long long celerite_fused4_primal_ws(int B) { return (long long)WsLayout(B).words; }

int celerite_fused4_primal_f32(const void* cf, const void* t, const void* tl, const void* dt,
                               const void* dg, const void* m, const void* y, void* ws,
                               void* quad, void* ld, void* mind, int L, int B, int jr,
                               int seg, void* stream) {
    return launch<float>(static_cast<const float*>(cf), static_cast<const float*>(t),
                         static_cast<const float*>(tl), static_cast<const float*>(dt),
                         static_cast<const float*>(dg), static_cast<const float*>(m),
                         static_cast<const float*>(y), L, B, jr, seg, ws,
                         static_cast<float*>(quad), static_cast<float*>(ld),
                         static_cast<float*>(mind), stream);
}

int celerite_fused4_primal_f64(const void* cf, const void* t, const void* tl, const void* dt,
                               const void* dg, const void* m, const void* y, void* ws,
                               void* quad, void* ld, void* mind, int L, int B, int jr,
                               int seg, void* stream) {
    return launch<double>(static_cast<const double*>(cf), static_cast<const double*>(t),
                          static_cast<const double*>(tl), static_cast<const double*>(dt),
                          static_cast<const double*>(dg), static_cast<const double*>(m),
                          static_cast<const double*>(y), L, B, jr, seg, ws,
                          static_cast<double*>(quad), static_cast<double*>(ld),
                          static_cast<double*>(mind), stream);
}

}  // extern "C"
