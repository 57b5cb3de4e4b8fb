// Exact mode for Hopper (sm_90a): the log-likelihood's per-lane sweeps with
// forward-mode tangents, in float64.
//
// Replaces the Pallas kernels of celerite_tpu/ops/dsfused.py:
//   elem_ds_kernel    <- _elem_kernel   (dsfused.py:379)
//   factor_ds_kernel  <- _factor_kernel (dsfused.py:432)
// The JAX kernels carry every stream and recursion as a dual of
// double-single words because the TPU has no float64.  The card computes
// float64 natively, so these carry a float64 value and float64 tangents:
// the value is the fused4 sweep (fused4_grad.cu's elem_fwd / factor_fwd
// without saves) on the raw-jitter coefficient layout, each tangent its
// derivative along a unit seed on packed coefficient toff + j.  The
// cross-lane prefixes between the two kernels and the assembly after them
// run as float64 torch glue in forward mode (celerite_torch/ops/dsfused.py).
//
// Design.  A block runs LB = 32 / G lanes (G = 1, 2, 4, 8 threads a lane for
// P <= 8; 16 up to P = 12) and every direction of the launch: warp 0 is the
// value warp, a group of G threads a lane; warp 1 + j holds direction j for
// the same LB lanes, so a warp keeps one role and one seed.  Thread r of a
// group owns row r of every P x P state.  The lanes' steps go by tiles of K:
//  - the value warp copies a tile's slice of the (L, B) streams into shared
//    memory with cp.async, two tiles ahead, and lowers it there once, a
//    thread per (step, lane, real column or complex pair): u, v, phi, a and
//    what the tangents need (t + t_lo, dt, m), with the coefficients kept
//    in shared memory, not in registers;
//  - it then sweeps the tile's value recursion and publishes per step what
//    the tangents need of it: d, 1 / d, w (P) and u^T Phi A (elem) or z0,
//    w and (Phi M)^T u (factor), and the step's start rows of Sh and of A
//    or M (and m);
//  - the tangent warps sweep the previous tile meanwhile, reading the value
//    from those records with no shuffle and no division; each shuffles only
//    for its tangent's own sums over rows.  The lowering's tangent is
//    computed per direction from the tile (no transcendental), on the
//    seed's one or two columns only.
// A named barrier per tile hands the tile over: the lowered and published
// rings hold two tiles, the stream ring two.
//
// Registers.  At P = 8 and T = 17 a block is 18 warps, five on some of the
// SM's four schedulers, whose 16K registers then give a thread 96.  So the
// tangent warps do not keep their own copy of the value rows (32 registers;
// they spilled), and what is only accumulated, never read back by the
// recursion, stays in shared memory: the value's J or Qm, a factor
// tangent's Qm, qv and the minimum pivot, and the Kahan-compensated quad and
// log-det, whose terms a step leaves and the tile's end adds.  The value
// warp's rows wait in shared memory between tiles, while it lowers.
//
// Arithmetic.  One reciprocal of d a step replaces every division but
// w = (v - S u) / d, which keeps its division: w feeds the Riccati
// recursion, whose cancelling pivots amplify a rounding difference, and the
// plain versions divide there.  Sums over rows whose every column each row
// needs are reduce-scatters (G - 1 shuffles, where a butterfly per column
// took P log2 G) followed by a broadcast per column.  T = 0 launches the
// value warp alone.  Outputs carry a word axis: word 0 the value, word 1 + j
// direction j, at ((w * P + i) * P + j) * B + l.
//
// Bound.  Bytes: each of the (1 + T) words of the per-lane outputs once, and
// the five or six (L, B) streams once (the factor also reads the 1 + T seed
// words): at config[2]'s exact-mode plan (16 chains x 128 lanes, 782
// steps, P = 8, T = 17) ~64 MB of streams and ~57 MB of output words a
// kernel, ~0.04 ms at 3.35 TB/s.  Operations: the value step once a point
// and the tangent step T times, ~1.0 x 10^3 flops a point and ~1.5-1.6 x
// 10^3 a point and direction at P = 8, what a unit seed needs (its own
// terms O(P), chip_smoke.ds_bound_ms), ~4.3-4.6 x 10^10 a launch, ~1.3 ms
// at 34 TFLOP/s float64: the function is bound by operations.  Each
// step of a lane depends on the one before, so a launch of few lanes is
// bound by a step's latency instead.
//
// Rounding: the default fma contraction.  The float64 bar against the plain
// versions is 1e-10; a contraction, or a product by 1 / d for a quotient,
// moves a step by ~1e-16 relative, which the solver's cancelling pivots
// amplify ~1e3 times at most.
//
// Compiled once per padded width: nvcc -DCELERITE_P=<P> (1 <= P <= 12).

#include "fused4_common.cuh"

static_assert(P <= 12, "padded width must be in [1, 12]");

typedef double R;

constexpr unsigned FULL = 0xffffffffu;
// Lanes a block (a warp of value groups) and steps a tile.
constexpr int LB = 32 / G;
constexpr int K = 8;
// Most directions a launch (the coefficient count at width P) and the
// largest block: the value warp and a warp a direction.
constexpr int MAX_THREADS = 32 * (2 * P + 2);

// The streams a tile copies: t, t_lo, dt, diag, mask and (factor) y.
constexpr int NS = 6;
// Fields of a lowered step, each LB lanes wide: u, v, phi (P each), a,
// t + t_lo, dt, m, y.
constexpr int FU = 0, FV = P, FPH = 2 * P, FA = 3 * P, FANG = FA + 1, FDT = FA + 2,
              FM = FA + 3, FY = FA + 4, NF = FA + 5;
// Fields the value warp publishes a step, each LB lanes wide: d, 1 / d,
// z0, w (P), uA or gv (P), and at the step's start m (P, the factor's) and
// the rows of Sh and of A or M (P x P each, a column's rows together).
constexpr int QD = 0, QRD = 1, QZ = 2, QW = 3, QG = QW + P, QM = QG + P, QS = QM + P,
              QA = QS + PP, NQ = QA + PP;

// Shared memory in doubles, at offsets known when compiling: the
// coefficients, the value warp's rows between tiles, two tiles of each
// ring (the published ring only with tangents), then each warp's buffer:
// the factor's Kahan sums and their terms, entry r of qv (or its tangent)
// and of the minimum pivot, and the rows of an accumulated output (the
// value's J or Qm, a factor tangent's Qm).
static_assert(sizeof(Coeffs<R>) == sizeof(R) * (4 * P + 1), "Coeffs<R> is 4P + 1 doubles");
constexpr int SM_COEF = LB * (4 * P + 1);
constexpr int SM_STASH = 32 * (2 * P + 1);
constexpr int SM_SB = NS * K * LB;
constexpr int SM_LOW = K * NF * LB;
constexpr int SM_PUB = K * NQ * LB;
constexpr int KB_INC = LB * 4, KB_QV = KB_INC + LB * 2 * K, KB_MIN = KB_QV + 32,
              KB_ACC = KB_MIN + 32, SM_KB = KB_ACC + 32 * P;
constexpr int OFF_STASH = SM_COEF, OFF_SB = OFF_STASH + SM_STASH,
              OFF_LOW = OFF_SB + 2 * SM_SB, OFF_PUB = OFF_LOW + 2 * SM_LOW;
__host__ __device__ constexpr int off_kb(bool tangents) {
    return OFF_PUB + (tangents ? 2 * SM_PUB : 0);
}
constexpr size_t smem_bytes(int T) { return sizeof(R) * (off_kb(T > 0) + (1 + T) * SM_KB); }

extern __shared__ __align__(16) R ds_smem[];

// ---------------------------------------------------------------------------
// The block's layout (copies and barriers: fused4_common.cuh)
// ---------------------------------------------------------------------------

// threadIdx.x read anew at each call: what derives from it is recomputed
// after the sweep instead of held in a register through it.
__device__ __forceinline__ unsigned tid_now() {
    unsigned t;
    asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(t));
    return t;
}

// Row r of word w of a (1 + T, P, P, B) output, lane l.
__device__ __forceinline__ void put_row(R* __restrict__ out, int w, int r, int B, int l,
                                        const R (&a)[P]) {
    R* p = out + ((size_t)w * PP + (size_t)r * P) * B + l;
#pragma unroll
    for (int j = 0; j < P; ++j) p[(size_t)j * B] = a[j];
}

__device__ __forceinline__ void get_row(const R* __restrict__ in, int w, int r, int B, int l,
                                        R (&a)[P]) {
#pragma unroll
    for (int j = 0; j < P; ++j) a[j] = R(0);
    if (r >= P) return;
    const R* p = in + ((size_t)w * PP + (size_t)r * P) * B + l;
#pragma unroll
    for (int j = 0; j < P; ++j) a[j] = p[(size_t)j * B];
}

// This thread's place: lane q of the block's LB (global lane l, read as lc,
// which dead lanes past B clamp to B - 1 and never write), row r, and its
// warp's buffer.
struct Ctx {
    R* kb;
    int L, B, jr, l0, q, r, l, lc;
    bool live, row;
};

template <bool TAN>
__device__ __forceinline__ Ctx make_ctx(int L, int B, int jr) {
    Ctx c;
    const unsigned tid = tid_now();
    c.kb = ds_smem + off_kb(TAN) + (tid / 32) * SM_KB;
    c.L = L;
    c.B = B;
    c.jr = jr;
    c.l0 = blockIdx.x * LB;
    c.q = (tid & 31) / G;
    c.r = tid % G;
    c.l = c.l0 + c.q;
    c.live = c.l < B;
    c.lc = c.live ? c.l : B - 1;
    c.row = c.r < P;
    return c;
}

// Lowered step s of the tile in ring slot `tile`, and its published record;
// field f of this lane at [f * LB].
__device__ __forceinline__ const R* step_rec(const Ctx& c, int tile, int s) {
    return ds_smem + OFF_LOW + (tile & 1) * SM_LOW + s * NF * LB + c.q;
}
__device__ __forceinline__ R* pub_rec(const Ctx& c, int tile, int s) {
    return ds_smem + OFF_PUB + (tile & 1) * SM_PUB + s * NQ * LB + c.q;
}

__device__ __forceinline__ Coeffs<R>* coef() { return reinterpret_cast<Coeffs<R>*>(ds_smem); }

// The value warp's rows of Sh and of A or M and its entry r of m live in
// registers through a tile's sweep and here between sweeps, so that the
// lowering between them has the registers.
__device__ __forceinline__ R& stash(int k) {
    return ds_smem[OFF_STASH + k * 32 + (threadIdx.x & 31)];
}
__device__ __forceinline__ void stash_put(const R (&Sh)[P], const R (&A)[P], R m) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
        stash(j) = Sh[j];
        stash(P + j) = A[j];
    }
    stash(2 * P) = m;
}
__device__ __forceinline__ void stash_get(R (&Sh)[P], R (&A)[P], R& m) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
        Sh[j] = stash(j);
        A[j] = stash(P + j);
    }
    m = stash(2 * P);
}

__device__ __forceinline__ int tile_steps(const Ctx& c, int tile) {
    return min(K, c.L - tile * K);
}

// The factor's Kahan-compensated sums (quad and log-det, of the value or of
// one tangent) leave the registers of the sweep: a step puts its two terms
// in the warp's buffer (the value's log-det term as d, whose log the tile's
// end takes), and the tile's end adds them in order to the lane's sums and
// compensations, which the buffer holds between tiles.  Thread 0 of each
// group does both.
__device__ __forceinline__ R* kahan_state(const Ctx& c) { return c.kb + c.q * 4; }

__device__ __forceinline__ void kahan_init(const Ctx& c) {
    if (c.r != 0) return;
    R* st = kahan_state(c);
    st[0] = st[1] = st[2] = st[3] = R(0);
}

__device__ __forceinline__ void kahan_put(const Ctx& c, int s, R x1, R x2) {
    if (c.r != 0) return;
    R* p = c.kb + KB_INC + (s * LB + c.q) * 2;
    p[0] = x1;
    p[1] = x2;
}

// Row r of an accumulated P x P output in the warp's buffer, column j at
// [j * 32]; a factor warp's entry r of qv (or of its tangent) and the
// value's minimum pivot.
__device__ __forceinline__ R& acc(const Ctx& c, int j) {
    return c.kb[KB_ACC + j * 32 + (threadIdx.x & 31)];
}
__device__ __forceinline__ void acc_init(const Ctx& c) {
#pragma unroll
    for (int j = 0; j < P; ++j) acc(c, j) = R(0);
}
__device__ __forceinline__ void acc_row(const Ctx& c, R (&a)[P]) {
#pragma unroll
    for (int j = 0; j < P; ++j) a[j] = acc(c, j);
}
__device__ __forceinline__ R& qv_acc(const Ctx& c) { return c.kb[KB_QV + (threadIdx.x & 31)]; }
__device__ __forceinline__ R& min_pivot(const Ctx& c) { return c.kb[KB_MIN + (threadIdx.x & 31)]; }

template <bool LOG>
__device__ __forceinline__ void kahan_tile(const Ctx& c, int n) {
    if (c.r != 0) return;
    R* st = kahan_state(c);
    R s1 = st[0], c1 = st[1], s2 = st[2], c2 = st[3];
    for (int s = 0; s < n; ++s) {
        const R* p = c.kb + KB_INC + (s * LB + c.q) * 2;
        const R y1 = p[0] - c1;
        const R t1 = s1 + y1;
        c1 = (t1 - s1) - y1;
        s1 = t1;
        const R y2 = (LOG ? dlog(p[1]) : p[1]) - c2;
        const R t2 = s2 + y2;
        c2 = (t2 - s2) - y2;
        s2 = t2;
    }
    st[0] = s1;
    st[1] = c1;
    st[2] = s2;
    st[3] = c2;
}

// ---------------------------------------------------------------------------
// The value warp's tile work: coefficients, copies, the lowering
// ---------------------------------------------------------------------------

// Each lane's coefficient row (pack_cf_ds, one row per segment of seg lanes).
__device__ __forceinline__ void load_lane_coeffs(const Ctx& c, const R* __restrict__ cf, int seg) {
    const int lane = threadIdx.x & 31;
    if (lane < LB) {
        const int l = min(c.l0 + lane, c.B - 1);
        load_coeffs_ds(cf + (size_t)(l / seg) * (2 * P + 1), c.jr, coef()[lane]);
    }
}

// The tile's slice of the streams into its ring slot (y may be null); one
// cp.async group a tile, empty past the end.
__device__ __forceinline__ void prefetch_tile(const Ctx& c, const R* t, const R* tl, const R* dt,
                                              const R* dg, const R* msk, const R* y, int tile) {
    R* sb = ds_smem + OFF_SB + (tile & 1) * SM_SB;
    const int lane = threadIdx.x & 31, s0 = tile * K;
    const R* st[NS] = {t, tl, dt, dg, msk, y};
#pragma unroll
    for (int k = 0; k < NS; ++k) {
        if (st[k] == nullptr) continue;
        for (int i = lane; i < K * LB; i += 32) {
            const int s = s0 + i / LB;
            if (s < c.L)
                cp_async(sb + k * K * LB + i,
                         st[k] + (size_t)s * c.B + min(c.l0 + i % LB, c.B - 1));
        }
    }
    cp_async_commit();
}

// Lower the tile in ring slot `tile` (its streams arrived): the arithmetic
// of fused4._lower_step, a thread per (step, lane, real column
// or complex pair), then a thread per (step, lane) for the scalars.
__device__ __forceinline__ void lower_tile(const Ctx& c, int tile, bool with_y) {
    const R* sb = ds_smem + OFF_SB + (tile & 1) * SM_SB;
    R* low = ds_smem + OFF_LOW + (tile & 1) * SM_LOW;
    const int lane = threadIdx.x & 31, n = tile_steps(c, tile) * LB;
    const int jr = c.jr, nc = jr + (P - jr) / 2;
    auto in = [&](int k, int i) { return sb[k * K * LB + i]; };
    for (int i = lane; i < n; i += 32) {
        const int q = i % LB;
        R* o = low + (i / LB) * NF * LB + q;
        const R m = in(4, i);
        o[FA * LB] = m * (in(3, i) + coef()[q].total) + (R(1) - m);
        o[FANG * LB] = in(0, i) + in(1, i);
        o[FDT * LB] = in(2, i);
        o[FM * LB] = m;
        if (with_y) o[FY * LB] = in(5, i);
    }
    for (int x = lane; x < n * nc; x += 32) {
        const int i = x % n, q = i % LB, kc = x / n;
        const Coeffs<R>& k = coef()[q];
        R* o = low + (i / LB) * NF * LB + q;
        const R m = in(4, i), dts = in(2, i);
        if (kc < jr) {
            o[(FU + kc) * LB] = k.c0[kc] * m;
            o[(FV + kc) * LB] = m;
            o[(FPH + kc) * LB] = dexp(-k.c1[kc] * dts);
        } else {
            const int col = jr + 2 * (kc - jr);
            R cm, sm, p;
            pair_rot(k.c2[col], k.c3[col], in(0, i), in(1, i), dts, m, cm, sm, p);
            o[(FU + col) * LB] = k.c0[col] * cm + k.c1[col] * sm;
            o[(FV + col) * LB] = cm;
            o[(FPH + col) * LB] = p;
            o[(FU + col + 1) * LB] = k.c0[col] * sm - k.c1[col] * cm;
            o[(FV + col + 1) * LB] = sm;
            o[(FPH + col + 1) * LB] = p;
        }
    }
}

// The value warp's pipeline: each tile's streams are copied two tiles
// ahead; the tile is lowered and swept (sweep(tile, n) runs its value
// steps), and the barrier after it hands it to the tangent warps, which
// sweep it while this warp goes on with the next.  The block's barriers
// number 1 + tiles.
template <class Sweep>
__device__ __forceinline__ void value_pipeline(const Ctx& c, const R* t, const R* tl,
                                               const R* dt, const R* dg, const R* msk,
                                               const R* y, Sweep&& sweep) {
    const int ntiles = (c.L + K - 1) / K;
    if (c.L > 0) {
        prefetch_tile(c, t, tl, dt, dg, msk, y, 0);
        prefetch_tile(c, t, tl, dt, dg, msk, y, 1);
    }
    for (int k = 0; k <= ntiles; ++k) {
        if (k < ntiles) {
            cp_async_wait<1>();
            __syncwarp();
            lower_tile(c, k, y != nullptr);
            __syncwarp();
            prefetch_tile(c, t, tl, dt, dg, msk, y, k + 2);
            sweep(k, tile_steps(c, k));
        }
        tile_barrier();
    }
    cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// Sums over a group's rows
// ---------------------------------------------------------------------------

// Reduce-scatter: returns to thread r the group's sum of x(r), x(j) given
// by a functor for j < P (0 past P).  Each round halves the columns a
// thread keeps, G - 1 shuffles in all; the first round takes the columns
// in pairs as x gives them, so no thread holds all G at once.
template <class X>
__device__ __forceinline__ R scatter_sum(X&& x_of, int r) {
    if constexpr (G == 1) {
        return x_of(0);
    } else {
        constexpr int H = G / 2;
        R x[H];
        const bool hi = (r & H) != 0;
#pragma unroll
        for (int i = 0; i < H; ++i) {
            const R a = i < P ? x_of(i) : R(0);
            const R b = i + H < P ? x_of(i + H) : R(0);
            x[i] = (hi ? b : a) + __shfl_xor_sync(FULL, hi ? a : b, H, G);
        }
#pragma unroll
        for (int n = H; n > 1; n >>= 1) {
            const int o = n / 2;
            const bool up = (r & o) != 0;
#pragma unroll
            for (int i = 0; i < o; ++i) {
                const R send = up ? x[i] : x[i + o];
                const R keep = up ? x[i + o] : x[i];
                x[i] = keep + __shfl_xor_sync(FULL, send, o, G);
            }
        }
        return x[0];
    }
}

__device__ __forceinline__ R from_row(R x, int j) { return __shfl_sync(FULL, x, j, G); }

// ---------------------------------------------------------------------------
// A tangent's seed and the lowering's tangent on its columns
// ---------------------------------------------------------------------------

// decode_seed's seed with the columns it moves (c1 < 0: one column; c0 < 0:
// none, the jitter).  dph: the seed moves phi (c_real, c_comp), else u, v
// or a.
struct TanSeed {
    int kind, c0, c1;
    bool dph;
};

__device__ __forceinline__ TanSeed tan_seed(const Ctx& c, int kk) {
    const Seed sd = decode_seed(kk, c.jr);
    TanSeed s;
    s.kind = sd.kind;
    s.c0 = sd.col;
    s.c1 = (sd.kind >= 2 && sd.kind <= 5) ? sd.col + 1 : -1;
    s.dph = sd.kind == 1 || sd.kind == 4;
    return s;
}

// The lowering's tangent along the seed, on its columns only: du, dv at c0
// and c1, dph (both columns alike), da.  A complex pair's (cos, sin) * m are
// its columns of v and its decay is phi, so d(phi)/d(c) = -dt phi and
// d(angle)/d(d) = t + t_lo (celerite_tpu/ops/dsfused.py:320-328); pads
// (m = 0) get zero tangents.
struct TanCols {
    R du0, du1, dv0, dv1, g, da;
};

__device__ __forceinline__ TanCols tan_cols(const Ctx& c, const TanSeed& s, const R* rec) {
    TanCols t{R(0), R(0), R(0), R(0), R(0), R(0)};
    const R m = rec[FM * LB];
    switch (s.kind) {
        case 0:
            t.du0 = m;
            t.da = m;
            break;
        case 1:
        case 4:
            t.g = -rec[FDT * LB] * rec[(FPH + s.c0) * LB];
            break;
        case 2:
            t.du0 = rec[(FV + s.c0) * LB];
            t.du1 = rec[(FV + s.c1) * LB];
            t.da = m;
            break;
        case 3:
            t.du0 = rec[(FV + s.c1) * LB];
            t.du1 = -rec[(FV + s.c0) * LB];
            break;
        case 5: {
            const R cm = rec[(FV + s.c0) * LB], sm = rec[(FV + s.c1) * LB];
            const R ang = rec[FANG * LB];
            const R dcm = -sm * ang, dsm = cm * ang;
            const R ca = coef()[c.q].c0[s.c0], cb = coef()[c.q].c1[s.c0];
            t.du0 = ca * dcm + cb * dsm;
            t.du1 = ca * dsm - cb * dcm;
            t.dv0 = dcm;
            t.dv1 = dsm;
            break;
        }
        case 6:
            t.da = m;
            break;
        default:
            break;
    }
    return t;
}

__device__ __forceinline__ R on_cols(const TanSeed& s, int j, R x0, R x1) {
    return j == s.c0 ? x0 : (j == s.c1 ? x1 : R(0));
}

// ---------------------------------------------------------------------------
// The value rows a tangent step reads: row r of Sh, of A (elem) or M
// (factor) and entry r of m at the step's start, from the value warp's
// record of the step.
// ---------------------------------------------------------------------------

__device__ __forceinline__ R sh_at(const Ctx& c, const R* pb, int j) {
    return c.row ? pb[(QS + j * P + c.r) * LB] : R(0);
}

// Row r of A or M, read only where the tangent multiplies it by a nonzero
// (the seed's rows), else 0.
__device__ __forceinline__ R a_at(const Ctx& c, const R* pb, int j, bool seedrow) {
    return seedrow ? pb[(QA + j * P + c.r) * LB] : R(0);
}

__device__ __forceinline__ R m_at(const Ctx& c, const R* pb) {
    return c.row ? pb[(QM + c.r) * LB] : R(0);
}

// ---------------------------------------------------------------------------
// The Riccati step, value and tangent, in row-parallel form
// ---------------------------------------------------------------------------

// Value: Sh <- Phi Sh Phi + d w w^T.  Returns d; leaves 1 / d, S u (row r)
// and w_r.
__device__ __forceinline__ R riccati_value(const Ctx& c, const R* rec, R (&Sh)[P], R phr,
                                           R ur, R& rd, R& su, R& wr) {
    const int rr = c.row ? c.r : 0;
    su = R(0);
#pragma unroll
    for (int j = 0; j < P; ++j) {
        Sh[j] = phr * Sh[j] * rec[(FPH + j) * LB];
        su += Sh[j] * rec[(FU + j) * LB];
    }
    const R d = rec[FA * LB] - group_sum(ur * su);
    rd = R(1) / d;
    wr = c.row ? (rec[(FV + rr) * LB] - su) / d : R(0);
#pragma unroll
    for (int j = 0; j < P; ++j) Sh[j] = Sh[j] + d * wr * from_row(wr, j);
    return d;
}

// The tangent of the Riccati step along one seed: the value's row of Sh,
// d, 1 / d and w from the value warp's record.  (dphr, dur, dvr) are row
// r's of the lowering's tangent.  Returns dd; leaves d, 1 / d, w_r, dw_r.
template <bool DPH>
__device__ __forceinline__ R riccati_tangent(const Ctx& c, const TanSeed& sd, const TanCols& tc,
                                             const R* rec, const R* pb, R (&dSh)[P], R phr, R ur,
                                             R dphr, R dur, R dvr, R& d, R& rd, R& wr, R& dwr) {
    const int rr = c.row ? c.r : 0;
    R su = R(0), dsu = R(0);
#pragma unroll
    for (int j = 0; j < P; ++j) {
        const R phj = rec[(FPH + j) * LB], uj = rec[(FU + j) * LB];
        const R shj = sh_at(c, pb, j);
        const R S = phr * shj * phj;
        R dS;
        if constexpr (DPH)
            dS = dphr * shj * phj + phr * dSh[j] * phj + phr * shj * on_cols(sd, j, tc.g, tc.g);
        else
            dS = phr * dSh[j] * phj;
        dSh[j] = dS;
        su += S * uj;
        dsu += dS * uj;
        if constexpr (!DPH) dsu += S * on_cols(sd, j, tc.du0, tc.du1);
    }
    R dd;
    if constexpr (DPH)
        dd = tc.da - group_sum(ur * dsu);
    else
        dd = tc.da - group_sum(dur * su + ur * dsu);
    d = pb[QD * LB];
    rd = pb[QRD * LB];
    wr = c.row ? pb[(QW + rr) * LB] : R(0);
    dwr = c.row ? ((dvr - dsu) - wr * dd) * rd : R(0);
#pragma unroll
    for (int j = 0; j < P; ++j) {
        const R wj = pb[(QW + j) * LB];
        const R dwj = from_row(dwr, j);
        dSh[j] = dSh[j] + dd * wr * wj + d * (dwr * wj + wr * dwj);
    }
    return dd;
}

// The step's start rows of Sh and of A or M into the value warp's record.
__device__ __forceinline__ void publish_rows(const Ctx& c, R* pb, const R (&Sh)[P],
                                             const R (&A)[P]) {
    if (!c.row) return;
#pragma unroll
    for (int j = 0; j < P; ++j) {
        pb[(QS + j * P + c.r) * LB] = Sh[j];
        pb[(QA + j * P + c.r) * LB] = A[j];
    }
}

// ---------------------------------------------------------------------------
// elem_ds: phase 0 (each lane's Riccati element A, J, C) with tangents.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void elem_value_step(const Ctx& c, const R* rec, R* pb, bool publish,
                                                R (&Sh)[P], R (&A)[P]) {
    const int rr = c.row ? c.r : 0;
    if (publish) publish_rows(c, pb, Sh, A);
    const R phr = c.row ? rec[(FPH + rr) * LB] : R(0);
    const R ur = c.row ? rec[(FU + rr) * LB] : R(0);
    R rd, su, wr;
    const R d = riccati_value(c, rec, Sh, phr, ur, rd, su, wr);
    // uA = A^T (Phi u), column r to thread r.
    const R utr = phr * ur;
    const R uAr = scatter_sum([&](int j) { return A[j] * utr; }, c.r);
#pragma unroll
    for (int j = 0; j < P; ++j) {
        const R uAj = from_row(uAr, j);
        A[j] = phr * A[j] - wr * uAj;
        acc(c, j) = acc(c, j) - uAr * (uAj * rd);
    }
    if (!publish) return;
    if (c.r == 0) {
        pb[QD * LB] = d;
        pb[QRD * LB] = rd;
    }
    if (c.row) {
        pb[(QW + rr) * LB] = wr;
        pb[(QG + rr) * LB] = uAr;
    }
}

template <bool DPH>
__device__ __forceinline__ void elem_tan_step(const Ctx& c, const TanSeed& sd, const R* rec,
                                              const R* pb, R (&dSh)[P], R (&dA)[P], R (&dJ)[P]) {
    const int rr = c.row ? c.r : 0;
    const bool seedrow = c.r == sd.c0 || c.r == sd.c1;
    const TanCols tc = tan_cols(c, sd, rec);
    const R phr = c.row ? rec[(FPH + rr) * LB] : R(0);
    const R ur = c.row ? rec[(FU + rr) * LB] : R(0);
    const R dphr = DPH ? on_cols(sd, c.r, tc.g, tc.g) : R(0);
    const R dur = DPH ? R(0) : on_cols(sd, c.r, tc.du0, tc.du1);
    const R dvr = DPH ? R(0) : on_cols(sd, c.r, tc.dv0, tc.dv1);
    R d, rd, wr, dwr;
    const R dd =
        riccati_tangent<DPH>(c, sd, tc, rec, pb, dSh, phr, ur, dphr, dur, dvr, d, rd, wr, dwr);
    // uA's tangent, column r to thread r; the value's A enters on the
    // seed's rows only.
    const R utr = phr * ur;
    const R dutr = DPH ? dphr * ur : phr * dur;
    const R duAr = scatter_sum(
        [&](int j) { return dA[j] * utr + a_at(c, pb, j, seedrow) * dutr; }, c.r);
    const R uAr = c.row ? pb[(QG + rr) * LB] : R(0);
    // dJ += a uA^T + b duA^T, row r.
    const R a = uAr * (dd * rd * rd) - duAr * rd, b = -uAr * rd;
#pragma unroll
    for (int j = 0; j < P; ++j) {
        const R uAj = pb[(QG + j) * LB];
        const R duAj = from_row(duAr, j);
        if constexpr (DPH)
            dA[j] = dphr * a_at(c, pb, j, seedrow) + phr * dA[j] - dwr * uAj - wr * duAj;
        else
            dA[j] = phr * dA[j] - dwr * uAj - wr * duAj;
        dJ[j] = dJ[j] + a * uAj + b * duAj;
    }
}

// A tangent warp's sweep of one tile, on the seed's class.
__device__ __forceinline__ void elem_tan_tile(const Ctx& c, const TanSeed& sd, int tile, int n,
                                              R (&dSh)[P], R (&dA)[P], R (&dJ)[P]) {
    if (sd.dph) {
        for (int s = 0; s < n; ++s)
            elem_tan_step<true>(c, sd, step_rec(c, tile, s), pub_rec(c, tile, s), dSh, dA, dJ);
    } else {
        for (int s = 0; s < n; ++s)
            elem_tan_step<false>(c, sd, step_rec(c, tile, s), pub_rec(c, tile, s), dSh, dA, dJ);
    }
}

template <bool TAN>
__global__ void __launch_bounds__(TAN ? MAX_THREADS : 32, 1)
elem_ds_kernel(const R* __restrict__ cf, int seg, const R* __restrict__ t,
               const R* __restrict__ tl, const R* __restrict__ dt, const R* __restrict__ dg,
               const R* __restrict__ msk, int L, int B, int jr, int toff, int T,
               R* __restrict__ A_out, R* __restrict__ J_out, R* __restrict__ C_out) {
    const Ctx c = make_ctx<TAN>(L, B, jr);
    const int r = c.r;

    if (threadIdx.x < 32) {
        // The value warp.
        {
            R Sh[P], A[P];
#pragma unroll
            for (int j = 0; j < P; ++j) {
                Sh[j] = R(0);
                A[j] = j == r ? R(1) : R(0);
            }
            stash_put(Sh, A, R(0));
        }
        acc_init(c);
        load_lane_coeffs(c, cf, seg);
        __syncwarp();
        value_pipeline(c, t, tl, dt, dg, msk, nullptr, [&](int tile, int n) {
            R Sh[P], A[P], m;
            stash_get(Sh, A, m);
            for (int s = 0; s < n; ++s)
                elem_value_step(c, step_rec(c, tile, s), pub_rec(c, tile, s), TAN, Sh, A);
            stash_put(Sh, A, m);
        });
        if (c.live && c.row) {
            R Sh[P], A[P], J[P], m;
            stash_get(Sh, A, m);
            acc_row(c, J);
            put_row(A_out, 0, r, B, c.l, A);
            put_row(J_out, 0, r, B, c.l, J);
            put_row(C_out, 0, r, B, c.l, Sh);
        }
        return;
    }
    if constexpr (TAN) {
        // Tangent warp of direction jd.
        const int jd = threadIdx.x / 32 - 1;
        R dSh[P], dA[P], dJ[P];
#pragma unroll
        for (int j = 0; j < P; ++j) dSh[j] = dA[j] = dJ[j] = R(0);
        tile_barrier();
        const TanSeed sd = tan_seed(c, toff + jd);
        for (int k = 0; k * K < L; ++k) {
            elem_tan_tile(c, sd, k, tile_steps(c, k), dSh, dA, dJ);
            tile_barrier();
        }
        const Ctx e = make_ctx<TAN>(L, B, jr);
        if (e.live && e.row) {
            put_row(A_out, 1 + jd, e.r, B, e.l, dA);
            put_row(J_out, 1 + jd, e.r, B, e.l, dJ);
            put_row(C_out, 1 + jd, e.r, B, e.l, dSh);
        }
    }
}

// ---------------------------------------------------------------------------
// factor_ds: phase 1 from the dual seed sh0 (1 + T, P, P, B): the affine map
// (M, m) and the statistics (Qm, qv, Kahan-summed q0 and ld) with tangents,
// and the value's minimum pivot.
// ---------------------------------------------------------------------------

// The value step: Sh, M and entry r of m carried; Qm, qv and the minimum
// pivot kept in the warp's buffer, q0 and ld Kahan-summed by tiles.
__device__ __forceinline__ void factor_value_step(const Ctx& c, int s, const R* rec, R* pb,
                                                  bool publish, R (&Sh)[P], R (&M)[P],
                                                  R& mvr) {
    const int rr = c.row ? c.r : 0;
    if (publish) {
        publish_rows(c, pb, Sh, M);
        if (c.row) pb[(QM + rr) * LB] = mvr;
    }
    const R phr = c.row ? rec[(FPH + rr) * LB] : R(0);
    const R ur = c.row ? rec[(FU + rr) * LB] : R(0);
    R rd, su, wr;
    const R d = riccati_value(c, rec, Sh, phr, ur, rd, su, wr);
    // M <- (I - w u^T) Phi M with g = (Phi M)^T u, column r to thread r.
#pragma unroll
    for (int j = 0; j < P; ++j) M[j] = phr * M[j];
    const R gr = scatter_sum([&](int j) { return M[j] * ur; }, c.r);
#pragma unroll
    for (int j = 0; j < P; ++j) {
        const R gj = from_row(gr, j);
        M[j] = M[j] - wr * gj;
        acc(c, j) = acc(c, j) + gr * (gj * rd);
    }
    // m <- Phi m + w z0 with z0 = y - u . Phi m.
    const R mh = phr * mvr;
    const R z0 = rec[FY * LB] - group_sum(ur * mh);
    const R zd = z0 * rd;
    mvr = mh + wr * z0;
    // The terms of the Kahan-compensated quad and log-det.
    kahan_put(c, s, z0 * zd, d);
    qv_acc(c) = qv_acc(c) + zd * gr;
    // NaN-propagating min, like torch.minimum.
    R& mind = min_pivot(c);
    mind = (d < mind || d != d) ? d : mind;
    if (!publish) return;
    if (c.r == 0) {
        pb[QD * LB] = d;
        pb[QRD * LB] = rd;
        pb[QZ * LB] = z0;
    }
    if (c.row) {
        pb[(QW + rr) * LB] = wr;
        pb[(QG + rr) * LB] = gr;
    }
}

// The tangent step: dSh, dM and entry r of m's tangent carried; qv's
// tangent accumulated in the warp's buffer, q0's and ld's Kahan-summed by
// tiles.
template <bool DPH>
__device__ __forceinline__ void factor_tan_step(const Ctx& c, const TanSeed& sd, int s,
                                                const R* rec, const R* pb, R (&dSh)[P],
                                                R (&dM)[P], R& dmvr) {
    const int rr = c.row ? c.r : 0;
    const bool seedrow = c.r == sd.c0 || c.r == sd.c1;
    const TanCols tc = tan_cols(c, sd, rec);
    const R phr = c.row ? rec[(FPH + rr) * LB] : R(0);
    const R ur = c.row ? rec[(FU + rr) * LB] : R(0);
    const R dphr = DPH ? on_cols(sd, c.r, tc.g, tc.g) : R(0);
    const R dur = DPH ? R(0) : on_cols(sd, c.r, tc.du0, tc.du1);
    const R dvr = DPH ? R(0) : on_cols(sd, c.r, tc.dv0, tc.dv1);
    R d, rd, wr, dwr;
    const R dd =
        riccati_tangent<DPH>(c, sd, tc, rec, pb, dSh, phr, ur, dphr, dur, dvr, d, rd, wr, dwr);
    // M's Phi and g's tangent, column r to thread r; the value's M enters
    // on the seed's rows only.
#pragma unroll
    for (int j = 0; j < P; ++j) {
        const R mj = a_at(c, pb, j, seedrow);
        if constexpr (DPH)
            dM[j] = dphr * mj + phr * dM[j];
        else
            dM[j] = phr * dM[j];
    }
    const R dgr = scatter_sum(
        [&](int j) {
            if constexpr (DPH)
                return dM[j] * ur;
            else
                return dM[j] * ur + phr * a_at(c, pb, j, seedrow) * dur;
        },
        c.r);
    const R gr = c.row ? pb[(QG + rr) * LB] : R(0);
    // m's tangent; the tangents of the Kahan-summed quad and log-det, and
    // qv's (before M's update, so that fewer values live through it).
    const R mv = m_at(c, pb);
    const R mh = phr * mv;
    const R dmh = DPH ? dphr * mv + phr * dmvr : phr * dmvr;
    const R z0 = pb[QZ * LB];
    const R dz0 = DPH ? -group_sum(ur * dmh) : -group_sum(dur * mh + ur * dmh);
    dmvr = dmh + dwr * z0 + wr * dz0;
    const R zd = z0 * rd;
    const R dzd = (dz0 - zd * dd) * rd;
    kahan_put(c, s, dz0 * zd + z0 * dzd, dd * rd);
    qv_acc(c) = qv_acc(c) + dzd * gr + zd * dgr;
    // dQm += a g^T + b dg^T, row r, in the warp's buffer; M's tangent.
    const R a = dgr * rd - gr * (dd * rd * rd), b = gr * rd;
#pragma unroll
    for (int j = 0; j < P; ++j) {
        const R gj = pb[(QG + j) * LB];
        const R dgj = from_row(dgr, j);
        dM[j] = dM[j] - dwr * gj - wr * dgj;
        acc(c, j) = acc(c, j) + a * gj + b * dgj;
    }
}

__device__ __forceinline__ void factor_tan_tile(const Ctx& c, const TanSeed& sd, int tile, int n,
                                                R (&dSh)[P], R (&dM)[P], R& dmvr) {
    if (sd.dph) {
        for (int s = 0; s < n; ++s)
            factor_tan_step<true>(c, sd, s, step_rec(c, tile, s), pub_rec(c, tile, s), dSh, dM,
                                  dmvr);
    } else {
        for (int s = 0; s < n; ++s)
            factor_tan_step<false>(c, sd, s, step_rec(c, tile, s), pub_rec(c, tile, s), dSh, dM,
                                   dmvr);
    }
    kahan_tile<false>(c, n);
}

template <bool TAN>
__global__ void __launch_bounds__(TAN ? MAX_THREADS : 32, 1)
factor_ds_kernel(const R* __restrict__ cf, int seg, const R* __restrict__ t,
                 const R* __restrict__ tl, const R* __restrict__ dt, const R* __restrict__ dg,
                 const R* __restrict__ msk, const R* __restrict__ y, int L, int B, int jr,
                 int toff, int T, const R* __restrict__ sh0, R* __restrict__ M_out,
                 R* __restrict__ m_out, R* __restrict__ Qm_out, R* __restrict__ qv_out,
                 R* __restrict__ q0_out, R* __restrict__ ld_out, R* __restrict__ mind_out) {
    const Ctx c = make_ctx<TAN>(L, B, jr);
    const int r = c.r;

    if (threadIdx.x < 32) {
        // The value warp.
        {
            R Sh[P], M[P];
            get_row(sh0, 0, r, B, c.lc, Sh);
#pragma unroll
            for (int j = 0; j < P; ++j) M[j] = j == r ? R(1) : R(0);
            stash_put(Sh, M, R(0));
        }
        acc_init(c);
        kahan_init(c);
        qv_acc(c) = R(0);
        min_pivot(c) = R(INFINITY);
        load_lane_coeffs(c, cf, seg);
        __syncwarp();
        value_pipeline(c, t, tl, dt, dg, msk, y, [&](int tile, int n) {
            R Sh[P], M[P], mvr;
            stash_get(Sh, M, mvr);
            for (int s = 0; s < n; ++s)
                factor_value_step(c, s, step_rec(c, tile, s), pub_rec(c, tile, s), TAN, Sh, M,
                                  mvr);
            stash_put(Sh, M, mvr);
            kahan_tile<true>(c, n);
        });
        if (c.live && c.row) {
            R Sh[P], M[P], Qm[P], mvr;
            stash_get(Sh, M, mvr);
            acc_row(c, Qm);
            put_row(M_out, 0, r, B, c.l, M);
            put_row(Qm_out, 0, r, B, c.l, Qm);
            m_out[(size_t)r * B + c.l] = mvr;
            qv_out[(size_t)r * B + c.l] = qv_acc(c);
            if (r == 0) {
                const R* st = kahan_state(c);
                q0_out[c.l] = st[0] + st[1];
                ld_out[c.l] = st[2] + st[3];
                mind_out[c.l] = min_pivot(c);
            }
        }
        return;
    }
    if constexpr (TAN) {
        // Tangent warp of direction jd.
        const int jd = threadIdx.x / 32 - 1;
        R dSh[P], dM[P];
        get_row(sh0, 1 + jd, r, B, c.lc, dSh);
#pragma unroll
        for (int j = 0; j < P; ++j) dM[j] = R(0);
        acc_init(c);
        R dmvr = R(0);
        kahan_init(c);
        qv_acc(c) = R(0);
        tile_barrier();
        const TanSeed sd = tan_seed(c, toff + jd);
        for (int k = 0; k * K < L; ++k) {
            factor_tan_tile(c, sd, k, tile_steps(c, k), dSh, dM, dmvr);
            tile_barrier();
        }
        const Ctx e = make_ctx<TAN>(L, B, jr);
        if (e.live && e.row) {
            const size_t w = 1 + jd;
            R dQm[P];
            acc_row(e, dQm);
            put_row(M_out, (int)w, e.r, B, e.l, dM);
            put_row(Qm_out, (int)w, e.r, B, e.l, dQm);
            m_out[(w * P + e.r) * B + e.l] = dmvr;
            qv_out[(w * P + e.r) * B + e.l] = qv_acc(e);
            if (e.r == 0) {
                const R* st = kahan_state(e);
                q0_out[w * B + e.l] = st[0] + st[1];
                ld_out[w * B + e.l] = st[2] + st[3];
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Host entry points: one launch each on the caller's stream, nothing
// allocated; cf holds one row of 2P + 1 coefficients (pack_cf_ds) per
// segment of `seg` lanes.  A block is LB lanes and 1 + T warps (T = 0
// launches the value alone) with smem_bytes(T) of dynamic shared memory,
// above the default 48 KB at P = 8 with tangents, so each entry
// raises the kernel's limit first.  Each returns the first CUDA error of
// its launch.
// ---------------------------------------------------------------------------

template <class Kernel>
static cudaError_t prepare(Kernel kernel, size_t bytes) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

static inline dim3 grid_for(int B) { return dim3((unsigned)((B + LB - 1) / LB)); }
static inline dim3 block_for(int T) { return dim3((unsigned)(32 * (1 + T))); }

extern "C" {

int celerite_dsfused_elem(const void* cf, const void* t, const void* tl, const void* dt,
                          const void* dg, const void* m, void* A, void* J, void* C, int L,
                          int B, int jr, int seg, int toff, int T, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (T < 0 || 32 * (1 + T) > MAX_THREADS) return (int)cudaErrorInvalidValue;
    auto kernel = T > 0 ? elem_ds_kernel<true> : elem_ds_kernel<false>;
    const size_t bytes = smem_bytes(T);
    const cudaError_t e = prepare(kernel, bytes);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid_for(B), block_for(T), bytes, st>>>(
        static_cast<const R*>(cf), seg, static_cast<const R*>(t), static_cast<const R*>(tl),
        static_cast<const R*>(dt), static_cast<const R*>(dg), static_cast<const R*>(m), L, B,
        jr, toff, T, static_cast<R*>(A), static_cast<R*>(J), static_cast<R*>(C));
    return (int)cudaGetLastError();
}

int celerite_dsfused_factor(const void* cf, const void* t, const void* tl, const void* dt,
                            const void* dg, const void* m, const void* y, const void* sh0,
                            void* M, void* mv, void* Qm, void* qv, void* q0, void* ld,
                            void* mind, int L, int B, int jr, int seg, int toff, int T,
                            void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (T < 0 || 32 * (1 + T) > MAX_THREADS) return (int)cudaErrorInvalidValue;
    auto kernel = T > 0 ? factor_ds_kernel<true> : factor_ds_kernel<false>;
    const size_t bytes = smem_bytes(T);
    const cudaError_t e = prepare(kernel, bytes);
    if (e != cudaSuccess) return (int)e;
    kernel<<<grid_for(B), block_for(T), bytes, st>>>(
        static_cast<const R*>(cf), seg, static_cast<const R*>(t), static_cast<const R*>(tl),
        static_cast<const R*>(dt), static_cast<const R*>(dg), static_cast<const R*>(m),
        static_cast<const R*>(y), L, B, jr, toff, T, static_cast<const R*>(sh0),
        static_cast<R*>(M), static_cast<R*>(mv), static_cast<R*>(Qm), static_cast<R*>(qv),
        static_cast<R*>(q0), static_cast<R*>(ld), static_cast<R*>(mind));
    return (int)cudaGetLastError();
}

}  // extern "C"
