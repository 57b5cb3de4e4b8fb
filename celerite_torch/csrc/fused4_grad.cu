// The gradient pipeline of the fused GP log-likelihood for Hopper (sm_90a):
// four per-lane sweeps with per-step saves.
//
// Replaces the Pallas kernels of celerite_tpu/ops/fused4.py that
// build_ll_and_grad launches:
//   elem_fwd_kernel    <- _elem_fwd_kernel   (fused4.py:499)
//   factor_fwd_kernel  <- _factor_fwd_kernel (fused4.py:619)
//   factor_bwd_kernel  <- _factor_bwd_kernel (fused4.py:686)
//   elem_bwd_kernel    <- _elem_bwd_kernel   (fused4.py:533)
// The forward pair is the primal's two phases (fused4_primal.cu) split at
// the element prefix, each writing its per-step input state to a save
// stream.  The backward pair walks the steps in reverse, recomputes each
// step's lowering and Riccati intermediates from the saves, transposes the
// step by hand (the F1-F9 / E1-E12 comments follow the Pallas bodies) and
// accumulates the packed-coefficient cotangent per lane (chain_step).  The
// cross-lane prefixes and their VJP run between the launches as float64
// torch glue (celerite_torch/ops/fused4.py); cotangents and seeds that come
// from the glue arrive in float64 and are rounded to T here on load.
//
// Design.  As in the primal: one thread owns one lane and loops over its L
// steps with the P x P state in registers (it spills at P = 8 in float64:
// a backward sweep carries three P x P adjoints beside the two saved
// matrices; registers and spills are in PERF.md); THREADS lanes a block;
// one coefficient row per segment of `seg` lanes.  The streams and saves
// are stored with the lane fastest, step s of lane l at s * B + l and save
// word q at (s * NSV + q) * B + l, so a warp reads and writes 32
// neighbouring words.  The coefficient cotangent is accumulated per column
// of the padded model (CoefGrad, the layout of Coeffs), so every register
// index is known at compile time, and scattered into the packed layout
// once at the end.
//
// Bound.  Bytes: the saves, 2P^2 + (2P^2 + P) words a point, are written
// once and read once; at config[2] (N = 1e5, P = 8, float64) that is 211 MB
// a chain, ~0.13 ms at 3.35 TB/s, well above the streams' 6-7 words a
// point.  Operations: a few thousand a point for P = 8 (each sweep
// recomputes the step and its O(P^2) products).  In practice the kernels
// are bound by the latency of the per-lane dependent recursion and by
// local-memory spills.
//
// Numerics: fused4_common.cuh.  Compiled once per padded width:
// nvcc -DCELERITE_P=<P> (1 <= P <= 12).

#include "fused4_common.cuh"

constexpr int NSV0 = 2 * PP;      // elem saves a step: Sh, A
constexpr int NSV1 = 2 * PP + P;  // factor saves a step: Sh, M, m

// Cotangent of the packed coefficients, per column of the padded model
// (the layout of Coeffs): real columns k < jr carry (a, c); the first
// column of a complex pair carries (a, b, c, d).
template <typename T>
struct CoefGrad {
    T c0[P], c1[P], c2[P], c3[P];
    T total;
};

template <typename T>
__device__ __forceinline__ void zero_grad(CoefGrad<T>& g) {
#pragma unroll
    for (int col = 0; col < P; ++col) g.c0[col] = g.c1[col] = g.c2[col] = g.c3[col] = T(0);
    g.total = T(0);
}

// The packed layout of load_coeffs: hcf[k * B + l].
template <typename T>
__device__ __forceinline__ void store_grad(const CoefGrad<T>& g, int jr, int B, int l,
                                           T* __restrict__ hcf) {
    const int jc = (P - jr) / 2;
#pragma unroll
    for (int col = 0; col < P; ++col) {
        if (col < jr) {
            hcf[(size_t)col * B + l] = g.c0[col];
            hcf[(size_t)(jr + col) * B + l] = g.c1[col];
        } else if (((col - jr) & 1) == 0) {
            const int j = (col - jr) >> 1;
            hcf[(size_t)(2 * jr + j) * B + l] = g.c0[col];
            hcf[(size_t)(2 * jr + jc + j) * B + l] = g.c1[col];
            hcf[(size_t)(2 * jr + 2 * jc + j) * B + l] = g.c2[col];
            hcf[(size_t)(2 * jr + 3 * jc + j) * B + l] = g.c3[col];
        }
    }
    hcf[(size_t)(2 * jr + 4 * jc) * B + l] = g.total;
}

// Transpose of lower_step for one step (fused4._chain_step).  A complex
// pair's (cos, sin) * m are its columns of v and its decay is ph, so the
// tangents d(phi)/d(c) = -dt phi and d(angle)/d(d) = t + t_lo use the
// forward step's own rounded transcendentals.
template <typename T>
__device__ __forceinline__ void chain_step(const Coeffs<T>& k, int jr, const T (&hu)[P],
                                           const T (&hv)[P], const T (&hph)[P], T ha,
                                           const T (&v)[P], const T (&ph)[P], T t, T tl,
                                           T dt, T m, CoefGrad<T>& g) {
#pragma unroll
    for (int col = 0; col < P; ++col) {
        if (col < jr) {
            g.c0[col] += hu[col] * m;
            g.c1[col] += hph[col] * ph[col] * (-dt);
        } else if (((col - jr) & 1) == 0 && col + 1 < P) {
            const int q = col + 1 < P ? col + 1 : col;  // the pair's partner
            const T cm = v[col], sm = v[q];
            const T ac = k.c0[col], bc = k.c1[col];
            g.c0[col] += hu[col] * cm + hu[q] * sm;
            g.c1[col] += hu[col] * sm - hu[q] * cm;
            g.c2[col] += (hph[col] + hph[q]) * ph[col] * (-dt);
            const T hcm = ac * hu[col] - bc * hu[q] + hv[col];
            const T hsm = bc * hu[col] + ac * hu[q] + hv[q];
            // cm = cos(ang) m, sm = sin(ang) m: d cm/d ang = -sm, d sm/d ang = cm.
            g.c3[col] += (hsm * cm - hcm * sm) * (t + tl);
        }
    }
    g.total += ha * m;
}

// The Riccati step's intermediates from its input Shin, with
// S = Phi Shin Phi formed on the fly: su = S u, d = a - u.su,
// w = (v - su) / d.  Returns d.
template <typename T>
__device__ __forceinline__ T riccati_front(const T (&Shin)[P][P], const T (&u)[P],
                                           const T (&v)[P], const T (&ph)[P], T a,
                                           T (&su)[P], T (&w)[P]) {
#pragma unroll
    for (int i = 0; i < P; ++i) {
        T s = T(0);
#pragma unroll
        for (int j = 0; j < P; ++j) s += ph[i] * Shin[i][j] * ph[j] * u[j];
        su[i] = s;
    }
    T us = T(0);
#pragma unroll
    for (int i = 0; i < P; ++i) us += u[i] * su[i];
    const T d = a - us;
#pragma unroll
    for (int i = 0; i < P; ++i) w[i] = (v[i] - su[i]) / d;
    return d;
}

// Steps 5-1 of both backward sweeps (F5-F1 = E5-E1): the transposes of
// Sh_out = S + d w w^T, w = (v - su)/d, d = a - u.su, su = S u and
// S = Phi Shin Phi.  Adds into hu, hph; writes hv, ha; hSh goes from the
// cotangent of Sh_out to that of Shin.
template <typename T>
__device__ __forceinline__ void riccati_adjoint(const T (&Shin)[P][P], const T (&u)[P],
                                                const T (&ph)[P], const T (&su)[P], T d,
                                                const T (&w)[P], T (&hSh)[P][P], T (&hw)[P],
                                                T hd, T (&hu)[P], T (&hph)[P], T (&hv)[P],
                                                T& ha) {
    // 5: Sh_out = S + d w w^T
#pragma unroll
    for (int i = 0; i < P; ++i) {
        T acc = T(0), hdw = T(0);
#pragma unroll
        for (int j = 0; j < P; ++j) {
            acc += (hSh[i][j] + hSh[j][i]) * w[j];
            hdw += hSh[i][j] * w[j];
        }
        hd += w[i] * hdw;
        hw[i] += d * acc;
    }
    // 4: w = (v - su) / d
    T hsu[P], hww = T(0);
#pragma unroll
    for (int i = 0; i < P; ++i) {
        hv[i] = hw[i] / d;
        hsu[i] = -hw[i] / d;
        hww += hw[i] * w[i];
    }
    hd -= hww / d;
    // 3: d = a - u.su
    ha = hd;
#pragma unroll
    for (int i = 0; i < P; ++i) {
        hu[i] -= hd * su[i];
        hsu[i] -= hd * u[i];
    }
    // 2: su = S u, hS = hSh + hsu u^T
#pragma unroll
    for (int j = 0; j < P; ++j) {
        T acc = T(0);
#pragma unroll
        for (int i = 0; i < P; ++i) acc += ph[i] * Shin[i][j] * ph[j] * hsu[i];
        hu[j] += acc;
    }
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
        for (int j = 0; j < P; ++j) hSh[i][j] += hsu[i] * u[j];
    // 1: S = Phi Shin Phi
#pragma unroll
    for (int i = 0; i < P; ++i) {
        T acc = T(0);
#pragma unroll
        for (int j = 0; j < P; ++j)
            acc += (hSh[i][j] * Shin[i][j] + hSh[j][i] * Shin[j][i]) * ph[j];
        hph[i] += acc;
    }
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
        for (int j = 0; j < P; ++j) hSh[i][j] = ph[i] * hSh[i][j] * ph[j];
}

template <typename T>
__device__ __forceinline__ void load_sq(const T* __restrict__ p, int B, T (&X)[P][P]) {
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
        for (int j = 0; j < P; ++j) X[i][j] = p[(size_t)(i * P + j) * B];
}

template <typename T>
__device__ __forceinline__ void store_sq(T* __restrict__ p, int B, const T (&X)[P][P]) {
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
        for (int j = 0; j < P; ++j) p[(size_t)(i * P + j) * B] = X[i][j];
}

// A float64 P x P operand from the glue, rounded to T.
template <typename T>
__device__ __forceinline__ void load_sq64(const double* __restrict__ p, int B, T (&X)[P][P]) {
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
        for (int j = 0; j < P; ++j) X[i][j] = static_cast<T>(p[(size_t)(i * P + j) * B]);
}

// ---------------------------------------------------------------------------
// elem_fwd: phase 0 with saves.  Outputs A, J, C at (i * P + j) * B + l;
// saves [Sh_in, A_in] a step.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
elem_fwd_kernel(const T* __restrict__ cf, int seg, const T* __restrict__ t,
                const T* __restrict__ tl, const T* __restrict__ dt, const T* __restrict__ dg,
                const T* __restrict__ msk, int L, int B, int jr, T* __restrict__ A_out,
                T* __restrict__ J_out, T* __restrict__ C_out, T* __restrict__ sv) {
    const int l = blockIdx.x * blockDim.x + threadIdx.x;
    if (l >= B) return;
    Coeffs<T> k;
    load_coeffs(cf + (size_t)(l / seg) * (2 * P + 1), jr, k);

    T Sh[P][P], A[P][P], J[P][P];
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
        for (int j = 0; j < P; ++j) {
            Sh[i][j] = T(0);
            A[i][j] = i == j ? T(1) : T(0);
            J[i][j] = T(0);
        }

    for (int s = 0; s < L; ++s) {
        const size_t o = (size_t)s * B + l;
        T* sp = sv + (size_t)s * NSV0 * B + l;
        store_sq(sp, B, Sh);
        store_sq(sp + (size_t)PP * B, B, A);
        T u[P], v[P], ph[P], w[P], a;
        lower_step(k, jr, t[o], tl[o], dt[o], dg[o], msk[o], u, v, ph, a);
        const T d = riccati_step(Sh, u, v, ph, a, w);
        T uA[P];
#pragma unroll
        for (int j = 0; j < P; ++j) {
            T acc = T(0);
#pragma unroll
            for (int i = 0; i < P; ++i) acc += A[i][j] * (ph[i] * u[i]);
            uA[j] = acc;
        }
#pragma unroll
        for (int i = 0; i < P; ++i)
#pragma unroll
            for (int j = 0; j < P; ++j) {
                A[i][j] = ph[i] * A[i][j] - w[i] * uA[j];
                J[i][j] = J[i][j] - uA[i] * (uA[j] / d);
            }
    }
    store_sq(A_out + l, B, A);
    store_sq(J_out + l, B, J);
    store_sq(C_out + l, B, Sh);
}

// ---------------------------------------------------------------------------
// factor_fwd: phase 1 from the float64 seed sh0 (P, P, B), with saves
// [Sh_in, M_in, m_in] a step.  Outputs M, m, Qm, qv, mind in T and the
// Kahan pairs q0, ld added in float64.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
factor_fwd_kernel(const T* __restrict__ cf, int seg, const T* __restrict__ t,
                  const T* __restrict__ tl, const T* __restrict__ dt, const T* __restrict__ dg,
                  const T* __restrict__ msk, const T* __restrict__ y, int L, int B, int jr,
                  const double* __restrict__ sh0, T* __restrict__ M_out, T* __restrict__ m_out,
                  T* __restrict__ Qm_out, T* __restrict__ qv_out, double* __restrict__ q0_out,
                  double* __restrict__ ld_out, T* __restrict__ mind_out, T* __restrict__ sv) {
    const int l = blockIdx.x * blockDim.x + threadIdx.x;
    if (l >= B) return;
    Coeffs<T> k;
    load_coeffs(cf + (size_t)(l / seg) * (2 * P + 1), jr, k);

    T Sh[P][P], M[P][P], Qm[P][P], mv[P], qv[P];
    load_sq64(sh0 + l, B, Sh);
#pragma unroll
    for (int i = 0; i < P; ++i) {
#pragma unroll
        for (int j = 0; j < P; ++j) {
            M[i][j] = i == j ? T(1) : T(0);
            Qm[i][j] = T(0);
        }
        mv[i] = T(0);
        qv[i] = T(0);
    }
    T q0 = T(0), cq0 = T(0), ld = T(0), cld = T(0);
    T mind = T(INFINITY);

    for (int s = 0; s < L; ++s) {
        const size_t o = (size_t)s * B + l;
        T* sp = sv + (size_t)s * NSV1 * B + l;
        store_sq(sp, B, Sh);
        store_sq(sp + (size_t)PP * B, B, M);
#pragma unroll
        for (int i = 0; i < P; ++i) sp[(size_t)(2 * PP + i) * B] = mv[i];

        T u[P], v[P], ph[P], w[P], a;
        lower_step(k, jr, t[o], tl[o], dt[o], dg[o], msk[o], u, v, ph, a);
        const T yo = y[o];
        const T d = riccati_step(Sh, u, v, ph, a, w);

        T g[P];
#pragma unroll
        for (int i = 0; i < P; ++i)
#pragma unroll
            for (int j = 0; j < P; ++j) M[i][j] = ph[i] * M[i][j];
#pragma unroll
        for (int j = 0; j < P; ++j) {
            T acc = T(0);
#pragma unroll
            for (int i = 0; i < P; ++i) acc += M[i][j] * u[i];
            g[j] = acc;
        }
#pragma unroll
        for (int i = 0; i < P; ++i)
#pragma unroll
            for (int j = 0; j < P; ++j) M[i][j] = M[i][j] - w[i] * g[j];

        T um = T(0);
#pragma unroll
        for (int i = 0; i < P; ++i) {
            mv[i] = ph[i] * mv[i];
            um += u[i] * mv[i];
        }
        const T z0 = yo - um;
#pragma unroll
        for (int i = 0; i < P; ++i) mv[i] = mv[i] + w[i] * z0;

        // Kahan-compensated quad and log-det accumulators.
        const T x1 = z0 * z0 / d - cq0;
        const T t1 = q0 + x1;
        cq0 = (t1 - q0) - x1;
        q0 = t1;
        const T x2 = dlog(d) - cld;
        const T t2 = ld + x2;
        cld = (t2 - ld) - x2;
        ld = t2;

        const T zd = z0 / d;
#pragma unroll
        for (int i = 0; i < P; ++i) qv[i] = qv[i] + zd * g[i];
#pragma unroll
        for (int i = 0; i < P; ++i)
#pragma unroll
            for (int j = 0; j < P; ++j) Qm[i][j] = Qm[i][j] + g[i] * (g[j] / d);
        // NaN-propagating min, like torch.minimum / jnp.minimum.
        mind = (d < mind || d != d) ? d : mind;
    }

    store_sq(M_out + l, B, M);
    store_sq(Qm_out + l, B, Qm);
#pragma unroll
    for (int i = 0; i < P; ++i) {
        m_out[(size_t)i * B + l] = mv[i];
        qv_out[(size_t)i * B + l] = qv[i];
    }
    q0_out[l] = static_cast<double>(q0) + static_cast<double>(cq0);
    ld_out[l] = static_cast<double>(ld) + static_cast<double>(cld);
    mind_out[l] = mind;
}

// ---------------------------------------------------------------------------
// factor_bwd: reversed phase 1.  Cotangents of the outputs (float64):
// hM0, hm0 seed the sweep; hQm, hqv, hq0, hld are constant through it.
// Writes the per-lane coefficient rows hcf (C, B), the data cotangent hy
// (L, B) and the seed cotangent hsh0 (P, P, B).
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
factor_bwd_kernel(const T* __restrict__ cf, int seg, const T* __restrict__ t,
                  const T* __restrict__ tl, const T* __restrict__ dt, const T* __restrict__ dg,
                  const T* __restrict__ msk, const T* __restrict__ y, int L, int B, int jr,
                  const T* __restrict__ sv, const double* __restrict__ hM0,
                  const double* __restrict__ hm0, const double* __restrict__ hQm0,
                  const double* __restrict__ hqv0, const double* __restrict__ hq0_,
                  const double* __restrict__ hld_, T* __restrict__ hcf, T* __restrict__ hy_out,
                  T* __restrict__ hsh0) {
    const int l = blockIdx.x * blockDim.x + threadIdx.x;
    if (l >= B) return;
    Coeffs<T> k;
    load_coeffs(cf + (size_t)(l / seg) * (2 * P + 1), jr, k);

    T hSh[P][P], hM[P][P], hQs[P][P], hm[P], hqv[P];
    load_sq64(hM0 + l, B, hM);
    load_sq64(hQm0 + l, B, hQs);
    // hQm enters only symmetrised: hQs = hQm + hQm^T.
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
        for (int j = i; j < P; ++j) {
            const T s = hQs[i][j] + hQs[j][i];
            hQs[i][j] = s;
            hQs[j][i] = s;
        }
#pragma unroll
    for (int i = 0; i < P; ++i) {
#pragma unroll
        for (int j = 0; j < P; ++j) hSh[i][j] = T(0);
        hm[i] = static_cast<T>(hm0[(size_t)i * B + l]);
        hqv[i] = static_cast<T>(hqv0[(size_t)i * B + l]);
    }
    const T hq0 = static_cast<T>(hq0_[l]), hld = static_cast<T>(hld_[l]);
    CoefGrad<T> gr;
    zero_grad(gr);

    for (int s = L - 1; s >= 0; --s) {
        const size_t o = (size_t)s * B + l;
        const T* sp = sv + (size_t)s * NSV1 * B + l;
        T u[P], v[P], ph[P], a;
        const T ts = t[o], tls = tl[o], dts = dt[o], ms = msk[o];
        lower_step(k, jr, ts, tls, dts, dg[o], ms, u, v, ph, a);
        T Shin[P][P], Mprev[P][P], mprev[P];
        load_sq(sp, B, Shin);
        load_sq(sp + (size_t)PP * B, B, Mprev);
#pragma unroll
        for (int i = 0; i < P; ++i) mprev[i] = sp[(size_t)(2 * PP + i) * B];

        T su[P], w[P], g[P];
        const T d = riccati_front(Shin, u, v, ph, a, su, w);
        // g = PhM^T u with PhM = Phi Mprev; z0 = y - u.(ph * mprev).
#pragma unroll
        for (int j = 0; j < P; ++j) {
            T acc = T(0);
#pragma unroll
            for (int i = 0; i < P; ++i) acc += ph[i] * Mprev[i][j] * u[i];
            g[j] = acc;
        }
        T um = T(0);
#pragma unroll
        for (int i = 0; i < P; ++i) um += u[i] * (ph[i] * mprev[i]);
        const T z0 = y[o] - um;

        // E12: the statistics (constant cotangents, one term a step).
        T hqv_g = T(0), gQg = T(0), hg[P];
#pragma unroll
        for (int i = 0; i < P; ++i) {
            T acc = T(0);
#pragma unroll
            for (int j = 0; j < P; ++j) acc += hQs[i][j] * g[j];
            hqv_g += hqv[i] * g[i];
            gQg += g[i] * acc;
            hg[i] = acc;
        }
        gQg = T(0.5) * gQg;  // g^T hQm g
        const T dd = d * d;
        T hz0 = hq0 * (T(2) * z0 / d) + hqv_g / d;
        T hd = -hq0 * z0 * z0 / dd + hld / d - hqv_g * z0 / dd - gQg / dd;
#pragma unroll
        for (int i = 0; i < P; ++i) hg[i] = hqv[i] * (z0 / d) + hg[i] / d;

        // E11: m_out = mh + w z0
        T hw[P], hu[P], hph[P];
        T hmw = T(0);
#pragma unroll
        for (int i = 0; i < P; ++i) {
            hw[i] = hm[i] * z0;
            hmw += hm[i] * w[i];
        }
        hz0 += hmw;
        // E10: z0 = y - u.mh
        hy_out[o] = hz0;
        // E9: mh = ph * mprev, with hmh = hm - hz0 u
#pragma unroll
        for (int i = 0; i < P; ++i) {
            const T hmh = hm[i] - hz0 * u[i];
            hu[i] = -hz0 * (ph[i] * mprev[i]);
            hph[i] = hmh * mprev[i];
            hm[i] = hmh * ph[i];
        }
        // E8: M_out = PhM - w g^T
#pragma unroll
        for (int i = 0; i < P; ++i) {
            T acc = T(0);
#pragma unroll
            for (int j = 0; j < P; ++j) acc += hM[i][j] * g[j];
            hw[i] -= acc;
        }
#pragma unroll
        for (int j = 0; j < P; ++j) {
            T acc = T(0);
#pragma unroll
            for (int i = 0; i < P; ++i) acc += hM[i][j] * w[i];
            hg[j] -= acc;
        }
        // E7: g = PhM^T u, hPhM = hM + u hg^T;  E6: PhM = Phi Mprev
#pragma unroll
        for (int i = 0; i < P; ++i) {
            T acc = T(0), accm = T(0);
#pragma unroll
            for (int j = 0; j < P; ++j) {
                acc += ph[i] * Mprev[i][j] * hg[j];
                const T hPhM = hM[i][j] + u[i] * hg[j];
                accm += hPhM * Mprev[i][j];
                hM[i][j] = ph[i] * hPhM;
            }
            hu[i] += acc;
            hph[i] += accm;
        }
        // E5-E1: the Riccati step.
        T hv[P], ha;
        riccati_adjoint(Shin, u, ph, su, d, w, hSh, hw, hd, hu, hph, hv, ha);
        chain_step(k, jr, hu, hv, hph, ha, v, ph, ts, tls, dts, ms, gr);
    }
    store_grad(gr, jr, B, l, hcf);
    store_sq(hsh0 + l, B, hSh);
}

// ---------------------------------------------------------------------------
// elem_bwd: reversed phase 0.  Cotangents of the lane's element (float64,
// from the prefix VJP): hA0 and hC0 seed the sweep, hJ0 is constant.
// Writes the per-lane coefficient rows hcf (C, B).
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(THREADS)
elem_bwd_kernel(const T* __restrict__ cf, int seg, const T* __restrict__ t,
                const T* __restrict__ tl, const T* __restrict__ dt, const T* __restrict__ dg,
                const T* __restrict__ msk, int L, int B, int jr, const T* __restrict__ sv,
                const double* __restrict__ hA0, const double* __restrict__ hJ0,
                const double* __restrict__ hC0, T* __restrict__ hcf) {
    const int l = blockIdx.x * blockDim.x + threadIdx.x;
    if (l >= B) return;
    Coeffs<T> k;
    load_coeffs(cf + (size_t)(l / seg) * (2 * P + 1), jr, k);

    T hA[P][P], hJs[P][P], hSh[P][P];
    load_sq64(hA0 + l, B, hA);
    load_sq64(hJ0 + l, B, hJs);
    load_sq64(hC0 + l, B, hSh);
    // hJ is constant through the sweep and enters only symmetrised.
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
        for (int j = i; j < P; ++j) {
            const T s = hJs[i][j] + hJs[j][i];
            hJs[i][j] = s;
            hJs[j][i] = s;
        }
    CoefGrad<T> gr;
    zero_grad(gr);

    for (int s = L - 1; s >= 0; --s) {
        const size_t o = (size_t)s * B + l;
        const T* sp = sv + (size_t)s * NSV0 * B + l;
        T u[P], v[P], ph[P], a;
        const T ts = t[o], tls = tl[o], dts = dt[o], ms = msk[o];
        lower_step(k, jr, ts, tls, dts, dg[o], ms, u, v, ph, a);
        T Shin[P][P], A_in[P][P];
        load_sq(sp, B, Shin);
        load_sq(sp + (size_t)PP * B, B, A_in);

        T su[P], w[P], ut[P], uAc[P];
        const T d = riccati_front(Shin, u, v, ph, a, su, w);
#pragma unroll
        for (int i = 0; i < P; ++i) ut[i] = ph[i] * u[i];
#pragma unroll
        for (int j = 0; j < P; ++j) {
            T acc = T(0);
#pragma unroll
            for (int i = 0; i < P; ++i) acc += A_in[i][j] * ut[i];
            uAc[j] = acc;
        }

        // F9: J_out = J_in - uAc (uAc/d)^T
        T huAc[P], hd = T(0);
#pragma unroll
        for (int i = 0; i < P; ++i) {
            T acc = T(0);
#pragma unroll
            for (int j = 0; j < P; ++j) acc += hJs[i][j] * uAc[j];
            huAc[i] = -acc / d;
            hd += uAc[i] * acc;
        }
        hd = T(0.5) * hd / (d * d);
        // F8: A_out = Phi A_in - w uAc^T
        T hph[P], hw[P];
#pragma unroll
        for (int i = 0; i < P; ++i) {
            T acc = T(0), accw = T(0);
#pragma unroll
            for (int j = 0; j < P; ++j) {
                acc += hA[i][j] * A_in[i][j];
                accw += hA[i][j] * uAc[j];
            }
            hph[i] = acc;
            hw[i] = -accw;
        }
#pragma unroll
        for (int j = 0; j < P; ++j) {
            T acc = T(0);
#pragma unroll
            for (int i = 0; i < P; ++i) acc += hA[i][j] * w[i];
            huAc[j] -= acc;
        }
        // F7: uAc = A_in^T ut;  F6: ut = ph * u
        T hu[P];
#pragma unroll
        for (int i = 0; i < P; ++i) {
            T acc = T(0);
#pragma unroll
            for (int j = 0; j < P; ++j) {
                acc += A_in[i][j] * huAc[j];
                hA[i][j] = ph[i] * hA[i][j] + ut[i] * huAc[j];
            }
            hph[i] += acc * u[i];
            hu[i] = acc * ph[i];
        }
        // F5-F1: the Riccati step.
        T hv[P], ha;
        riccati_adjoint(Shin, u, ph, su, d, w, hSh, hw, hd, hu, hph, hv, ha);
        chain_step(k, jr, hu, hv, hph, ha, v, ph, ts, tls, dts, ms, gr);
    }
    store_grad(gr, jr, B, l, hcf);
}

// ---------------------------------------------------------------------------
// Host entry points: one launch each on the caller's stream, nothing
// allocated; cf holds one row of 2P + 1 coefficients per segment of `seg`
// lanes.  Each returns cudaGetLastError() after its launch.
// ---------------------------------------------------------------------------

static inline dim3 grid_for(int B) { return dim3((B + THREADS - 1) / THREADS); }

#define CELERITE_GRAD_ENTRIES(T, SFX)                                                            \
    int celerite_fused4_elem_fwd_##SFX(const void* cf, const void* t, const void* tl,           \
                                       const void* dt, const void* dg, const void* m, void* A,   \
                                       void* J, void* C, void* sv, int L, int B, int jr,         \
                                       int seg, void* stream) {                                  \
        elem_fwd_kernel<T><<<grid_for(B), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(    \
            static_cast<const T*>(cf), seg, static_cast<const T*>(t),                            \
            static_cast<const T*>(tl), static_cast<const T*>(dt), static_cast<const T*>(dg),     \
            static_cast<const T*>(m), L, B, jr, static_cast<T*>(A), static_cast<T*>(J),          \
            static_cast<T*>(C), static_cast<T*>(sv));                                            \
        return (int)cudaGetLastError();                                                          \
    }                                                                                            \
    int celerite_fused4_factor_fwd_##SFX(                                                        \
        const void* cf, const void* t, const void* tl, const void* dt, const void* dg,           \
        const void* m, const void* y, const void* sh0, void* M, void* mv, void* Qm, void* qv,    \
        void* q0, void* ld, void* mind, void* sv, int L, int B, int jr, int seg, void* stream) { \
        factor_fwd_kernel<T><<<grid_for(B), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(  \
            static_cast<const T*>(cf), seg, static_cast<const T*>(t),                            \
            static_cast<const T*>(tl), static_cast<const T*>(dt), static_cast<const T*>(dg),     \
            static_cast<const T*>(m), static_cast<const T*>(y), L, B, jr,                        \
            static_cast<const double*>(sh0), static_cast<T*>(M), static_cast<T*>(mv),            \
            static_cast<T*>(Qm), static_cast<T*>(qv), static_cast<double*>(q0),                  \
            static_cast<double*>(ld), static_cast<T*>(mind), static_cast<T*>(sv));               \
        return (int)cudaGetLastError();                                                          \
    }                                                                                            \
    int celerite_fused4_factor_bwd_##SFX(                                                        \
        const void* cf, const void* t, const void* tl, const void* dt, const void* dg,           \
        const void* m, const void* y, const void* sv, const void* hM, const void* hm,            \
        const void* hQm, const void* hqv, const void* hq0, const void* hld, void* hcf,           \
        void* hy, void* hsh0, int L, int B, int jr, int seg, void* stream) {                     \
        factor_bwd_kernel<T><<<grid_for(B), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(  \
            static_cast<const T*>(cf), seg, static_cast<const T*>(t),                            \
            static_cast<const T*>(tl), static_cast<const T*>(dt), static_cast<const T*>(dg),     \
            static_cast<const T*>(m), static_cast<const T*>(y), L, B, jr,                        \
            static_cast<const T*>(sv), static_cast<const double*>(hM),                           \
            static_cast<const double*>(hm), static_cast<const double*>(hQm),                     \
            static_cast<const double*>(hqv), static_cast<const double*>(hq0),                    \
            static_cast<const double*>(hld), static_cast<T*>(hcf), static_cast<T*>(hy),          \
            static_cast<T*>(hsh0));                                                              \
        return (int)cudaGetLastError();                                                          \
    }                                                                                            \
    int celerite_fused4_elem_bwd_##SFX(const void* cf, const void* t, const void* tl,           \
                                       const void* dt, const void* dg, const void* m,            \
                                       const void* sv, const void* hA, const void* hJ,           \
                                       const void* hC, void* hcf, int L, int B, int jr,          \
                                       int seg, void* stream) {                                  \
        elem_bwd_kernel<T><<<grid_for(B), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(    \
            static_cast<const T*>(cf), seg, static_cast<const T*>(t),                            \
            static_cast<const T*>(tl), static_cast<const T*>(dt), static_cast<const T*>(dg),     \
            static_cast<const T*>(m), L, B, jr, static_cast<const T*>(sv),                       \
            static_cast<const double*>(hA), static_cast<const double*>(hJ),                      \
            static_cast<const double*>(hC), static_cast<T*>(hcf));                               \
        return (int)cudaGetLastError();                                                          \
    }

extern "C" {

CELERITE_GRAD_ENTRIES(float, f32)
CELERITE_GRAD_ENTRIES(double, f64)

}  // extern "C"
