// The coverage model's EM in one launch: every E-step and every Nelder-Mead
// M-step of spades_tpu_torch/graph/coverage_model.py `fit_coverage_model`
// (the loop over rounds), on one thread block.
//
// Replaces no TPU kernel: the JAX package fits on the host, with scipy.  It
// was added because a fit makes some 30,000 evaluations of the M-step's
// objective, one after another, each a grid of 10 copy numbers x the
// histogram's bins (up to 5,000), and numpy spends about 110 us on each in
// interpreter and call overhead while the card waits.
//
// Bound on an H100: float64 arithmetic, one evaluation after another.  An
// evaluation costs per non-empty bin 2 pow and 2 log, and per bin and copy
// an exp and, where |a| < 6, an erf; the simplex makes each evaluation wait
// for the one before, so the launch takes (evaluations) x (one evaluation's
// float64 work and latency on the one SM the block runs on, 64 FP64 lanes,
// plus its barriers).
//
// Input:  cov (n,) float64, the histogram's bins 1..n (good_cov); init: x0
//         (zp, shape, u, sd, scale, shape2), err_prob, the histogram's total.
// Output: out (9,) float64: x (6), err_prob, the rounds run, the objective's
//         evaluations.
//
// The round loop, the E-step and the update of err_prob follow
// fit_coverage_model's loop; the objective is `_em_objective`'s (empty bins
// add nothing, erf only where |a| < 6); the minimiser is scipy's
// `_minimize_neldermead` (scipy/optimize/_optimize.py, not adaptive): the same
// initial simplex, coefficients, order of steps, tolerance test, budget of
// evaluations and iterations, and the same stop when the budget runs out in
// the middle of an iteration.  Its arithmetic is written with __d*_rn so that
// nvcc contracts none of it into fused multiply-adds: given the same objective
// values it takes scipy's path bit for bit (csrc/emulation/ checks that on the
// CPU).  The simplex is sorted stably, NaN last; numpy's argsort orders ties
// as its sort network does.  The objective's own values differ from numpy's
// in the last bits (another exp, erf, pow, log, zeta and order of summation),
// so the fit is close to the host's, not equal.
//
// Design: every thread runs the same minimiser on the same values read from
// shared memory (so its branches are uniform and the barriers inside an
// evaluation are met by all); thread 0 writes the simplex, and a sort is a
// stable rank per vertex, moved by 49 threads.  The non-empty bins are
// compacted once, in order, into shared memory with their posteriors `z`.
// An evaluation is short of work (75-230 bins in the cells), so it is cut
// fine: the per-copy constants and zeta's tail on the last warps while every
// thread takes a bin's error density, then one (bin, copy) term per thread
// (819 bins a chunk), then one bin per thread for its log-likelihood.  A sum
// is a butterfly in each warp (every lane ends with the same bits) and the
// warps' sums added in order: no atomics, so a launch repeats bit for bit.
// All arithmetic is float64, without fast math.

#include <math.h>
#include <cuda_runtime.h>

// The launch goes through a macro so that the same source can be compiled as
// host code and checked without a card (csrc/emulation/).
#ifndef SPADES_LAUNCH
#define SPADES_LAUNCH(kernel, grid, block, smem, stream, ...) \
    kernel<<<grid, block, smem, stream>>>(__VA_ARGS__)
#endif

// The block's threads: whole warps, at least 64.  512 ran the cells' fits
// faster than 256 or 1,024 on an H100; the CPU emulation builds 64.
#ifndef SPADES_EM_THREADS
#define SPADES_EM_THREADS 512
#endif

namespace {

constexpr int kDim = 6;                 // zp, shape, u, sd, scale, shape2
constexpr int kVerts = kDim + 1;
constexpr int kCopies = 10;             // MAX_COPY
constexpr int kMaxBins = 5000;          // the histogram's cap
constexpr int kThreads = SPADES_EM_THREADS;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRounds = 100;
constexpr int kDefaultEvals = 200 * kDim;   // scipy's maxfev and maxiter when neither is given
constexpr double kTol = 1e-8;               // xatol, fatol, and the rounds' |dp|
constexpr double kMachEp = 1.11022302462515654042e-16;
constexpr double kInvSqrt2Pi = 0.3989422804014327;  // 1 / sqrt(2 pi)
constexpr double kInvSqrt2 = 0.7071067811865476;    // 1 / sqrt(2)
constexpr int kPairCap = 8192;          // (bin, copy) terms staged at once: 64 KB
constexpr double kErfSaturated = 6.0;
// exp(-0.5 t^2) is 0 in float64 from t^2 = 1492 on, and so is the density
constexpr double kPhiZeroT2 = 1500.0;
static_assert(kThreads % 32 == 0 && kThreads >= 64 && kThreads <= 1024,
              "the block is whole warps, at least 49 threads for the sort");

// float64 steps that nvcc may not fuse (the host's numpy rounds each)
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ bool finite(double v) { return v - v == 0.0; }
__device__ __forceinline__ bool is_nan(double v) { return v != v; }
// numpy's order: NaN after every number
__device__ __forceinline__ bool before(double a, double b) {
    return a < b || (!is_nan(a) && is_nan(b));
}

struct Simplex {
    double sim[kVerts][kDim];
    double fsim[kVerts];
};

// What an evaluation computes once for all bins: per copy c the prior's
// c^-(zp+1), the peak c*u, 1/omega and 2/omega; the tail of zeta(zp+1).
struct Consts {
    double pw[kCopies], cu[kCopies], inv_om[kCopies], two_om[kCopies];
    double tail;
};

struct Shared {
    Simplex s;
    Consts c;
    double red[kWarps];
};

// Sum of v over the block; every thread gets the same bits.
__device__ double block_sum(double v, double* red) {
#pragma unroll
    for (int m = 16; m >= 1; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
    __syncthreads();                       // the last sum's reads of red are done
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    double s = red[0];
    for (int w = 1; w < kWarps; ++w) s += red[w];
    return s;
}

// ---------------------------------------------------------------------------
// Nelder-Mead (scipy's _minimize_neldermead, adaptive=False, no bounds)
// ---------------------------------------------------------------------------

// sim[k] <- p (and fsim[k] <- f when f is given), once every thread has read
// what it needs of the simplex
__device__ void store_vertex(Simplex& s, int k, const double* p, const double* f) {
    __syncthreads();
    if (threadIdx.x == 0) {
#pragma unroll
        for (int j = 0; j < kDim; ++j) s.sim[k][j] = p[j];
        if (f != nullptr) s.fsim[k] = *f;
    }
    __syncthreads();
}

// np.argsort(fsim), stably, then np.take of both arrays
__device__ void sort_simplex(Simplex& s) {
    __syncthreads();
    const int t = threadIdx.x;
    int dst = -1, k = 0, col = 0;
    double v = 0.0;
    if (t < kVerts * (kDim + 1)) {
        k = t / (kDim + 1);
        col = t % (kDim + 1);
        const double fk = s.fsim[k];
        dst = 0;
        for (int m = 0; m < kVerts; ++m) {
            const double fm = s.fsim[m];
            if (before(fm, fk) || (m < k && !before(fk, fm))) ++dst;
        }
        v = col < kDim ? s.sim[k][col] : fk;
    }
    __syncthreads();
    if (dst >= 0) {
        if (col < kDim) s.sim[dst][col] = v;
        else s.fsim[dst] = v;
    }
    __syncthreads();
}

// Minimise f from x (in every thread's registers; on return the best vertex).
// f(p) is called by every thread together with the same p and gives every
// thread the same value.  maxfev and maxiter as scipy's after its defaults
// are applied; *nfev and *nit as its result's.
template <class F>
__device__ void nelder_mead(F& f, double* x, int maxfev, int maxiter, Simplex& s,
                            int* nfev, int* nit) {
    constexpr double rho = 1.0, chi = 2.0, psi = 0.5, sigma = 0.5;
    constexpr double nonzdelt = 0.05, zdelt = 0.00025;
    int fcalls = 0;
    // scipy's wrapper: no call once the budget is spent
    auto call = [&](const double* p, double* out) -> bool {
        if (fcalls >= maxfev) return false;
        ++fcalls;
        *out = f(p);
        return true;
    };

    __syncthreads();
    if (threadIdx.x == 0) {
        for (int k = 0; k < kVerts; ++k) {
            for (int j = 0; j < kDim; ++j) s.sim[k][j] = x[j];
            s.fsim[k] = INFINITY;
        }
        for (int k = 0; k < kDim; ++k)
            s.sim[k + 1][k] = x[k] != 0.0 ? mul(1.0 + nonzdelt, x[k]) : zdelt;
    }
    __syncthreads();
    for (int k = 0; k < kVerts; ++k) {
        double p[kDim], fk;
        for (int j = 0; j < kDim; ++j) p[j] = s.sim[k][j];
        if (!call(p, &fk)) break;
        if (threadIdx.x == 0) s.fsim[k] = fk;
    }
    sort_simplex(s);            // scipy sorts twice; a stable sort of a sorted array moves nothing

    int iterations = 1;
    while (fcalls < maxfev && iterations < maxiter) {
        // max(|sim[1:] - sim[0]|) <= xatol and max(|fsim[0] - fsim[1:]|) <= fatol
        // (a NaN fails both), all loads at once
        bool done = true;
#pragma unroll
        for (int k = 1; k < kVerts; ++k) {
#pragma unroll
            for (int j = 0; j < kDim; ++j) done &= fabs(sub(s.sim[k][j], s.sim[0][j])) <= kTol;
            done &= fabs(sub(s.fsim[0], s.fsim[k])) <= kTol;
        }
        if (done) break;

        // one iteration; false where the budget ran out inside it
        auto step = [&]() -> bool {
            double xbar[kDim], worst[kDim], xr[kDim], p[kDim];
            for (int j = 0; j < kDim; ++j) {
                double acc = s.sim[0][j];
                for (int k = 1; k < kDim; ++k) acc = add(acc, s.sim[k][j]);
                xbar[j] = acc / kDim;
                worst[j] = s.sim[kDim][j];
            }
            const double f0 = s.fsim[0], fsecond = s.fsim[kDim - 1], fworst = s.fsim[kDim];
            for (int j = 0; j < kDim; ++j) xr[j] = sub(mul(1.0 + rho, xbar[j]), mul(rho, worst[j]));
            double fxr, fp;
            if (!call(xr, &fxr)) return false;
            if (fxr < f0) {
                for (int j = 0; j < kDim; ++j)
                    p[j] = sub(mul(1.0 + rho * chi, xbar[j]), mul(rho * chi, worst[j]));
                if (!call(p, &fp)) return false;
                if (fp < fxr) store_vertex(s, kDim, p, &fp);
                else store_vertex(s, kDim, xr, &fxr);
                return true;
            }
            if (fxr < fsecond) {
                store_vertex(s, kDim, xr, &fxr);
                return true;
            }
            bool shrink;
            if (fxr < fworst) {         // contraction
                for (int j = 0; j < kDim; ++j)
                    p[j] = sub(mul(1.0 + psi * rho, xbar[j]), mul(psi * rho, worst[j]));
                if (!call(p, &fp)) return false;
                shrink = !(fp <= fxr);
            } else {                    // inside contraction
                for (int j = 0; j < kDim; ++j)
                    p[j] = add(mul(1.0 - psi, xbar[j]), mul(psi, worst[j]));
                if (!call(p, &fp)) return false;
                shrink = !(fp < fworst);
            }
            if (!shrink) {
                store_vertex(s, kDim, p, &fp);
                return true;
            }
            for (int k = 1; k < kVerts; ++k) {
                // scipy sets sim[k] before the call that may find the budget spent
                for (int j = 0; j < kDim; ++j)
                    p[j] = add(s.sim[0][j], mul(sigma, sub(s.sim[k][j], s.sim[0][j])));
                store_vertex(s, k, p, nullptr);
                if (!call(p, &fp)) return false;
                if (threadIdx.x == 0) s.fsim[k] = fp;
            }
            return true;
        };
        if (step()) ++iterations;
        sort_simplex(s);
    }
    for (int j = 0; j < kDim; ++j) x[j] = s.sim[0][j];
    *nfev = fcalls;
    *nit = iterations;
}

// ---------------------------------------------------------------------------
// the mixture (graph/coverage_model.py: _perr, _skew_normal_pdf, _dzeta)
// ---------------------------------------------------------------------------

struct Bins {
    const int* idx;      // multiplicity of each non-empty bin (bin b <-> b + 1)
    const double* cov;   // its count
    double* z;           // its posterior error probability
    double* le;          // log error density of the evaluation under way
    double* gp;          // (bin, copy) terms of the genomic density, one chunk of bins
    int n;               // non-empty bins
};

// The discretized generalized-Pareto density at multiplicity i, 0 where it
// is not finite.
__device__ __forceinline__ double perr(double i, double scale, double shape) {
    const double e = -1.0 / shape;
    const double a = pow(1.0 + shape * (i - 1.0) / scale, e);
    const double b = pow(1.0 + shape * i / scale, e);
    const double d = a - b;
    return finite(d) ? d : 0.0;
}

// c^-(zp+1) x the skew-normal density of copy k + 1 at multiplicity i, 0
// where the density is not finite; a_scale is shape2 / sqrt(2).
__device__ __forceinline__ double weighted_pdf(double i, int k, double a_scale, const Consts& c) {
    const double t = (i - c.cu[k]) * c.inv_om[k];
    if (t * t > kPhiZeroT2) return 0.0;
    const double phi = exp(t * t * -0.5) * kInvSqrt2Pi;
    const double a = t * a_scale;
    const double e = fabs(a) < kErfSaturated ? erf(a) : (a > 0.0 ? 1.0 : (a < 0.0 ? -1.0 : a));
    const double pdf = phi * c.two_om[k] * ((e + 1.0) * 0.5);
    return finite(pdf) ? c.pw[k] * pdf : 0.0;
}

// For the non-empty bins, a chunk at a time: every thread takes (bin, copy)
// pairs, then body(q, s) runs for each bin q of the chunk with s = zeta x its
// genomic density (the copies' terms added in order).
template <class Body>
__device__ void for_each_genomic(const Bins& b, double shape2, const Consts& c, Body body) {
    constexpr int per = kPairCap / kCopies;
    const double a_scale = shape2 * kInvSqrt2;
    for (int base = 0; base < b.n; base += per) {
        const int nb = b.n - base < per ? b.n - base : per;
        for (int p = threadIdx.x; p < nb * kCopies; p += kThreads) {
            const int q = p / kCopies;
            b.gp[p] = weighted_pdf((double)b.idx[base + q], p - q * kCopies, a_scale, c);
        }
        __syncthreads();
        for (int q = threadIdx.x; q < nb; q += kThreads) {
            const double* g = b.gp + q * kCopies;
            double s = g[0];
#pragma unroll
            for (int k = 1; k < kCopies; ++k) s += g[k];
            body(base + q, s);
        }
        if (base + per < b.n) __syncthreads();   // read before the next chunk is written
    }
}

// zeta(zp + 1): the direct sum 1 + 2^-x + ... + 10^-x of the copies' priors
// plus the Euler-Maclaurin tail from 10 on (cephes' Hurwitz zeta at q = 1).
__device__ __forceinline__ double zeta_of(const Consts& c) {
    double s = c.pw[0];
#pragma unroll
    for (int k = 1; k < kCopies; ++k) s += c.pw[k];
    return s + c.tail;
}

// The per-evaluation constants: ten lanes of the last warp one copy each,
// the first lane of the warp before it the tail of zeta(zp + 1) (the bins
// reach the last warps last); a barrier follows in the caller.
__device__ void fill_consts(const double* x, Consts& c) {
    const double zp = x[0], u = x[2], sd = x[3];
    const int t = threadIdx.x - (kThreads - 64);
    if (t >= 32 && t < 32 + kCopies) {
        const int k = t - 32;
        const double cc = k + 1.0;
        c.pw[k] = pow(cc, -zp - 1.0);
        c.cu[k] = cc * u;
        const double om = fmax(sd * sqrt(cc), 1e-300);
        c.inv_om[k] = 1.0 / om;
        c.two_om[k] = 2.0 / om;
    } else if (t == 0) {
        // (2j)! / B_2j, reciprocal (cephes' A[])
        const double inv_a[12] = {1.0 / 12.0, 1.0 / -720.0, 1.0 / 30240.0, 1.0 / -1209600.0,
                                  1.0 / 47900160.0, 1.0 / -1.8924375803183791606e9,
                                  1.0 / 7.47242496e10, 1.0 / -2.950130727918164224e12,
                                  1.0 / 1.1646782814350067249e14,
                                  1.0 / -4.5979787224074726105e15,
                                  1.0 / 1.8152105401943546773e17,
                                  1.0 / -7.1661652561756670113e18};
        const double sx = zp + 1.0;
        double b = pow((double)kCopies, -sx);
        double tail = b * kCopies / (sx - 1.0) - 0.5 * b;
        double a = 1.0, k = 0.0;
#pragma unroll
        for (int i = 0; i < 12; ++i) {
            a *= sx + k;
            b *= 1.0 / kCopies;
            const double term = a * b * inv_a[i];
            tail += term;
            if (fabs(term) < kMachEp) break;       // zeta >= 1: below an ulp of it
            k += 1.0;
            a *= sx + k;
            b *= 1.0 / kCopies;
            k += 1.0;
        }
        c.tail = tail;
    }
}

// The M-step's objective: minus the weighted complete-data log-likelihood
// over the non-empty bins (`_em_objective`).
struct Objective {
    Bins b;
    Shared* sh;

    __device__ double operator()(const double* x) const {
        const double zp = x[0], shape = x[1], u = x[2], sd = x[3], scale = x[4], shape2 = x[5];
        bool ok = finite(zp) && finite(shape) && finite(u) && finite(sd) && finite(scale) &&
                  finite(shape2);
        if (zp <= 1.0 || shape <= 0.0 || sd <= 0.0 || u <= 0.0 || scale <= 0.0 || !ok)
            return INFINITY;
        const Consts& c = sh->c;
        fill_consts(x, sh->c);
        for (int q = threadIdx.x; q < b.n; q += kThreads) {
            const double le = log(perr((double)b.idx[q], scale, shape));
            b.le[q] = finite(le) ? le : -1000.0;
        }
        __syncthreads();
        const double zeta = zeta_of(c);
        double part = 0.0;
        for_each_genomic(b, shape2, c, [&](int q, double s) {
            double lg = log(s / zeta);
            lg = finite(lg) ? lg : -1000.0;
            const double z = b.z[q];
            part += b.cov[q] * (z * b.le[q] + (1.0 - z) * lg);
        });
        return -block_sum(part, sh->red);
    }
};

// The E-step (`_estep`) into b.z; returns sum(z * cov) to every thread.
__device__ double estep(const double* x, double p, const Bins& b, Shared& sh) {
    const double shape = x[1], scale = x[4], shape2 = x[5];
    __syncthreads();                   // the last evaluation's reads of the constants are done
    fill_consts(x, sh.c);
    __syncthreads();
    const double zeta = zeta_of(sh.c);
    double part = 0.0;
    for_each_genomic(b, shape2, sh.c, [&](int q, double s) {
        const double pe = p * perr((double)b.idx[q], scale, shape);
        double z = pe / (pe + (1.0 - p) * (s / zeta));
        z = finite(z) ? z : 1.0;
        b.z[q] = z;
        part += z * b.cov[q];
    });
    return block_sum(part, sh.red);
}

struct Init {
    double x[kDim];
    double err_prob, total;
};

__global__ void __launch_bounds__(kThreads)
coverage_em_kernel(const double* cov, int n, Init init, double* out) {
    extern __shared__ double em_smem[];
    Shared& sh = *reinterpret_cast<Shared*>(em_smem);
    double* base = em_smem + (sizeof(Shared) + 7) / 8;
    double* const cv = base;
    Bins b;
    b.cov = cv;
    b.z = base + n;
    b.le = base + 2 * n;
    b.gp = base + 3 * n;
    int* idx = reinterpret_cast<int*>(base + 3 * n + kPairCap);
    b.idx = idx;

    // compact the non-empty bins in order: thread t takes a contiguous chunk
    const int t = threadIdx.x;
    const int chunk = (n + kThreads - 1) / kThreads;
    const int lo = t * chunk < n ? t * chunk : n, hi = lo + chunk < n ? lo + chunk : n;
    int mine = 0;
    for (int i = lo; i < hi; ++i) mine += cov[i] > 0.0 ? 1 : 0;
    int* counts = idx + n;             // scratch behind the bins
    counts[t] = mine;
    __syncthreads();
    if (t == 0) {
        int run = 0;
        for (int u = 0; u < kThreads; ++u) {
            const int m = counts[u];
            counts[u] = run;
            run += m;
        }
        counts[kThreads] = run;
    }
    __syncthreads();
    int at = counts[t];
    for (int i = lo; i < hi; ++i) {
        const double v = cov[i];
        if (v > 0.0) {
            cv[at] = v;
            idx[at] = i + 1;
            ++at;
        }
    }
    b.n = counts[kThreads];
    __syncthreads();

    double x[kDim];
    for (int j = 0; j < kDim; ++j) x[j] = init.x[j];
    double err_prob = init.err_prob;
    double prev_p = 2.0;
    int it = 1, evals = 0;
    Objective f{b, &sh};
    while (fabs(prev_p - err_prob) > kTol && it <= kMaxRounds) {
        const double zsum = estep(x, err_prob, b, sh);
        prev_p = err_prob;
        err_prob = zsum / init.total;
        const bool last_iter = fabs(prev_p - err_prob) <= kTol;
        // maxfev 5*6*it; on the last round scipy's defaults
        const int maxfev = last_iter ? kDefaultEvals : 5 * kDim * it;
        const int maxiter = last_iter ? kDefaultEvals : 0x7fffffff;
        double r[kDim];
        for (int j = 0; j < kDim; ++j) r[j] = x[j];
        int nfev = 0, nit = 0;
        nelder_mead(f, r, maxfev, maxiter, sh.s, &nfev, &nit);
        evals += nfev;
        bool keep = true;
        for (int j = 0; j < kDim; ++j) keep = keep && finite(r[j]);
        if (keep)
            for (int j = 0; j < kDim; ++j) x[j] = r[j];
        ++it;
    }
    if (t == 0) {
        for (int j = 0; j < kDim; ++j) out[j] = x[j];
        out[kDim] = err_prob;
        out[kDim + 1] = it - 1;
        out[kDim + 2] = evals;
    }
}

constexpr size_t smem_bytes(int n) {
    return ((sizeof(Shared) + 7) / 8) * 8 + (size_t)n * (3 * sizeof(double) + sizeof(int)) +
           kPairCap * sizeof(double) + (kThreads + 1) * sizeof(int);
}

}  // namespace

// Returns the launch's cudaGetLastError() (0 on success); 1 (an invalid
// value) when n is out of 1..5000 or a pointer is null.  `cov` and `out` are
// device memory; `init` (x0[6], err_prob, total) host memory.
extern "C" int spades_coverage_em(const void* cov, int n, const double* init, void* out,
                                  void* stream) {
    if (n < 1 || n > kMaxBins || cov == nullptr || init == nullptr || out == nullptr)
        return (int)cudaErrorInvalidValue;
    Init in;
    for (int j = 0; j < kDim; ++j) in.x[j] = init[j];
    in.err_prob = init[kDim];
    in.total = init[kDim + 1];
    const size_t smem = smem_bytes(n);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(coverage_em_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    SPADES_LAUNCH(coverage_em_kernel, 1, kThreads, smem, static_cast<cudaStream_t>(stream),
                  static_cast<const double*>(cov), n, in, static_cast<double*>(out));
    return (int)cudaGetLastError();
}

extern "C" const char* spades_coverage_em_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
