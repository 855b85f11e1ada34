// csrc/coverage_em.cu compiled as host code: the same source, with the CUDA
// names it uses replaced by the stand-ins of this directory, behind the same
// C interface.  It checks what a CPU can check of the kernel: the minimiser's
// path, the compaction of the bins, the block's sums and barriers, the loop
// over rounds.  Besides the kernel's interface it exports the minimiser alone
// on a test objective, a weighted quadratic that host code and Python compute
// with the same float64 steps, optionally infinite above a bound on one axis.
//
//   g++ -std=c++17 -O1 -shared -fPIC -pthread -I csrc/emulation \
//       -DSPADES_EM_THREADS=64 -o libcoverage_em_emulated.so \
//       csrc/emulation/emulate_coverage_em.cpp
#include "cuda_runtime.h"

#define SPADES_LAUNCH(kernel, grid, block, smem, stream, ...) \
    spades_emulation::run_grid(grid, block, [&] { kernel(__VA_ARGS__); })

#include "../coverage_em.cu"

namespace {
// the dynamic shared memory of the one block
double em_smem[smem_bytes(kMaxBins) / sizeof(double) + 1];

// sum_j c[j] * (x[j] - a[j])^2, left to right; inf where x[axis] > bound
struct Quadratic {
    const double* c;
    const double* a;
    int axis;
    double bound;

    double operator()(const double* x) const {
        if (axis >= 0 && x[axis] > bound) return INFINITY;
        double s = 0.0;
        for (int j = 0; j < kDim; ++j) {
            const double d = x[j] - a[j];
            s = s + c[j] * (d * d);
        }
        return s;
    }
};
}  // namespace

// Nelder-Mead from x0 on the quadratic, as the kernel runs it in a block;
// writes the best vertex to x_out and (nfev, nit) to counts.
extern "C" int spades_nelder_mead_quadratic(const double* c, const double* a, int axis,
                                            double bound, const double* x0, int maxfev,
                                            int maxiter, double* x_out, int* counts) {
    spades_emulation::run_grid(1, kThreads, [&] {
        Shared& sh = *reinterpret_cast<Shared*>(em_smem);
        Quadratic f{c, a, axis, bound};
        double x[kDim];
        for (int j = 0; j < kDim; ++j) x[j] = x0[j];
        int nfev = 0, nit = 0;
        nelder_mead(f, x, maxfev, maxiter, sh.s, &nfev, &nit);
        if (threadIdx.x == 0) {
            for (int j = 0; j < kDim; ++j) x_out[j] = x[j];
            counts[0] = nfev;
            counts[1] = nit;
        }
    });
    return 0;
}
