// Host stand-ins for the few CUDA names that the kernels of csrc/ use, so
// that their index, bit and control logic can be compiled with a plain C++
// compiler and run on the CPU (see emulate_*.cpp).  A block is
// a group of host threads, __syncthreads() a barrier among them, shared
// memory a static array, and an asynchronous copy an immediate memcpy.
#pragma once

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__

using std::max;
using std::min;

struct alignas(16) uint4 { uint32_t x, y, z, w; };
struct alignas(2) uchar2 { unsigned char x, y; };
inline uint4 make_uint4(uint32_t x, uint32_t y, uint32_t z, uint32_t w) { return {x, y, z, w}; }
inline uchar2 make_uchar2(unsigned char x, unsigned char y) { return {x, y}; }

struct EmuDim3 { unsigned x = 1, y = 1, z = 1; };
inline thread_local EmuDim3 threadIdx;
inline EmuDim3 blockIdx, blockDim, gridDim;

inline uint32_t __brev(uint32_t x) {
    uint32_t r = 0;
    for (int i = 0; i < 32; ++i) r |= ((x >> i) & 1u) << (31 - i);
    return r;
}
inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, uint32_t s) {
    return (uint32_t)((((uint64_t)hi << 32) | lo) >> (s & 31));
}
inline uint32_t __funnelshift_rc(uint32_t lo, uint32_t hi, uint32_t s) {
    return (uint32_t)((((uint64_t)hi << 32) | lo) >> (s > 32 ? 32 : s));
}
inline uint32_t __umulhi(uint32_t a, uint32_t b) { return (uint32_t)(((uint64_t)a * b) >> 32); }
template <typename V> inline void __stcs(V* p, V v) { *p = v; }

namespace spades_emulation {

// A block's barrier: the last thread to arrive opens the next phase; the
// others yield until it does (a block has more threads than the host cores).
class Barrier {
  public:
    void reset(int n) { n_ = n; waiting_ = 0; phase_ = 0; }
    void wait() {
        const int phase = phase_.load(std::memory_order_acquire);
        if (waiting_.fetch_add(1, std::memory_order_acq_rel) + 1 == n_) {
            waiting_.store(0, std::memory_order_relaxed);
            phase_.store(phase + 1, std::memory_order_release);
        } else {
            while (phase_.load(std::memory_order_acquire) == phase) std::this_thread::yield();
        }
    }

  private:
    int n_ = 1;
    std::atomic<int> waiting_{0}, phase_{0};
};

inline Barrier block_barrier;

// Run `body` as grid x block threads: the blocks one after another, the
// threads of a block together.
inline void run_grid(int grid, int block, const std::function<void()>& body) {
    gridDim.x = grid;
    blockDim.x = block;
    for (int b = 0; b < grid; ++b) {
        blockIdx.x = b;
        block_barrier.reset(block);
        std::vector<std::thread> threads;
        threads.reserve(block);
        for (int t = 0; t < block; ++t)
            threads.emplace_back([&, t] { threadIdx.x = t; body(); });
        for (auto& th : threads) th.join();
    }
}

}  // namespace spades_emulation

inline void __syncthreads() { spades_emulation::block_barrier.wait(); }

// A warp shuffle, for code that calls it from every thread of the block at
// once (as block-wide sums do): each thread posts its value, then reads its
// partner's.
inline double __shfl_xor_sync(unsigned, double v, int lane_mask) {
    static double posted[1024];
    posted[threadIdx.x] = v;
    spades_emulation::block_barrier.wait();
    const double r = posted[threadIdx.x ^ lane_mask];
    spades_emulation::block_barrier.wait();
    return r;
}

// float64 steps with their own rounding (host code contracts nothing here)
inline double __dadd_rn(double a, double b) { return a + b; }
inline double __dsub_rn(double a, double b) { return a - b; }
inline double __dmul_rn(double a, double b) { return a * b; }

typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr cudaError_t cudaSuccess = 0;
constexpr cudaError_t cudaErrorInvalidValue = 1;
constexpr int cudaDevAttrMultiProcessorCount = 16;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline cudaError_t cudaGetDevice(int* dev) { *dev = 0; return cudaSuccess; }
// one emulated SM keeps the grid small, so each block walks several tiles
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) { *v = 1; return cudaSuccess; }
template <typename F> inline cudaError_t cudaFuncSetAttribute(F, int, int) { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t e) { return e == 0 ? "no error" : "invalid value"; }
