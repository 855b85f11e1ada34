// Host stand-in for <cuda_pipeline.h>: an asynchronous copy is done at once,
// which is one of the orders the hardware may take.
#pragma once

#include <cstddef>
#include <cstring>

inline void __pipeline_memcpy_async(void* dst, const void* src, size_t n, size_t zfill = 0) {
    std::memcpy(dst, src, n - zfill);
    std::memset(static_cast<char*>(dst) + n - zfill, 0, zfill);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(int) {}
