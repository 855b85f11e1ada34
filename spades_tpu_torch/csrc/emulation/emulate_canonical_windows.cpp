// csrc/canonical_windows.cu compiled as host code: the same source, with the
// CUDA names it uses replaced by the stand-ins of this directory, behind the
// same C interface.  It checks what a CPU can check of the kernel: tiling,
// staging offsets, flat indices, the bit logic and the store paths.
//
//   g++ -std=c++17 -O1 -shared -fPIC -pthread -I csrc/emulation \
//       -o libcanonical_windows_emulated.so csrc/emulation/emulate_canonical_windows.cpp
//
// Input rows are read from the 16-byte line that holds their first byte, so
// let every array start on such a line or give it 16 bytes of slack in front.
#include "cuda_runtime.h"

#define SPADES_LAUNCH(kernel, grid, block, smem, stream, ...) \
    spades_emulation::run_grid(grid, block, [&] { kernel(__VA_ARGS__); })

#include "../canonical_windows.cu"

// the dynamic shared memory of the one block that runs at a time
namespace {
uint4 smem4[kMaxSmemBytes / sizeof(uint4)];
}
