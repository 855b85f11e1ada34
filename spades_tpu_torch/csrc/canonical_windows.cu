// Canonical k-mer windows of a packed read batch, as int64 sort keys, with an
// optional strand plane.
//
// Replaces the Pallas TPU kernel spades_tpu/ops/pallas_kernels.py
// `_extract_kernel` (launched by `canonical_windows_planar`), fuses in the
// unpack of the packed wire format that runs just before it
// (spades_tpu/ops/count.py `unpack_batch_device`), and also gives the strand
// bit of spades_tpu/core/kmers.py `canonical_windows_strand`, which the
// Pallas kernel lacks and the read mapper needs.
//
// Input, one row per read (the wire format of core/reads.py):
//   pc      (R, ceil(L/4)) uint8   2-bit codes, base i at bits 2*(i%4) of byte i/4
//   pn      (R, ceil(L/8)) uint8   N mask, base i at bit i%8 of byte i/8
//   lengths (R,)           int32   true read lengths
// Output, for window p of read r (P = L - k + 1 windows per row):
//   keys    (ceil(W/2), R, P) int64  canonical k-mer as sort keys: with the
//           big-endian uint32 words w[0..W) of core/kmers.py (W = ceil(k/16)),
//           plane j = ((w[2j] << 32) | w[2j+1]) ^ INT64_MIN, w[W] = 0 when W
//           is odd; INT64_MAX in every plane where the window is invalid
//   valid   (R, P) uint8/bool   1 iff p + k <= length and the window has no N
//   strand  (R, P) uint8/bool, or null: 1 iff the window is valid and its
//           canonical form is its reverse complement
// The canonical k-mer is the lexicographic minimum of the window and its
// reverse complement, exactly as core/kmers.py `canonical_windows`.
//
// Bound on an H100: memory.  The kernel reads R*(ceil(L/4)+ceil(L/8)+4)
// bytes and writes R*P*(8*ceil(W/2)+1) bytes (R*P more with the strand
// plane); at 3.35 TB/s that is the least time it can take.  The output is
// 97 % of the traffic, so the design is built around full, wide stores:
//
// * A persistent grid (a few blocks per SM) walks over tiles of T reads.  The
//   packed rows of a tile are contiguous in pc and pn, so a tile is staged
//   into shared memory as one span of 16-byte asynchronous copies
//   (cp.async), double-buffered: tile i+1 loads while tile i is computed and
//   stored.  The span starts at the 16-byte line that holds the tile's first
//   byte, so any pointer alignment and any row width take the same path.  The
//   copy therefore reads up to 15 bytes in front of the tile, inside that
//   line and never used: they lie in the same allocation whenever the
//   allocation starts on a 16-byte line, as every CUDA allocator's does.
//   Nothing behind the tile's last byte is read (the last line's copy is cut
//   there and zero-filled).
// * The staged tile is one flat stream of 2-bit bases (row r starts at base
//   4*ceil(L/4)*r) and the windows of a tile are one flat index r*P + p, the
//   output offset itself.  Every thread is busy whatever P is; each thread
//   takes two neighbouring windows and writes 16 bytes per key plane and two
//   bytes of `valid`/`strand`, so a warp writes 512 contiguous bytes a plane.
// * A thread loads the W+2 staged words that cover both windows and both
//   strands once; each 16-base k-mer word is then one funnel shift
//   (bit-reversed and pair-swapped for the forward strand, complemented for
//   the reverse strand), so no thread loops over the k bases.  Reverse-strand
//   words of a partial last word start up to 15 bases before the window, in
//   the previous row or the pad in front of the tile; the last-word mask drops
//   those bits.
// * Stores are streaming (`st.global.cs`): the sort that follows reads more
//   than the L2 holds.

#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

// The launch goes through a macro so that the kernel's index and bit logic
// can also be compiled as host code and checked without a card
// (csrc/emulation/).
#ifndef SPADES_LAUNCH
#define SPADES_LAUNCH(kernel, grid, block, smem, stream, ...) \
    kernel<<<grid, block, smem, stream>>>(__VA_ARGS__)
#endif

// Tuning constants.  The defaults are what every caller runs; only
// tools/kernel_bench.py overrides them (-D) to time other choices.
#ifndef SPADES_TILE_WINDOWS
#define SPADES_TILE_WINDOWS 16384    // target windows per tile
#endif
#ifndef SPADES_TILE_ALIGN
#define SPADES_TILE_ALIGN 64         // tile heights are multiples of this power of two
#endif
#ifndef SPADES_BLOCKS_PER_SM
#define SPADES_BLOCKS_PER_SM 16      // blocks of the persistent grid per SM, where they fit
#endif
#ifdef SPADES_PLAIN_STORES
#define SPADES_STORE(p, v) (*(p) = (v))
#else
#define SPADES_STORE(p, v) __stcs(p, v)
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kTileWindows = SPADES_TILE_WINDOWS;
constexpr int kMaxTileReads = 256;
constexpr int kBlocksPerSM = SPADES_BLOCKS_PER_SM;
constexpr int kFrontPadBytes = 16;   // 64 bases in front of the staged codes
constexpr int kBackPadBytes = 16;
constexpr size_t kMaxSmemBytes = 200 * 1024;

__host__ __device__ inline int round_up16(int x) { return (x + 15) & ~15; }

// Shared-memory layout of one staging buffer, in bytes (all multiples of 16):
// codes (front pad, up to 15 bytes of misalignment, T rows, back pad), then
// the N mask, then the lengths.
struct TileLayout {
    int code_bytes, n_bytes, len_bytes;
    __host__ __device__ TileLayout(int T, int Lc, int Ln)
        : code_bytes(kFrontPadBytes + round_up16(T * Lc) + 32 + kBackPadBytes),
          n_bytes(round_up16(T * Ln) + 32 + kBackPadBytes),
          len_bytes(round_up16(T * 4) + 32) {}
    __host__ __device__ int total() const { return code_bytes + n_bytes + len_bytes; }
};

// Queue 16-byte asynchronous copies of the lines that hold src[0, nbytes)
// into dst (16-byte aligned shared memory).  Byte i of src lands at
// dst[(src & 15) + i].  The last line is read only up to src[nbytes - 1]
// and zero-filled behind it.
__device__ __forceinline__ void stage_async(uint8_t* dst, const uint8_t* src, size_t nbytes) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(src);
    const uintptr_t a0 = a & ~static_cast<uintptr_t>(15);
    const uintptr_t end = a + nbytes;
    const int lines = static_cast<int>(((end + 15) & ~static_cast<uintptr_t>(15)) - a0) >> 4;
    const int over = static_cast<int>(a0 + 16 * (uintptr_t)lines - end);    // 0..15
    for (int i = threadIdx.x; i < lines; i += blockDim.x)
        __pipeline_memcpy_async(dst + 16 * i, reinterpret_cast<const void*>(a0 + 16 * (uintptr_t)i),
                                16, i == lines - 1 ? over : 0);
}

__device__ __forceinline__ int misalign16(const void* p) {
    return static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
}

// little-endian field order -> big-endian k-mer word (first base in the top bits)
__device__ __forceinline__ uint32_t to_big_endian(uint32_t x) {
    x = __brev(x);
    return ((x >> 1) & 0x55555555u) | ((x & 0x55555555u) << 1);
}

// N flags of a window: the NK = ceil(k/32) staged mask words that start at
// the word holding the window's first flag, plus one.
template <int NK>
__device__ __forceinline__ uint32_t load_n_words(const uint32_t* s_n, int lo,
                                                 uint32_t (&reg)[NK + 1]) {
    uint32_t any = 0u;
#pragma unroll
    for (int j = 0; j <= NK; ++j) {
        reg[j] = s_n[(lo >> 5) + j];
        any |= reg[j];
    }
    return any;
}

// Any flag among the k bits that start at bit `sh` (0..32) of reg?  tail_mask
// keeps the k - 32 (NK - 1) bits of the last 32-bit piece.
template <int NK>
__device__ __forceinline__ bool window_has_n(const uint32_t (&reg)[NK + 1], int sh,
                                             uint32_t tail_mask) {
    uint32_t any = 0u;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
        uint32_t piece = __funnelshift_rc(reg[j], reg[j + 1], sh);
        if (j == NK - 1) piece &= tail_mask;
        any |= piece;
    }
    return any != 0u;
}

// Canonical sort keys of one window from the staged words reg[0..W+1], which
// start at the 16-base word holding base (window start + m - 16), m being the
// bases of the last k-mer word.  `off` (0..16) is that base's index in
// reg[0], `d` = 16 - m.  Returns whether the reverse complement was taken.
template <int W>
__device__ __forceinline__ bool window_keys(const uint32_t (&reg)[W + 2], int off, int d,
                                            uint32_t last_mask,
                                            unsigned long long (&key)[(W + 1) / 2]) {
    const int e = off + d;              // 0..31: the window's first base in reg[0..1]
    const bool up = e >= 16;
    const int sh_fw = 2 * (e & 15);
    const int sh_rc = 2 * off;          // 0..32
    uint32_t fw[W], rc[W];
#pragma unroll
    for (int w = 0; w < W; ++w) {
        const uint32_t lo = up ? reg[w + 1] : reg[w];
        const uint32_t hi = up ? reg[w + 2] : reg[w + 1];
        fw[w] = to_big_endian(__funnelshift_r(lo, hi, sh_fw));
        // reverse-strand word w holds the complements of the 16 bases that end
        // at base k-1-16w of the window, the last base in the top bits; for
        // the last word the bases before the window fall in the masked bits
        rc[w] = ~__funnelshift_rc(reg[W - 1 - w], reg[W - w], sh_rc);
    }
    fw[W - 1] &= last_mask;
    rc[W - 1] &= last_mask;
    bool use_rc = false;
    bool decided = false;
#pragma unroll
    for (int w = 0; w < W; ++w) {
        if (!decided && rc[w] != fw[w]) {
            use_rc = rc[w] < fw[w];
            decided = true;
        }
    }
#pragma unroll
    for (int j = 0; j < (W + 1) / 2; ++j) {
        const uint32_t h = use_rc ? rc[2 * j] : fw[2 * j];
        uint32_t l = 0u;
        if (2 * j + 1 < W) l = use_rc ? rc[2 * j + 1] : fw[2 * j + 1];
        key[j] = (((unsigned long long)h << 32) | l) ^ 0x8000000000000000ULL;
    }
    return use_rc;
}

constexpr unsigned long long kSentinelKey = 0x7FFFFFFFFFFFFFFFULL;

template <int W>
__global__ void __launch_bounds__(kThreads)
canonical_windows_kernel(const uint8_t* __restrict__ pc,
                         const uint8_t* __restrict__ pn,
                         const int32_t* __restrict__ lengths,
                         long long* __restrict__ keys,
                         uint8_t* __restrict__ valid,
                         uint8_t* __restrict__ strand,   // may be null
                         int R, int L, int k, int T, int n_tiles, int vec,
                         uint32_t p_magic) {
    extern __shared__ uint4 smem4[];
    constexpr int NK = (W + 1) / 2;
    const int Lc = (L + 3) / 4;
    const int Ln = (L + 7) / 8;
    const int P = L - k + 1;
    const int m = k - 16 * (W - 1);     // bases in the last word, 1..16
    const int d = 16 - m;
    const uint32_t last_mask = m == 16 ? 0xFFFFFFFFu : ~(0xFFFFFFFFu >> (2 * m));
    const int n_tail = k - 32 * (NK - 1);       // N flags in the last 32-bit piece, 1..32
    const uint32_t n_tail_mask = n_tail == 32 ? 0xFFFFFFFFu : ((1u << n_tail) - 1u);
    const size_t plane = (size_t)R * P;
    const TileLayout lay(T, Lc, Ln);
    uint8_t* const smem = reinterpret_cast<uint8_t*>(smem4);

    auto stage = [&](int tile, int buf) {
        const int r0 = tile * T;
        const int rows = min(T, R - r0);
        uint8_t* b = smem + (size_t)buf * lay.total();
        stage_async(b + kFrontPadBytes, pc + (size_t)r0 * Lc, (size_t)rows * Lc);
        stage_async(b + lay.code_bytes, pn + (size_t)r0 * Ln, (size_t)rows * Ln);
        stage_async(b + lay.code_bytes + lay.n_bytes,
                    reinterpret_cast<const uint8_t*>(lengths + r0), (size_t)rows * 4);
    };

    int tile = blockIdx.x;
    int buf = 0;
    if (tile < n_tiles) stage(tile, buf);
    __pipeline_commit();
    for (; tile < n_tiles; tile += gridDim.x, buf ^= 1) {
        const int next = tile + gridDim.x;
        if (next < n_tiles) stage(next, buf ^ 1);
        __pipeline_commit();
        __pipeline_wait_prior(1);       // this tile's copies have landed
        __syncthreads();

        const int r0 = tile * T;
        const int rows = min(T, R - r0);
        const uint8_t* b = smem + (size_t)buf * lay.total();
        const uint32_t* s_code = reinterpret_cast<const uint32_t*>(b);
        const uint32_t* s_n = reinterpret_cast<const uint32_t*>(b + lay.code_bytes);
        const int32_t* s_len = reinterpret_cast<const int32_t*>(
            b + lay.code_bytes + lay.n_bytes + misalign16(lengths + r0));
        // flat base / bit index of base 0 of the tile's first row
        const int base0 = 4 * (kFrontPadBytes + misalign16(pc + (size_t)r0 * Lc));
        const int bit0 = 8 * misalign16(pn + (size_t)r0 * Ln);
        const int n_win = rows * P;
        const size_t o0 = (size_t)r0 * P;

        for (int f = 2 * threadIdx.x; f < n_win; f += 2 * blockDim.x) {
            // f = rA * P + pA by a multiply: p_magic is about 2^32 / P, and
            // the quotient it gives is off by at most one
            int rA = (int)__umulhi((uint32_t)f, p_magic);
            int pA = f - rA * P;
            if (pA < 0) { --rA; pA += P; } else if (pA >= P) { ++rA; pA -= P; }
            const bool two = f + 1 < n_win;
            const bool same = pA + 1 < P;           // the neighbour is in the same read
            const int rB = same ? rA : rA + 1;
            const int pB = same ? pA + 1 : 0;
            bool okA = pA + k <= s_len[rA];
            bool okB = two && pB + k <= s_len[rB];
            {
                uint32_t nreg[NK + 1];
                const int loA = bit0 + rA * 8 * Ln + pA;
                if (load_n_words<NK>(s_n, loA, nreg) != 0u) {   // rarely: an N is near
                    okA = okA && !window_has_n<NK>(nreg, loA & 31, n_tail_mask);
                    if (same) okB = okB && !window_has_n<NK>(nreg, (loA & 31) + 1, n_tail_mask);
                }
                if (!same && okB) {
                    const int loB = bit0 + rB * 8 * Ln;
                    if (load_n_words<NK>(s_n, loB, nreg) != 0u)
                        okB = !window_has_n<NK>(nreg, loB & 31, n_tail_mask);
                }
            }
            unsigned long long keyA[NK], keyB[NK];
            bool rcA = false, rcB = false;
#pragma unroll
            for (int j = 0; j < NK; ++j) keyA[j] = keyB[j] = kSentinelKey;
            if (okA || okB) {
                uint32_t reg[W + 2];
                // the window's reverse-strand stream starts m - 16 bases
                // before the window (>= 15 bases into the front pad)
                const int sA = base0 + rA * 4 * Lc + pA - d;
                const int wA = sA >> 4;
                if (okA || same) {
#pragma unroll
                    for (int j = 0; j < W + 2; ++j) reg[j] = s_code[wA + j];
                }
                if (okA) rcA = window_keys<W>(reg, sA & 15, d, last_mask, keyA);
                if (okB) {
                    int offB = (sA & 15) + 1;
                    if (!same) {
                        const int sB = base0 + rB * 4 * Lc + pB - d;
#pragma unroll
                        for (int j = 0; j < W + 2; ++j) reg[j] = s_code[(sB >> 4) + j];
                        offB = sB & 15;
                    }
                    rcB = window_keys<W>(reg, offB, d, last_mask, keyB);
                }
            }
            const size_t o = o0 + f;
            if (vec && two) {
#pragma unroll
                for (int j = 0; j < NK; ++j)
                    SPADES_STORE(reinterpret_cast<uint4*>(keys + j * plane + o),
                                  make_uint4((uint32_t)keyA[j], (uint32_t)(keyA[j] >> 32),
                                             (uint32_t)keyB[j], (uint32_t)(keyB[j] >> 32)));
                SPADES_STORE(reinterpret_cast<uchar2*>(valid + o),
                              make_uchar2(okA ? 1 : 0, okB ? 1 : 0));
                if (strand != nullptr)
                    SPADES_STORE(reinterpret_cast<uchar2*>(strand + o),
                                  make_uchar2(rcA ? 1 : 0, rcB ? 1 : 0));
            } else {
#pragma unroll
                for (int j = 0; j < NK; ++j) {
                    keys[j * plane + o] = (long long)keyA[j];
                    if (two) keys[j * plane + o + 1] = (long long)keyB[j];
                }
                valid[o] = okA ? 1 : 0;
                if (two) valid[o + 1] = okB ? 1 : 0;
                if (strand != nullptr) {
                    strand[o] = rcA ? 1 : 0;
                    if (two) strand[o + 1] = rcB ? 1 : 0;
                }
            }
        }
        __syncthreads();                // all reads of this buffer are done
    }
    __pipeline_wait_prior(0);
}

int sm_count() {
    static int n = 0;
    if (n == 0) {
        int dev = 0;
        if (cudaGetDevice(&dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n <= 0)
            n = 132;
    }
    return n;
}

template <int W>
cudaError_t launch(const uint8_t* pc, const uint8_t* pn, const int32_t* lengths,
                   long long* keys, uint8_t* valid, uint8_t* strand, int R, int L, int k,
                   cudaStream_t stream) {
    const int Lc = (L + 3) / 4;
    const int Ln = (L + 7) / 8;
    const int P = L - k + 1;
    // tiles of about kTileWindows windows, but at least two tiles for every
    // SM while the batch has the reads for it.  The height is a multiple of
    // 64 (or of the largest power of two it reaches): every tile's first
    // output offset is then even, and a warp's 512-byte store of a key plane
    // starts on a 512-byte line whatever P is
    int T = kTileWindows / P;
    const int spread = R / (2 * sm_count());
    if (T > spread) T = spread;
    T = T < 2 ? 2 : (T > kMaxTileReads ? kMaxTileReads : T);
    int align = SPADES_TILE_ALIGN;
    while (align > T) align >>= 1;
    T &= ~(align - 1);
    while (T > 1 && 2 * (size_t)TileLayout(T, Lc, Ln).total() > kMaxSmemBytes) T /= 2;
    const size_t smem = 2 * (size_t)TileLayout(T, Lc, Ln).total();
    if (smem > kMaxSmemBytes) return cudaErrorInvalidValue;   // one row does not fit
    const int n_tiles = (R + T - 1) / T;
    // two windows per 16-byte store need even offsets in every plane
    const bool even = T % 2 == 0 && ((W + 1) / 2 == 1 || ((size_t)R * P) % 2 == 0);
    const bool aligned = reinterpret_cast<uintptr_t>(keys) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(valid) % 2 == 0 &&
                         reinterpret_cast<uintptr_t>(strand) % 2 == 0;
    auto kern = canonical_windows_kernel<W>;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
        if (e != cudaSuccess) return e;
    }
    int per_sm = (int)(kMaxSmemBytes / smem);
    per_sm = per_sm < 1 ? 1 : (per_sm > kBlocksPerSM ? kBlocksPerSM : per_sm);
    int grid = sm_count() * per_sm;
    if (grid > n_tiles) grid = n_tiles;
    const uint64_t magic = ((1ull << 32) + P - 1) / P;      // 2^32 itself when P = 1
    SPADES_LAUNCH(kern, grid, kThreads, smem, stream, pc, pn, lengths, keys, valid, strand,
                  R, L, k, T, n_tiles, (even && aligned) ? 1 : 0,
                  (uint32_t)(magic > 0xFFFFFFFFull ? 0xFFFFFFFFull : magic));
    return cudaGetLastError();
}

}  // namespace

// Returns the launch's cudaGetLastError() (0 on success); 1 (an invalid
// value) when k or the shapes are out of range.  `strand` may be null.
extern "C" int spades_canonical_windows(const void* pc, const void* pn,
                                        const void* lengths, void* keys,
                                        void* valid, void* strand, int R, int L, int k,
                                        void* stream) {
    if (R <= 0 || k < 1 || k > 128 || L < k) return (int)cudaErrorInvalidValue;
    const auto* c = static_cast<const uint8_t*>(pc);
    const auto* n = static_cast<const uint8_t*>(pn);
    const auto* ln = static_cast<const int32_t*>(lengths);
    auto* ky = static_cast<long long*>(keys);
    auto* v = static_cast<uint8_t*>(valid);
    auto* sd = static_cast<uint8_t*>(strand);
    auto s = static_cast<cudaStream_t>(stream);
    switch ((k + 15) / 16) {
        case 1: return (int)launch<1>(c, n, ln, ky, v, sd, R, L, k, s);
        case 2: return (int)launch<2>(c, n, ln, ky, v, sd, R, L, k, s);
        case 3: return (int)launch<3>(c, n, ln, ky, v, sd, R, L, k, s);
        case 4: return (int)launch<4>(c, n, ln, ky, v, sd, R, L, k, s);
        case 5: return (int)launch<5>(c, n, ln, ky, v, sd, R, L, k, s);
        case 6: return (int)launch<6>(c, n, ln, ky, v, sd, R, L, k, s);
        case 7: return (int)launch<7>(c, n, ln, ky, v, sd, R, L, k, s);
        default: return (int)launch<8>(c, n, ln, ky, v, sd, R, L, k, s);
    }
}

extern "C" const char* spades_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
