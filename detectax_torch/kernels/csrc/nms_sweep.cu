// Greedy hard-NMS over K score-sorted boxes as a suppression bitmask and a
// sweep over it: two launches from one entry point.
//
// Replaces the TPU kernel detectax/ops/pallas/nms_kernel.py::_nms_kernel
// (suppression_mask_pallas). Same function: keep[i] starts as valid[i];
// walking i in score order, every still-kept i drops each later j whose
// IoU with it exceeds the threshold (same class only, when classes are
// given). Padding (valid = 0) neither survives nor suppresses.
//
// The TPU kernel walked i and computed each IoU row inside the serial
// chain, on one core. Here the IoUs leave the chain, because IoU(i, j)
// does not depend on what was kept:
//
//   (a) nms_mask_kernel fills the upper triangle of a [K, W] bitmask per
//       image, W = ceil(K / 64): bit b of word w in row i is set iff
//       j = 64w + b > i, the classes match and IoU(i, j) > thresh. The
//       grid is B x T(T+1)/2 tiles of 64 x 64 (T = W), spread over every
//       SM; a tile stages its 64 column boxes in shared memory and two of
//       its 128 threads build one 64-bit word, 32 bits each, joined in
//       shared memory. Every word has one writer, so nothing needs
//       atomics. Rows of the last tile past K are written as zeros; tiles
//       below the diagonal are never written.
//   (b) nms_sweep_kernel walks the rows, one warp per image. The removed
//       set lives in registers, lane w holding word w (and w + 32, ...).
//       It starts as not-valid, plus every bit past K. The mask rows come
//       in through a ring of bulk asynchronous copies (one 64-row tile a
//       stage, an mbarrier each), so the chain never waits on L2. For tile
//       r the chain is 64 steps over the diagonal words only, in
//       registers: step b keeps row 64r + b iff its bit of the removed
//       word r is clear, and then ORs that row's diagonal word in. The
//       kept rows of the tile then OR their words past r into the removed
//       set, every lane its own words, with no dependence between rows.
//   (c) Above K = 14,464 two 64-row tiles of the mask no longer fit a
//       block's shared memory, nor the removed set a warp's registers
//       (8 words a lane). There nms_sweep_wide_kernel takes the place of
//       (b): one block per image keeps the removed set in shared memory
//       (8 W bytes: 2.5 KB at K = 20,000) and reads the mask where
//       (a) left it, in device memory and mostly in L2. For tile r, 64
//       threads load the tile's diagonal words, one thread runs the
//       64-step chain on them in registers, and then every thread takes
//       columns w > r of the tile, 256 at a time (a column chunk), and
//       ORs in the words of the tile's kept rows only: consecutive
//       threads read consecutive words of a row, and a row that was not
//       kept is not read at all. Each column has one writer, so nothing
//       needs atomics, and the keep set is the ring's bit for bit.
//
// What bounds it: the sweep's chain, K steps of a few dependent ALU
// operations on one SM per image; the mask is B * K^2 / 2 IoUs spread
// over the card, and both its bytes (B * K * W * 8 written once, read
// once from L2) and its operations are far below the card's rates at the
// serving path's K = 1,024 (numbers in PERF.md).
//
// Arithmetic is kept bit-for-bit equal to the plain PyTorch version
// (nms_sweep_plain): the file is compiled with -fmad=false and without
// fast-math, area is (y2-y1)*(x2-x1) unclamped, and the IoU is
// inter / (area_j + area_i - inter + 1e-8) in that order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;     // rows and columns of a mask tile; bits a word
constexpr int kMaxSlots = 8;  // removed words a lane holds: W <= 256
constexpr int kMaskThreads = 2 * kTile;

typedef unsigned long long u64;

// Two threads a row, 32 columns each: twice the warps to hide the
// division's latency behind, half the chain of each.
__global__ void __launch_bounds__(kMaskThreads) nms_mask_kernel(
    const float* __restrict__ boxes,  // [B, K, 4] y1 x1 y2 x2
    const int* __restrict__ classes,  // [B, K] or nullptr: class-agnostic
    u64* __restrict__ mask,           // [B, 64 W, W]
    int k, int words, float iou_thresh)
{
    __shared__ float4 cbox[kTile];
    __shared__ float carea[kTile];
    __shared__ int ccls[kTile];
    __shared__ unsigned high[kTile];

    // tile (r, c), c >= r, from its place in the upper triangle, row-major
    int t = blockIdx.x;
    int r = 0;
    while (t >= words - r) {
        t -= words - r;
        ++r;
    }
    const int c = r + t;
    const int tid = threadIdx.x;
    const int row = tid % kTile;
    const int half = tid / kTile;
    const size_t base = static_cast<size_t>(blockIdx.y) * k;
    const float4* gbox = reinterpret_cast<const float4*>(boxes) + base;
    const bool class_aware = classes != nullptr;

    const int jt = c * kTile + tid;
    if (tid < kTile && jt < k) {
        const float4 b = gbox[jt];
        cbox[tid] = b;
        carea[tid] = (b.z - b.x) * (b.w - b.y);
        ccls[tid] = class_aware ? classes[base + jt] : 0;
    }
    __syncthreads();

    const int i = r * kTile + row;
    unsigned bits = 0;
    if (i < k) {
        const float4 bi = gbox[i];
        const float ai = (bi.z - bi.x) * (bi.w - bi.y);
        const int ci = class_aware ? classes[base + i] : 0;
        const int b0 = half * 32;
        const int n = min(32, k - c * kTile - b0);
#pragma unroll 8
        for (int b = 0; b < n; ++b) {
            const float4 bj = cbox[b0 + b];
            const float ih = fmaxf(0.0f, fminf(bj.z, bi.z) - fmaxf(bj.x, bi.x));
            const float iw = fmaxf(0.0f, fminf(bj.w, bi.w) - fmaxf(bj.y, bi.y));
            const float inter = ih * iw;
            const float iou = inter / (carea[b0 + b] + ai - inter + 1e-8f);
            const bool hit = c * kTile + b0 + b > i && ccls[b0 + b] == ci
                             && iou > iou_thresh;
            bits |= static_cast<unsigned>(hit) << b;
        }
    }
    if (half == 1) high[row] = bits;
    __syncthreads();
    if (half == 0) {
        const size_t at = static_cast<size_t>(blockIdx.y) * words * kTile + i;
        mask[at * words + c] = (static_cast<u64>(high[row]) << 32) | bits;
    }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 :: "r"(smem_addr(bar)) : "memory");
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global to shared memory; `bar` completes its phase when they arrived.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
        : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    } while (!done);
}

// One warp per image. SLOTS: removed words per lane (W <= 32 * SLOTS).
template <int SLOTS>
__global__ void __launch_bounds__(32) nms_sweep_kernel(
    const u64* __restrict__ mask,       // [B, 64 W, W] from nms_mask_kernel
    const uint8_t* __restrict__ valid,  // [B, K] or nullptr: all valid
    uint8_t* __restrict__ keep,         // [B, K] out, 0/1
    int k, int words, int stages)
{
    extern __shared__ __align__(128) unsigned char smem_raw[];
    const int lane = threadIdx.x;
    const int tile_words = kTile * words;
    const uint32_t tile_bytes = static_cast<uint32_t>(tile_words) * 8u;
    u64* ring = reinterpret_cast<u64*>(smem_raw);  // [stages][64][W]
    uint64_t* bars = reinterpret_cast<uint64_t*>(
        smem_raw + static_cast<size_t>(stages) * tile_bytes);
    const u64* gmask = mask + static_cast<size_t>(blockIdx.x) * words * tile_words;
    const size_t base = static_cast<size_t>(blockIdx.x) * k;

    if (lane == 0) {
        for (int s = 0; s < stages; ++s) mbar_init(&bars[s]);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        for (int s = 0; s < stages && s < words; ++s)
            bulk_load(ring + static_cast<size_t>(s) * tile_words,
                      gmask + static_cast<size_t>(s) * tile_words,
                      tile_bytes, &bars[s]);
    }
    __syncwarp();

    // removed := not valid, and every bit past K (while the first copies fly)
    const uint8_t* gvalid = valid != nullptr ? valid + base : nullptr;
    u64 rem[SLOTS];
#pragma unroll
    for (int q = 0; q < SLOTS; ++q) {
        rem[q] = ~0ull;
        if (q * 32 >= words) continue;
        bool lo[32], hi[32];
#pragma unroll
        for (int l = 0; l < 32; ++l) {
            const int j = (q * 32 + l) * kTile + lane;
            lo[l] = j >= k || (gvalid != nullptr && gvalid[j] == 0);
            hi[l] = j + 32 >= k || (gvalid != nullptr && gvalid[j + 32] == 0);
        }
#pragma unroll
        for (int l = 0; l < 32; ++l) {
            const u64 w = (static_cast<u64>(__ballot_sync(0xffffffffu, hi[l])) << 32)
                          | __ballot_sync(0xffffffffu, lo[l]);
            if (lane == l) rem[q] = w;
        }
    }

    for (int r = 0; r < words; ++r) {
        const int s = r % stages;
        mbar_wait(&bars[s], static_cast<uint32_t>(r / stages) & 1u);
        const u64* tile = ring + static_cast<size_t>(s) * tile_words;

        // the chain: removed word r from its owner, then 64 steps over the
        // diagonal words of the tile's rows
        u64 cur = 0;
#pragma unroll
        for (int q = 0; q < SLOTS; ++q)
            if (q == (r >> 5)) cur = rem[q];
        cur = __shfl_sync(0xffffffffu, cur, r & 31);
        u64 kept = 0;
#pragma unroll
        for (int b = 0; b < kTile; ++b) {
            const u64 d = tile[b * words + r];
            if (((cur >> b) & 1ull) == 0) {
                kept |= 1ull << b;
                cur |= d;
            }
        }

        const int i0 = r * kTile + lane;
        if (i0 < k) keep[base + i0] = static_cast<uint8_t>((kept >> lane) & 1ull);
        if (i0 + 32 < k)
            keep[base + i0 + 32] = static_cast<uint8_t>((kept >> (lane + 32)) & 1ull);

        // every kept row removes what it overlaps among the later words:
        // each lane folds its words of all 64 rows, a row not kept masked
        // to zero, so that the 64 loads do not wait on one another
#pragma unroll
        for (int q = 0; q < SLOTS; ++q) {
            const int w = q * 32 + lane;
            if (w > r && w < words) {
                u64 acc[4] = {0ull, 0ull, 0ull, 0ull};
#pragma unroll
                for (int b = 0; b < kTile; ++b)
                    acc[b & 3] |= tile[b * words + w] & (0ull - ((kept >> b) & 1ull));
                rem[q] |= (acc[0] | acc[1]) | (acc[2] | acc[3]);
            }
        }
        __syncwarp();

        // the stage is read: refill it with tile r + stages
        if (lane == 0 && r + stages < words) {
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            bulk_load(ring + static_cast<size_t>(s) * tile_words,
                      gmask + static_cast<size_t>(r + stages) * tile_words,
                      tile_bytes, &bars[s]);
        }
    }
}

// One block per image: the removed set in shared memory, the mask read
// from device memory (K > 14,464, where the ring of (b) does not fit).
constexpr int kWideThreads = 256;

__global__ void __launch_bounds__(kWideThreads) nms_sweep_wide_kernel(
    const u64* __restrict__ mask,       // [B, 64 W, W] from nms_mask_kernel
    const uint8_t* __restrict__ valid,  // [B, K] or nullptr: all valid
    uint8_t* __restrict__ keep,         // [B, K] out, 0/1
    int k, int words)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    u64* rem = reinterpret_cast<u64*>(smem_raw);  // [W] removed set
    __shared__ u64 diag[kTile];
    __shared__ u64 kept_s;
    const int tid = threadIdx.x;
    const size_t row_words = static_cast<size_t>(words);
    const u64* gmask = mask + static_cast<size_t>(blockIdx.x) * kTile * row_words * row_words;
    const size_t base = static_cast<size_t>(blockIdx.x) * k;

    // removed := not valid, and every bit past K
    for (int w = tid; w < words; w += kWideThreads) {
        u64 word = 0;
        for (int b = 0; b < kTile; ++b) {
            const int j = w * kTile + b;
            const bool gone = j >= k || (valid != nullptr && valid[base + j] == 0);
            word |= static_cast<u64>(gone) << b;
        }
        rem[w] = word;
    }
    __syncthreads();

    // the next tile's diagonal words are loaded while this tile is swept
    u64 dnext = tid < kTile ? gmask[static_cast<size_t>(tid) * row_words] : 0ull;
    for (int r = 0; r < words; ++r) {
        const u64* tile = gmask + static_cast<size_t>(r) * kTile * row_words;
        if (tid < kTile) diag[tid] = dnext;
        __syncthreads();  // the diagonal, and rem[r] from the tiles before
        if (tid == 0) {
            u64 d[kTile];
#pragma unroll
            for (int b = 0; b < kTile; ++b) d[b] = diag[b];
            u64 cur = rem[r], kept = 0;
#pragma unroll
            for (int b = 0; b < kTile; ++b) {
                if (((cur >> b) & 1ull) == 0) {
                    kept |= 1ull << b;
                    cur |= d[b];
                }
            }
            kept_s = kept;
        }
        __syncthreads();
        const u64 kept = kept_s;
        if (tid < kTile && r + 1 < words)
            dnext = tile[(kTile + static_cast<size_t>(tid)) * row_words + r + 1];
        if (tid < kTile && r * kTile + tid < k)
            keep[base + r * kTile + tid] = static_cast<uint8_t>((kept >> tid) & 1ull);
        // the kept rows remove what they overlap among the later words, a
        // chunk of kWideThreads columns at a time; eight loads in flight
        for (int w = r + 1 + tid; w < words; w += kWideThreads) {
            u64 acc = 0ull;
            u64 rows = kept;
            while (rows != 0ull) {
                u64 v[8];
#pragma unroll
                for (int q = 0; q < 8; ++q) {
                    v[q] = 0ull;
                    if (rows != 0ull) {
                        const int b = __ffsll(static_cast<long long>(rows)) - 1;
                        rows &= rows - 1;
                        v[q] = tile[static_cast<size_t>(b) * row_words + w];
                    }
                }
#pragma unroll
                for (int q = 0; q < 8; ++q) acc |= v[q];
            }
            rem[w] |= acc;
        }
    }
}

cudaError_t launch_mask(const void* boxes, const void* classes, void* mask,
                        int batch, int k, float iou_thresh, cudaStream_t stream)
{
    const int words = (k + kTile - 1) / kTile;
    const dim3 grid(words * (words + 1) / 2, batch);
    nms_mask_kernel<<<grid, kMaskThreads, 0, stream>>>(
        static_cast<const float*>(boxes), static_cast<const int*>(classes),
        static_cast<u64*>(mask), k, words, iou_thresh);
    return cudaGetLastError();
}

template <int SLOTS>
cudaError_t launch_sweep(const void* mask, const void* valid, void* keep,
                         int batch, int k, int words, int stages, cudaStream_t stream)
{
    const size_t smem = static_cast<size_t>(stages) * kTile * words * 8
                        + static_cast<size_t>(stages) * 8;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            nms_sweep_kernel<SLOTS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return e;
    }
    nms_sweep_kernel<SLOTS><<<batch, 32, smem, stream>>>(
        static_cast<const u64*>(mask), static_cast<const uint8_t*>(valid),
        static_cast<uint8_t*>(keep), k, words, stages);
    return cudaGetLastError();
}

cudaError_t launch_sweep_wide(const void* mask, const void* valid, void* keep,
                              int batch, int k, int words, cudaStream_t stream)
{
    const size_t smem = static_cast<size_t>(words) * 8;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            nms_sweep_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return e;
    }
    nms_sweep_wide_kernel<<<batch, kWideThreads, smem, stream>>>(
        static_cast<const u64*>(mask), static_cast<const uint8_t*>(valid),
        static_cast<uint8_t*>(keep), k, words);
    return cudaGetLastError();
}

}  // namespace

// The mask alone, [B, 64 W, W] words (upper-triangle tiles written; the
// caller zeroes the rest if it reads them). Launches on `stream`; returns
// the cudaError_t of the launch (0 = success).
extern "C" int detectax_nms_mask(
    const void* boxes, const void* classes, void* mask,
    int batch, int k, float iou_thresh, void* stream)
{
    return static_cast<int>(launch_mask(boxes, classes, mask, batch, k,
                                        iou_thresh, static_cast<cudaStream_t>(stream)));
}

// Mask then sweep, both on `stream`; `mask` is scratch of B * 64 W * W
// words. `stages` > 0: tiles of 64 W words that fit the ring of
// nms_sweep_kernel (the wrapper's plan); 0: the wide sweep, the removed
// set of W words in shared memory. Allocates nothing and does not
// synchronise. Returns the cudaError_t of the first launch that failed
// (0 = success).
extern "C" int detectax_nms_sweep(
    const void* boxes, const void* classes, const void* valid, void* mask,
    void* keep, int batch, int k, float iou_thresh, int stages, void* stream)
{
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t e = launch_mask(boxes, classes, mask, batch, k, iou_thresh, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    const int words = (k + kTile - 1) / kTile;
    const int slots = (words + 31) / 32;
    if (stages == 0) e = launch_sweep_wide(mask, valid, keep, batch, k, words, st);
    else if (slots <= 1) e = launch_sweep<1>(mask, valid, keep, batch, k, words, stages, st);
    else if (slots <= 2) e = launch_sweep<2>(mask, valid, keep, batch, k, words, stages, st);
    else if (slots <= 4) e = launch_sweep<4>(mask, valid, keep, batch, k, words, stages, st);
    else if (slots <= kMaxSlots) e = launch_sweep<8>(mask, valid, keep, batch, k, words, stages, st);
    else e = cudaErrorInvalidValue;
    return static_cast<int>(e);
}

extern "C" const char* detectax_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
