// CenterNet heatmap peak decode: optional sigmoid, then keep a score where
// it is >= each of its 8 neighbours in its own class plane, else 0.
//
// Replaces the TPU kernel detectax/ops/pallas/peak_decode.py::_peak_kernel
// (peak_scores_pallas with the sigmoid, peak_mask_scores_pallas without).
// Same function, per element of a [B, h, w, C] map:
//   p   = SIGMOID ? 1 / (1 + exp(-x)) : x
//   out = (q <= p for each of the 8 neighbours q in the [h, w] plane of
//          its batch row and channel, with -1 standing for a neighbour
//          outside the map) ? p : 0
// which is `p >= max(neighbours) ? p : 0` written so that a NaN anywhere in
// a neighbourhood gives 0, as a maximum that propagates NaN gives it
// (jnp.maximum, torch.maximum). The fill is -1 and not -inf: a border cell
// below -1 is no peak. The test is >=, so every cell of a plateau is kept.
//
// The TPU kernel moved the map to [P, H, W], took one whole plane into
// VMEM for each grid step and rolled it eight times; its caller transposed
// [B, h, w, C] to [h, w, B*C] before and back after. None of that carries
// over. The map is read where the decode leaves it, channel-last: one
// thread for each element, its neighbours at +-row_stride (one cell along
// w) and +-w*row_stride (one cell along h). Threads of a warp walk the
// channel axis first, so each of the nine loads of a warp is one
// contiguous run. `row_stride` is the distance between two cells in
// floats: C for a contiguous map, more for the class channels of a wider
// map (`probs[..., 1:]`), read in place. The folded [H, W, P] layout of the
// TPU kernel is the case B = 1, C = P.
//
// What bounds it: bytes, 4 in and 4 out an element against 8 comparisons
// (and 9 exponentials with the sigmoid; a neighbour's score is recomputed
// rather than staged, the exponentials being far under the float32 rate).
// The eight neighbour loads hit L1/L2: the input is read from device memory
// once. At the serving shapes (8 x 48 x 48 x 20 = 368,640 elements, 2.9 MB
// in and out) the whole map is a microsecond of memory traffic, so what a
// call costs is its launch (numbers in PERF.md); one launch for all planes
// of the batch is what the design does about that.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <bool SIGMOID>
__device__ __forceinline__ float score(float x)
{
    return SIGMOID ? 1.0f / (1.0f + expf(-x)) : x;
}

template <bool SIGMOID>
__global__ void peak_kernel(
    const float* __restrict__ in, int64_t row_stride,
    uint32_t n, int h, int w, uint32_t c,
    float* __restrict__ out)            // [B, h, w, C] contiguous
{
    const uint32_t i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const uint32_t cell = i / c;        // b * h * w + y * w + x
    const uint32_t ch = i - cell * c;
    const uint32_t uw = static_cast<uint32_t>(w);
    const int x = static_cast<int>(cell % uw);
    const int y = static_cast<int>((cell / uw) % static_cast<uint32_t>(h));
    const float* centre = in + static_cast<int64_t>(cell) * row_stride + ch;
    const float p = score<SIGMOID>(centre[0]);
    bool keep = true;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
            if (dy == 0 && dx == 0) continue;
            const int yy = y + dy;
            const int xx = x + dx;
            float q = -1.0f;
            if (yy >= 0 && yy < h && xx >= 0 && xx < w)
                q = score<SIGMOID>(centre[(dy * w + dx) * row_stride]);
            keep = keep && (q <= p);    // false when q or p is NaN
        }
    }
    out[i] = keep ? p : 0.0f;
}

}  // namespace

// out[B, h, w, C] (contiguous) = the peak-masked scores of `in`, read as
// B*h*w cells of C floats, `row_stride` floats apart. Launches one kernel
// on `stream`; allocates nothing and does not synchronise. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int detectax_peak(
    const void* in, int64_t row_stride, int64_t batch, int64_t h, int64_t w,
    int64_t c, int apply_sigmoid, void* out, void* stream)
{
    const int64_t n = batch * h * w * c;
    if (n == 0) return 0;
    const unsigned blocks = static_cast<unsigned>((n + kThreads - 1) / kThreads);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (apply_sigmoid) {
        peak_kernel<true><<<blocks, kThreads, 0, s>>>(
            static_cast<const float*>(in), row_stride,
            static_cast<uint32_t>(n), static_cast<int>(h), static_cast<int>(w),
            static_cast<uint32_t>(c), static_cast<float*>(out));
    } else {
        peak_kernel<false><<<blocks, kThreads, 0, s>>>(
            static_cast<const float*>(in), row_stride,
            static_cast<uint32_t>(n), static_cast<int>(h), static_cast<int>(w),
            static_cast<uint32_t>(c), static_cast<float*>(out));
    }
    return static_cast<int>(cudaGetLastError());
}
