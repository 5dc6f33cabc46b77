// Sum-reduced stable sigmoid focal loss: forward (partial sums + ordered
// reduction) and backward (closed-form dL/dlogits).
//
// Replaces the TPU kernel detectax/ops/pallas/focal.py::_focal_kernel
// (focal_loss_pallas) and its analytic _bwd. Same function, per element
//   l1p    = log1p(exp(-|x|))
//   ce_pos = l1p - min(x, 0)          (-log sigmoid(x))
//   ce_neg = l1p + max(x, 0)          (-log(1 - sigmoid(x)))
//   p      = 1 / (1 + exp(-x))
//   loss   = z a (1-p)^g ce_pos + (1-z)(1-a) p^g ce_neg        [* w]
//   dloss  = z * -a (1-p)^g (g p ce_pos + (1-p))
//          + (1-z) * (1-a) p^g (g (1-p) ce_neg + p)            [* w] * upstream
//
// The TPU kernel walked [256, 128] tiles in grid order and added each
// tile's sum into one scalar: a sequential grid. Blocks here run in
// parallel, so nothing is carried between them. Each thread strides over
// the elements and keeps a private sum; the block folds its sums in a
// fixed order (warp shuffles, then one shared-memory stage) and writes ONE
// partial; a second single-block kernel adds the partials in index order
// by the same fixed tree. No atomics anywhere: two runs on the same input
// give the same bits. There is no [m, 128] padding and no tile shape to
// carry over; the inputs are read where they lie, as [rows, cols] with a
// row stride each (the loss reads the class channels y[..., 5:] of a
// wider map without a copy).
//
// What bounds it: bytes. An element is 8 bytes in (12 with weights) and,
// backward, 4 out, against some 25-35 float operations; at the training
// shapes (3 K to 740 K elements a level) the whole input is a few MB, so
// on the card the two launches' latency, not the memory rate, is what one
// call costs (numbers in PERF.md). The design therefore does the whole
// elementwise chain in one pass, and the backward recomputes the chain
// from labels and logits instead of storing anything in the forward: the
// forward stays read-only (evaluation pays for no gradient buffer) and the
// backward moves 8-12 bytes in and 4 out, which is its floor.
//
// Compiled with -fmad=false and without fast-math: expf, log1pf and powf
// are the accurate versions. powf(0, g) = 0 and powf(1, g) = 1 for g > 0,
// and at x = -100 expf(-x) = inf gives p = 0 with every term finite.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 1024;

struct Terms {
    float p, ce_pos, ce_neg;
};

__device__ __forceinline__ Terms focal_terms(float x)
{
    const float l1p = log1pf(expf(-fabsf(x)));
    Terms t;
    t.ce_pos = l1p - fminf(x, 0.0f);
    t.ce_neg = l1p + fmaxf(x, 0.0f);
    t.p = 1.0f / (1.0f + expf(-x));
    return t;
}

// Sum of `v` over the block in a fixed order; valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* stage)
{
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) stage[warp] = v;
    __syncthreads();
    if (warp == 0) {
        v = lane < (blockDim.x >> 5) ? stage[lane] : 0.0f;
        for (int off = 16; off > 0; off >>= 1)
            v += __shfl_down_sync(0xffffffffu, v, off);
    }
    return v;
}

__global__ void focal_fwd_kernel(
    const float* __restrict__ labels, uint32_t labels_stride,
    const float* __restrict__ logits, uint32_t logits_stride,
    const float* __restrict__ weights,  // [rows, cols] contiguous or nullptr
    uint32_t n, uint32_t cols, float alpha, float gamma,
    float* __restrict__ partials)       // [gridDim.x]
{
    __shared__ float stage[32];
    float acc = 0.0f;
    const uint32_t step = gridDim.x * blockDim.x;
    for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
        const uint32_t row = i / cols;
        const uint32_t col = i - row * cols;
        const float z = labels[row * labels_stride + col];
        const float x = logits[row * logits_stride + col];
        const Terms t = focal_terms(x);
        float loss = z * alpha * powf(1.0f - t.p, gamma) * t.ce_pos
                   + (1.0f - z) * (1.0f - alpha) * powf(t.p, gamma) * t.ce_neg;
        if (weights != nullptr) loss = loss * weights[i];
        acc += loss;
    }
    const float total = block_sum(acc, stage);
    if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

// One block: thread t adds partials t, t + T, ... in index order, then the
// block folds by the same fixed tree.
__global__ void focal_reduce_kernel(
    const float* __restrict__ partials, int count, float* __restrict__ out)
{
    __shared__ float stage[32];
    float acc = 0.0f;
    for (int i = threadIdx.x; i < count; i += blockDim.x) acc += partials[i];
    const float total = block_sum(acc, stage);
    if (threadIdx.x == 0) out[0] = total;
}

__global__ void focal_bwd_kernel(
    const float* __restrict__ labels, uint32_t labels_stride,
    const float* __restrict__ logits, uint32_t logits_stride,
    const float* __restrict__ weights,   // [rows, cols] contiguous or nullptr
    const float* __restrict__ upstream,  // one float on the device
    uint32_t n, uint32_t cols, float alpha, float gamma,
    float* __restrict__ dlogits)         // [rows, cols] contiguous
{
    const float g = upstream[0];
    const uint32_t step = gridDim.x * blockDim.x;
    for (uint32_t i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += step) {
        const uint32_t row = i / cols;
        const uint32_t col = i - row * cols;
        const float z = labels[row * labels_stride + col];
        const float x = logits[row * logits_stride + col];
        const Terms t = focal_terms(x);
        const float q = 1.0f - t.p;
        const float dpos = -alpha * powf(q, gamma) * (gamma * t.p * t.ce_pos + q);
        const float dneg = (1.0f - alpha) * powf(t.p, gamma)
                         * (gamma * q * t.ce_neg + t.p);
        float grad = z * dpos + (1.0f - z) * dneg;
        if (weights != nullptr) grad = grad * weights[i];
        dlogits[i] = g * grad;
    }
}

}  // namespace

// Blocks the forward uses for n elements: a function of n alone, so the
// summation order is fixed for a given input size.
extern "C" int detectax_focal_blocks(int64_t n)
{
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    if (blocks < 1) return 1;
    return blocks > kMaxBlocks ? kMaxBlocks : static_cast<int>(blocks);
}

// out[0] = sum of the focal loss over rows x cols elements. `partials`
// holds detectax_focal_blocks(rows * cols) floats of scratch. Launches two
// kernels on `stream`; allocates nothing and does not synchronise. Returns
// the cudaError_t of the launches (0 = success).
extern "C" int detectax_focal_fwd(
    const void* labels, int64_t labels_stride,
    const void* logits, int64_t logits_stride,
    const void* weights, int64_t rows, int64_t cols,
    float alpha, float gamma, void* partials, void* out, void* stream)
{
    const int64_t n = rows * cols;
    const int blocks = detectax_focal_blocks(n);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    focal_fwd_kernel<<<blocks, kThreads, 0, s>>>(
        static_cast<const float*>(labels), static_cast<uint32_t>(labels_stride),
        static_cast<const float*>(logits), static_cast<uint32_t>(logits_stride),
        static_cast<const float*>(weights),
        static_cast<uint32_t>(n), static_cast<uint32_t>(cols), alpha, gamma,
        static_cast<float*>(partials));
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    focal_reduce_kernel<<<1, kThreads, 0, s>>>(
        static_cast<const float*>(partials), blocks, static_cast<float*>(out));
    return static_cast<int>(cudaGetLastError());
}

// dlogits[rows, cols] (contiguous) = upstream[0] * dloss/dlogits.
extern "C" int detectax_focal_bwd(
    const void* labels, int64_t labels_stride,
    const void* logits, int64_t logits_stride,
    const void* weights, const void* upstream, int64_t rows, int64_t cols,
    float alpha, float gamma, void* dlogits, void* stream)
{
    const int64_t n = rows * cols;
    const int blocks = detectax_focal_blocks(n);
    focal_bwd_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(labels), static_cast<uint32_t>(labels_stride),
        static_cast<const float*>(logits), static_cast<uint32_t>(logits_stride),
        static_cast<const float*>(weights), static_cast<const float*>(upstream),
        static_cast<uint32_t>(n), static_cast<uint32_t>(cols), alpha, gamma,
        static_cast<float*>(dlogits));
    return static_cast<int>(cudaGetLastError());
}
