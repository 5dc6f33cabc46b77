// Greedy hard-NMS suppression sweep over K score-sorted boxes, one thread
// block per image.
//
// Replaces the TPU kernel detectax/ops/pallas/nms_kernel.py::_nms_kernel
// (suppression_mask_pallas). Same function: keep[i] starts as valid[i];
// walking i in score order, every still-kept i drops each later j whose
// IoU with it exceeds the threshold (same class only, when classes are
// given). The [K, K] IoU matrix is never formed: each round computes its
// row on the fly from boxes held in shared memory.
//
// The TPU kernel fetched candidate i with one-hot reductions because it
// has no dynamic lane load; here every thread simply reads smem[i].
//
// What bounds it: the chain of dependent rounds, not the card's byte or
// arithmetic rates (one image's rows are a few tens of KB, and 8 images
// use 8 of 132 SMs). A round is the block's pass over the candidates after
// i, on one SM, and one barrier. Timed on an H100 beside an empty round
// (csrc/barrier_probe.cu) the barrier is about a tenth of a round: the
// pass itself, one SM issuing K threads' worth of IoU instructions, sets
// the time (numbers in PERF.md). The design keeps the chain short: a round
// whose box is already suppressed writes nothing, so it needs no barrier
// and costs one shared-memory read; only the rounds of kept boxes (the
// survivors) pay a pass and a barrier. A candidate that is already dropped
// or of another class leaves the pass after two shared-memory reads.
// Images run in parallel, one block each.
//
// Arithmetic is kept bit-for-bit equal to the plain PyTorch version
// (nms_sweep_plain): the file is compiled with -fmad=false and without
// fast-math, area is (y2-y1)*(x2-x1) unclamped, and the IoU is
// inter / (area_j + area_i - inter + 1e-8) in that order.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void nms_sweep_kernel(
    const float* __restrict__ boxes,    // [B, K, 4] y1 x1 y2 x2
    const int* __restrict__ classes,    // [B, K] or nullptr: class-agnostic
    const uint8_t* __restrict__ valid,  // [B, K] or nullptr: all valid
    uint8_t* __restrict__ keep,         // [B, K] out, 0/1
    int k, float iou_thresh)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    float4* sbox = reinterpret_cast<float4*>(smem_raw);
    float* sarea = reinterpret_cast<float*>(sbox + k);
    int* scls = reinterpret_cast<int*>(sarea + k);
    uint8_t* skeep = reinterpret_cast<uint8_t*>(scls + k);

    const int tid = threadIdx.x;
    const int nthreads = blockDim.x;
    const size_t base = static_cast<size_t>(blockIdx.x) * k;
    const float4* gbox = reinterpret_cast<const float4*>(boxes) + base;
    const bool class_aware = classes != nullptr;

    for (int j = tid; j < k; j += nthreads) {
        const float4 b = gbox[j];
        sbox[j] = b;
        sarea[j] = (b.z - b.x) * (b.w - b.y);
        scls[j] = class_aware ? classes[base + j] : 0;
        skeep[j] = valid != nullptr ? (valid[base + j] != 0) : 1;
    }
    __syncthreads();

    for (int i = 0; i < k; ++i) {
        // keep[i] is final here: only rounds before i write it, and every
        // writing round ends in a barrier. All threads read the same
        // value, so the branch (and the barrier inside) is uniform.
        if (skeep[i]) {
            const float4 bi = sbox[i];
            const float ai = sarea[i];
            const int ci = scls[i];
            for (int j = i + 1 + tid; j < k; j += nthreads) {
                if (!skeep[j]) continue;
                if (class_aware && scls[j] != ci) continue;
                const float4 bj = sbox[j];
                const float ih = fmaxf(0.0f, fminf(bj.z, bi.z) - fmaxf(bj.x, bi.x));
                const float iw = fmaxf(0.0f, fminf(bj.w, bi.w) - fmaxf(bj.y, bi.y));
                const float inter = ih * iw;
                const float iou = inter / (sarea[j] + ai - inter + 1e-8f);
                if (iou > iou_thresh) skeep[j] = 0;
            }
            __syncthreads();
        }
    }

    for (int j = tid; j < k; j += nthreads) keep[base + j] = skeep[j];
}

}  // namespace

// Bytes of shared memory one image of K candidates needs.
static size_t sweep_smem_bytes(int k) {
    return static_cast<size_t>(k) * (sizeof(float4) + sizeof(float) + sizeof(int) + 1);
}

// Launches on `stream`; allocates nothing and does not synchronise.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int detectax_nms_sweep(
    const void* boxes, const void* classes, const void* valid, void* keep,
    int batch, int k, float iou_thresh, int threads, void* stream)
{
    const size_t smem = sweep_smem_bytes(k);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            nms_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    nms_sweep_kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(boxes), static_cast<const int*>(classes),
        static_cast<const uint8_t*>(valid), static_cast<uint8_t*>(keep),
        k, iou_thresh);
    return static_cast<int>(cudaGetLastError());
}

extern "C" const char* detectax_cuda_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
