// Fused selection + suppression greedy NMS over the full dense candidate
// set, one thread block per image.
//
// Replaces the TPU kernel
// detectax/ops/pallas/nms_kernel.py::_dense_nms_kernel (dense_nms_pallas).
// Same function: up to `max_outputs` rounds; each round takes the argmax
// of the live scores (lowest index wins ties, as a stable descending sort
// would order them), emits that candidate, and kills it together with
// every candidate whose IoU with it exceeds the threshold (same class
// only, when class-aware). Scores below `score_thresh` are dead from the
// start. Outputs are written in their final form: boxes [B, O, 4], scores
// [B, O], classes int32 [B, O] (-1 where empty), valid [B, O].
//
// What bounds it: the chain of dependent rounds. A round is one pass over
// M candidates split across the block, on one SM, plus one block-wide
// argmax; the bytes (M * 24 B per image, read once) and the arithmetic are
// far below what the card can do in that time. Timed on an H100 beside an
// empty round (csrc/barrier_probe.cu) a round costs some forty empty
// rounds at M = 3,069: the pass (one SM issuing M candidates' worth of
// loads and IoU instructions), not the barrier, sets the time (numbers in
// PERF.md). The design keeps a round at one pass and one barrier:
//   - thread t owns candidates t, t+T, t+2T, ... for the whole kernel, so
//     the live scores need no barrier at all;
//   - the pass that kills the overlapped candidates also finds the
//     thread's best survivor for the next round;
//   - the argmax is a warp-shuffle butterfly, one shared-memory stage with
//     double-buffered slots (so the next round may write while a slow warp
//     still reads), and a second butterfly that every warp runs for
//     itself, leaving the winner in every thread without a broadcast;
//   - the loop ends at the first round whose maximum is dead: the
//     remaining output columns are empty either way.
// Boxes stay in global memory (a crowd-scale image does not fit a block's
// shared memory together with everything else); they are read as float4
// and stay in L1/L2 across rounds.
//
// Arithmetic equals the plain PyTorch version (dense_nms_plain) bit for
// bit: -fmad=false, no fast-math, unclamped area, and
// inter / (area_j + area_sel - inter + 1e-8).
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr float kBig = 1e9f;
constexpr float kDead = -0.5f * kBig;  // a score at or below this is dead

__device__ __forceinline__ void argmax_step(float& s, int& i, float os, int oi) {
    if (os > s || (os == s && oi < i)) {
        s = os;
        i = oi;
    }
}

__device__ __forceinline__ void warp_argmax(float& s, int& i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const float os = __shfl_xor_sync(0xffffffffu, s, off);
        const int oi = __shfl_xor_sync(0xffffffffu, i, off);
        argmax_step(s, i, os, oi);
    }
}

__global__ void dense_nms_kernel(
    const float* __restrict__ boxes,    // [B, M, 4] y1 x1 y2 x2
    const float* __restrict__ scores,   // [B, M]
    const int* __restrict__ classes,    // [B, M] or nullptr (class 0)
    float* __restrict__ out_boxes,      // [B, O, 4]
    float* __restrict__ out_scores,     // [B, O]
    int* __restrict__ out_classes,      // [B, O]
    uint8_t* __restrict__ out_valid,    // [B, O]
    int m, int max_outputs, float iou_thresh, float score_thresh,
    int class_aware)
{
    extern __shared__ float live[];  // [M], thread-owned entries
    __shared__ float part_s[2][32];
    __shared__ int part_i[2][32];

    const int tid = threadIdx.x;
    const int nthreads = blockDim.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int nwarps = nthreads >> 5;
    const size_t in_base = static_cast<size_t>(blockIdx.x) * m;
    const size_t out_base = static_cast<size_t>(blockIdx.x) * max_outputs;
    const float4* gbox = reinterpret_cast<const float4*>(boxes) + in_base;
    const float* gscore = scores + in_base;
    const int* gcls = classes != nullptr ? classes + in_base : nullptr;
    const bool by_class = class_aware != 0 && gcls != nullptr;

    float best_s = -FLT_MAX;
    int best_i = INT_MAX;
    for (int j = tid; j < m; j += nthreads) {
        const float s = gscore[j];
        const float l = s >= score_thresh ? s : -kBig;
        live[j] = l;
        if (l > best_s) {
            best_s = l;
            best_i = j;
        }
    }

    int t = 0;
    for (; t < max_outputs; ++t) {
        // block-wide argmax of (score, lowest index)
        const int buf = t & 1;
        warp_argmax(best_s, best_i);
        if (lane == 0) {
            part_s[buf][warp] = best_s;
            part_i[buf][warp] = best_i;
        }
        __syncthreads();
        float smax = lane < nwarps ? part_s[buf][lane] : -FLT_MAX;
        int sel = lane < nwarps ? part_i[buf][lane] : INT_MAX;
        warp_argmax(smax, sel);
        if (!(smax > kDead)) break;  // uniform: every thread holds the winner

        const float4 bs = gbox[sel];
        const float area_s = (bs.z - bs.x) * (bs.w - bs.y);
        const int cls_s = gcls != nullptr ? gcls[sel] : 0;
        if (tid == 0) {
            reinterpret_cast<float4*>(out_boxes)[out_base + t] = bs;
            out_scores[out_base + t] = smax;
            out_classes[out_base + t] = cls_s;
            out_valid[out_base + t] = 1;
        }

        // kill the pick and all it overlaps; find this thread's next best
        best_s = -FLT_MAX;
        best_i = INT_MAX;
        for (int j = tid; j < m; j += nthreads) {
            float l = live[j];
            if (l > kDead) {
                bool dead = j == sel;
                if (!dead && (!by_class || gcls[j] == cls_s)) {
                    const float4 bj = gbox[j];
                    const float ih = fmaxf(0.0f, fminf(bj.z, bs.z) - fmaxf(bj.x, bs.x));
                    const float iw = fmaxf(0.0f, fminf(bj.w, bs.w) - fmaxf(bj.y, bs.y));
                    const float inter = ih * iw;
                    const float area_j = (bj.z - bj.x) * (bj.w - bj.y);
                    const float iou = inter / (area_j + area_s - inter + 1e-8f);
                    dead = iou > iou_thresh;
                }
                if (dead) {
                    l = -kBig;
                    live[j] = l;
                }
            }
            if (l > best_s) {
                best_s = l;
                best_i = j;
            }
        }
    }

    // columns never reached stay empty
    for (int c = t + tid; c < max_outputs; c += nthreads) {
        reinterpret_cast<float4*>(out_boxes)[out_base + c] = make_float4(0.f, 0.f, 0.f, 0.f);
        out_scores[out_base + c] = 0.0f;
        out_classes[out_base + c] = -1;
        out_valid[out_base + c] = 0;
    }
}

}  // namespace

// Launches on `stream`; allocates nothing and does not synchronise.
// `threads` must be a multiple of 32, at most 1024.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int detectax_dense_nms(
    const void* boxes, const void* scores, const void* classes,
    void* out_boxes, void* out_scores, void* out_classes, void* out_valid,
    int batch, int m, int max_outputs, float iou_thresh, float score_thresh,
    int class_aware, int threads, void* stream)
{
    const size_t smem = static_cast<size_t>(m) * sizeof(float);
    if (smem > 40 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            dense_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    dense_nms_kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(boxes), static_cast<const float*>(scores),
        static_cast<const int*>(classes), static_cast<float*>(out_boxes),
        static_cast<float*>(out_scores), static_cast<int*>(out_classes),
        static_cast<uint8_t*>(out_valid), m, max_outputs, iou_thresh,
        score_thresh, class_aware);
    return static_cast<int>(cudaGetLastError());
}
