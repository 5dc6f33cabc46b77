// Fused selection + suppression greedy NMS over the full dense candidate
// set, one thread-block cluster per image.
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
// What bounds it: the chain of dependent rounds; the bytes (M * 24 B per
// image, read once) and the arithmetic are far below what the card can do
// in that time. A round is a pass over the candidates, an argmax and an
// exchange. One block per image put the whole pass on one SM; here the
// image is a cluster of C blocks on C SMs (C from the wrapper's plan), so
// a round costs a pass over M / C candidates plus one exchange across the
// cluster. A cluster barrier costs some fourteen block barriers on an
// H100, so the exchange is a push and no barrier (numbers in PERF.md):
//   - block `rank` owns the contiguous slice [rank * S, rank * S + S) of
//     the candidates, S = ceil(M / C); thread t of it holds candidates
//     t, t + T, ... of the slice (PER of them) in registers for the whole
//     kernel: box, area (computed once), class and live score. No round
//     reads global memory;
//   - the pass that kills the overlapped candidates also finds each
//     thread's best survivor for the next round;
//   - each warp reduces its threads' bests (redux.sync on the score's key,
//     then on the index), the lane holding the warp's best hands its slot
//     (box, score, index, class, area) to the others by shuffles, and lane
//     q stores it into block q's inbox with st.async, whose bytes complete
//     on block q's mbarrier;
//   - each block waits on its own mbarrier for all C * warps slots of the
//     round, and every warp folds them in the same total order (score
//     descending, index ascending): every thread of every block holds the
//     winner, whose box it reads from the winner's slot;
//   - inboxes and mbarriers alternate by round parity: a block can send
//     round t + 2 only after it received every slot of round t + 1, which
//     each warp sends after it has read round t;
//   - the loop ends at the first round whose maximum is dead: the
//     remaining output columns are empty either way. A cluster barrier
//     after the mbarriers are set up, and one before exit, keep every
//     block's shared memory valid while a peer may reach it.
// No reduction uses atomics; the winner is the maximum of a total order,
// so the order in which lanes combine does not change it.
//
// Arithmetic equals the plain PyTorch version (dense_nms_plain) bit for
// bit: -fmad=false, no fast-math, unclamped area, and
// inter / (area_j + area_sel - inter + 1e-8).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kBig = 1e9f;
constexpr float kDead = -0.5f * kBig;  // a score at or below this is dead
constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxCluster = 16;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;  // no candidate

// A warp's best candidate of a round, as its peers receive it.
struct __align__(16) Slot {
    float4 box;
    float score;
    unsigned index;
    int cls;
    float area;
};

// Scores as unsigned keys in the same order; -0 and +0 compare equal, as
// they do as floats.
__device__ __forceinline__ unsigned score_key(float s) {
    const unsigned u = __float_as_uint(s + 0.0f);
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes into block `rank`'s copy of `dst`, counted on its copy of `bar`.
__device__ __forceinline__ void st_peer(const void* dst, const float4& v,
                                        const uint64_t* bar, unsigned rank) {
    unsigned rdst, rbar;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(rdst) : "r"(smem_addr(dst)), "r"(rank));
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(rbar) : "r"(smem_addr(bar)), "r"(rank));
    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
                 "[%0], {%1, %2, %3, %4}, [%5];\n"
                 :: "r"(rdst), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(rbar)
                 : "memory");
}

__device__ __forceinline__ void mbar_wait(const uint64_t* bar, unsigned parity) {
    unsigned done;
    do {
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}\n"
                     : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
    } while (!done);
}

// One barrier for the whole cluster, every thread of every block.
__device__ __forceinline__ void cluster_sync() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n"
                 "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The warp's largest key and, among the lanes holding it, smallest index.
__device__ __forceinline__ void warp_best(unsigned& key, unsigned& idx) {
    const unsigned top = __reduce_max_sync(kFull, key);
    idx = __reduce_min_sync(kFull, key == top ? idx : kNone);
    key = top;
}

template <int PER>
__global__ void __launch_bounds__(kMaxThreads, 1) dense_nms_kernel(
    const float* __restrict__ boxes,    // [B, M, 4] y1 x1 y2 x2
    const float* __restrict__ scores,   // [B, M]
    const int* __restrict__ classes,    // [B, M] or nullptr (class 0)
    float* __restrict__ out_boxes,      // [B, O, 4]
    float* __restrict__ out_scores,     // [B, O]
    int* __restrict__ out_classes,      // [B, O]
    uint8_t* __restrict__ out_valid,    // [B, O]
    int m, int slice, int max_outputs, float iou_thresh, float score_thresh,
    int class_aware)
{
    // round parity x (block, warp) of the cluster; one mbarrier a parity
    __shared__ Slot inbox[2][kMaxCluster * kMaxWarps];
    __shared__ __align__(8) uint64_t bars[2];

    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const int csize = static_cast<int>(cluster.num_blocks());
    const int image = blockIdx.x / csize;
    const int tid = threadIdx.x;
    const int nthreads = blockDim.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int nwarps = nthreads >> 5;
    const int nslots = csize * nwarps;
    const size_t in_base = static_cast<size_t>(image) * m;
    const size_t out_base = static_cast<size_t>(image) * max_outputs;
    const bool by_class = class_aware != 0 && classes != nullptr;
    const int lo = rank * slice;
    const int hi = min(m, lo + slice);
    const unsigned dead_key = score_key(kDead);

    if (tid == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                     "mbarrier.init.shared::cta.b64 [%1], 1;\n"
                     "fence.mbarrier_init.release.cluster;\n"
                     :: "r"(smem_addr(&bars[0])), "r"(smem_addr(&bars[1])) : "memory");
    }

    // this thread's candidates, held for the whole kernel
    float4 bx[PER];
    float ar[PER], lv[PER];
    int cl[PER];
    unsigned best_key = 0, best_idx = kNone;  // 0: below every score's key
#pragma unroll
    for (int p = 0; p < PER; ++p) {
        const int j = lo + tid + p * nthreads;
        bx[p] = make_float4(0.f, 0.f, 0.f, 0.f);
        ar[p] = 0.0f;
        cl[p] = 0;
        lv[p] = -FLT_MAX;  // no candidate: never alive
        if (j < hi) {
            const float4 b = reinterpret_cast<const float4*>(boxes)[in_base + j];
            const float s = scores[in_base + j];
            bx[p] = b;
            ar[p] = (b.z - b.x) * (b.w - b.y);
            cl[p] = classes != nullptr ? classes[in_base + j] : 0;
            lv[p] = s >= score_thresh ? s : -kBig;
            const unsigned key = score_key(lv[p]);
            if (key > best_key) {
                best_key = key;
                best_idx = j;
            }
        }
    }
    cluster_sync();  // every block's mbarriers are set up before any send

    int t = 0;
    for (; t < max_outputs; ++t) {
        const int buf = t & 1;
        if (tid == 0)
            asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                         :: "r"(smem_addr(&bars[buf])),
                            "r"(static_cast<unsigned>(nslots * sizeof(Slot))) : "memory");

        // the warp's best goes to every block of the cluster: the lane
        // holding it hands it over, lane q sends it to block q
        unsigned wkey = best_key, widx = best_idx;
        warp_best(wkey, widx);
        Slot sl;
        sl.box = make_float4(0.f, 0.f, 0.f, 0.f);
        sl.score = -FLT_MAX;
        sl.index = widx;
        sl.cls = 0;
        sl.area = 0.0f;
#pragma unroll
        for (int p = 0; p < PER; ++p) {
            if (static_cast<unsigned>(lo + tid + p * nthreads) == widx) {
                sl.box = bx[p];
                sl.score = lv[p];
                sl.cls = cl[p];
                sl.area = ar[p];
            }
        }
        const unsigned holder = __ballot_sync(kFull, widx != kNone && best_idx == widx);
        const int src = holder ? __ffs(holder) - 1 : 0;
        sl.box.x = __shfl_sync(kFull, sl.box.x, src);
        sl.box.y = __shfl_sync(kFull, sl.box.y, src);
        sl.box.z = __shfl_sync(kFull, sl.box.z, src);
        sl.box.w = __shfl_sync(kFull, sl.box.w, src);
        sl.score = __shfl_sync(kFull, sl.score, src);
        sl.cls = __shfl_sync(kFull, sl.cls, src);
        sl.area = __shfl_sync(kFull, sl.area, src);
        if (lane < csize) {
            Slot* mine = &inbox[buf][rank * nwarps + warp];
            st_peer(&mine->box, sl.box, &bars[buf], lane);
            st_peer(&mine->score,
                    make_float4(sl.score, __uint_as_float(sl.index),
                                __int_as_float(sl.cls), sl.area),
                    &bars[buf], lane);
        }

        // the cluster's best: every warp folds all the slots
        mbar_wait(&bars[buf], static_cast<unsigned>(t >> 1) & 1u);
        unsigned key = 0, sel = kNone;
        for (int q = lane; q < nslots; q += 32) {
            const float2 si = *reinterpret_cast<const float2*>(&inbox[buf][q].score);
            const unsigned k = score_key(si.x);
            const unsigned i = __float_as_uint(si.y);
            if (k > key || (k == key && i < sel)) {
                key = k;
                sel = i;
            }
        }
        warp_best(key, sel);
        if (key <= dead_key) break;  // uniform across the cluster

        // the winner's slot: its block, then the warp that holds it
        const int wrank = static_cast<int>(sel) / slice;
        const int wwarp = ((static_cast<int>(sel) - wrank * slice) % nthreads) >> 5;
        const Slot& win = inbox[buf][wrank * nwarps + wwarp];
        const float4 bs = win.box;
        const float smax = win.score;
        const int cls_s = win.cls;
        const float area_s = win.area;
        if (rank == 0 && tid == 0) {
            reinterpret_cast<float4*>(out_boxes)[out_base + t] = bs;
            out_scores[out_base + t] = smax;
            out_classes[out_base + t] = cls_s;
            out_valid[out_base + t] = 1;
        }

        // kill the pick and all it overlaps; find this thread's next best
        best_key = 0;
        best_idx = kNone;
#pragma unroll
        for (int p = 0; p < PER; ++p) {
            const int j = lo + tid + p * nthreads;
            float l = lv[p];
            if (l > kDead) {
                bool dead = static_cast<unsigned>(j) == sel;
                if (!dead && (!by_class || cl[p] == cls_s)) {
                    const float4 bj = bx[p];
                    const float ih = fmaxf(0.0f, fminf(bj.z, bs.z) - fmaxf(bj.x, bs.x));
                    const float iw = fmaxf(0.0f, fminf(bj.w, bs.w) - fmaxf(bj.y, bs.y));
                    const float inter = ih * iw;
                    const float iou = inter / (ar[p] + area_s - inter + 1e-8f);
                    dead = iou > iou_thresh;
                }
                if (dead) {
                    l = -kBig;
                    lv[p] = l;
                }
            }
            if (j < hi) {
                const unsigned k = score_key(l);
                if (k > best_key) {
                    best_key = k;
                    best_idx = j;
                }
            }
        }
    }

    // columns never reached stay empty
    if (rank == 0) {
        for (int c = t + tid; c < max_outputs; c += nthreads) {
            reinterpret_cast<float4*>(out_boxes)[out_base + c] = make_float4(0.f, 0.f, 0.f, 0.f);
            out_scores[out_base + c] = 0.0f;
            out_classes[out_base + c] = -1;
            out_valid[out_base + c] = 0;
        }
    }
    // no block leaves while a peer may still send to it or read from it
    cluster_sync();
}

template <int PER>
cudaError_t launch(const void* boxes, const void* scores, const void* classes,
                   void* out_boxes, void* out_scores, void* out_classes,
                   void* out_valid, int batch, int m, int max_outputs,
                   float iou_thresh, float score_thresh, int class_aware,
                   int cluster, int threads, cudaStream_t stream)
{
    auto kernel = dense_nms_kernel<PER>;
    if (cluster > 8) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (e != cudaSuccess) return e;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(batch) * cluster);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const int slice = (m + cluster - 1) / cluster;
    cudaError_t e = cudaLaunchKernelEx(
        &cfg, kernel, static_cast<const float*>(boxes),
        static_cast<const float*>(scores), static_cast<const int*>(classes),
        static_cast<float*>(out_boxes), static_cast<float*>(out_scores),
        static_cast<int*>(out_classes), static_cast<uint8_t*>(out_valid),
        m, slice, max_outputs, iou_thresh, score_thresh, class_aware);
    if (e != cudaSuccess) return e;
    return cudaGetLastError();
}

}  // namespace

// Launches B clusters of `cluster` blocks of `threads` threads, each thread
// holding `per` candidates (the wrapper's plan: cluster <= 16, threads a
// multiple of 32 up to 512, per in {1, 2, 4, 8}, cluster * threads * per
// >= M). On `stream`; allocates nothing and does not synchronise.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int detectax_dense_nms(
    const void* boxes, const void* scores, const void* classes,
    void* out_boxes, void* out_scores, void* out_classes, void* out_valid,
    int batch, int m, int max_outputs, float iou_thresh, float score_thresh,
    int class_aware, int cluster, int threads, int per, void* stream)
{
    if (cluster < 1 || cluster > kMaxCluster || threads < 32
        || threads > kMaxThreads || threads % 32 != 0
        || static_cast<long long>(cluster) * threads * per < m)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DETECTAX_DENSE_LAUNCH(P)                                               \
    launch<P>(boxes, scores, classes, out_boxes, out_scores, out_classes,     \
              out_valid, batch, m, max_outputs, iou_thresh, score_thresh,     \
              class_aware, cluster, threads, st)
    cudaError_t e;
    switch (per) {
        case 1: e = DETECTAX_DENSE_LAUNCH(1); break;
        case 2: e = DETECTAX_DENSE_LAUNCH(2); break;
        case 4: e = DETECTAX_DENSE_LAUNCH(4); break;
        case 8: e = DETECTAX_DENSE_LAUNCH(8); break;
        default: e = cudaErrorInvalidValue;
    }
#undef DETECTAX_DENSE_LAUNCH
    return static_cast<int>(e);
}
