// Sum-reduced stable sigmoid focal loss over a group of segments: one
// forward launch (every segment's sum) and one backward launch (every
// segment's closed-form dL/dlogits).
//
// Replaces the TPU kernel detectax/ops/pallas/focal.py::_focal_kernel
// (focal_loss_pallas) and its analytic _bwd. Same function, per element
//   e      = exp(-|x|)
//   l1p    = log1p(e)
//   ce_pos = l1p - min(x, 0)          (-log sigmoid(x))
//   ce_neg = l1p + max(x, 0)          (-log(1 - sigmoid(x)))
//   p      = x >= 0 ? 1 / (1 + e) : e / (1 + e)        (sigmoid(x))
//   loss   = z a (1-p)^g ce_pos + (1-z)(1-a) p^g ce_neg        [* w]
//   dloss  = z * -a (1-p)^g (g p ce_pos + (1-p))
//          + (1-z) * (1-a) p^g (g (1-p) ce_neg + p)            [* w] * upstream
// with one exponential feeding both the log term and p, and (1-p)^2, p^2
// as products when g = 2 (FCOS and CenterNet always train at g = 2; any
// other g goes through powf).
//
// The TPU kernel walked [256, 128] tiles in grid order and added each
// tile's sum into one scalar: a sequential grid, one call per FCOS level.
// Here one launch covers every segment of a step (FCOS: the five levels'
// class channels, and their centerness maps under cen_type="focal"). The
// segment table travels as a kernel parameter: each segment's pointers,
// row strides, rows, cols, an optional weights pointer, its first block
// and its rows per block. The wrapper (kernels/focal.py::_focal_plan) sizes
// the grid to the card's 132 SMs from the segment sizes alone, and the
// walk below hands elements to threads by (rows, cols) alone, so the order
// in which a sum is formed depends on the sizes and nothing else: not on
// the strides, the pointers' alignment or the width of the loads.
//
// A block walks whole rows of its segment: with u = cols units a row (a
// unit is four consecutive floats when cols is a multiple of 4, else one
// float), thread t takes unit t % u of row t / u of each group of
// 256 / u rows; a row of more than 256 units is walked 256 units at a
// time. The offsets are formed once a row, so no element pays a division,
// and a thread issues the loads of four floats (four rows, or one row's
// unit of four) before any of their arithmetic. Which elements a thread
// takes, and in which order it adds them, thus depends on (rows, cols)
// alone; where every pointer and row stride is a multiple of 16 bytes a
// unit of four is read with one 16-byte load, else with four 4-byte
// loads of the same floats. A view at an odd offset and its clone give
// the same bits.
//
// The forward reduces in one launch, without atomics on any float: each
// block folds its threads' sums in a fixed order (warp shuffles, then one
// shared-memory stage) and writes ONE partial; then it takes a ticket from
// an integer counter. The block that draws the last ticket adds every
// segment's partials in index order (a warp a segment, a fixed tree) and
// sets the counter back to 0 for the next launch, so no memset is queued
// per call. The counter lives in scratch the wrapper owns, one a device
// and stream. Two runs on the same input give the same bits.
//
// What bounds it: bytes. An element is 8 bytes in (12 with weights) and,
// backward, 4 out, against some 20-30 float operations; at the training
// shapes (982,080 elements for the five FCOS class maps) the whole input
// moves in 2.3 us, which is about a launch. One launch each way is what
// the design does about it; the backward recomputes the chain from labels
// and logits, so the forward stays read-only and the backward moves 8-12
// bytes in and 4 out an element, its floor.
//
// Compiled with -fmad=false and without fast-math: expf, log1pf, powf and
// the divisions are the accurate versions. At x = -100, e is a subnormal
// (3.7e-44) and p = e / (1 + e) stays finite; every term is finite.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSegments = 32;
constexpr int kUnroll = 4;   // floats a thread loads before using any

struct Segment {
    const float* labels;      // element (r, c) at labels[r * labels_stride + c]
    const float* logits;
    const float* weights;     // [rows, cols] contiguous, or nullptr
    float* dlogits;           // [rows, cols] contiguous (backward only)
    int64_t labels_stride;    // floats
    int64_t logits_stride;
    int64_t rows;
    int64_t rows_per_block;
    int32_t cols;
    int32_t unit;             // kScalar, kQuad16 or kQuad4 (below)
    int32_t first_block;      // this segment's blocks are
    int32_t blocks;           // [first_block, first_block + blocks)
};

struct Table {
    Segment seg[kMaxSegments];
    int32_t count;
};

template <bool G2>
__device__ __forceinline__ float pow_g(float v, float gamma)
{
    return G2 ? v * v : powf(v, gamma);
}

struct Terms {
    float p, q, ce_pos, ce_neg;
};

__device__ __forceinline__ Terms focal_terms(float x)
{
    const float e = expf(-fabsf(x));
    const float l1p = log1pf(e);
    const float d = 1.0f + e;
    Terms t;
    t.ce_pos = l1p - fminf(x, 0.0f);
    t.ce_neg = l1p + fmaxf(x, 0.0f);
    t.p = (x >= 0.0f ? 1.0f : e) / d;
    t.q = 1.0f - t.p;
    return t;
}

template <bool G2>
__device__ __forceinline__ float focal_value(float z, float x, float alpha,
                                             float gamma)
{
    const Terms t = focal_terms(x);
    return z * alpha * pow_g<G2>(t.q, gamma) * t.ce_pos
         + (1.0f - z) * (1.0f - alpha) * pow_g<G2>(t.p, gamma) * t.ce_neg;
}

template <bool G2>
__device__ __forceinline__ float focal_grad(float z, float x, float alpha,
                                            float gamma)
{
    const Terms t = focal_terms(x);
    const float dpos = -alpha * pow_g<G2>(t.q, gamma)
                     * (gamma * t.p * t.ce_pos + t.q);
    const float dneg = (1.0f - alpha) * pow_g<G2>(t.p, gamma)
                     * (gamma * t.q * t.ce_neg + t.p);
    return z * dpos + (1.0f - z) * dneg;
}

// How a segment is walked: one float a unit (cols not a multiple of 4),
// or four consecutive floats a unit read by one 16-byte load or by four
// 4-byte loads. The two quad modes take the same elements in the same
// order; only the width of their loads differs.
constexpr int kScalar = 0;
constexpr int kQuad16 = 1;
constexpr int kQuad4 = 2;

template <int MODE> struct Unit;
template <> struct Unit<kScalar> {
    using T = float;
    static constexpr int n = 1;
    static __device__ __forceinline__ T load(const float* p) { return *p; }
    static __device__ __forceinline__ void store(float* p, const T& v) { *p = v; }
    static __device__ __forceinline__ float get(const T& v, int) { return v; }
    static __device__ __forceinline__ void set(T& v, int, float f) { v = f; }
};
struct Quad {
    using T = float4;
    static constexpr int n = 4;
    static __device__ __forceinline__ float get(const T& v, int k)
    {
        return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
    }
    static __device__ __forceinline__ void set(T& v, int k, float f)
    {
        if (k == 0) v.x = f; else if (k == 1) v.y = f;
        else if (k == 2) v.z = f; else v.w = f;
    }
};
template <> struct Unit<kQuad16> : Quad {
    static __device__ __forceinline__ T load(const float* p)
    {
        return *reinterpret_cast<const float4*>(p);
    }
    static __device__ __forceinline__ void store(float* p, const T& v)
    {
        *reinterpret_cast<float4*>(p) = v;
    }
};
template <> struct Unit<kQuad4> : Quad {
    static __device__ __forceinline__ T load(const float* p)
    {
        return make_float4(p[0], p[1], p[2], p[3]);
    }
    static __device__ __forceinline__ void store(float* p, const T& v)
    {
        p[0] = v.x; p[1] = v.y; p[2] = v.z; p[3] = v.w;
    }
};

// Walks rows [r0, r1) of `sg` with every thread of the block. FORWARD adds
// each element's loss to `acc` in a fixed order (row groups in order, then
// the four floats of a unit in order); the backward writes g * dloss.
template <int MODE, bool G2, bool FORWARD>
__device__ __forceinline__ void walk(const Segment& sg, int64_t r0,
                                     int64_t r1, float alpha, float gamma,
                                     float g, float& acc)
{
    using U = Unit<MODE>;
    using T = typename U::T;
    constexpr int kRows = kUnroll / U::n;   // rows whose loads go together
    const int units = sg.cols / U::n;
    const int t = threadIdx.x;
    const int dr = t / units;      // once a block, not once an element
    const int c0 = t - dr * units;
    const int rows_per_group = units >= kThreads ? 1 : kThreads / units;
    if (dr >= rows_per_group) return;   // the block's tail threads
    const float* __restrict__ zs = sg.labels;
    const float* __restrict__ xs = sg.logits;
    const float* __restrict__ ws = sg.weights;
    float* __restrict__ ds = sg.dlogits;
    for (int c = c0; c < units; c += kThreads) {
        const int64_t col = static_cast<int64_t>(c) * U::n;  // in floats
        for (int64_t base = r0 + dr; base < r1;
             base += static_cast<int64_t>(kRows) * rows_per_group) {
            T z[kRows], x[kRows], w[kRows];
            bool ok[kRows];
#pragma unroll
            for (int k = 0; k < kRows; ++k) {
                const int64_t row = base + static_cast<int64_t>(k) * rows_per_group;
                ok[k] = row < r1;
                if (ok[k]) {
                    z[k] = U::load(zs + row * sg.labels_stride + col);
                    x[k] = U::load(xs + row * sg.logits_stride + col);
                    if (ws != nullptr) w[k] = U::load(ws + row * sg.cols + col);
                }
            }
#pragma unroll
            for (int k = 0; k < kRows; ++k) {
                if (!ok[k]) continue;
                T out;
#pragma unroll
                for (int e = 0; e < U::n; ++e) {
                    const float zv = U::get(z[k], e), xv = U::get(x[k], e);
                    if (FORWARD) {
                        float loss = focal_value<G2>(zv, xv, alpha, gamma);
                        if (ws != nullptr) loss = loss * U::get(w[k], e);
                        acc += loss;
                    } else {
                        float grad = focal_grad<G2>(zv, xv, alpha, gamma);
                        if (ws != nullptr) grad = grad * U::get(w[k], e);
                        U::set(out, e, g * grad);
                    }
                }
                if (!FORWARD) {
                    const int64_t row = base + static_cast<int64_t>(k) * rows_per_group;
                    U::store(ds + row * sg.cols + col, out);
                }
            }
        }
    }
}

// The segment of block `b`: the last one whose first block is <= b (a
// segment of no rows has no block and is stepped over).
__device__ __forceinline__ int segment_of(const Table& table, int b)
{
    int s = 0;
    while (s + 1 < table.count && table.seg[s + 1].first_block <= b) ++s;
    return s;
}

template <bool G2, bool FORWARD>
__device__ __forceinline__ void block_walk(const Table& table, float alpha,
                                           float gamma,
                                           const float* __restrict__ upstream,
                                           float& acc)
{
    const int s = segment_of(table, blockIdx.x);
    const Segment& sg = table.seg[s];
    const int64_t j = blockIdx.x - sg.first_block;
    const int64_t r0 = j * sg.rows_per_block;
    const int64_t end = r0 + sg.rows_per_block;
    const int64_t r1 = end < sg.rows ? end : sg.rows;
    const float g = FORWARD ? 0.0f : upstream[s];
    if (sg.unit == kQuad16)
        walk<kQuad16, G2, FORWARD>(sg, r0, r1, alpha, gamma, g, acc);
    else if (sg.unit == kQuad4)
        walk<kQuad4, G2, FORWARD>(sg, r0, r1, alpha, gamma, g, acc);
    else
        walk<kScalar, G2, FORWARD>(sg, r0, r1, alpha, gamma, g, acc);
}

__device__ __forceinline__ float warp_sum(float v)
{
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
    return v;
}

// Sum of `v` over the block in a fixed order; valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* stage)
{
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    v = warp_sum(v);
    if (lane == 0) stage[warp] = v;
    __syncthreads();
    if (warp == 0) v = warp_sum(lane < kWarps ? stage[lane] : 0.0f);
    return v;
}

template <bool G2>
__global__ void __launch_bounds__(kThreads)
focal_fwd_kernel(const __grid_constant__ Table table, float alpha,
                 float gamma, float* __restrict__ partials,
                 unsigned* __restrict__ counter, float* __restrict__ out)
{
    __shared__ float stage[kWarps];
    __shared__ bool last;
    float acc = 0.0f;
    block_walk<G2, true>(table, alpha, gamma, nullptr, acc);
    const float total = block_sum(acc, stage);
    if (threadIdx.x == 0) {
        partials[blockIdx.x] = total;
        __threadfence();                    // the partial before the ticket
        last = atomicAdd(counter, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (!last) return;
    // every other block's partial is visible once its ticket is
    __threadfence();
    const int lane = threadIdx.x & 31;
    for (int s = threadIdx.x >> 5; s < table.count; s += kWarps) {
        const Segment& sg = table.seg[s];
        float v = 0.0f;
        for (int i = lane; i < sg.blocks; i += 32)
            v += __ldcg(partials + sg.first_block + i);
        v = warp_sum(v);
        if (lane == 0) out[s] = v;
    }
    if (threadIdx.x == 0) *counter = 0u;    // ready for the next launch
}

template <bool G2>
__global__ void __launch_bounds__(kThreads)
focal_bwd_kernel(const __grid_constant__ Table table, float alpha,
                 float gamma, const float* __restrict__ upstream)
{
    float unused = 0.0f;
    block_walk<G2, false>(table, alpha, gamma, upstream, unused);
}

// desc: count rows of 8 int64 (labels_stride, logits_stride, rows, cols,
// unit, first_block, blocks, rows_per_block); ptrs: count rows of 4
// (labels, logits, weights or null, dlogits or null).
int fill_table(Table& table, int count, const int64_t* desc,
               const void* const* ptrs, int* blocks)
{
    if (count < 1 || count > kMaxSegments) return -1;
    table.count = count;
    int total = 0;
    for (int s = 0; s < count; ++s) {
        const int64_t* d = desc + 8 * s;
        const void* const* p = ptrs + 4 * s;
        Segment& sg = table.seg[s];
        sg.labels = static_cast<const float*>(p[0]);
        sg.logits = static_cast<const float*>(p[1]);
        sg.weights = static_cast<const float*>(p[2]);
        sg.dlogits = static_cast<float*>(const_cast<void*>(p[3]));
        sg.labels_stride = d[0];
        sg.logits_stride = d[1];
        sg.rows = d[2];
        sg.cols = static_cast<int32_t>(d[3]);
        sg.unit = static_cast<int32_t>(d[4]);
        sg.first_block = static_cast<int32_t>(d[5]);
        sg.blocks = static_cast<int32_t>(d[6]);
        sg.rows_per_block = d[7];
        if (sg.first_block != total || sg.unit < kScalar || sg.unit > kQuad4
            || (sg.unit != kScalar && sg.cols % 4 != 0))
            return -1;
        total += sg.blocks;
    }
    *blocks = total;
    return 0;
}

}  // namespace

// out[s] = the focal-loss sum of segment s, for s < count, in ONE launch.
// `partials` holds one float a block; `counter` is one unsigned int, 0 on
// entry, left 0. Allocates nothing and does not synchronise. Returns the
// cudaError_t of the launch (0 = success), or -1 for a table that does not
// hold together (checked on the host before anything is queued).
extern "C" int detectax_focal_group_fwd(
    int count, const int64_t* desc, const void* const* ptrs, float alpha,
    float gamma, void* partials, void* counter, void* out, void* stream)
{
    Table table;
    int blocks = 0;
    if (fill_table(table, count, desc, ptrs, &blocks) != 0) return -1;
    if (blocks == 0) return -1;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* part = static_cast<float*>(partials);
    unsigned* ctr = static_cast<unsigned*>(counter);
    float* o = static_cast<float*>(out);
    if (gamma == 2.0f)
        focal_fwd_kernel<true><<<blocks, kThreads, 0, s>>>(
            table, alpha, gamma, part, ctr, o);
    else
        focal_fwd_kernel<false><<<blocks, kThreads, 0, s>>>(
            table, alpha, gamma, part, ctr, o);
    return static_cast<int>(cudaGetLastError());
}

// Every segment's dlogits (contiguous [rows, cols], the 4th pointer of its
// row in `ptrs`) = upstream[s] * dloss/dlogits, in ONE launch.
extern "C" int detectax_focal_group_bwd(
    int count, const int64_t* desc, const void* const* ptrs, float alpha,
    float gamma, const void* upstream, void* stream)
{
    Table table;
    int blocks = 0;
    if (fill_table(table, count, desc, ptrs, &blocks) != 0) return -1;
    if (blocks == 0) return -1;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* up = static_cast<const float*>(upstream);
    if (gamma == 2.0f)
        focal_bwd_kernel<true><<<blocks, kThreads, 0, s>>>(
            table, alpha, gamma, up);
    else
        focal_bwd_kernel<false><<<blocks, kThreads, 0, s>>>(
            table, alpha, gamma, up);
    return static_cast<int>(cudaGetLastError());
}
