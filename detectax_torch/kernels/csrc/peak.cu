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
// over. The map is read where the decode leaves it, channel-last, with
// `row_stride` floats from one cell to the next (C for a contiguous map,
// more for the class channels of a wider map, `probs[..., 1:]`, read in
// place). The folded [H, W, P] layout of the TPU kernel is B = 1, C = P.
//
// One block takes one band of R rows of one image (and, where a row does
// not fit, one tile of TW cells of it, or of TC channels of a cell: the
// plan is kernels/peak.py::_peak_plan, a pure function of the shape that
// keeps a block's staging under 48 KB and puts at least 132 blocks, one an
// SM, in flight where the map allows it). The block stages rows y0 - 1 ..
// y0 + R, cells x0 - 1 .. x0 + TW, into shared memory once, with -1 for
// whatever lies outside the map: a contiguous map with C a multiple of 4
// in 16-byte loads, anything else in 4-byte loads. In sigmoid mode each
// staged element is put through the sigmoid once, not once for each of the
// nine neighbourhoods it belongs to. Then every output is its eight
// `q <= p` tests on shared memory, written back four floats at a time
// where C allows. Cell and channel indices come from a division once a
// block and a carried remainder after that, not from a division an element.
//
// What bounds it: bytes, 4 in and 4 out an element against 8 comparisons
// (and one exponential and one division with the sigmoid). At the serving
// shape (8 x 48 x 48 x 20 = 368,640 elements, 2.9 MB in and out) the whole
// map is under a microsecond of memory traffic, so a call costs little
// more than its launch (numbers in PERF.md); the halo rows a band reads
// twice come from L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmemBytes = 48 * 1024;   // no opt-in needed below this
constexpr int kStageBatch = 4;             // staging loads in flight a thread

template <bool SIGMOID>
__device__ __forceinline__ float score(float x)
{
    return SIGMOID ? 1.0f / (1.0f + expf(-x)) : x;
}

// The 8 neighbours of staged element i: +-dx is one cell along w, +-dy
// one row along h.
__device__ __forceinline__ float peak1(const float* s, int i, int dx, int dy)
{
    const float p = s[i];
    const bool keep =
        (s[i - dy - dx] <= p) & (s[i - dy] <= p) & (s[i - dy + dx] <= p)
        & (s[i - dx] <= p) & (s[i + dx] <= p)
        & (s[i + dy - dx] <= p) & (s[i + dy] <= p) & (s[i + dy + dx] <= p);
    return keep ? p : 0.0f;
}

__device__ __forceinline__ float4 ld4(const float* s, int i)
{
    return *reinterpret_cast<const float4*>(s + i);
}

// Four consecutive channels of one cell; i, dx and dy are multiples of 4.
__device__ __forceinline__ float4 peak4(const float* s, int i, int dx, int dy)
{
    const float4 p = ld4(s, i);
    const int off[8] = {-dy - dx, -dy, -dy + dx, -dx, dx, dy - dx, dy, dy + dx};
    bool k0 = true, k1 = true, k2 = true, k3 = true;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
        const float4 q = ld4(s, i + off[n]);
        k0 &= q.x <= p.x;
        k1 &= q.y <= p.y;
        k2 &= q.z <= p.z;
        k3 &= q.w <= p.w;
    }
    return make_float4(k0 ? p.x : 0.0f, k1 ? p.y : 0.0f, k2 ? p.z : 0.0f,
                       k3 ? p.w : 0.0f);
}

template <bool SIGMOID>
__device__ __forceinline__ float score_of(float v) { return score<SIGMOID>(v); }

template <bool SIGMOID>
__device__ __forceinline__ float4 score_of(float4 v)
{
    return make_float4(score<SIGMOID>(v.x), score<SIGMOID>(v.y),
                       score<SIGMOID>(v.z), score<SIGMOID>(v.w));
}

__device__ __forceinline__ void fill(float& v) { v = -1.0f; }
__device__ __forceinline__ void fill(float4& v)
{
    v = make_float4(-1.0f, -1.0f, -1.0f, -1.0f);
}

// Stages rows y0 - 1 .. y0 + rows and cells x0 - 1 .. x0 + tw of image
// `img` into `s`, T (a float, or four consecutive channels) at a time,
// kStageBatch loads in flight a thread; -1 outside the map.
template <typename T, bool SIGMOID>
__device__ __forceinline__ void stage(
    float* s, const float* __restrict__ in, int64_t row_stride, int64_t img,
    int h, int w, int y0, int x0, int c0, int rows, int tw, int cw)
{
    constexpr int U = sizeof(T) / sizeof(float);
    const int cells = tw + 2;
    const int per_cell = cw / U;             // units a staged cell
    const int units = cells * per_cell;      // units a staged row
    const int total = (rows + 2) * units;
    const int t = threadIdx.x;
    // (staged row, cell, unit in the cell) of unit t, and of a step of
    // kThreads units: divided once, carried after that
    int sr = t / units;
    int cell = (t - sr * units) / per_cell;
    int k = t - sr * units - cell * per_cell;
    const int sr_step = kThreads / units;
    const int cell_step = (kThreads - sr_step * units) / per_cell;
    const int k_step = kThreads - sr_step * units - cell_step * per_cell;
    T* dst = reinterpret_cast<T*>(s);
    for (int j0 = t; j0 < total; j0 += kStageBatch * kThreads) {
        T v[kStageBatch];
        bool ok[kStageBatch];
#pragma unroll
        for (int q = 0; q < kStageBatch; ++q) {
            const int yy = y0 - 1 + sr;
            const int xx = x0 - 1 + cell;
            ok[q] = j0 + q * kThreads < total && yy >= 0 && yy < h
                  && xx >= 0 && xx < w;
            if (ok[q])
                v[q] = *reinterpret_cast<const T*>(
                    in + ((img * h + yy) * w + xx) * row_stride + c0 + U * k);
            k += k_step;
            cell += cell_step;
            sr += sr_step;
            if (k >= per_cell) {
                k -= per_cell;
                ++cell;
            }
            if (cell >= cells) {
                cell -= cells;
                ++sr;
            }
        }
#pragma unroll
        for (int q = 0; q < kStageBatch; ++q) {
            const int j = j0 + q * kThreads;
            if (j >= total) break;
            if (ok[q])
                v[q] = score_of<SIGMOID>(v[q]);
            else
                fill(v[q]);
            dst[j] = v[q];
        }
    }
}

template <bool SIGMOID>
__global__ void __launch_bounds__(kThreads)
peak_kernel(const float* __restrict__ in, int64_t row_stride, int h, int w,
            int c, int band_rows, int col_tile, int chan_tile, int bands,
            int col_tiles, int chan_tiles,
            float* __restrict__ out)   // [B, h, w, C] contiguous
{
    extern __shared__ float4 smem4[];
    float* s = reinterpret_cast<float*>(smem4);

    int64_t bid = blockIdx.x;
    const int ct = static_cast<int>(bid % chan_tiles);
    bid /= chan_tiles;
    const int xt = static_cast<int>(bid % col_tiles);
    bid /= col_tiles;
    const int band = static_cast<int>(bid % bands);
    const int64_t img = bid / bands;
    const int y0 = band * band_rows;
    const int x0 = xt * col_tile;
    const int c0 = ct * chan_tile;
    const int rows = min(band_rows, h - y0);
    const int tw = min(col_tile, w - x0);
    const int cw = min(chan_tile, c - c0);   // floats a staged cell
    const int rw = (tw + 2) * cw;            // floats a staged row
    const int t = threadIdx.x;
    const bool whole = cw == c;              // every channel of a cell
    const bool vec_out = whole && (c & 3) == 0;
    const bool vec_in = vec_out && row_stride == c
                      && (reinterpret_cast<uintptr_t>(in) & 15) == 0;

    if (vec_in)
        stage<float4, SIGMOID>(s, in, row_stride, img, h, w, y0, x0, c0,
                               rows, tw, cw);
    else
        stage<float, SIGMOID>(s, in, row_stride, img, h, w, y0, x0, c0,
                              rows, tw, cw);
    __syncthreads();

    // ---- the band's outputs, a row at a time
    const int outs = tw * cw;                // outputs a row of the band
    for (int r = 0; r < rows; ++r) {
        const int centre = (r + 1) * rw + cw;    // staged (row r + 1, cell 1)
        const int64_t out_cell =
            (img * h + y0 + r) * static_cast<int64_t>(w) + x0;
        if (vec_out) {
            float4* o = reinterpret_cast<float4*>(out + out_cell * c);
            for (int j = t; j < outs / 4; j += kThreads)
                o[j] = peak4(s, centre + 4 * j, cw, rw);
        } else if (whole) {
            float* o = out + out_cell * c;
            for (int j = t; j < outs; j += kThreads)
                o[j] = peak1(s, centre + j, cw, rw);
        } else {                             // a tile of the channels
            const int x_step = kThreads / cw;
            const int c_step = kThreads - x_step * cw;
            int x = t / cw;
            int k = t - x * cw;
            for (int j = t; j < outs; j += kThreads) {
                out[(out_cell + x) * c + c0 + k] = peak1(s, centre + j, cw, rw);
                x += x_step;
                k += c_step;
                if (k >= cw) {
                    k -= cw;
                    ++x;
                }
            }
        }
    }
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

}  // namespace

// out[B, h, w, C] (contiguous) = the peak-masked scores of `in`, read as
// B*h*w cells of C floats, `row_stride` floats apart, in bands of
// `band_rows` rows, tiles of `col_tile` cells and `chan_tile` channels
// (kernels/peak.py::_peak_plan). Launches one kernel on `stream`;
// allocates nothing and does not synchronise. Returns the cudaError_t of
// the launch (0 = success).
extern "C" int detectax_peak(
    const void* in, int64_t row_stride, int64_t batch, int64_t h, int64_t w,
    int64_t c, int64_t band_rows, int64_t col_tile, int64_t chan_tile,
    int apply_sigmoid, void* out, void* stream)
{
    if (batch * h * w * c == 0) return 0;
    if (band_rows < 1 || col_tile < 1 || chan_tile < 1 || h > INT32_MAX
        || w > INT32_MAX || c > INT32_MAX)
        return static_cast<int>(cudaErrorInvalidValue);
    const int64_t bands = ceil_div(h, band_rows);
    const int64_t col_tiles = ceil_div(w, col_tile);
    const int64_t chan_tiles = ceil_div(c, chan_tile);
    const int64_t blocks = batch * bands * col_tiles * chan_tiles;
    const int64_t smem = (band_rows + 2) * (col_tile + 2) * chan_tile * 4;
    if (blocks > INT32_MAX || smem > kMaxSmemBytes)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto kernel = apply_sigmoid ? peak_kernel<true> : peak_kernel<false>;
    kernel<<<static_cast<unsigned>(blocks), kThreads, static_cast<size_t>(smem),
             s>>>(
        static_cast<const float*>(in), row_stride, static_cast<int>(h),
        static_cast<int>(w), static_cast<int>(c), static_cast<int>(band_rows),
        static_cast<int>(col_tile), static_cast<int>(chan_tile),
        static_cast<int>(bands), static_cast<int>(col_tiles),
        static_cast<int>(chan_tiles), static_cast<float*>(out));
    return static_cast<int>(cudaGetLastError());
}
