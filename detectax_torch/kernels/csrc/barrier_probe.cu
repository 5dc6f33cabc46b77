// Measurement aid, not a port of any TPU kernel: the cost of one dependent
// round that does nothing but exchange a value through shared memory and
// meet at a block-wide barrier. The two NMS kernels are chains of such
// rounds, so rounds x this cost is the floor of their one-block designs;
// chip_smoke.py times it beside them.
#include <cuda_runtime.h>

namespace {

__global__ void barrier_probe_kernel(int rounds, int* __restrict__ out)
{
    __shared__ int slot[2][1024];
    const int tid = threadIdx.x;
    const int next = (tid + 1) % blockDim.x;
    int v = tid;
    for (int r = 0; r < rounds; ++r) {
        // double-buffered like the kernels' argmax stage: round r + 2 may
        // write a slot only after every thread passed the barrier of r + 1
        slot[r & 1][tid] = v;
        __syncthreads();
        v += slot[r & 1][next];
    }
    out[blockIdx.x * blockDim.x + tid] = v;
}

}  // namespace

// `out` holds blocks * threads ints. Launches on `stream`; returns the
// cudaError_t of the launch.
extern "C" int detectax_barrier_probe(
    int rounds, int blocks, int threads, void* out, void* stream)
{
    barrier_probe_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        rounds, static_cast<int*>(out));
    return static_cast<int>(cudaGetLastError());
}
