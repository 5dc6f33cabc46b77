// Measurement aids, not ports of any TPU kernel: the cost of one dependent
// step of the NMS kernels with no work in it. The two NMS kernels are
// chains of such steps, so steps x this cost is the floor of their
// designs; chip_smoke.py times the probes beside them.
//
//   barrier_probe_kernel: a shared-memory exchange and one block-wide
//     barrier, the round of a one-block-per-image design.
//   cluster_probe_kernel, by `mode`:
//     0: one cluster barrier (barrier.cluster arrive.release / wait.acquire)
//        and nothing else;
//     1: a round built on it: block-wide exchange and barrier, a slot
//        write, the cluster barrier, and a read of every block's slot
//        through distributed shared memory;
//     2: the round of dense_nms.cu: every warp's value goes to every block
//        of the cluster (st.async, lane q to block q, counted on the
//        block's mbarrier), each block waits on its own mbarrier and every
//        warp folds all the cluster's slots. No block-wide barrier.
//   chain_probe_kernel: the chain of the sweep in nms_sweep.cu, one warp:
//     step b tests bit b of the removed word and, when clear, ORs in a
//     word read from shared memory.
//   empty_kernel: one warp that does nothing; queued back to back, its
//     launches give the floor under every kernel's time (launch_floor_ms).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned peer_addr(const void* p, unsigned rank) {
    unsigned r;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                 : "=r"(r) : "r"(smem_addr(p)), "r"(rank));
    return r;
}

__device__ __forceinline__ void cluster_sync() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n"
                 "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
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

__global__ void cluster_probe_kernel(int rounds, int mode, unsigned* __restrict__ out)
{
    __shared__ unsigned part[32];
    __shared__ unsigned slot[2];
    __shared__ __align__(16) uint4 inbox[2][2 * 16 * 16];  // 32 B a warp slot
    __shared__ __align__(8) uint64_t bar[2];
    cg::cluster_group cluster = cg::this_cluster();
    const int csize = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int nwarps = blockDim.x >> 5;
    const int nslots = csize * nwarps;
    if (threadIdx.x == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                     "mbarrier.init.shared::cta.b64 [%1], 1;\n"
                     "fence.mbarrier_init.release.cluster;\n"
                     :: "r"(smem_addr(&bar[0])), "r"(smem_addr(&bar[1])) : "memory");
    }
    cluster_sync();
    unsigned v = threadIdx.x;
    for (int r = 0; r < rounds; ++r) {
        const int p = r & 1;
        unsigned got = 0;
        if (mode == 0) {
            cluster_sync();
            got = v;
        } else if (mode == 1) {
            if (lane == 0) part[warp] = v;
            __syncthreads();
            const unsigned b = lane < nwarps ? part[lane] : 0u;
            if (threadIdx.x == 0) slot[p] = b;
            cluster_sync();
            if (lane < csize) {
                asm volatile("ld.shared::cluster.u32 %0, [%1];\n"
                             : "=r"(got) : "r"(peer_addr(&slot[p], lane)) : "memory");
            }
        } else {
            if (threadIdx.x == 0)
                asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                             :: "r"(smem_addr(&bar[p])),
                                "r"(static_cast<unsigned>(nslots) * 32u) : "memory");
            const unsigned b = __reduce_max_sync(0xffffffffu, v);
            if (lane < csize) {
                const unsigned rb = peer_addr(&bar[p], lane);
                for (int h = 0; h < 2; ++h) {
                    const unsigned dst = peer_addr(&inbox[p][2 * (rank * nwarps + warp) + h], lane);
                    asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
                                 "[%0], {%1, %2, %3, %4}, [%5];\n"
                                 :: "r"(dst), "r"(b), "r"(b), "r"(b), "r"(b), "r"(rb) : "memory");
                }
            }
            mbar_wait(&bar[p], static_cast<unsigned>(r >> 1) & 1u);
            for (int q = lane; q < nslots; q += 32)
                got = max(got, inbox[p][2 * q + 1].x);
        }
        v += __reduce_max_sync(0xffffffffu, got);
    }
    out[blockIdx.x * blockDim.x + threadIdx.x] = v;
    cluster_sync();  // no block leaves while a peer may still reach it
}

__global__ void chain_probe_kernel(int steps, unsigned long long* __restrict__ out)
{
    __shared__ unsigned long long words[64];
    const int lane = threadIdx.x;
    words[lane] = 0x9E3779B97F4A7C15ull * (lane + 1);
    words[lane + 32] = 0xC2B2AE3D27D4EB4Full * (lane + 1);
    __syncwarp();
    unsigned long long cur = 0, kept = 0;
    for (int s = 0; s < steps; s += 64) {
#pragma unroll
        for (int b = 0; b < 64; ++b) {
            const unsigned long long d = words[b];
            if (((cur >> b) & 1ull) == 0) {
                kept |= 1ull << b;
                cur |= d;
            }
        }
        cur = kept & static_cast<unsigned long long>(s);  // carry the dependence on
    }
    out[blockIdx.x * 32 + lane] = cur ^ kept;
}

__global__ void empty_kernel() {}

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

// `clusters` clusters of `cluster` blocks of `threads` threads (cluster <=
// 16, threads <= 512); `out` holds clusters * cluster * threads ints.
// Returns the cudaError_t of the launch.
extern "C" int detectax_cluster_probe(
    int rounds, int mode, int clusters, int cluster, int threads, void* out,
    void* stream)
{
    if (cluster > 8) {
        cudaError_t e = cudaFuncSetAttribute(
            cluster_probe_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (e != cudaSuccess) return static_cast<int>(e);
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(clusters) * cluster);
    cfg.blockDim = dim3(threads);
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t e = cudaLaunchKernelEx(&cfg, cluster_probe_kernel, rounds, mode,
                                       static_cast<unsigned*>(out));
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(cudaGetLastError());
}

// `blocks` warps, each a chain of `steps` (a multiple of 64); `out` holds
// blocks * 32 words. Returns the cudaError_t of the launch.
extern "C" int detectax_chain_probe(int steps, int blocks, void* out, void* stream)
{
    chain_probe_kernel<<<blocks, 32, 0, static_cast<cudaStream_t>(stream)>>>(
        steps, static_cast<unsigned long long*>(out));
    return static_cast<int>(cudaGetLastError());
}

// One launch of a kernel that does nothing. Returns the cudaError_t.
extern "C" int detectax_empty_launch(void* stream)
{
    empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
    return static_cast<int>(cudaGetLastError());
}
