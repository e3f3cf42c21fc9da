// DLRM pairwise dot interaction for Hopper (sm_90a): Gram product and
// triangle packing in one kernel.
//
// Replaces the Pallas TPU kernel src/repro/kernels/interaction.py::gram and
// the wrapper around it, ::dot_interaction.  On the TPU the Gram matrices
// are written out as (B, F*F) and the strict lower triangle is taken by a
// second, separate gather, because a Pallas kernel cannot capture the
// constant index array.  Here one launch does both: feats (B, F, D) ->
// out (B, F(F-1)/2), out[b, p] = <feats[b, i], feats[b, j]> with
// p = i(i-1)/2 + j, j < i, which is np.tril_indices(F, -1) row-major order.
// With packed = 0 the same kernel writes the full (B, F*F) Gram matrix, the
// counterpart of ::gram.  float32 and bfloat16 inputs; products and sums
// are float32, the result is stored in the input's type.
//
// What bounds it: at the sizes of the paper models (F = 11 or 41, D = 32)
// a sample's slab is 1.4 to 5.2 KB and a batch of 1024 moves under 10 MB
// and 0.11 GFLOP, a few microseconds of either on this card, so the launch
// itself and the latency of one pass dominate, not bytes or operations.
// The design keeps to one pass: one block per sample stages the slab in
// shared memory once (row stride padded to an odd word count, so threads
// that read different rows at the same column hit different banks), each
// thread owns packed outputs and walks D sequentially, and every input
// byte is read from device memory once.  F and D are run-time values; the
// ragged edges are masked by the loop bounds, nothing is padded in memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
}

template <typename T>
__global__ void dot_interaction_kernel(const T* __restrict__ feats, T* __restrict__ out,
                                       int F, int D, int stride, int n_out, int packed) {
    extern __shared__ float slab[];  // F rows of `stride` floats
    const long long b = blockIdx.x;
    const T* x = feats + b * (long long)F * D;
    for (int e = threadIdx.x; e < F * D; e += blockDim.x) {
        slab[(e / D) * stride + (e % D)] = to_float(x[e]);
    }
    __syncthreads();

    T* o = out + b * (long long)n_out;
    for (int p = threadIdx.x; p < n_out; p += blockDim.x) {
        int i, j;
        if (packed) {
            // invert p = i(i-1)/2 + j; the float root may be off by one
            i = (int)((1.f + sqrtf(1.f + 8.f * (float)p)) * 0.5f);
            while (i * (i - 1) / 2 > p) --i;
            while ((i + 1) * i / 2 <= p) ++i;
            j = p - i * (i - 1) / 2;
        } else {
            i = p / F;
            j = p % F;
        }
        const float* ri = slab + i * stride;
        const float* rj = slab + j * stride;
        float acc = 0.f;
        for (int d = 0; d < D; ++d) acc = fmaf(ri[d], rj[d], acc);
        from_float(o + p, acc);
    }
}

template <typename T>
int launch(const void* feats, void* out, int B, int F, int D, int packed,
           cudaStream_t stream) {
    const int n_out = packed ? F * (F - 1) / 2 : F * F;
    const int stride = D | 1;
    const size_t smem = (size_t)F * stride * sizeof(float);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(dot_interaction_kernel<T>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    int threads = ((n_out < F * D ? F * D : n_out) + 31) / 32 * 32;
    if (threads > 256) threads = 256;
    dot_interaction_kernel<T><<<B, threads, smem, stream>>>(
        static_cast<const T*>(feats), static_cast<T*>(out), F, D, stride, n_out, packed);
    return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  packed: 1 = strict lower triangle,
// 0 = full Gram matrix.  Returns cudaGetLastError() after the launch.
extern "C" int dot_interaction_launch(const void* feats, void* out, int B, int F, int D,
                                      int packed, int dtype, void* stream) {
    if (B == 0 || F == 0 || (packed && F < 2)) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch<float>(feats, out, B, F, D, packed, s);
    if (dtype == 1) return launch<__nv_bfloat16>(feats, out, B, F, D, packed, s);
    return (int)cudaErrorInvalidValue;
}
