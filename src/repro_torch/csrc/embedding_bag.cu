// Embedding bag for Hopper (sm_90a): gather H rows per bag and pool them.
//
// Replaces the Pallas TPU kernel src/repro/kernels/embedding_bag.py::embedding_bag.
// That kernel streams one (1, D) row per sequential grid step, selected by
// scalar-prefetched indices, and accumulates in an output block that stays
// resident across the steps of a bag tile.  None of that shape exists on a
// GPU: blocks run in parallel and in no order, so here the hotness loop
// runs inside a thread group and the running sum lives in registers.
//
// What it computes: tables (F, V, D), idx (B, F, H) int32 -> out (B, F, D);
// bag (b, f) sums (or averages) rows idx[b, f, :] of table f.  The
// single-table form (V, D), (B, H) -> (B, D) is the F = 1 view.
// Accumulation is float32 with Kahan compensation, in index order, exactly
// as the TPU kernel does it; the result is cast to the table's type.
//
// What bounds it: bytes.  Each output element costs H row reads and one
// add; DLRM-RMC2 at batch 1024 gathers 1024*40*80 rows of 128 bytes
// (419 MB) to write 5 MB, so the floor is the gathered bytes over the
// memory rate.  The design therefore (a) reads each row with 16-byte loads
// on neighbouring threads whenever a row's byte length is a multiple of 16,
// (b) gives a bag only as many threads as its row has 16-byte vectors
// (8 for D = 32 float32), so a warp serves several bags and no lane idles,
// and (c) issues four independent row loads before the dependent Kahan
// chain consumes them, to keep loads in flight.  Rows whose length is not a
// multiple of 16 bytes (D = 130) take the scalar instantiation.
//
// Row offsets are 64-bit: (f*V + idx)*D passes 2^31 elements for the paper
// models (40 tables * 10^6 rows * 32).  Indices are trusted to lie in
// [0, V); the Python wrapper offers the range check.
//
// Compile without -use_fast_math: it would let the compiler simplify the
// compensation term away.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

template <typename T, int VEC>
struct RowIO;

template <>
struct RowIO<float, 4> {
    static __device__ __forceinline__ void load(const float* p, float (&r)[4]) {
        const float4 v = *reinterpret_cast<const float4*>(p);
        r[0] = v.x; r[1] = v.y; r[2] = v.z; r[3] = v.w;
    }
    static __device__ __forceinline__ void store(float* p, const float (&r)[4]) {
        *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
    }
};

template <>
struct RowIO<float, 1> {
    static __device__ __forceinline__ void load(const float* p, float (&r)[1]) { r[0] = *p; }
    static __device__ __forceinline__ void store(float* p, const float (&r)[1]) { *p = r[0]; }
};

template <>
struct RowIO<__nv_bfloat16, 8> {
    static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&r)[8]) {
        const uint4 v = *reinterpret_cast<const uint4*>(p);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float2 f = __bfloat1622float2(h[i]);
            r[2 * i] = f.x; r[2 * i + 1] = f.y;
        }
    }
    static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&r)[8]) {
        uint4 v;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
        for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(r[2 * i], r[2 * i + 1]);
        *reinterpret_cast<uint4*>(p) = v;
    }
};

template <>
struct RowIO<__nv_bfloat16, 1> {
    static __device__ __forceinline__ void load(const __nv_bfloat16* p, float (&r)[1]) {
        r[0] = __bfloat162float(*p);
    }
    static __device__ __forceinline__ void store(__nv_bfloat16* p, const float (&r)[1]) {
        *p = __float2bfloat16(r[0]);
    }
};

// One Kahan step per lane element: comp carries the rounding error of the
// running sum, as in the TPU kernel's comp_ref.
template <int VEC>
__device__ __forceinline__ void kahan_add(float (&acc)[VEC], float (&comp)[VEC],
                                          const float (&row)[VEC]) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
        const float y = row[i] - comp[i];
        const float t = acc[i] + y;
        comp[i] = (t - acc[i]) - y;
        acc[i] = t;
    }
}

// `group` threads (a power of two <= 32) serve one bag; a block of
// blockDim.x threads serves blockDim.x / group bags.
template <typename T, int VEC>
__global__ void embedding_bag_kernel(const T* __restrict__ tables,
                                     const int* __restrict__ idx,
                                     T* __restrict__ out,
                                     long long n_bags, int F, long long V, int D,
                                     int H, int group, int mean) {
    const int lane = threadIdx.x % group;
    const long long bag =
        (long long)blockIdx.x * (blockDim.x / group) + threadIdx.x / group;
    if (bag >= n_bags) return;

    const long long field = bag % F;
    const T* table = tables + field * V * (long long)D;
    const int* bag_idx = idx + bag * H;
    T* bag_out = out + bag * D;
    const int n_vec = D / VEC;

    for (int v = lane; v < n_vec; v += group) {
        const int col = v * VEC;
        float acc[VEC], comp[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) { acc[i] = 0.f; comp[i] = 0.f; }

        int h = 0;
        for (; h + 4 <= H; h += 4) {
            float r0[VEC], r1[VEC], r2[VEC], r3[VEC];
            const long long i0 = bag_idx[h], i1 = bag_idx[h + 1];
            const long long i2 = bag_idx[h + 2], i3 = bag_idx[h + 3];
            RowIO<T, VEC>::load(table + i0 * D + col, r0);
            RowIO<T, VEC>::load(table + i1 * D + col, r1);
            RowIO<T, VEC>::load(table + i2 * D + col, r2);
            RowIO<T, VEC>::load(table + i3 * D + col, r3);
            kahan_add<VEC>(acc, comp, r0);
            kahan_add<VEC>(acc, comp, r1);
            kahan_add<VEC>(acc, comp, r2);
            kahan_add<VEC>(acc, comp, r3);
        }
        for (; h < H; ++h) {
            float r[VEC];
            const long long i0 = bag_idx[h];
            RowIO<T, VEC>::load(table + i0 * D + col, r);
            kahan_add<VEC>(acc, comp, r);
        }
        if (mean) {
#pragma unroll
            for (int i = 0; i < VEC; ++i) acc[i] = acc[i] / (float)H;
        }
        RowIO<T, VEC>::store(bag_out + col, acc);
    }
}

template <typename T, int VEC>
int launch(const void* tables, const int* idx, void* out, long long n_bags, int F,
           long long V, int D, int H, int mean, cudaStream_t stream) {
    const int n_vec = D / VEC;
    int group = 1;
    while (group < n_vec && group < 32) group *= 2;
    const int threads = 256;
    const long long bags_per_block = threads / group;
    const long long blocks = (n_bags + bags_per_block - 1) / bags_per_block;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
    embedding_bag_kernel<T, VEC><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const T*>(tables), idx, static_cast<T*>(out), n_bags, F, V, D, H,
        group, mean);
    return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  vectorized: 1 when a row's byte length
// is a multiple of 16 and both base pointers are 16-byte aligned.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int embedding_bag_launch(const void* tables, const void* idx, void* out,
                                    long long n_bags, int F, long long V, int D, int H,
                                    int mean, int dtype, int vectorized, void* stream) {
    if (n_bags == 0 || D == 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int* ix = static_cast<const int*>(idx);
    if (dtype == 0) {
        return vectorized ? launch<float, 4>(tables, ix, out, n_bags, F, V, D, H, mean, s)
                          : launch<float, 1>(tables, ix, out, n_bags, F, V, D, H, mean, s);
    }
    if (dtype == 1) {
        return vectorized
                   ? launch<__nv_bfloat16, 8>(tables, ix, out, n_bags, F, V, D, H, mean, s)
                   : launch<__nv_bfloat16, 1>(tables, ix, out, n_bags, F, V, D, H, mean, s);
    }
    return (int)cudaErrorInvalidValue;
}
