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

// ---- K1-bwd: the gradient of the pooling with respect to the tables
//
// What it computes: grad_out (B, F, D) in the tables' type, idx (B, F, H)
// -> grad (F, V, D) float32, which the caller zeroes: for every (b, f, h),
// grad_out[b, f, :] (divided by H for mean) is added into row idx[b, f, h]
// of table f's gradient.  It is what the reference's autodiff of the
// gather-and-sum gives (a dense, table-shaped gradient); the TPU kernel has
// no backward of its own.  bfloat16 tables accumulate in this float32
// buffer, and the wrapper casts the result once.
//
// What bounds it: bytes, and under skewed ids the rows many lookups share.
// Each lookup adds a D-row of grad_out into a D-row of the gradient; at
// DLRM-RMC2's shape that is 3.3 M adds of 128-byte rows into about 1.3 M
// distinct rows.  Atomics would do it in whatever order the warps reach a
// row, so every launch would round differently, and adagrad's steps (about
// lr * sign(g) at first) carry such differences into the loss within a few
// steps: training would not repeat, nor resume bit for bit.  So the design
// is owner-computes, and no two warps ever add into one row:
//
//   * warp w of table f owns the rows r with r % W == w (W a power of two
//     from kernels/embedding_bag.py::backward_warps) and scans all of table
//     f's lookups in order (b, then h): 32 lookups a load, a ballot picks
//     its own, and the next bags' indices and gradient rows (a ring of 2 or
//     4) are in flight while it adds the current bag's;
//   * lanes run over D, a column each (CPL columns for D > 32), so a row is
//     one coalesced access;
//   * a small direct-mapped cache of K rows in registers sums a row's runs
//     of lookups (Zipf ids put 5 % of a table's lookups on its row 0); a
//     row's sum goes to device memory when it is evicted or at the end,
//     by a reduction (red.global.add) that the warp does not wait for: the
//     row's sole owner sends it, so nothing races, and one thread's adds to
//     one address take effect in program order.
//
// Every launch sums every row in the same order, so a launch gives the same
// bits every time.  Variants tried on an H100 and slower at DLRM-RMC2's
// shape: counting a chunk's cached rows by ballots, float4 columns with
// float4 or scalar reductions, a ring of 8 bags, W = 32 or 128.
constexpr int BWD_CHUNKS = 4;  // 32-lookup chunks of a bag in flight (H <= 128 at once)
constexpr int BWD_SLOTS = 4;   // rows a warp keeps summing in registers

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

template <typename T, int CPL>
__global__ void embedding_bag_backward_kernel(const T* __restrict__ grad_out,
                                              const int* __restrict__ idx,
                                              float* __restrict__ grad, int B, int F,
                                              long long V, int D, int H, int log_w, int mean) {
    constexpr unsigned FULL = 0xffffffffu;
    const int lane = threadIdx.x % 32;
    const long long gw = (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
    const int W = 1 << log_w;
    if (gw >= (long long)F * W) return;
    const int f = (int)(gw >> log_w), w = (int)(gw & (W - 1));
    float* table = grad + (long long)f * V * D;

    int cached[BWD_SLOTS];
    float acc[BWD_SLOTS][CPL];
#pragma unroll
    for (int s = 0; s < BWD_SLOTS; ++s) cached[s] = -1;

    // a reduction the sole owner sends off without waiting for it: one lane
    // always adds into the same columns, and one thread's adds to an
    // address take effect in program order, so the order stays fixed
    auto flush = [&](int s) {
        float* p = table + (long long)cached[s] * D;
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
            const int col = lane + 32 * c;
            if (col < D) atomicAdd(p + col, acc[s][c]);
        }
    };
    auto add = [&](int row, const float (&g)[CPL]) {
        const int slot = (row >> log_w) & (BWD_SLOTS - 1);
#pragma unroll
        for (int s = 0; s < BWD_SLOTS; ++s) {  // unrolled: the slot stays in registers
            if (s != slot) continue;
            if (cached[s] == row) {
#pragma unroll
                for (int c = 0; c < CPL; ++c) acc[s][c] += g[c];
            } else {
                if (cached[s] >= 0) flush(s);
                cached[s] = row;
#pragma unroll
                for (int c = 0; c < CPL; ++c) acc[s][c] = g[c];
            }
        }
    };
    auto load = [&](int b, int (&rows)[BWD_CHUNKS], float (&g)[CPL]) {
        const long long bag = (long long)b * F + f;
#pragma unroll
        for (int k = 0; k < BWD_CHUNKS; ++k) {
            const int h = 32 * k + lane;
            rows[k] = h < H ? idx[bag * H + h] : -1;
        }
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
            const int col = lane + 32 * c;
            g[c] = col < D ? to_float(grad_out[bag * D + col]) : 0.f;
        }
    };
    // the lookups of one 32-wide chunk that this warp owns, in lane order
    auto take = [&](int r, const float (&g)[CPL]) {
        unsigned own = __ballot_sync(FULL, r >= 0 && (r & (W - 1)) == w);
        while (own) {
            const int j = __ffs(own) - 1;
            own &= own - 1;
            add(__shfl_sync(FULL, r, j), g);
        }
    };

    // a ring of the next AHEAD bags' indices and gradient rows in flight
    constexpr int AHEAD = CPL <= 2 ? 4 : 2;
    int nrows[AHEAD][BWD_CHUNKS];
    float ng[AHEAD][CPL];
#pragma unroll
    for (int j = 0; j < AHEAD; ++j)
        if (j < B) load(j, nrows[j], ng[j]);
    for (int b0 = 0; b0 < B; b0 += AHEAD) {
#pragma unroll
        for (int j = 0; j < AHEAD; ++j) {  // unrolled: the ring stays in registers
            const int b = b0 + j;
            if (b >= B) break;
            int rows[BWD_CHUNKS];
            float g[CPL];
#pragma unroll
            for (int k = 0; k < BWD_CHUNKS; ++k) rows[k] = nrows[j][k];
#pragma unroll
            for (int c = 0; c < CPL; ++c) g[c] = mean ? ng[j][c] / (float)H : ng[j][c];
            if (b + AHEAD < B) load(b + AHEAD, nrows[j], ng[j]);
#pragma unroll
            for (int k = 0; k < BWD_CHUNKS; ++k) take(rows[k], g);
            for (int h0 = 32 * BWD_CHUNKS; h0 < H; h0 += 32) {  // bags of more than 128 lookups
                const int h = h0 + lane;
                take(h < H ? idx[((long long)b * F + f) * H + h] : -1, g);
            }
        }
    }
#pragma unroll
    for (int s = 0; s < BWD_SLOTS; ++s)
        if (cached[s] >= 0) flush(s);
}

template <typename T, int CPL>
int launch_backward(const void* grad_out, const int* idx, float* grad, int B, int F,
                    long long V, int D, int H, int log_w, int mean, cudaStream_t stream) {
    const int threads = 256;  // eight warps
    const long long warps = (long long)F << log_w;
    const long long blocks = (warps + threads / 32 - 1) / (threads / 32);
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
    embedding_bag_backward_kernel<T, CPL><<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const T*>(grad_out), idx, grad, B, F, V, D, H, log_w, mean);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_backward_cpl(const void* grad_out, const int* idx, float* grad, int B, int F,
                        long long V, int D, int H, int log_w, int mean, cudaStream_t s) {
    if (D <= 32) return launch_backward<T, 1>(grad_out, idx, grad, B, F, V, D, H, log_w, mean, s);
    if (D <= 64) return launch_backward<T, 2>(grad_out, idx, grad, B, F, V, D, H, log_w, mean, s);
    if (D <= 128) return launch_backward<T, 4>(grad_out, idx, grad, B, F, V, D, H, log_w, mean, s);
    if (D <= 256) return launch_backward<T, 8>(grad_out, idx, grad, B, F, V, D, H, log_w, mean, s);
    return (int)cudaErrorInvalidValue;
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

// K1-bwd.  grad_out (B, F, D) in `dtype` (0 = float32, 1 = bfloat16),
// idx (B, F, H) int32, grad (F, V, D) float32 zeroed by the caller, D <= 256;
// 2^log_w warps own each table's rows (kernels/embedding_bag.py).  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int embedding_bag_backward_launch(const void* grad_out, const void* idx, void* grad,
                                             int B, int F, long long V, int D, int H,
                                             int log_w, int mean, int dtype, void* stream) {
    if (B == 0 || F == 0 || D == 0 || H == 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int* ix = static_cast<const int*>(idx);
    float* g = static_cast<float*>(grad);
    if (dtype == 0)
        return launch_backward_cpl<float>(grad_out, ix, g, B, F, V, D, H, log_w, mean, s);
    if (dtype == 1)
        return launch_backward_cpl<__nv_bfloat16>(grad_out, ix, g, B, F, V, D, H, log_w, mean, s);
    return (int)cudaErrorInvalidValue;
}
