// The gradient of one xDeepFM Compressed Interaction Network layer (K3-bwd)
// for Hopper (sm_90a), float32 on the CUDA cores.
//
// Replaces no TPU kernel: src/repro/kernels/cin.py::cin_layer has no
// backward, and the JAX package's training step gets the layer's gradient
// from XLA's autodiff of the plain layer (src/repro/layers/interactions.py).
// Forward (csrc/cin.cu, K3): x0 (B, F, D), xk (B, H, D), w (H*F, N) ->
// out (B, N, D), out[b, n, d] = sum_{h,f} w[h*F + f, n] * xk[b, h, d] * x0[b, f, d].
// Given g = dL/dout (B, N, D), with rows r = (b, d) (M = B*D), m = h*F + f
// (K = H*F) and P[r, m] = sum_n w[m, n] * g[b, n, d]:
//     dxk[b, h, d] = sum_f P[r, h*F + f] * x0[b, f, d]
//     dx0[b, f, d] = sum_h P[r, h*F + f] * xk[b, h, d]
//     dw[m, n]     = sum_r A[r, m] * g[b, n, d],   A[r, m] = xk[b, h, d] * x0[b, f, d]
// float32 and bfloat16 inputs (all four of one type, bfloat16 widened on
// load); every sum is float32; the results are stored in the inputs' type.
// Neither P nor A, each (B, H*F, D), is ever written to device memory: at
// B = 65,536 and K = 7,800 either would be 20.4 GB.
//
// What bounds it: float32 operations, 2*M*N*K for each product (plus 4*M*K
// for the data gradient's two contractions and M*K to form A).  At
// xDeepFM's B = 512, K = 7,800, N = 200 that is 32.1 GFLOP, 0.480 ms at the
// card's 67 TFLOP/s; the ~26 MB of inputs and results are 0.008 ms at
// 3.35 TB/s.  Float32 on the CUDA cores rather than the forward's 3xTF32:
// the first version of the gradient is the simple one (two products,
// exact float32 sums); the tensor cores are later work.  On an H100 SXM
// (700 W) it took 1.56 ms there (31 % of the bound) and 172 ms at
// B = 65,536 (36 %); the weight product pads N = 200 to two tiles of 128.
//
// The design: two products on one tiled core, a block of 256 threads
// computing a 128 x 128 tile of outputs, 8 x 8 in each thread's registers,
// over stages of 8 reduction values staged through shared memory
// (double-buffered, the next stage's loads in flight while this one is
// multiplied; 16-byte shared reads; rows ty*4 + {0..3}, 64 + ty*4 + {0..3}
// and columns likewise of tx, so that a warp's reads are conflict-free).
//   - The data gradient (cin_bwd_data_kernel): rows r x columns m, the
//     reduction over n.  A block owns 128 rows and walks its run of h
//     values in chunks of 128 columns of P; after each chunk P goes through
//     shared memory, 64 columns at a time, and the contractions run there:
//     threads 0-127 each add P * xk into their row's dx0 (F values in
//     shared memory), threads 128-255 each add P * x0 into their row's
//     running dxk and store it when its h is complete.  Each output is
//     summed by one thread in ascending m.  At a small batch the rows
//     give too few blocks, so the h values are cut into runs (a plan that
//     depends on the shapes alone); each run writes its own dxk and a
//     float32 plane of dx0, and a second kernel adds the planes in order.
//   - The weight gradient (cin_bwd_weight_kernel): rows m x columns n, the
//     reduction over r.  A stage's A tile is formed from xk and x0 as it is
//     loaded (the one product the forward also forms); the rows are cut
//     into runs of a length fixed by the shapes, each run's float32 partial
//     sums go to a plane of a workspace, and the second kernel adds the
//     planes in run order.
// No atomics: every sum runs in an order fixed by the shapes, and two
// launches on the same inputs give the same bits.  Offsets into device
// memory are 64-bit.  No -use_fast_math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// kernels/cin.py keeps copies of these to plan the runs; a test holds them equal.
constexpr int TILE = 128;                // a block's tile: TILE x TILE outputs
constexpr int HALF = TILE / 2;
constexpr int KS = 8;                    // reduction values a stage
constexpr int LD = TILE + 4;             // row stride of a stage's tiles (floats)
constexpr int PS = HALF + 4;             // row stride of P's staging tile (floats)
constexpr int THREADS = 256;             // 16 x 16 threads, 8 x 8 outputs each
constexpr int STAGE_FLOATS = KS * LD;
constexpr int SMEM_LIMIT = 232448;       // dynamic shared memory a block may have
static_assert(THREADS * 4 == KS * TILE, "a stage is four loads a thread of each operand");
static_assert(THREADS == 2 * TILE, "the data gradient's contractions: two threads a row");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// The tile row of a thread's i-th output row (and, with tx, its column).
__device__ __forceinline__ int tile_row(int i, int t) { return (i < 4 ? 0 : HALF) + t * 4 + (i & 3); }

// acc[i][j] += sum over the stage's KS values k of a[k][tile_row(i, ty)] * b[k][tile_row(j, tx)],
// in ascending k.
__device__ __forceinline__ void multiply_stage(float (&acc)[8][8], const float* a, const float* b,
                                               int ty, int tx) {
#pragma unroll
    for (int k = 0; k < KS; ++k) {
        const float4 a0 = *reinterpret_cast<const float4*>(a + k * LD + ty * 4);
        const float4 a1 = *reinterpret_cast<const float4*>(a + k * LD + HALF + ty * 4);
        const float4 b0 = *reinterpret_cast<const float4*>(b + k * LD + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(b + k * LD + HALF + tx * 4);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
}

// Block (x, y): rows [x*TILE, x*TILE + TILE) of M, and h in [y*hp, min(H, (y+1)*hp)).
// dx0_partial == nullptr: dx0 is stored in dx0; otherwise float32 into plane y of
// dx0_partial (splits, B, F, D).
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
cin_bwd_data_kernel(const T* __restrict__ g, const T* __restrict__ x0, const T* __restrict__ xk,
                    const T* __restrict__ w, T* __restrict__ dx0, T* __restrict__ dxk,
                    float* __restrict__ dx0_partial, long long M, int F, int H, int N, int D,
                    int hp) {
    extern __shared__ __align__(16) float smem[];
    float* as = smem;                            // [2][KS][LD]: g, n x rows
    float* bs = as + 2 * STAGE_FLOATS;           // [2][KS][LD]: w, n x m
    float* ps = bs + 2 * STAGE_FLOATS;           // [TILE][PS]: P, rows x 64 columns
    float* x0s = ps + TILE * PS;                 // [F][TILE]
    float* dx0s = x0s + F * TILE;                // [F][TILE]

    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const long long row0 = (long long)blockIdx.x * TILE;
    const int h_begin = blockIdx.y * hp;
    const int h_end = min(H, h_begin + hp);
    const int m_begin = h_begin * F, m_end = h_end * F;
    const long long B = M / D;

    for (int e = tid; e < F * TILE; e += THREADS) {
        const int f = e / TILE, i = e - f * TILE;
        const long long r = row0 + i;
        float v = 0.f;
        if (r < M) {
            const long long b = r / D;
            v = to_float(x0[(b * F + f) * D + (r - b * D)]);
        }
        x0s[e] = v;
        dx0s[e] = 0.f;
    }

    // the stage loads: g at this thread's row ar, n = n0 + (tid >> 7) + 2u;
    // w at k = tid & 7 (n = n0 + k), columns (tid >> 3) + 32u
    const int ar = tid & (TILE - 1), ak = tid >> 7;
    const long long grow = row0 + ar;
    const T* g_row = nullptr;
    if (grow < M) {
        const long long b = grow / D;
        g_row = g + b * N * D + (grow - b * D);
    }
    const int bk = tid & 7, bc = tid >> 3;
    float ra[4], rb[4];
    auto load = [&](int m0, int n0) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int n = n0 + ak + 2 * u;
            ra[u] = (g_row != nullptr && n < N) ? to_float(g_row[(long long)n * D]) : 0.f;
            const int m = m0 + bc + 32 * u;
            rb[u] = (m < m_end && n0 + bk < N) ? to_float(w[(long long)m * N + n0 + bk]) : 0.f;
        }
    };
    auto put = [&](int buf) {
        float* a = as + buf * STAGE_FLOATS;
        float* b = bs + buf * STAGE_FLOATS;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            a[(ak + 2 * u) * LD + ar] = ra[u];
            b[bk * LD + bc + 32 * u] = rb[u];
        }
    };

    // the contractions: two threads a row, one for dx0 and one for dxk
    const bool dx0_role = tid < TILE;
    const int pi = tid & (TILE - 1);
    const long long pr = row0 + pi;
    const bool prow = pr < M;
    const long long pb = prow ? pr / D : 0;
    const int pd = prow ? (int)(pr - pb * D) : 0;
    float cur = 0.f;                             // dxk[pb, h, pd] so far
    int xk_h = -1;
    float xkv = 0.f;                             // xk[pb, xk_h, pd]

    const int n_stages = (N + KS - 1) / KS;
    for (int m0 = m_begin; m0 < m_end; m0 += TILE) {
        float acc[8][8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
        load(m0, 0);
        put(0);
        __syncthreads();
        for (int s = 0; s < n_stages; ++s) {
            if (s + 1 < n_stages) load(m0, (s + 1) * KS);
            multiply_stage(acc, as + (s & 1) * STAGE_FLOATS, bs + (s & 1) * STAGE_FLOATS, ty, tx);
            if (s + 1 < n_stages) put((s + 1) & 1);
            __syncthreads();
        }
        // P's chunk, 64 columns at a time, through ps[row][column]
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
            for (int i = 0; i < 8; ++i)
                *reinterpret_cast<float4*>(ps + tile_row(i, ty) * PS + tx * 4) =
                    make_float4(acc[i][half * 4], acc[i][half * 4 + 1], acc[i][half * 4 + 2],
                                acc[i][half * 4 + 3]);
            __syncthreads();
            const int mc = m0 + half * HALF;
            const int cnt = min(HALF, m_end - mc);
            if (prow && cnt > 0) {
                int h = mc / F, f = mc - h * F;
                for (int c4 = 0; c4 < cnt; c4 += 4) {
                    const float4 p4 = *reinterpret_cast<const float4*>(ps + pi * PS + c4);
                    const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        if (c4 + q < cnt) {
                            if (dx0_role) {
                                if (h != xk_h) {
                                    xk_h = h;
                                    xkv = to_float(xk[(pb * H + h) * D + pd]);
                                }
                                dx0s[f * TILE + pi] += pv[q] * xkv;
                            } else {
                                cur += pv[q] * x0s[f * TILE + pi];
                                if (f == F - 1) {
                                    store(dxk + (pb * H + h) * D + pd, cur);
                                    cur = 0.f;
                                }
                            }
                            if (++f == F) {
                                f = 0;
                                ++h;
                            }
                        }
                    }
                }
            }
            __syncthreads();
        }
    }

    if (dx0_role && prow) {
        for (int f = 0; f < F; ++f) {
            const float v = dx0s[f * TILE + pi];
            if (dx0_partial == nullptr) store(dx0 + (pb * F + f) * D + pd, v);
            else dx0_partial[(((long long)blockIdx.y * B + pb) * F + f) * D + pd] = v;
        }
    }
}

// Block (x, y, z): dw[m0 .. m0 + TILE) x [n0 .. n0 + TILE) summed over rows
// [z*run, min(M, (z+1)*run)).  dw_partial == nullptr: stored in dw; otherwise
// float32 into plane z of dw_partial (splits, K, N).
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
cin_bwd_weight_kernel(const T* __restrict__ g, const T* __restrict__ x0,
                      const T* __restrict__ xk, T* __restrict__ dw,
                      float* __restrict__ dw_partial, long long M, int F, int H, int N, int D,
                      long long run) {
    __shared__ __align__(16) float as[2 * STAGE_FLOATS];   // A, rows x m
    __shared__ __align__(16) float bs[2 * STAGE_FLOATS];   // g, rows x n
    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int K = H * F;
    const int m0 = blockIdx.x * TILE, n0 = blockIdx.y * TILE;
    const long long r_begin = (long long)blockIdx.z * run;
    const long long r_end = min(M, r_begin + run);

    // the stage loads: row k = tid & 7 of the stage, columns (tid >> 3) + 32u
    const int lk = tid & 7, lc = tid >> 3;
    int ah[4], af[4];                            // (h, f) of this thread's columns of A; -1 past K
    bool nv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
        const int m = m0 + lc + 32 * u;
        ah[u] = m < K ? m / F : -1;
        af[u] = m < K ? m - ah[u] * F : 0;
        nv[u] = n0 + lc + 32 * u < N;
    }
    float ra[4], rb[4];
    auto load = [&](long long r0) {
        const long long r = r0 + lk;
        const bool ok = r < r_end;
        const long long b = ok ? r / D : 0;
        const int d = ok ? (int)(r - b * D) : 0;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            ra[u] = (ok && ah[u] >= 0)
                        ? to_float(xk[(b * H + ah[u]) * D + d]) * to_float(x0[(b * F + af[u]) * D + d])
                        : 0.f;
            rb[u] = (ok && nv[u]) ? to_float(g[(b * N + n0 + lc + 32 * u) * D + d]) : 0.f;
        }
    };
    auto put = [&](int buf) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            as[buf * STAGE_FLOATS + lk * LD + lc + 32 * u] = ra[u];
            bs[buf * STAGE_FLOATS + lk * LD + lc + 32 * u] = rb[u];
        }
    };

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    if (r_begin < r_end) {
        load(r_begin);
        put(0);
        __syncthreads();
        int s = 0;
        for (long long r0 = r_begin; r0 < r_end; r0 += KS, ++s) {
            const bool more = r0 + KS < r_end;
            if (more) load(r0 + KS);
            multiply_stage(acc, as + (s & 1) * STAGE_FLOATS, bs + (s & 1) * STAGE_FLOATS, ty, tx);
            if (more) put((s + 1) & 1);
            __syncthreads();
        }
    }

    float* plane = dw_partial == nullptr ? nullptr : dw_partial + (long long)blockIdx.z * K * N;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int m = m0 + tile_row(i, ty);
        if (m >= K) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int n = n0 + tile_row(j, tx);
            if (n >= N) continue;
            const long long at = (long long)m * N + n;
            if (plane == nullptr) store(dw + at, acc[i][j]);
            else plane[at] = acc[i][j];
        }
    }
}

// out[e] = the sum over planes z < splits of partial[z][e], in ascending z.
template <typename T>
__global__ void __launch_bounds__(256)
cin_bwd_reduce_kernel(const float* __restrict__ partial, T* __restrict__ out, long long numel,
                      int splits) {
    const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= numel) return;
    float acc = 0.f;
    for (int z = 0; z < splits; ++z) acc += partial[z * numel + e];
    store(out + e, acc);
}

int data_smem_bytes(int F) {
    return (4 * STAGE_FLOATS + TILE * PS + 2 * F * TILE) * 4;
}

template <typename T>
int launch(const void* g, const void* x0, const void* xk, const void* w, void* dx0, void* dxk,
           void* dw, float* dx0_partial, float* dw_partial, int B, int F, int H, int N, int D,
           int data_splits, int hp, int weight_splits, long long run, cudaStream_t stream) {
    const long long M = (long long)B * D;
    const int K = H * F;
    // the plan must be whole runs with none empty (kernels/cin.py::backward_plan)
    if (hp < 1 || run < 1 || run % KS != 0 || (H + hp - 1) / hp != data_splits ||
        (M + run - 1) / run != weight_splits) {
        return (int)cudaErrorInvalidValue;
    }
    const int smem = data_smem_bytes(F);
    if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    // once per process (the port drives one card), outside any graph capture
    static const cudaError_t opt_in = cudaFuncSetAttribute(
        cin_bwd_data_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (opt_in != cudaSuccess) return (int)opt_in;
    if (data_splits == 1) dx0_partial = nullptr;
    if (weight_splits == 1) dw_partial = nullptr;

    const dim3 data_grid((unsigned)((M + TILE - 1) / TILE), (unsigned)data_splits);
    cin_bwd_data_kernel<T><<<data_grid, THREADS, smem, stream>>>(
        static_cast<const T*>(g), static_cast<const T*>(x0), static_cast<const T*>(xk),
        static_cast<const T*>(w), static_cast<T*>(dx0), static_cast<T*>(dxk), dx0_partial, M, F,
        H, N, D, hp);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    if (dx0_partial != nullptr) {
        const long long numel = M * F;
        cin_bwd_reduce_kernel<T><<<(unsigned)((numel + 255) / 256), 256, 0, stream>>>(
            dx0_partial, static_cast<T*>(dx0), numel, data_splits);
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }

    const dim3 weight_grid((unsigned)((K + TILE - 1) / TILE), (unsigned)((N + TILE - 1) / TILE),
                           (unsigned)weight_splits);
    cin_bwd_weight_kernel<T><<<weight_grid, THREADS, 0, stream>>>(
        static_cast<const T*>(g), static_cast<const T*>(x0), static_cast<const T*>(xk),
        static_cast<T*>(dw), dw_partial, M, F, H, N, D, run);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    if (dw_partial != nullptr) {
        const long long numel = (long long)K * N;
        cin_bwd_reduce_kernel<T><<<(unsigned)((numel + 255) / 256), 256, 0, stream>>>(
            dw_partial, static_cast<T*>(dw), numel, weight_splits);
        e = cudaGetLastError();
    }
    return (int)e;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  g (B, N, D), x0 (B, F, D), xk (B, H, D),
// w (H*F, N) in; dx0, dxk, dw (their inputs' shapes) out.  The data
// gradient's h values are cut into data_splits runs of h_run (for > 1,
// dx0_partial is a float32 workspace of data_splits * B * F * D values); the
// weight gradient's B*D rows into weight_splits runs of row_run, a multiple
// of KS (for > 1, dw_partial holds weight_splits * H * F * N float32
// values); both as kernels/cin.py's backward_plan gives them.  Returns the error of the first launch CUDA
// refused, or cudaErrorInvalidValue for arguments the kernels do not take
// (a plan that is not backward_plan's, or F too large for a block's shared
// memory).
extern "C" int cin_layer_backward_launch(const void* g, const void* x0, const void* xk,
                                         const void* w, void* dx0, void* dxk, void* dw,
                                         void* dx0_partial, void* dw_partial, int B, int F,
                                         int H, int N, int D, int data_splits, int h_run,
                                         int weight_splits, long long row_run, int dtype,
                                         void* stream) {
    if (B == 0 || D == 0 || N == 0) return 0;     // the wrapper zeroes what is left
    if (F < 1 || H < 1 || data_splits < 1 || data_splits > H || weight_splits < 1 ||
        (data_splits > 1 && dx0_partial == nullptr) ||
        (weight_splits > 1 && dw_partial == nullptr)) {
        return (int)cudaErrorInvalidValue;
    }
    float* pd = static_cast<float*>(dx0_partial);
    float* pw = static_cast<float*>(dw_partial);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) {
        return launch<float>(g, x0, xk, w, dx0, dxk, dw, pd, pw, B, F, H, N, D, data_splits,
                             h_run, weight_splits, row_run, s);
    }
    if (dtype == 1) {
        return launch<__nv_bfloat16>(g, x0, xk, w, dx0, dxk, dw, pd, pw, B, F, H, N, D,
                                     data_splits, h_run, weight_splits, row_run, s);
    }
    return (int)cudaErrorInvalidValue;
}
