// One xDeepFM Compressed Interaction Network layer for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/cin.py::cin_layer:
//     x0 (B, F, D), xk (B, H, D), w (H*F, N) -> out (B, N, D),
//     out[b, n, d] = sum_{h,f} w[h*F + f, n] * xk[b, h, d] * x0[b, f, d].
// float32 and bfloat16 inputs (all three of one type); products and sums
// are float32, the result is stored in the input's type.
//
// Read as a matrix product whose A operand is never stored in device
// memory: rows r = (b, d) (M = B*D), reduction over m = h*F + f (K = H*F),
// columns n (N), with A[r, m] = xk[b, h, d] * x0[b, f, d].  The TPU kernel
// pads D to 128 lanes and builds each sample's (H*F, 128) block in VMEM;
// at xDeepFM's D = 10 that is 12.8 times the arithmetic.  Here nothing is
// padded: D only changes which (b, d) a row is, and the ragged edges of M,
// N and K are masked by bounds checks.
//
// What bounds it: at xDeepFM's published size (F = 39, D = 10, layers
// 200-200-200) a request of B = 512 is 35 GFLOP over three launches and
// ~14 MB a launch, 2,500 operations a byte, so it is bound by float32
// arithmetic (67 TFLOP/s outside the tensor cores), never by memory.  The
// design is a register-tiled product on the CUDA cores:
//   - a block owns BM rows and BN columns and walks K in slices of BK;
//   - for each slice it forms the A values (one multiply each) and loads
//     the w slice, both into shared memory; w (6.24 MB at 7800 x 200) is
//     read again by every row tile and stays in the 50 MB L2;
//   - the global loads of slice s+1 are issued into registers before the
//     products of slice s, and stored to the other of two shared buffers
//     after them, so one barrier per slice suffices;
//   - each of the block's 256 threads accumulates a 4 x 4 tile in float32
//     registers and reads its operands from shared memory as float4.
// Of nine tilings timed on an H100 at xDeepFM's shapes (PERF.md), the
// 64 x 64 block with 4 x 4 thread tiles was the only one within 15 % of the
// fastest both at B = 512 (3 %) and at 16,384-row chunks (14 %): larger
// thread tiles leave too few blocks to fill 132 SMs at B = 512.
// Split K: a small batch has few (row, column) tiles (B = 1 gives 4), and
// each would walk all K/BK slices alone.  The caller then asks for
// `splits` > 1: block z of the grid's third axis takes one run of slices
// and writes its float32 partial sums to plane z of a (splits, B, N, D)
// workspace, and a second kernel adds the planes in plane order and
// stores the result.  The order of every sum is fixed, so the result does
// not change from run to run.
// Offsets into device memory are 64-bit (B*N*D passes 2^31 at bulk sizes).
// No -use_fast_math.  Tensor-core (TF32 / bf16 wgmma) versions fed by TMA
// are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// kernels/cin.py keeps copies of BM, BN and BK (BLOCK_M, BLOCK_N, SLICE_K)
// to choose the split of K; a test holds them equal to these.
constexpr int BM = 64;                     // rows (b, d) of a block
constexpr int BN = 64;                     // output channels n of a block
constexpr int BK = 16;                     // slice of the reduction m = h*F + f
constexpr int TM = 4;                      // a thread's register tile
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);
constexpr int A_PER = BM * BK / THREADS;   // A values a thread forms per slice
constexpr int W_PER = BK * BN / THREADS;   // w values a thread loads per slice

static_assert(TM % 4 == 0 && TN % 4 == 0, "register tiles are read as float4");
static_assert(THREADS % BM == 0 && THREADS % BN == 0, "loader layout");
static_assert(BK % (THREADS / BM) == 0 && A_PER * (THREADS / BM) == BK, "A loader");
static_assert(W_PER * (THREADS / BN) == BK, "w loader");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// partial == nullptr: store the result in out.  Otherwise this block sums
// slices [z*per, (z+1)*per) and stores float32 into plane z of partial.
template <typename T>
__global__ void __launch_bounds__(THREADS)
cin_layer_kernel(const T* __restrict__ x0, const T* __restrict__ xk, const T* __restrict__ w,
                 T* __restrict__ out, float* __restrict__ partial, long long M, int F, int H,
                 int N, int D, int per) {
    __shared__ __align__(16) float As[2][BK][BM];
    __shared__ __align__(16) float Ws[2][BK][BN];

    const int tid = threadIdx.x;
    const long long row0 = (long long)blockIdx.x * BM;
    const int n0 = blockIdx.y * BN;
    const int K = H * F;
    const int s_begin = blockIdx.z * per;
    const int s_end = min((K + BK - 1) / BK, s_begin + per);

    // A loader: row ar of the tile, A_PER consecutive m from slot aq on
    const int ar = tid % BM;
    const int aq = (tid / BM) * A_PER;
    const long long arow = row0 + ar;
    const bool a_ok = arow < M;
    const long long ab = a_ok ? arow / D : 0;
    const long long ad = a_ok ? arow - ab * D : 0;
    const T* x0_r = x0 + ab * F * D + ad;                  // x0[b, f, d] = x0_r[f*D]
    const T* xk_r = xk + ab * (long long)H * D + ad;       // xk[b, h, d] = xk_r[h*D]
    const int m_first = s_begin * BK + aq;
    int ah = m_first / F, af = m_first % F;                // (h, f) of m = k0 + aq

    // w loader: column wn of the tile, rows wk0 + j*(THREADS/BN)
    const int wn = tid % BN;
    const int wk0 = tid / BN;
    const bool w_ok = n0 + wn < N;

    float a_reg[A_PER], w_reg[W_PER];

    auto load = [&](int k0) {
        int h = ah, f = af;
#pragma unroll
        for (int i = 0; i < A_PER; ++i) {
            float v = 0.f;
            if (a_ok && k0 + aq + i < K) {
                v = to_float(xk_r[(long long)h * D]) * to_float(x0_r[(long long)f * D]);
            }
            a_reg[i] = v;
            if (++f == F) { f = 0; ++h; }
        }
        af += BK;                                          // next slice's (h, f)
        while (af >= F) { af -= F; ++ah; }
#pragma unroll
        for (int j = 0; j < W_PER; ++j) {
            const int k = k0 + wk0 + j * (THREADS / BN);
            w_reg[j] = (w_ok && k < K) ? to_float(w[(long long)k * N + n0 + wn]) : 0.f;
        }
    };
    auto stash = [&](int buf) {
#pragma unroll
        for (int i = 0; i < A_PER; ++i) As[buf][aq + i][ar] = a_reg[i];
#pragma unroll
        for (int j = 0; j < W_PER; ++j) Ws[buf][wk0 + j * (THREADS / BN)][wn] = w_reg[j];
    };

    const int tx = tid % (BN / TN);
    const int ty = tid / (BN / TN);
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    load(s_begin * BK);
    stash(0);
    __syncthreads();
    for (int s = s_begin; s < s_end; ++s) {
        const int buf = (s - s_begin) & 1;
        const bool more = s + 1 < s_end;
        if (more) load((s + 1) * BK);
#pragma unroll
        for (int k = 0; k < BK; ++k) {
            float av[TM], bv[TN];
#pragma unroll
            for (int i = 0; i < TM; i += 4) {
                const float4 v = *reinterpret_cast<const float4*>(&As[buf][k][ty * TM + i]);
                av[i] = v.x; av[i + 1] = v.y; av[i + 2] = v.z; av[i + 3] = v.w;
            }
#pragma unroll
            for (int j = 0; j < TN; j += 4) {
                const float4 v = *reinterpret_cast<const float4*>(&Ws[buf][k][tx * TN + j]);
                bv[j] = v.x; bv[j + 1] = v.y; bv[j + 2] = v.z; bv[j + 3] = v.w;
            }
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        if (more) stash(buf ^ 1);
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < TM; ++i) {
        const long long r = row0 + ty * TM + i;
        if (r >= M) continue;
        const long long b = r / D;
        const long long at = b * (long long)N * D + (r - b * D);  // [b, n, d] = at + n*D
        if (partial == nullptr) {
#pragma unroll
            for (int j = 0; j < TN; ++j) {
                const int n = n0 + tx * TN + j;
                if (n < N) store(out + at + (long long)n * D, acc[i][j]);
            }
        } else {
            float* plane = partial + (long long)blockIdx.z * M * N;
#pragma unroll
            for (int j = 0; j < TN; ++j) {
                const int n = n0 + tx * TN + j;
                if (n < N) plane[at + (long long)n * D] = acc[i][j];
            }
        }
    }
}

// out[e] = sum over planes z < splits of partial[z][e], in plane order.
template <typename T>
__global__ void cin_reduce_kernel(const float* __restrict__ partial, T* __restrict__ out,
                                  long long numel, int splits) {
    for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < numel;
         e += (long long)gridDim.x * blockDim.x) {
        float acc = 0.f;
        for (int z = 0; z < splits; ++z) acc += partial[z * numel + e];
        store(out + e, acc);
    }
}

template <typename T>
int launch(const void* x0, const void* xk, const void* w, void* out, float* partial,
           long long M, int F, int H, int N, int D, int splits, cudaStream_t stream) {
    const int n_slices = (H * F + BK - 1) / BK;
    const int per = (n_slices + splits - 1) / splits;
    splits = (n_slices + per - 1) / per;                  // no plane without a slice
    if (splits == 1) partial = nullptr;
    const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN),
                    (unsigned)splits);
    cin_layer_kernel<T><<<grid, THREADS, 0, stream>>>(
        static_cast<const T*>(x0), static_cast<const T*>(xk), static_cast<const T*>(w),
        static_cast<T*>(out), partial, M, F, H, N, D, per);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || partial == nullptr) return (int)e;
    const long long numel = M * N;
    const long long blocks = (numel + 255) / 256;
    cin_reduce_kernel<T><<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
        partial, static_cast<T*>(out), numel, splits);
    return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  F, H >= 1 (the wrapper checks).
// splits: how many runs of K slices to sum in separate blocks; for
// splits > 1, partial is a float32 workspace of splits * B * N * D values
// (fewer planes are used when K has fewer slices than that).
// Returns cudaGetLastError() after the launches.
extern "C" int cin_layer_launch(const void* x0, const void* xk, const void* w, void* out,
                                void* partial, int B, int F, int H, int N, int D, int splits,
                                int dtype, void* stream) {
    if (B == 0 || N == 0 || D == 0) return 0;
    if (F < 1 || H < 1 || splits < 1 || (splits > 1 && partial == nullptr)) {
        return (int)cudaErrorInvalidValue;
    }
    const long long M = (long long)B * D;
    float* ws = static_cast<float*>(partial);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch<float>(x0, xk, w, out, ws, M, F, H, N, D, splits, s);
    if (dtype == 1) return launch<__nv_bfloat16>(x0, xk, w, out, ws, M, F, H, N, D, splits, s);
    return (int)cudaErrorInvalidValue;
}
