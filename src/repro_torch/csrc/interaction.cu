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
// What bounds it: bytes, then shared memory and latency.  At DLRM-RMC2's
// shape (B = 1024, F = 41, D = 32, float32) the kernel must read 5.4 MB and
// write 3.4 MB, 2.6 us at the card's memory rate; its 54 MFLOP take 0.8 us
// on the float32 CUDA cores, so tensor cores would buy nothing.  The first
// design lost its time to shared-memory traffic (one thread an output, two
// 4-byte shared reads a multiply-add) and to blocks of one sample.  This
// design:
//
//   * a block takes S consecutive samples (S from the Python plan,
//     kernels/interaction.py::plan: 1 at F = 41, 2 at F = 11 and B = 1024),
//     one contiguous range of S*F*D elements, brought into shared memory by
//     16-byte cp.async copies when the range starts on a 16-byte boundary
//     and a row is whole 16-byte chunks (the host checks the address), else
//     by a masked scalar loop.  Nothing is padded in device memory; the
//     d-tail of a 16-byte chunk is zeroed in shared memory only;
//   * each thread owns a TILE x TILE register tile of (i, j) pairs of the
//     lower block triangle and reads 16 bytes of d at a time: 2*TILE wide
//     reads feed TILE*TILE*(16 / sizeof(T)) float32 multiply-adds (4x fewer
//     shared words a sample than one thread an output at F = 41, and 4x
//     fewer load instructions again).  bfloat16 is widened as it is read;
//   * a sample's rows lie in shared memory by register-tile row: row r in
//     slot (r % TILE)*rb + r / TILE, at a stride of an odd number of 16-byte
//     chunks.  Row a of neighbouring tiles (rows a + TILE*I, I = 0, 1, ...)
//     are then neighbouring slots, so a quarter-warp's 16-byte reads fall
//     on different banks (with rows in order, rows TILE apart would share
//     banks pairwise at any odd stride);
//   * when the card is far from full (small B), KS lanes split a tile's d
//     chunks and halve their partial sums KS-fold by shuffles, in a fixed
//     order, so that each lane ends with TILE*TILE/KS finished outputs;
//   * tiles are numbered row block by row block and a thread finds its
//     (I, J) by walking forward from row block 0; an output's packed offset
//     i(i-1)/2 + j is computed forward too, no root is taken.  The few
//     divisions (by a row's copies, by F, by the tile count) use a float
//     estimate from the host's reciprocal and one correction step;
//   * when the card is full (a lane a tile), the block stages its S*n_out
//     results in shared memory and writes them as one contiguous range with
//     16-byte stores (the staging copy starts at the same offset modulo 16
//     as its destination, so both sides of the vector body are aligned);
//     at small B, and where the slab and the results do not fit together
//     (F = 300), the tiles write straight to device memory.  packed = 0
//     writes (i, j), (j, i) and the diagonal from the same tiles.
//
// The plan (samples a block, lanes a tile, threads, the row stride, the
// shared-memory layout, the copy path and the reciprocals) is computed in
// Python and passed in; this file trusts it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 4;           // rows of i and of j in a thread's register tile
constexpr int MAX_THREADS = 512;  // a block's threads at most (the plan's MAX_THREADS)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void from_float(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_float(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
}
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16(0.f); }

// a / d for 0 <= a < 2^24 and d >= 1 without an integer divide's long chain: a float
// estimate from 1/d (rounded by the host) is off by at most one, and one step corrects it
struct Divisor {
    int d;
    float inv;
    __device__ __forceinline__ int div(int a) const {
        int q = __float2int_rz((float)a * inv);
        const int r = a - q * d;
        return q + (r >= d) - (r < 0);
    }
};

// 16 bytes of shared memory as floats
__device__ __forceinline__ void widen(const float* p, float (&v)[4]) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
}
__device__ __forceinline__ void widen(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[q]));
        v[2 * q] = f.x;
        v[2 * q + 1] = f.y;
    }
}

template <typename T, int KS>
__global__ void __launch_bounds__(MAX_THREADS)
    dot_interaction_kernel(const T* __restrict__ feats, T* __restrict__ out, int B, int F, int D,
                           int S, int ld, int stage_at, int packed, int vec, Divisor per_row,
                           Divisor fields, Divisor tiles) {
    constexpr int CH = 16 / sizeof(T);  // elements in 16 bytes
    extern __shared__ __align__(16) unsigned char smem[];
    // a sample's F rows padded to rb*TILE slots; row r lies in slot (r % TILE)*rb + r / TILE,
    // so row a of neighbouring register tiles (rows a + TILE*I, I = 0, 1, ...) are neighbours
    T* slab = reinterpret_cast<T*>(smem);
    const long long b0 = (long long)blockIdx.x * S;
    const int ns = (int)min((long long)S, (long long)B - b0);  // samples of this block
    const int rows = ns * F;
    const int rb = (F + TILE - 1) / TILE;
    const T* x = feats + b0 * F * D;

    // ---- the slab in: 16-byte copies where the range allows, else masked scalars
    const int chunks = (D + CH - 1) / CH;  // 16-byte chunks of a row in shared memory
    for (int e = threadIdx.x; e < rows * per_row.d; e += blockDim.x) {
        const int r = per_row.div(e), col = e - r * per_row.d;
        const int s = fields.div(r), rr = r - s * F;
        T* slot = slab + ((s * TILE + rr % TILE) * rb + rr / TILE) * ld;
        if (vec) {
            cp_async16(slot + col * CH, x + (long long)r * D + col * CH);
        } else {
            slot[col] = col < D ? x[(long long)r * D + col] : zero<T>();
        }
    }
    cp_async_wait_all();
    __syncthreads();

    // ---- register tiles: work item w = (sample, tile, lane of KS)
    const int n_out = packed ? F * (F - 1) / 2 : F * F;
    const uintptr_t dst = reinterpret_cast<uintptr_t>(out + b0 * n_out);
    T* stage = stage_at < 0 ? nullptr
                            : reinterpret_cast<T*>(smem + stage_at + (dst & 15));
    const int total = ns * tiles.d * KS;
    const int row_step = rb * ld;  // from register-tile row a to a + 1
    for (int base = 0; base < total; base += blockDim.x) {  // same trip count in every thread
        const int w = base + threadIdx.x;
        const bool active = w < total;
        const int k = w % KS;
        const int u = active ? w / KS : 0;
        const int s = tiles.div(u);
        int I = 0, J = u - s * tiles.d;
        while (J > I) {  // row block I holds tiles J = 0..I
            J -= I + 1;
            ++I;
        }
        const T* ri = slab + (s * TILE * rb + I) * ld;
        const T* rj = slab + (s * TILE * rb + J) * ld;
        float acc[TILE * TILE];  // acc[a*TILE + b]: rows I*TILE + a and J*TILE + b
#pragma unroll
        for (int v = 0; v < TILE * TILE; ++v) acc[v] = 0.f;
        const int nch = active ? chunks : 0;
        for (int c = k; c < nch; c += KS) {
            float va[TILE][CH], vb[TILE][CH];
#pragma unroll
            for (int a = 0; a < TILE; ++a) widen(ri + a * row_step + c * CH, va[a]);
#pragma unroll
            for (int b = 0; b < TILE; ++b) widen(rj + b * row_step + c * CH, vb[b]);
#pragma unroll
            for (int e = 0; e < CH; ++e)
#pragma unroll
                for (int a = 0; a < TILE; ++a)
#pragma unroll
                    for (int b = 0; b < TILE; ++b)
                        acc[a * TILE + b] = fmaf(va[a][e], vb[b][e], acc[a * TILE + b]);
        }
        // the KS lanes' partial sums, halved each round: a lane keeps the upper or
        // lower half of its live sums and adds its partner's; lane k ends with the
        // full sums of outputs k*PER .. k*PER + PER - 1, in a fixed order
        constexpr int PER = TILE * TILE / KS;
        constexpr int ROUNDS = KS == 8 ? 3 : KS == 4 ? 2 : KS == 2 ? 1 : 0;
#pragma unroll
        for (int round = 0; round < ROUNDS; ++round) {
            const int o = KS >> (round + 1);  // partner lane's distance
            const int h = PER * o;            // sums a lane keeps this round
            const bool up = (k & o) != 0;
#pragma unroll
            for (int q = 0; q < TILE * TILE / 2; ++q) {  // a fixed bound unrolls before h folds
                if (q >= h) break;
                const float lo = acc[q], hi = acc[q + h];  // select values, not addresses
                acc[q] = (up ? hi : lo) + __shfl_xor_sync(0xffffffffu, up ? lo : hi, o);
            }
        }
        if (!active) continue;
        T* op = stage ? stage + s * n_out : out + (b0 + s) * n_out;
#pragma unroll
        for (int q = 0; q < PER; ++q) {
            const int v = k * PER + q;
            const int i = I * TILE + v / TILE, j = J * TILE + v % TILE;
            if (packed) {
                if (i < F && j < i) from_float(op + i * (i - 1) / 2 + j, acc[q]);
            } else if (i < F && j < F) {
                from_float(op + i * F + j, acc[q]);
                if (I != J) from_float(op + j * F + i, acc[q]);
            }
        }
    }
    if (!stage) return;

    // ---- the block's ns*n_out results out as one range: scalar head, 16-byte body, tail
    __syncthreads();
    T* g = out + b0 * n_out;
    const int n = ns * n_out;
    const int head = min(n, (int)(((16 - (dst & 15)) & 15) / sizeof(T)));
    const int nvec = (n - head) / CH;
    for (int e = threadIdx.x; e < head; e += blockDim.x) g[e] = stage[e];
    const uint4* sv = reinterpret_cast<const uint4*>(stage + head);
    uint4* gv = reinterpret_cast<uint4*>(g + head);
    for (int v = threadIdx.x; v < nvec; v += blockDim.x) gv[v] = sv[v];
    for (int e = head + nvec * CH + threadIdx.x; e < n; e += blockDim.x) g[e] = stage[e];
}

// the arguments every instantiation takes, as the plan gives them
struct Args {
    const void* feats;
    void* out;
    int B, F, D, packed, S, threads, ld, stage_at, smem, vec;
    float inv_row, inv_f, inv_tiles;  // 1/d of the three divisors, rounded to float
};

template <typename T, int KS>
int launch(const Args& a, cudaStream_t stream) {
    auto kernel = dot_interaction_kernel<T, KS>;
    if (a.smem > 48 * 1024) {
        cudaError_t e =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, a.smem);
        if (e != cudaSuccess) return (int)e;
    }
    constexpr int CH = 16 / sizeof(T);
    const int chunks = (a.D + CH - 1) / CH;
    const int rb = (a.F + TILE - 1) / TILE;
    const Divisor per_row{a.vec ? chunks : chunks * CH, a.inv_row};
    const Divisor fields{a.F, a.inv_f};
    const Divisor tiles{rb * (rb + 1) / 2, a.inv_tiles};
    kernel<<<(a.B + a.S - 1) / a.S, a.threads, a.smem, stream>>>(
        static_cast<const T*>(a.feats), static_cast<T*>(a.out), a.B, a.F, a.D, a.S, a.ld,
        a.stage_at, a.packed, a.vec, per_row, fields, tiles);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_ks(const Args& a, int ks, cudaStream_t s) {
    switch (ks) {
        case 1: return launch<T, 1>(a, s);
        case 2: return launch<T, 2>(a, s);
        case 4: return launch<T, 4>(a, s);
        case 8: return launch<T, 8>(a, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  packed: 1 = strict lower triangle,
// 0 = full Gram matrix.  samples (S), splits (KS, lanes a tile: 1, 2, 4
// or 8), threads (a multiple of 32), ld (the slab's row stride in
// elements), stage_at (byte offset of the staged results in shared memory,
// -1 to write straight out), smem (dynamic shared bytes), vec (1: the
// 16-byte copy path, the input range starts on a 16-byte boundary and a row
// is whole 16-byte chunks) and the three reciprocals come from
// kernels/interaction.py::plan.  Returns cudaGetLastError() after the launch.
extern "C" int dot_interaction_launch(const void* feats, void* out, int B, int F, int D,
                                      int packed, int dtype, int samples, int splits,
                                      int threads, int ld, int stage_at, int smem, int vec,
                                      float inv_row, float inv_f, float inv_tiles,
                                      void* stream) {
    if (B == 0 || F == 0 || (packed && F < 2)) return 0;
    const Args a{feats, out,      B,  F,   D,       packed,  samples,  threads,
                 ld,    stage_at, smem, vec, inv_row, inv_f, inv_tiles};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return launch_ks<float>(a, splits, s);
    if (dtype == 1) return launch_ks<__nv_bfloat16>(a, splits, s);
    return (int)cudaErrorInvalidValue;
}
