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

// ---- K2-bwd: the gradient of the packed interaction with respect to its input
//
// What it computes: grad (B, F(F-1)/2) and feats (B, F, D) -> dfeats
// (B, F, D), dX[i, :] = sum_{j != i} g[pair(i, j)] * X[j, :], pair(i, j) =
// max(i,j)(max(i,j)-1)/2 + min(i,j): (S + S^T) X with S the strict lower
// triangle the forward packed.  It is what the reference's autodiff of the
// Gram product and the triangle gather gives; the TPU kernel has no backward
// of its own.  Products and sums are float32, in ascending j (fmaf over a
// full row of G, its zero diagonal included), so a launch gives the same
// bits every time; the result is stored in the input's type.
//
// What bounds it: bytes.  At DLRM-RMC2's shape (B = 1024, F = 41, D = 32,
// float32) it reads 5.4 MB of features and 3.4 MB of gradients and writes
// 5.4 MB, against 110 MFLOP.  The first design (a block a sample) left each
// block's loads, unpack and products in turn with nothing in flight between
// them, and unpacked with a division and a modulo per element.  This one:
//
//   * a grid of about one wave (kernels/interaction.py::backward_plan); each
//     block walks the samples blockIdx.x, + gridDim.x, ...;
//   * a sample's packed gradient and its (F, D) slab, each one contiguous
//     range, come into shared memory by 16-byte cp.async copies, double
//     buffered: the next sample's copies are in flight while the block
//     unpacks and multiplies the current one.  A range that starts off a
//     16-byte boundary (bfloat16 gradients of odd samples) is copied from the
//     boundary below and read from its offset; a last 16 bytes that would
//     pass the tensor's end are copied element by element.  Inputs whose
//     base address is off a 16-byte boundary take a scalar path instead;
//   * G, the full (F, F) matrix, is unpacked through a pair-index table the
//     block builds once (-1 on the diagonal and the padding), so the unpack
//     is a table read, a shared read and a store;
//   * a thread owns BWD_ROWS rows and BWD_COLS columns of dX (d and d + D/2):
//     per four j it reads four 16-byte runs of G's rows (a warp-wide
//     broadcast) and eight X[j, d] (neighbouring threads on neighbouring d).
constexpr int BWD_ROWS = 4;     // rows of dX a thread owns (kernels/interaction.py's BWD_ROWS)
constexpr int BWD_COLS = 2;     // columns of them (kernels/interaction.py's BWD_COLS)
constexpr int BWD_BUFFERS = 2;  // samples in shared memory at once (kernels/interaction.py's)

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// elements [first, first + n) of a tensor of `total` into shared memory at
// dst (16-byte aligned): with vec, by 16-byte copies from the boundary at or
// below the range's start, so element e lands at dst + (start & 15) + e *
// sizeof(T); else one element at a time, element e at dst + e * sizeof(T)
template <typename T>
__device__ __forceinline__ void stage_range(unsigned char* dst, const T* base, long long first,
                                            int n, long long total, int vec) {
    if (!vec) {
        T* d = reinterpret_cast<T*>(dst);
        for (int e = threadIdx.x; e < n; e += blockDim.x) d[e] = base[first + e];
        return;
    }
    const uintptr_t a = reinterpret_cast<uintptr_t>(base + first);
    const uintptr_t b = reinterpret_cast<uintptr_t>(base + first + n);
    const uintptr_t end = reinterpret_cast<uintptr_t>(base + total);
    const uintptr_t a0 = a & ~uintptr_t(15);
    const int chunks = (int)((b - a0 + 15) >> 4);
    for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
        const uintptr_t g = a0 + 16 * (uintptr_t)c;
        if (g + 16 <= end) {
            cp_async16(dst + 16 * c, reinterpret_cast<const void*>(g));
        } else {  // the tensor's last bytes: no read past its end
            for (uintptr_t q = g; q < end; q += sizeof(T))
                *reinterpret_cast<T*>(dst + (q - a0)) = *reinterpret_cast<const T*>(q);
        }
    }
}

// at most 64 registers a thread (kernels/interaction.py's BWD_REGISTERS)
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS, 2)
    dot_interaction_backward_kernel(const T* __restrict__ grad, const T* __restrict__ feats,
                                    T* __restrict__ dfeats, int B, int F, int D, int vec) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int groups = (F + BWD_ROWS - 1) / BWD_ROWS, rows = groups * BWD_ROWS;
    const int ldg = (F + 3) & ~3;  // G's row stride: 16-byte runs of four j
    const int P = F * (F - 1) / 2, FD = F * D;
    // a stage holds a sample's packed gradient, then its slab, each with 32
    // bytes of slack for the offset of a range that starts off a boundary
    const int sp = ((P * (int)sizeof(T) + 15) & ~15) + 32;
    const int sx = ((FD * (int)sizeof(T) + 15) & ~15) + 32;
    float* G = reinterpret_cast<float*>(smem);
    int* pair_at = reinterpret_cast<int*>(smem + rows * ldg * 4);
    unsigned char* stages = smem + 2 * rows * ldg * 4;

    for (int e = threadIdx.x; e < rows * ldg; e += blockDim.x) {  // once: the pair-index table
        const int i = e / ldg, j = e - i * ldg;
        pair_at[e] = i < F && j < F && i != j ? (i > j ? i * (i - 1) / 2 + j : j * (j - 1) / 2 + i)
                                              : -1;
    }
    const long long total_g = (long long)B * P, total_x = (long long)B * FD;
    auto issue = [&](long long s, int k) {
        unsigned char* st = stages + (k % BWD_BUFFERS) * (sp + sx);
        stage_range(st, grad, s * P, P, total_g, vec);
        stage_range(st + sp, feats, s * FD, FD, total_x, vec);
        cp_async_commit();
    };
    auto offset = [&](const T* base, long long first) {
        return vec ? (int)(reinterpret_cast<uintptr_t>(base + first) & 15) : 0;
    };

    const int dh = (D + BWD_COLS - 1) / BWD_COLS;  // a thread's columns: d, d + dh, ...
    const int items = groups * dh;
    long long s = blockIdx.x;
    if (s < B) issue(s, 0);
    for (int k = 0; s < B; s += gridDim.x, ++k) {
        if (s + gridDim.x < B) {
            issue(s + gridDim.x, k + 1);  // the next sample's copies, in flight from here
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const unsigned char* st = stages + (k % BWD_BUFFERS) * (sp + sx);
        const T* pg = reinterpret_cast<const T*>(st + offset(grad, s * P));
        const T* X = reinterpret_cast<const T*>(st + sp + offset(feats, s * FD));
        for (int e = threadIdx.x; e < rows * ldg; e += blockDim.x) {
            const int p = pair_at[e];
            G[e] = p >= 0 ? to_float(pg[p]) : 0.f;
        }
        __syncthreads();
        T* out = dfeats + s * FD;
        for (int w = threadIdx.x; w < items; w += blockDim.x) {
            const int ig = w / dh, d = w - ig * dh;
            const float* g0 = G + ig * BWD_ROWS * ldg;
            int col[BWD_COLS];
            bool has[BWD_COLS];
#pragma unroll
            for (int c = 0; c < BWD_COLS; ++c) {
                has[c] = d + c * dh < D;
                col[c] = has[c] ? d + c * dh : d;  // a column past D reads column d, unstored
            }
            float acc[BWD_ROWS][BWD_COLS];
#pragma unroll
            for (int q = 0; q < BWD_ROWS; ++q)
#pragma unroll
                for (int c = 0; c < BWD_COLS; ++c) acc[q][c] = 0.f;
            int j = 0;
            for (; j + 4 <= F; j += 4) {
                float4 r[BWD_ROWS];
#pragma unroll
                for (int q = 0; q < BWD_ROWS; ++q)
                    r[q] = *reinterpret_cast<const float4*>(g0 + q * ldg + j);
                float x[4][BWD_COLS];
#pragma unroll
                for (int t = 0; t < 4; ++t)
#pragma unroll
                    for (int c = 0; c < BWD_COLS; ++c) x[t][c] = to_float(X[(j + t) * D + col[c]]);
#pragma unroll
                for (int q = 0; q < BWD_ROWS; ++q)
#pragma unroll
                    for (int c = 0; c < BWD_COLS; ++c) {
                        acc[q][c] = fmaf(r[q].x, x[0][c], acc[q][c]);
                        acc[q][c] = fmaf(r[q].y, x[1][c], acc[q][c]);
                        acc[q][c] = fmaf(r[q].z, x[2][c], acc[q][c]);
                        acc[q][c] = fmaf(r[q].w, x[3][c], acc[q][c]);
                    }
            }
            for (; j < F; ++j) {
#pragma unroll
                for (int c = 0; c < BWD_COLS; ++c) {
                    const float xj = to_float(X[j * D + col[c]]);
#pragma unroll
                    for (int q = 0; q < BWD_ROWS; ++q)
                        acc[q][c] = fmaf(g0[q * ldg + j], xj, acc[q][c]);
                }
            }
#pragma unroll
            for (int q = 0; q < BWD_ROWS; ++q) {
                const int i = ig * BWD_ROWS + q;
#pragma unroll
                for (int c = 0; c < BWD_COLS; ++c)
                    if (i < F && has[c]) from_float(out + i * D + col[c], acc[q][c]);
            }
        }
        __syncthreads();  // the stage read here is the one the next sample after next fills
    }
}

template <typename T>
int launch_backward(const void* grad, const void* feats, void* dfeats, int B, int F, int D,
                    int grid, int threads, int smem, int vec, cudaStream_t stream) {
    auto kernel = dot_interaction_backward_kernel<T>;
    if (smem > 48 * 1024) {
        cudaError_t e =
            cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
    kernel<<<grid, threads, smem, stream>>>(static_cast<const T*>(grad),
                                            static_cast<const T*>(feats),
                                            static_cast<T*>(dfeats), B, F, D, vec);
    return (int)cudaGetLastError();
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


// K2-bwd.  grad (B, F(F-1)/2), feats and dfeats (B, F, D), all in `dtype`
// (0 = float32, 1 = bfloat16) and contiguous; grid, threads and smem
// (dynamic shared bytes) come from kernels/interaction.py::backward_plan;
// vec 1 when grad and feats both start on a 16-byte boundary (the
// 16-byte copy path), else 0.  Returns cudaGetLastError() after the launch.
extern "C" int dot_interaction_backward_launch(const void* grad, const void* feats,
                                               void* dfeats, int B, int F, int D, int dtype,
                                               int grid, int threads, int smem, int vec,
                                               void* stream) {
    if (B == 0 || F == 0 || D == 0) return 0;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return launch_backward<float>(grad, feats, dfeats, B, F, D, grid, threads, smem, vec, s);
    if (dtype == 1)
        return launch_backward<__nv_bfloat16>(grad, feats, dfeats, B, F, D, grid, threads, smem,
                                              vec, s);
    return (int)cudaErrorInvalidValue;
}
