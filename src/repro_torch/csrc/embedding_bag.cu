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
// distinct rows, and Zipf ids put 5 % of a table's lookups on its row 0.
// Atomics would add in whatever order the warps reach a row, so every
// launch would round differently, and adagrad's steps (about lr * sign(g)
// at first) carry such differences into the loss within a few steps:
// training would not repeat, nor resume bit for bit.  So no two threads
// ever add into one row, and every sum is taken in an order fixed by the
// data.  The lookups are partitioned once, then summed by runs:
//
//   * partition: a stable LSD radix sort of each table's (row, bag) pairs
//     by row, `passes` passes of `digit_bits` bits (at most 1,024 buckets).
//     A pass is three kernels: each block of SORT_TILE lookups counts its
//     buckets (counts[f][tile][bucket]); a thread a bucket turns its counts
//     down the tiles into prefixes and a total; each block ranks its
//     lookups in order by warp-wide ballots of equal buckets, lays the tile
//     out by bucket in shared memory and writes each bucket's run of it to
//     its slot (the totals of the buckets below, plus the tiles before).
//     The first pass reads idx itself.  After the last pass each row's
//     lookups lie together, in (b, h) order.  Counts and offsets stay on
//     the device, and the scratch is sized by B * F * H alone;
//   * sum: a group of G lanes (G * VEC columns of a row a load, G >= 8)
//     takes a chunk of `chunk` consecutive pairs of one table and sums each
//     run of equal rows in registers; a run that lies inside the chunk is
//     stored into its row.  A run that crosses the chunk's first or last
//     pair (the hot rows, and any run cut by a chunk's edge) leaves a
//     partial sum in scratch instead: its head (a run from the chunks
//     before) or its tail (a run going on).  The bags' gradient rows come
//     from L2; a lane keeps SUM_PREFETCH steps of its chunk's pairs in
//     flight;
//   * combine: the chunk where a crossing run starts adds its tail and the
//     next chunks' heads, in chunk order, and stores the row.
//
// Each touched row is stored exactly once, as its sum plus 0.0f (the bits
// an add into the zeroed buffer gives, -0 included); the buffer is never
// read, and untouched rows keep the caller's zeros.  One call launches
// 3 * passes + 2 kernels on the stream and synchronises nothing, so it can
// be captured in a CUDA graph.  The plan (passes, digit bits, tiles, chunk,
// lane groups, grid, the division by H) is computed in Python,
// kernels/embedding_bag.py::backward_plan; this file trusts it.
// Each kernel's time on an H100 at DLRM-RMC2's shape, and what holds it, is
// in PERF.md.
constexpr int SORT_THREADS = 256;                  // a partition block: eight warps
constexpr int SORT_WARPS = SORT_THREADS / 32;
constexpr int SORT_ITEMS = 16;                     // lookups a thread holds
constexpr int SORT_TILE = SORT_THREADS * SORT_ITEMS;  // a block's lookups a pass
constexpr int MAX_DIGIT_BITS = 10;                 // 1,024 buckets a pass at most
constexpr int SCAN_THREADS = 256;                  // a column-scan block: a bucket a thread
constexpr int SCAN_ITEMS = 8;                      // tiles' counts in flight a thread
constexpr int SUM_THREADS = 256;
constexpr unsigned FULL_MASK = 0xffffffffu;

typedef unsigned long long u64;

// n / d for 0 <= n < 2^31 by a multiply and a shift: m = 2^s / d + 1 with
// s = 31 + ceil(log2 d) (kernels/embedding_bag.py::div_magic)
struct FastDiv {
    u64 m;
    int s;
    __device__ __forceinline__ unsigned div(unsigned n) const {
        return (unsigned)(((u64)n * m) >> s);
    }
};

// a lookup as one 64-bit pair: its row above, its bag b below
__device__ __forceinline__ int pair_row(u64 p) { return (int)(p >> 32); }
__device__ __forceinline__ int pair_bag(u64 p) { return (int)(unsigned)p; }

// lookup i = b * H + h of table f: from idx on the first pass, else from
// the previous pass's pairs
template <bool FIRST>
__device__ __forceinline__ u64 load_pair(const int* __restrict__ idx, const u64* __restrict__ src,
                                         int f, int F, int H, long long N, FastDiv by_h,
                                         long long i) {
    if (FIRST) {
        const unsigned b = by_h.div((unsigned)i);
        const long long h = i - (long long)b * H;
        const int row = idx[((long long)b * F + f) * H + h];
        return ((u64)(unsigned)row << 32) | b;
    }
    return src[(long long)f * N + i];
}

// counts[f][tile][digit]: how many of the tile's lookups fall in each bucket
template <bool FIRST>
__global__ void __launch_bounds__(SORT_THREADS)
    partition_count(const int* __restrict__ idx, const u64* __restrict__ src,
                    int* __restrict__ counts, int F, int H, long long N, FastDiv by_h,
                    int shift, int radix) {
    __shared__ int hist[1 << MAX_DIGIT_BITS];
    const int f = blockIdx.y, t = blockIdx.x, tiles = gridDim.x;
    for (int d = threadIdx.x; d < radix; d += SORT_THREADS) hist[d] = 0;
    const long long i0 = (long long)t * SORT_TILE + threadIdx.x;
    int digit[SORT_ITEMS];
#pragma unroll
    for (int k = 0; k < SORT_ITEMS; ++k) {  // every load in flight before the first count
        const long long i = i0 + (long long)k * SORT_THREADS;
        digit[k] = i < N ? (pair_row(load_pair<FIRST>(idx, src, f, F, H, N, by_h, i)) >> shift) &
                               (radix - 1)
                         : -1;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < SORT_ITEMS; ++k)
        if (digit[k] >= 0) atomicAdd(&hist[digit[k]], 1);
    __syncthreads();
    int* c = counts + ((long long)f * tiles + t) * radix;
    for (int d = threadIdx.x; d < radix; d += SORT_THREADS) c[d] = hist[d];
}

// each bucket's counts down the tiles turned into exclusive prefixes in
// place, and the bucket's total into totals[f][digit]: a thread a bucket,
// neighbouring threads on neighbouring buckets
__global__ void __launch_bounds__(SCAN_THREADS)
    partition_columns(int* __restrict__ counts, int* __restrict__ totals, int tiles, int radix) {
    const int f = blockIdx.y, d = blockIdx.x * SCAN_THREADS + threadIdx.x;
    if (d >= radix) return;
    int* c = counts + (long long)f * tiles * radix + d;
    int run = 0;
    int t = 0;
    for (; t + SCAN_ITEMS <= tiles; t += SCAN_ITEMS) {  // SCAN_ITEMS loads in flight
        int v[SCAN_ITEMS];
#pragma unroll
        for (int k = 0; k < SCAN_ITEMS; ++k) v[k] = c[(long long)(t + k) * radix];
#pragma unroll
        for (int k = 0; k < SCAN_ITEMS; ++k) {
            c[(long long)(t + k) * radix] = run;
            run += v[k];
        }
    }
    for (; t < tiles; ++t) {
        const int v = c[(long long)t * radix];
        c[(long long)t * radix] = run;
        run += v;
    }
    totals[(long long)f * radix + d] = run;
}

// the exclusive prefix of x over the block's threads in order (SORT_THREADS
// of them); `sums` holds SORT_WARPS ints of shared memory
__device__ __forceinline__ int block_exclusive(int x, int* sums) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    int y = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int z = __shfl_up_sync(FULL_MASK, y, o);
        if (lane >= o) y += z;
    }
    if (lane == 31) sums[w] = y;
    __syncthreads();
    int before = y - x;
    for (int v = 0; v < w; ++v) before += sums[v];
    __syncthreads();
    return before;
}

// the tile's lookups to their slots, in order.  Warp w holds a contiguous
// SORT_TILE / SORT_WARPS of them; within a 32-lookup step, lanes of one
// bucket rank themselves by warp-wide ballots.  The ranked tile is laid out
// by bucket in shared memory first and then written out in that order, so
// that a bucket's lookups of the tile go to device memory as one run.  A
// bucket's first slot in the table is the totals of the buckets below it
// plus its counts in the tiles before this one.
// Dynamic shared memory: SORT_WARPS x radix slots, radix bases, the tile.
constexpr int SCATTER_SMEM = (SORT_WARPS + 1) * (1 << MAX_DIGIT_BITS) * 4 + SORT_TILE * 8;

template <bool FIRST>
__global__ void __launch_bounds__(SORT_THREADS)
    partition_scatter(const int* __restrict__ idx, const u64* __restrict__ src,
                      u64* __restrict__ dst, const int* __restrict__ prefix,
                      const int* __restrict__ totals, int F, int H, long long N, FastDiv by_h,
                      int shift, int radix) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int sums[SORT_WARPS];
    u64* tile = reinterpret_cast<u64*>(smem);                  // the tile by bucket
    int* next = reinterpret_cast<int*>(smem + SORT_TILE * 8);  // [SORT_WARPS][radix]
    int* base = next + SORT_WARPS * radix;                     // [radix]
    const int f = blockIdx.y, t = blockIdx.x, tiles = gridDim.x;
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const long long i0 = (long long)t * SORT_TILE + (long long)w * (SORT_TILE / SORT_WARPS);
    for (int d = lane; d < radix; d += 32) next[w * radix + d] = 0;
    u64 item[SORT_ITEMS];
    int digit[SORT_ITEMS];
#pragma unroll
    for (int k = 0; k < SORT_ITEMS; ++k) {
        const long long i = i0 + 32 * k + lane;
        item[k] = 0;
        digit[k] = radix;  // past the table's end: in no bucket
        if (i < N) {
            item[k] = load_pair<FIRST>(idx, src, f, F, H, N, by_h, i);
            digit[k] = (pair_row(item[k]) >> shift) & (radix - 1);
        }
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < SORT_ITEMS; ++k)  // the warp's count of each bucket
        if (digit[k] < radix) atomicAdd(&next[w * radix + digit[k]], 1);
    __syncthreads();
    // a thread takes `per` consecutive buckets: their starts in the tile and
    // in the table by two block-wide scans, then each warp's first slot
    const int per = (radix + SORT_THREADS - 1) / SORT_THREADS;
    const int d0 = threadIdx.x * per, d1 = min(radix, d0 + per);
    const int* tot = totals + (long long)f * radix;
    const int* pre = prefix + ((long long)f * tiles + t) * radix;
    int in_tile = 0, in_table = 0;
    for (int d = d0; d < d1; ++d) {
        in_table += tot[d];
        for (int v = 0; v < SORT_WARPS; ++v) in_tile += next[v * radix + d];
    }
    int run = block_exclusive(in_tile, sums);
    int below = block_exclusive(in_table, sums);
    for (int d = d0; d < d1; ++d) {
        base[d] = below + pre[d] - run;
        below += tot[d];
        for (int v = 0; v < SORT_WARPS; ++v) {
            const int c = next[v * radix + d];
            next[v * radix + d] = run;
            run += c;
        }
    }
    __syncthreads();
    const unsigned lower = (1u << lane) - 1;
#pragma unroll
    for (int k = 0; k < SORT_ITEMS; ++k) {
        // the lanes of this lane's bucket, by a ballot a bit (digits and the
        // past-the-end radix fit MAX_DIGIT_BITS + 1 bits); faster on an H100
        // than __match_any_sync
        unsigned peers = FULL_MASK;
#pragma unroll
        for (int bit = 0; bit <= MAX_DIGIT_BITS; ++bit) {
            const bool one = (digit[k] >> bit) & 1;
            const unsigned b = __ballot_sync(FULL_MASK, one);
            peers &= one ? b : ~b;
        }
        const bool in = digit[k] < radix;
        const int slot = in ? next[w * radix + digit[k]] + __popc(peers & lower) : 0;
        __syncwarp();
        if (in && lane == __ffs(peers) - 1) next[w * radix + digit[k]] += __popc(peers);
        __syncwarp();
        if (in) tile[slot] = item[k];
    }
    __syncthreads();
    u64* out = dst + (long long)f * N;
    const int n = (int)min((long long)SORT_TILE, N - (long long)t * SORT_TILE);
    for (int e = threadIdx.x; e < n; e += SORT_THREADS) {
        const u64 p = tile[e];
        out[base[(pair_row(p) >> shift) & (radix - 1)] + e] = p;
    }
}

// VEC float32 columns to and from device memory (16-byte vectors for VEC 4 and 8)
template <int VEC>
__device__ __forceinline__ void store_f32(float* p, const float (&r)[VEC]) {
    if constexpr (VEC == 1) {
        *p = r[0];
    } else {
#pragma unroll
        for (int i = 0; i < VEC; i += 4)
            *reinterpret_cast<float4*>(p + i) = make_float4(r[i], r[i + 1], r[i + 2], r[i + 3]);
    }
}
template <int VEC>
__device__ __forceinline__ void load_f32(const float* p, float (&r)[VEC]) {
    if constexpr (VEC == 1) {
        r[0] = *p;
    } else {
#pragma unroll
        for (int i = 0; i < VEC; i += 4) {
            const float4 v = *reinterpret_cast<const float4*>(p + i);
            r[i] = v.x; r[i + 1] = v.y; r[i + 2] = v.z; r[i + 3] = v.w;
        }
    }
}

// the arguments of the sum and the combine, as the plan gives them
struct SumArgs {
    const u64* pairs;  // the last pass's output: each table's pairs by row
    float* grad;       // (F, V, D)
    float* partials;   // (units, 2, D): a chunk's head, then its tail
    int F, D, H, N, chunk, chunks, group, mean;
    long long V, units;
};

constexpr int SUM_PREFETCH = 4;  // steps of a chunk's pairs a lane has in flight

// one chunk of table f: lane li of a group of G holds vectors v = li + G * k
// (k < CPV) of a row, VEC columns each; `go` is the table's first gradient
// row, rows `stride` apart.
// Every group of a warp runs the same steps (chunk / G of them), so the
// shuffles see all lanes; a group with no chunk (live false) loads nothing
template <typename T, int VEC, int CPV, bool MEAN>
__device__ __forceinline__ void sum_chunk(const SumArgs& a, const T* go, long long stride, int f,
                                          int c, bool live, int li) {
    const int G = a.group;
    const long long s = (long long)c * a.chunk;
    const long long e = live ? min((long long)a.N, s + a.chunk) : s;
    const u64* P = a.pairs + (long long)f * a.N;
    const int prev = live && c > 0 ? pair_row(P[s - 1]) : -1;  // the chunk before ends on it
    const int next = live && c + 1 < a.chunks ? pair_row(P[e]) : -1;  // the next begins on it
    const int n_vec = a.D / VEC;
    float* table = a.grad + (long long)f * a.V * a.D;
    float* head = a.partials + ((long long)f * a.chunks + c) * 2 * a.D;

    float acc[CPV][VEC];
    int run = -1;         // the row being summed
    bool before = false;  // it began in an earlier chunk
    auto flush = [&](bool goes_on) {
        float* p = before ? head : goes_on ? head + a.D : table + (long long)run * a.D;
#pragma unroll
        for (int k = 0; k < CPV; ++k) {
            const int v = li + G * k;
            if (v >= n_vec) continue;
            float o[VEC];  // + 0.f: the bits of an add into the zeroed buffer (-0 as +0)
#pragma unroll
            for (int q = 0; q < VEC; ++q) o[q] = acc[k][q] + 0.f;
            store_f32<VEC>(p + v * VEC, o);
        }
    };
    // the chunk's pairs, SUM_PREFETCH steps of G ahead
    u64 ring[SUM_PREFETCH];
#pragma unroll
    for (int m = 0; m < SUM_PREFETCH; ++m) {
        const long long i = s + (long long)m * G + li;
        ring[m] = i < e ? P[i] : 0;
    }
    const int steps = a.chunk / G;
    for (int st0 = 0; st0 < steps; st0 += SUM_PREFETCH) {
#pragma unroll
        for (int m = 0; m < SUM_PREFETCH; ++m) {
            const int st = st0 + m;
            if (st >= steps) break;
            const long long base = s + (long long)st * G;
            const u64 mine = ring[m];
            const long long ahead = base + (long long)SUM_PREFETCH * G + li;
            ring[m] = ahead < e ? P[ahead] : 0;
            for (int j0 = 0; j0 < G; j0 += 8) {
                float g[8][CPV][VEC];
                int rows[8];
#pragma unroll
                for (int q = 0; q < 8; ++q) {  // eight rows' loads in flight before the adds
                    const u64 p = __shfl_sync(FULL_MASK, mine, j0 + q, G);
                    rows[q] = base + j0 + q < e ? pair_row(p) : -1;
                    const T* src = go + (long long)pair_bag(p) * stride;
#pragma unroll
                    for (int k = 0; k < CPV; ++k) {  // a row past the chunk's end is never added
                        const int v = li + G * k;
                        if (rows[q] >= 0 && v < n_vec) RowIO<T, VEC>::load(src + v * VEC, g[q][k]);
                    }
                }
#pragma unroll
                for (int q = 0; q < 8; ++q) {
                    if (rows[q] < 0) continue;
                    const bool fresh = rows[q] != run;
                    if (fresh) {
                        if (run >= 0) flush(false);
                        run = rows[q];
                        before = run == prev;
                    }
#pragma unroll
                    for (int k = 0; k < CPV; ++k)
#pragma unroll
                        for (int i = 0; i < VEC; ++i) {
                            const float x = MEAN ? g[q][k][i] / (float)a.H : g[q][k][i];
                            acc[k][i] = fresh ? x : acc[k][i] + x;
                        }
                }
            }
        }
    }
    if (run >= 0) flush(run == next);
}

// a lane group a chunk
template <typename T, int VEC, int CPV>
__global__ void __launch_bounds__(SUM_THREADS, 2)
    backward_sum(const T* __restrict__ grad_out, SumArgs a) {
    const int G = a.group, li = threadIdx.x & (G - 1);
    const long long gid = (long long)blockIdx.x * SUM_THREADS + threadIdx.x;
    if ((gid & ~31LL) / G >= a.units) return;  // the whole warp is past the last chunk
    const long long u = gid / G;
    const bool live = u < a.units;
    const int f = live ? (int)(u / a.chunks) : 0;
    const int c = live ? (int)(u - (long long)f * a.chunks) : 0;
    const T* go = grad_out + (long long)f * a.D;
    if (a.mean)
        sum_chunk<T, VEC, CPV, true>(a, go, (long long)a.F * a.D, f, c, live, li);
    else
        sum_chunk<T, VEC, CPV, false>(a, go, (long long)a.F * a.D, f, c, live, li);
}

// the runs that cross a chunk's end: the chunk they start in adds its tail
// and the next chunks' heads, in chunk order, and stores the row.  The
// group's lanes look G chunk boundaries ahead at once for the run's end.
template <int VEC, int CPV>
__global__ void __launch_bounds__(SUM_THREADS) backward_combine(SumArgs a) {
    const int G = a.group, lane = threadIdx.x & 31, li = lane & (G - 1);
    const unsigned mask = (G == 32 ? FULL_MASK : ((1u << G) - 1)) << (lane & ~(G - 1));
    const long long u = ((long long)blockIdx.x * SUM_THREADS + threadIdx.x) / G;
    if (u >= a.units) return;
    const int f = (int)(u / a.chunks), c = (int)(u - (long long)f * a.chunks);
    if (c + 1 >= a.chunks) return;
    const u64* P = a.pairs + (long long)f * a.N;
    const long long s = (long long)c * a.chunk, e = s + a.chunk;  // not the last: a full chunk
    const int row = pair_row(P[e - 1]);
    if (pair_row(P[e]) != row) return;                  // no run goes on past the chunk
    if (c > 0 && pair_row(P[s - 1]) == row) return;     // it began in an earlier chunk
    int end = c + 1;  // the run's last chunk: the first k > c it does not go on past
    for (int k0 = c + 1;; k0 += G) {
        const int k = k0 + li;
        const bool on = k + 1 < a.chunks && pair_row(P[(long long)(k + 1) * a.chunk]) == row;
        const unsigned stop = __ballot_sync(mask, !on) & mask;
        if (stop) {
            end = k0 + __ffs(stop) - 1 - (lane & ~(G - 1));
            break;
        }
    }
    const int n_vec = a.D / VEC;
    const float* part = a.partials + (long long)f * a.chunks * 2 * a.D;
    float acc[CPV][VEC];
#pragma unroll
    for (int k = 0; k < CPV; ++k)
        if (li + G * k < n_vec)
            load_f32<VEC>(part + ((long long)c * 2 + 1) * a.D + (li + G * k) * VEC, acc[k]);
    for (int k0 = c + 1; k0 <= end; k0 += 8) {  // eight heads' loads in flight, added in order
        float r[8][CPV][VEC];
#pragma unroll
        for (int m = 0; m < 8; ++m) {
            const float* h = part + (long long)(k0 + m) * 2 * a.D;
#pragma unroll
            for (int q = 0; q < CPV; ++q)
                if (k0 + m <= end && li + G * q < n_vec)
                    load_f32<VEC>(h + (li + G * q) * VEC, r[m][q]);
        }
#pragma unroll
        for (int m = 0; m < 8; ++m) {
            if (k0 + m > end) break;
#pragma unroll
            for (int q = 0; q < CPV; ++q)
#pragma unroll
                for (int i = 0; i < VEC; ++i) acc[q][i] += r[m][q][i];
        }
    }
    float* out = a.grad + ((long long)f * a.V + row) * a.D;
#pragma unroll
    for (int k = 0; k < CPV; ++k) {
        const int v = li + G * k;
        if (v >= n_vec) continue;
        float o[VEC];
#pragma unroll
        for (int i = 0; i < VEC; ++i) o[i] = acc[k][i] + 0.f;
        store_f32<VEC>(out + v * VEC, o);
    }
}

// the plan of one call (kernels/embedding_bag.py::BackwardPlan)
struct BwdPlan {
    int passes, digit_bits, tiles, chunk, chunks, group, vec, cpv, blocks;
    unsigned long long div_m;
    int div_s;
};

template <typename T, int VEC, int CPV>
int launch_backward(const void* grad_out, const int* idx, float* grad, u64* pairs, int* counts,
                    float* partials, int B, int F, long long V, int D, int H, int mean,
                    const BwdPlan& p, cudaStream_t stream) {
    const long long N = (long long)B * H;
    const FastDiv by_h{p.div_m, p.div_s};
    const int radix = 1 << p.digit_bits;
    int* totals = counts + (long long)F * p.tiles * radix;  // [F][radix] after [F][tiles][radix]
    const dim3 grid(p.tiles, F);
    u64* buf[2] = {pairs, pairs + (long long)F * N};
    for (int pass = 0; pass < p.passes; ++pass) {
        const int shift = pass * p.digit_bits;
        const u64* src = buf[(pass + 1) & 1];
        u64* dst = buf[pass & 1];
        if (pass == 0)
            partition_count<true><<<grid, SORT_THREADS, 0, stream>>>(idx, src, counts, F, H, N,
                                                                     by_h, shift, radix);
        else
            partition_count<false><<<grid, SORT_THREADS, 0, stream>>>(idx, src, counts, F, H, N,
                                                                      by_h, shift, radix);
        cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        partition_columns<<<dim3((radix + SCAN_THREADS - 1) / SCAN_THREADS, F), SCAN_THREADS, 0,
                            stream>>>(counts, totals, p.tiles, radix);
        if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
        auto scatter = pass == 0 ? partition_scatter<true> : partition_scatter<false>;
        static bool sized[2];  // the shared-memory attribute, set once a process
        if (!sized[pass == 0]) {
            if ((e = cudaFuncSetAttribute(scatter, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          SCATTER_SMEM)) != cudaSuccess)
                return (int)e;
            sized[pass == 0] = true;
        }
        scatter<<<grid, SORT_THREADS, SCATTER_SMEM, stream>>>(idx, src, dst, counts, totals, F, H,
                                                              N, by_h, shift, radix);
        if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
    const SumArgs a{buf[(p.passes - 1) & 1], grad, partials, F, D, H, (int)N, p.chunk, p.chunks,
                    p.group, mean, V, (long long)F * p.chunks};
    backward_sum<T, VEC, CPV><<<p.blocks, SUM_THREADS, 0, stream>>>(
        static_cast<const T*>(grad_out), a);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    backward_combine<VEC, CPV><<<p.blocks, SUM_THREADS, 0, stream>>>(a);
    return (int)cudaGetLastError();
}

template <typename T, int VEC>
int launch_backward_cpv(const void* grad_out, const int* idx, float* grad, u64* pairs, int* counts,
                        float* partials, int B, int F, long long V, int D, int H, int mean,
                        const BwdPlan& p, cudaStream_t s) {
    // only the vectors a lane can need: D <= 256 is 256 / (32 * VEC) a lane at most
#define K1B_LAUNCH(CPV) \
    return launch_backward<T, VEC, CPV>(grad_out, idx, grad, pairs, counts, partials, B, F, V, D, \
                                        H, mean, p, s)
    switch (p.cpv) {
        case 1: K1B_LAUNCH(1);
        case 2: if constexpr (VEC <= 4) K1B_LAUNCH(2); break;
        case 4: if constexpr (VEC == 1) K1B_LAUNCH(4); break;
        case 8: if constexpr (VEC == 1) K1B_LAUNCH(8); break;
    }
#undef K1B_LAUNCH
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
// scratch: pairs (2 or, for one pass, 1) x F*B*H int64, counts F x 2^digit_bits
// x tiles int32, partials F*chunks x 2 x D float32.  The plan's fields come
// from kernels/embedding_bag.py::backward_plan (vec: 4 or 8 when the rows
// are read as 16-byte vectors, else 1).  Launches the whole backward on
// `stream`; returns the first launch error (0 = launched).
extern "C" int embedding_bag_backward_launch(
    const void* grad_out, const void* idx, void* grad, void* pairs, void* counts, void* partials,
    int B, int F, long long V, int D, int H, int mean, int dtype, int passes, int digit_bits,
    int tiles, int chunk, int chunks, int group, int vec, int cpv, int blocks,
    unsigned long long div_m, int div_s, void* stream) {
    if (B == 0 || F == 0 || D == 0 || H == 0) return 0;
    if (digit_bits < 1 || digit_bits > MAX_DIGIT_BITS) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int* ix = static_cast<const int*>(idx);
    float* g = static_cast<float*>(grad);
    u64* pr = static_cast<u64*>(pairs);
    int* cn = static_cast<int*>(counts);
    float* pt = static_cast<float*>(partials);
    const BwdPlan p{passes, digit_bits, tiles, chunk, chunks,
                    group,  vec,        cpv,   blocks, div_m,  div_s};
    if (dtype == 0 && vec == 4)
        return launch_backward_cpv<float, 4>(grad_out, ix, g, pr, cn, pt, B, F, V, D, H, mean, p,
                                             s);
    if (dtype == 0 && vec == 1)
        return launch_backward_cpv<float, 1>(grad_out, ix, g, pr, cn, pt, B, F, V, D, H, mean, p,
                                             s);
    if (dtype == 1 && vec == 8)
        return launch_backward_cpv<__nv_bfloat16, 8>(grad_out, ix, g, pr, cn, pt, B, F, V, D, H,
                                                     mean, p, s);
    if (dtype == 1 && vec == 1)
        return launch_backward_cpv<__nv_bfloat16, 1>(grad_out, ix, g, pr, cn, pt, B, F, V, D, H,
                                                     mean, p, s);
    return (int)cudaErrorInvalidValue;
}
