// The gradient of one xDeepFM Compressed Interaction Network layer (K3-bwd)
// for Hopper (sm_90a), on the tensor cores.
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
// load); sums are float32; the results are stored in the inputs' type.
// Neither P nor A, each (B, H*F, D), is ever written to device memory: at
// B = 65,536 and K = 7,800 either would be 20.4 GB.
//
// What bounds it: TF32 tensor-core operations.  Both products run as K3
// does (csrc/cin.cu): every operand split x = hi + lo, hi = tf32(x),
// lo = tf32(x - hi), and each k8 step issues hi*lo, lo*hi, hi*hi (lo*lo,
// below 2^-22 of a product, is dropped), so 3 x 2*M*N*K a product.  At
// xDeepFM's B = 512, K = 7,800, N = 200 that is 6 x 16.0 GFLOP, 0.195 ms at
// the card's 495 TF32 TFLOP/s; forming A (M*K) and the data gradient's two
// contractions (4*M*K) stay float32 on the CUDA cores, 0.003 ms at
// 67 TFLOP/s; the ~26 MB of inputs and results are 0.008 ms at 3.35 TB/s.
// On an H100 SXM (700 W) it takes 0.64 ms there (31 % of that bound) and
// 50.6-51.6 ms at B = 65,536 (49-50 %), about 33 of them the data kernel,
// whose product alone takes 28 when the contractors idle.
//
// The design: both products are K3's wgmma m64nNk8 .tf32 with A in
// registers and B from shared memory, two consumer warpgroups of 64 rows a
// block and a producer warpgroup whose one working thread keeps a ring of
// B stages in flight with cp.async.bulk on mbarriers.  TF32 wgmma reads B
// K-major only, so pre-pass kernels in the same launch write each B
// operand once as hi and lo TF32 planes already in wgmma's core-matrix
// layout (no swizzle), one contiguous run a stage.  The tensor cores add
// with truncation, so each stage (BS = 16 reduction values, six wgmma)
// starts from a zero accumulator and is added to a float32 total, rounded to
// nearest; setmaxnreg gives the producers' registers to the consumers.
//   - The data gradient (bwd_data_kernel): rows r x columns m, the reduction
//     over n.  A = g, formed in registers from a shared-memory tile of the
//     block's 128 rows (all N values, loaded once).  B = w, read K-major
//     along n, which is w's own (K, N) order: the pre-pass writes it as
//     planes of CW columns of m (64, or 32 where a block of 64 does not
//     fit: a large F) by BS values of n, laid out run by run (12.5 MB at
//     K = 7,800, which stays in the 50 MB L2 for every row tile).  A block
//     walks its run of h values in chunks of CW columns.  Each chunk of P
//     goes from the consumers' accumulators to a shared tile, and two more
//     warpgroups, the contractors, sum it there on the CUDA cores in
//     float32 while the consumers multiply the next chunk: one thread a row
//     adds dx0[r, f] over the chunk's columns of each f (xk's values of the
//     chunk's h brought in by the producer from the x-rows workspace,
//     below), another dxk[r, h] over those of each h (an h the chunk leaves
//     open carried to the next in a register), each in ascending m.  No sum
//     is shared between threads; named barriers hand the tile over both
//     ways.  (With the contractions in series, by the consumers between
//     chunks of 128 columns, they took 15 of the data kernel's 38 ms at
//     B = 65,536.)  At a small batch the rows give too few
//     blocks, so the h values are cut into runs (a plan that depends on the
//     shapes alone); each run writes its own dxk and a float32 plane of dx0,
//     and a second kernel adds the planes in order.
//   - The weight gradient (bwd_weight_kernel): rows m x columns n, the
//     reduction over r.  All N columns in one wgmma (N = 200: m64n200k8, no
//     padded column tile; K3's N_TILES for other N).  A = (xk*x0)^T, formed
//     in registers from a stage's xk and x0 values: each thread's two rows
//     m are fixed, so it reads its (h, f) rows of the stage.  B = g's rows r,
//     which g stores (B, N, D), strided by D along r: a pre-pass writes g's
//     hi and lo planes (BS rows r by the N tile) and one of x's rows (the
//     stage's H rows of xk and F rows of x0, BS values of r each, padded to
//     RS for conflict-free reads), and the producer brings a stage's g
//     planes, the block's xk rows and all x0 rows in three bulk copies.
//     The rows r are cut into runs of a length fixed by the shapes; each
//     run's float32 sums go to a plane of a workspace and the second kernel
//     adds the planes in run order.  The reuse of g: the grid puts the m
//     tiles of one run next to each other (blockIdx.x), so the tiles that
//     read a stage of g's planes run together and read it from L2.
// No atomics: every sum runs in an order fixed by the shapes, and two
// launches on the same inputs give the same bits.  Offsets into device
// memory are 64-bit.  No -use_fast_math.
#include <algorithm>

#include "wgmma_tf32.cuh"

namespace {

// kernels/cin.py keeps copies of these to plan the runs and the workspaces;
// a test holds them equal.
constexpr int BM = 128;                  // a block's rows: two warpgroups of 64
constexpr int BS = 16;                   // reduction values a stage: two k8 steps
// the data product's chunks of columns m (wgmma n), the widest whose block fits
constexpr int CHUNKS[] = {64, 32};
constexpr int XS = BM + 8;               // row stride of the data kernel's g tile (floats)
constexpr int PS = BM + 4;               // column stride of P's tile (floats)
constexpr int RS = BS + 4;               // row stride of a stage's x rows (floats)
constexpr int MIN_STAGES = 2;            // B stages in a ring, at least
constexpr int MAX_STAGES = 6;
constexpr int BARRIER_BYTES = 128;       // a ring's full and empty mbarriers, and the xk rows'
constexpr int SMEM_LIMIT = 232448;       // dynamic shared memory a block may have
// the weight product's column tiles (wgmma n), as csrc/cin.cu's
constexpr int N_TILES[] = {8, 16, 32, 64, 128, 200};

constexpr int CONSUMERS = 256;           // two warpgroups multiply, 64 rows each
constexpr int PRODUCERS = 128;           // a producer warpgroup (one thread of it works)
constexpr int CONTRACTORS = 256;         // the data kernel's two contraction warpgroups
constexpr int THREADS = CONSUMERS + PRODUCERS;              // the weight kernel's block
constexpr int DATA_THREADS = THREADS + CONTRACTORS;         // the data kernel's
// Registers are allocated by warpgroup at launch (168 a thread of 384, 96 of
// 640); setmaxnreg moves them from the producers to the consumers.  The
// contractors keep the launch count.
constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
constexpr int DATA_LAUNCH_REGS = 65536 / DATA_THREADS / 8 * 8;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;       // the weight kernel's: acc and total at N = 200
constexpr int DATA_CONSUMER_REGS = 128;  // the data kernel's: acc and total of a chunk
static_assert(CONSUMERS == 2 * BM && CONTRACTORS == 2 * BM,
              "a consumer warpgroup owns 64 rows; a contraction warpgroup one sum of each row");
static_assert(BS % 8 == 0 && BM % BS == 0, "whole k8 steps");
static_assert((2 * MAX_STAGES + 4) * 8 <= BARRIER_BYTES, "barriers");
static_assert(sizeof(CHUNKS) == 2 * sizeof(int) && CHUNKS[0] == 64 && CHUNKS[1] == 32,
              "launch() takes each of CHUNKS");
static_assert(CONSUMERS * CONSUMER_REGS + PRODUCERS * PRODUCER_REGS <= THREADS * LAUNCH_REGS,
              "setmaxnreg must not ask for more than the block holds");
static_assert(CONSUMERS * DATA_CONSUMER_REGS + PRODUCERS * PRODUCER_REGS +
                  CONTRACTORS * DATA_LAUNCH_REGS <= DATA_THREADS * DATA_LAUNCH_REGS,
              "setmaxnreg must not ask for more than the data kernel's block holds");

// named barrier 1 over the consumer warpgroups (the producers are not in it)
__device__ __forceinline__ void consumers_sync() { bar_sync<1, CONSUMERS>(); }

// A stage's A fragments: for each of its two k8 steps, hi and lo
struct Frag {
    uint32_t hi[BS / 8][4], lo[BS / 8][4];
};

// One stage of a product into acc, from a zero start: for each of the
// stage's two k8 steps j, hi*lo, lo*hi, hi*hi (the small terms first).  b
// points at the stage's hi plane [BS/4][NT/8][8][4], the lo plane follows.
// (Forming the next stage's A while this one runs measured slower.)
template <int NT>
__device__ __forceinline__ void mma_stage(float (&acc)[NT / 2], Frag& a, const float* b) {
    constexpr int PLANE = BS * NT;
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) hold(acc[i]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < BS / 8; ++j) {
        const uint64_t d_hi = smem_desc(b + j * 8 * NT, NT * 16, 128);
        const uint64_t d_lo = smem_desc(b + PLANE + j * 8 * NT, NT * 16, 128);
        mma_tf32<NT>(acc, a.hi[j], d_lo, j > 0);
        mma_tf32<NT>(acc, a.lo[j], d_hi, 1);
        mma_tf32<NT>(acc, a.hi[j], d_hi, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int j = 0; j < BS / 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            hold(a.hi[j][i]);
            hold(a.lo[j][i]);
        }
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) hold(acc[i]);
}

// Writes the quad of 4 consecutive K values at (stage st, index iq of the
// stage's [BS/4][NT/8][8][4] plane) as its hi and lo planes.
template <int NT>
__device__ __forceinline__ void put_quad(float* planes, long long st, int iq, const float (&v)[4]) {
    constexpr int PLANE = BS * NT;
    float h[4], l[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        h[kk] = __uint_as_float(tf32(v[kk]));
        l[kk] = __uint_as_float(tf32(v[kk] - h[kk]));
    }
    float4* dst = reinterpret_cast<float4*>(planes + st * 2 * PLANE) + iq;
    dst[0] = make_float4(h[0], h[1], h[2], h[3]);
    dst[PLANE / 4] = make_float4(l[0], l[1], l[2], l[3]);
}

// The data product's B: wp (runs, chunks a run, n stages, 2, BS, CW),
// stage (y, j, s) = w^T's values n in [s*BS, (s+1)*BS) of the columns
// m = y*hp*F + j*CW + [0, CW), zero past the run's last column and past N.
template <typename T, int CW>
__global__ void __launch_bounds__(256)
bwd_split_w_kernel(const T* __restrict__ w, float* __restrict__ wp, int K, int N, int F, int hp,
                   int cpr, int n_stages, long long quads) {
    const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (q >= quads) return;
    const long long st = q / (BS * CW / 4);
    const int iq = (int)(q - st * (BS * CW / 4));
    const int row = iq & 7, g8 = (iq >> 3) % (CW / 8), kc = (iq >> 3) / (CW / 8);
    const int s = (int)(st % n_stages);
    const int jc = (int)(st / n_stages), j = jc % cpr, y = jc / cpr;
    const int m = y * hp * F + j * CW + g8 * 8 + row;
    const int m_end = min(K, (y + 1) * hp * F);
    const int n = s * BS + kc * 4;
    float v[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
        v[kk] = (m < m_end && n + kk < N) ? to_float(w[(long long)m * N + n + kk]) : 0.f;
    put_quad<CW>(wp, st, iq, v);
}

// The weight product's B: gp (column tiles, r stages, 2, BS, NT), stage
// (c, s) = g's rows r in [s*BS, (s+1)*BS) of columns [c*NT, (c+1)*NT), zero
// past M and past N.
template <typename T, int NT>
__global__ void __launch_bounds__(256)
bwd_split_g_kernel(const T* __restrict__ g, float* __restrict__ gp, long long M, int N, int D,
                   int r_stages, long long quads) {
    const long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (q >= quads) return;
    const long long st = q / (BS * NT / 4);
    const int iq = (int)(q - st * (BS * NT / 4));
    const int row = iq & 7, g8 = (iq >> 3) % (NT / 8), kc = (iq >> 3) / (NT / 8);
    const long long s = st % r_stages;
    const int n = (int)(st / r_stages) * NT + g8 * 8 + row;
    const long long r = s * BS + kc * 4;
    float v[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        v[kk] = 0.f;
        if (r + kk < M && n < N) {
            const long long b = (r + kk) / D;
            v[kk] = to_float(g[(b * N + n) * D + (r + kk - b * D)]);
        }
    }
    put_quad<NT>(gp, st, iq, v);
}

// The weight product's x rows: xr (r stages, H + F, RS), stage s's row j the
// values at r = s*BS + i, i < BS, of xk's row j (j < H) or x0's row j - H;
// zero past M and in the RS - BS values of padding.
template <typename T>
__global__ void __launch_bounds__(256)
bwd_split_x_kernel(const T* __restrict__ x0, const T* __restrict__ xk, float* __restrict__ xr,
                   long long M, int F, int H, int D, long long numel) {
    const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= numel) return;
    const int i = (int)(e % RS);
    const long long sj = e / RS;
    const int j = (int)(sj % (H + F));
    const long long r = (sj / (H + F)) * BS + i;
    float v = 0.f;
    if (i < BS && r < M) {
        const long long b = r / D;
        const int d = (int)(r - b * D);
        v = j < H ? to_float(xk[(b * H + j) * D + d]) : to_float(x0[(b * F + j - H) * D + d]);
    }
    xr[e] = v;
}

// tile[row * stride + i] = the (B, rows, D) tensor src at (b, row, d) =
// (divmod(row0 + i, D)), for row < rows_pad and i < BM; 0 past `rows` and
// past M.  Walked in tile order by 256 threads (tid < CONSUMERS), eight
// loads in flight a thread.
template <typename T>
__device__ __forceinline__ void load_rows(float* tile, int stride, const T* __restrict__ src,
                                          int rows, int rows_pad, long long row0, long long M,
                                          int D, int tid) {
    constexpr int U = 8;
    const long long b0 = row0 / D;
    const int d0 = (int)(row0 - b0 * D);
    const int total = rows_pad * BM;
    for (int e0 = tid; e0 < total; e0 += U * CONSUMERS) {
        float v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int e = e0 + u * CONSUMERS;
            const int row = e / BM, i = e - row * BM;
            v[u] = 0.f;
            if (e < total && row < rows && row0 + i < M) {
                const int db = (d0 + i) / D;
                v[u] = to_float(src[((b0 + db) * rows + row) * D + (d0 + i - db * D)]);
            }
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int e = e0 + u * CONSUMERS;
            if (e < total) tile[(e / BM) * stride + e % BM] = v[u];
        }
    }
}

// the most values of h that n consecutive columns m span
__host__ __device__ __forceinline__ int h_span(int n, int F, int H) {
    const int span = (n - 1) / F + 2;
    return span < H ? span : H;
}

// Block (x, y): rows [x*BM, x*BM + BM) of M, and h in [y*hp, min(H, (y+1)*hp)).
// dx0_partial == nullptr: dx0 is stored in dx0; otherwise float32 into plane y
// of dx0_partial (splits, B, F, D).  xr: the x rows' workspace
// (bwd_split_x_kernel), from which each chunk's xk values come.
// Four roles: the consumer warpgroups multiply chunk j + 1 while the two
// contraction warpgroups contract chunk j from P's tile in shared memory,
// which the consumers refill once the contractors have read it (named
// barriers P_FULL and P_FREE); the producer thread brings the w stages and
// each chunk's xk rows.
template <typename T, int CW>
__global__ void __launch_bounds__(DATA_THREADS, 1)
bwd_data_kernel(const T* __restrict__ g, const T* __restrict__ x0, const float* __restrict__ wp,
                const float* __restrict__ xr, T* __restrict__ dx0, T* __restrict__ dxk,
                float* __restrict__ dx0_partial, long long M, int F, int H, int N, int D, int hp,
                int cpr, int n_stages, int stages) {
    constexpr int STAGE_FLOATS = 2 * BS * CW;
    constexpr int ROW_STAGES = BM / BS;               // the block's rows in x-row stages
    constexpr int P_FULL = 2, P_FREE = 3, CONTRACTORS_SYNC = 4;   // named barriers
    constexpr int P_THREADS = CONSUMERS + CONTRACTORS;            // P_FULL's and P_FREE's
    extern __shared__ __align__(128) unsigned char smem[];
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);
    uint64_t* empty = full + MAX_STAGES;
    uint64_t* xfull = empty + MAX_STAGES;             // a chunk's xk rows, two buffers
    uint64_t* xempty = xfull + 2;
    const int xh = h_span(CW, F, H);                  // xk rows a chunk holds, at most
    float* ring = reinterpret_cast<float*>(smem + BARRIER_BYTES);
    float* gs = ring + stages * STAGE_FLOATS;         // g: [n_stages*BS][XS], n x rows
    float* ps = gs + n_stages * BS * XS;              // P: [CW][PS], a chunk's columns x rows
    float* x0s = ps + CW * PS;                        // [F][BM]
    float* dx0s = x0s + F * BM;                       // [F][BM]
    float* xks = dx0s + F * BM;                       // [2][ROW_STAGES][xh][RS]

    const int tid = threadIdx.x;
    const long long row0 = (long long)blockIdx.x * BM;
    const int y = blockIdx.y;
    const int h_begin = y * hp;
    const int h_end = min(H, h_begin + hp);
    const int m_begin = h_begin * F, m_end = h_end * F;
    const int chunks = (m_end - m_begin + CW - 1) / CW;

    if (tid == 0) {
        for (int i = 0; i < stages; ++i) {
            mbar_init(&full[i], 1);
            mbar_init(&empty[i], CONSUMERS / 32);         // lane 0 of each consumer warp
        }
        for (int i = 0; i < 2; ++i) {
            mbar_init(&xfull[i], 1);
            mbar_init(&xempty[i], BM / 32);               // lane 0 of each dx0 contractor warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (tid >= THREADS) {
        // The contractors, a row each: warpgroup 0 sums dx0[r, f], warpgroup
        // 1 dxk[r, h], each output in ascending m, on the CUDA cores in
        // float32.  A thread owns every sum it adds to, so none is shared.
        const int ct = tid - THREADS;
        load_rows(x0s, BM, x0, F, F, row0, M, D, ct);
        for (int e = ct; e < F * BM; e += CONTRACTORS) dx0s[e] = 0.f;
        bar_sync<CONTRACTORS_SYNC, CONTRACTORS>();
        const bool sums_dx0 = ct < BM;
        const int pi = ct & (BM - 1);
        const long long pr = row0 + pi;
        const bool prow = pr < M;
        const long long pb = prow ? pr / D : 0;
        const int pd = prow ? (int)(pr - pb * D) : 0;
        const float* pcol = ps + pi;                  // column c of this row: pcol[c * PS]
        float carry = 0.f;                            // the dxk of an h a chunk left open
        for (int j = 0; j < chunks; ++j) {
            const int mc = m_begin + j * CW;
            const int cnt = min(CW, m_end - mc);
            const int h_first = mc / F, f_first = mc - h_first * F;
            bar_sync<P_FULL, P_THREADS>();            // chunk j's P is in the tile
            if (sums_dx0) {
                // dx0[r, f] += P[r, c] * xk[r, h] for the chunk's columns c,
                // f = (f_first + c) mod F, h counted from h_first (xk's rows)
                const int buf = j & 1;
                const float* xkb = xks + (buf * ROW_STAGES + pi / BS) * xh * RS + pi % BS;
                mbar_wait(&xfull[buf], (j >> 1) & 1);
                if (F >= 16) {
                    // blocks of 16 columns, whose f are distinct: loads first,
                    // then the stores
                    int f = f_first, h = 0;
                    for (int c0 = 0; c0 < cnt; c0 += 16) {
                        float a[16];
                        int at[16];
#pragma unroll
                        for (int u = 0; u < 16; ++u) {
                            at[u] = f * BM + pi;
                            if (c0 + u < cnt) a[u] = dx0s[at[u]] + pcol[(c0 + u) * PS] * xkb[h * RS];
                            if (++f == F) { f = 0; ++h; }
                        }
#pragma unroll
                        for (int u = 0; u < 16; ++u)
                            if (c0 + u < cnt) dx0s[at[u]] = a[u];
                    }
                } else {
                    // items q < min(F, cnt), each f's terms the columns q,
                    // q + F, ...
                    const int qn = min(F, cnt);
                    for (int q0 = 0; q0 < qn; q0 += 8) {
                        float a[8];
                        int at[8];
#pragma unroll
                        for (int u = 0; u < 8; ++u) {
                            const int q = q0 + u;
                            at[u] = -1;
                            if (q < qn) {
                                int f = f_first + q, h = 0;
                                if (f >= F) { f -= F; h = 1; }
                                at[u] = f * BM + pi;
                                float v = dx0s[at[u]];
                                for (int c = q; c < cnt; c += F, ++h)
                                    v += pcol[c * PS] * xkb[h * RS];
                                a[u] = v;
                            }
                        }
#pragma unroll
                        for (int u = 0; u < 8; ++u)
                            if (at[u] >= 0) dx0s[at[u]] = a[u];
                    }
                }
            } else {
                // dxk[r, h] += P[r, c] * x0[r, f]: a segment for each h the
                // chunk's columns touch, its loads eight columns at a time
                const int nseg = (mc + cnt - 1) / F - h_first + 1;
                for (int sg = 0; sg < nseg; ++sg) {
                    const int h = h_first + sg;
                    const int c_lo = max(0, h * F - mc), c_hi = min(cnt, (h + 1) * F - mc);
                    const int f_lo = mc + c_lo - h * F, f_hi = mc + c_hi - h * F;
                    float v = f_lo == 0 ? 0.f : carry;
                    for (int c = c_lo, f = f_lo; c < c_hi; c += 8, f += 8) {
                        float p8[8], x8[8];
#pragma unroll
                        for (int u = 0; u < 8; ++u) {
                            const bool in = c + u < c_hi;
                            p8[u] = in ? pcol[(c + u) * PS] : 0.f;
                            x8[u] = in ? x0s[(f + u) * BM + pi] : 0.f;
                        }
#pragma unroll
                        for (int u = 0; u < 8; ++u)
                            if (c + u < c_hi) v += p8[u] * x8[u];
                    }
                    if (f_hi < F) carry = v;
                    else if (prow) store(dxk + (pb * H + h) * D + pd, v);
                }
            }
            if (j + 1 < chunks) bar_arrive<P_FREE, P_THREADS>();   // P's tile is read
            if (sums_dx0) {
                __syncwarp();
                if ((tid & 31) == 0) mbar_arrive(&xempty[j & 1]);
            }
        }
        if (sums_dx0 && prow) {
            const long long B = M / D;
            for (int f = 0; f < F; ++f) {
                const float v = dx0s[f * BM + pi];
                if (dx0_partial == nullptr) store(dx0 + (pb * F + f) * D + pd, v);
                else dx0_partial[(((long long)y * B + pb) * F + f) * D + pd] = v;
            }
        }
    } else if (tid >= CONSUMERS) {
        // the producer warpgroup: one thread keeps the ring of w stages in
        // flight and, after each chunk's stages, brings in its xk rows
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
        if (tid == CONSUMERS) {
            const float* src = wp + (long long)y * cpr * n_stages * STAGE_FLOATS;
            const long long s_row0 = row0 / BS;
            const int row_stages = (int)min((long long)ROW_STAGES, (M + BS - 1) / BS - s_row0);
            for (int j = 0; j < chunks; ++j) {
                for (int st = 0; st < n_stages; ++st) {
                    const int t = j * n_stages + st;
                    const int slot = t % stages;
                    if (t >= stages) mbar_wait(&empty[slot], ((t / stages) - 1) & 1);
                    mbar_expect_tx(&full[slot], STAGE_FLOATS * 4);
                    bulk_load(ring + slot * STAGE_FLOATS, src + (long long)t * STAGE_FLOATS,
                              STAGE_FLOATS * 4, &full[slot]);
                }
                const int buf = j & 1;
                const int c0 = m_begin + j * CW;
                const int h0 = c0 / F, nh = (min(m_end, c0 + CW) - 1) / F - h0 + 1;
                if (j >= 2) mbar_wait(&xempty[buf], ((j >> 1) - 1) & 1);
                mbar_expect_tx(&xfull[buf], row_stages * nh * RS * 4);
                for (int s = 0; s < row_stages; ++s)
                    bulk_load(xks + (buf * ROW_STAGES + s) * xh * RS,
                              xr + ((s_row0 + s) * (H + F) + h0) * RS, nh * RS * 4, &xfull[buf]);
            }
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(DATA_CONSUMER_REGS));
        load_rows(gs, XS, g, N, n_stages * BS, row0, M, D, tid);
        consumers_sync();

        // This thread's A fragment (wgmma .tf32 m64k8, A in registers): rows
        // ra and ra + 8 of the block, columns n = tig and tig + 4 of each k8
        // step; its accumulator: rows ra, ra + 8, columns 8j + 2*tig + {0, 1}.
        const int lane = tid & 31;
        const int ra = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
        const int tig = lane & 3;
        for (int j = 0; j < chunks; ++j) {
            float acc[CW / 2], total[CW / 2];
#pragma unroll
            for (int i = 0; i < CW / 2; ++i) acc[i] = total[i] = 0.f;
            for (int s = 0; s < n_stages; ++s) {
                Frag a;
#pragma unroll
                for (int k = 0; k < BS / 8; ++k) {
                    const float* g1 = gs + (s * BS + 8 * k + tig) * XS;
                    const float* g2 = g1 + 4 * XS;
                    const float v[4] = {g1[ra], g1[ra + 8], g2[ra], g2[ra + 8]};
                    split(v, a.hi[k], a.lo[k]);
                }
                const int t = j * n_stages + s;
                const int slot = t % stages;
                mbar_wait(&full[slot], (t / stages) & 1);
                mma_stage<CW>(acc, a, ring + slot * STAGE_FLOATS);
                if (lane == 0) mbar_arrive(&empty[slot]);
#pragma unroll
                for (int i = 0; i < CW / 2; ++i) total[i] += acc[i];
            }
            // hand the chunk to the contractors once they have read the last
            if (j > 0) bar_sync<P_FREE, P_THREADS>();
#pragma unroll
            for (int q = 0; q < CW / 8; ++q) {
                const int col = 8 * q + 2 * tig;
                ps[col * PS + ra] = total[4 * q];
                ps[(col + 1) * PS + ra] = total[4 * q + 1];
                ps[col * PS + ra + 8] = total[4 * q + 2];
                ps[(col + 1) * PS + ra + 8] = total[4 * q + 3];
            }
            bar_arrive<P_FULL, P_THREADS>();
        }
    }
}

// a weight stage's slot: g's planes, then hr xk rows and F x0 rows, in
// whole 128-byte lines
__host__ __device__ __forceinline__ int weight_slot_floats(int nt, int hr, int F) {
    return (2 * BS * nt + (hr + F) * RS + 31) / 32 * 32;
}

// Block (x, y, z): dw[m0 .. m0 + BM) x [y*NT .. (y+1)*NT) summed over the r
// stages [z*per, min(r_stages, (z+1)*per)).  dw_partial == nullptr: stored in
// dw; otherwise float32 into plane z of dw_partial (splits, K, N).  hr: the
// xk rows a slot holds (the most any block's m tile spans).
template <typename T, int NT>
__global__ void __launch_bounds__(THREADS, 1)
bwd_weight_kernel(const float* __restrict__ xr, const float* __restrict__ gp,
                  T* __restrict__ dw, float* __restrict__ dw_partial, int F, int H, int N,
                  int r_stages, int per, int hr, int stages) {
    constexpr int G_FLOATS = 2 * BS * NT;
    extern __shared__ __align__(128) unsigned char smem[];
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);
    uint64_t* empty = full + MAX_STAGES;
    float* ring = reinterpret_cast<float*>(smem + BARRIER_BYTES);
    const int slot_floats = weight_slot_floats(NT, hr, F);

    const int tid = threadIdx.x;
    const int K = H * F;
    const int m0 = blockIdx.x * BM;
    const int c = blockIdx.y;
    const int s_begin = blockIdx.z * per;
    const int n_st = min(r_stages, s_begin + per) - s_begin;
    const int h_lo = m0 / F;
    const int h_rows = (min(K, m0 + BM) - 1) / F - h_lo + 1;

    if (tid == 0) {
        for (int i = 0; i < stages; ++i) {
            mbar_init(&full[i], 1);
            mbar_init(&empty[i], CONSUMERS / 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (tid >= CONSUMERS) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
        if (tid == CONSUMERS) {
            const uint32_t bytes = (G_FLOATS + (h_rows + F) * RS) * 4;
            for (int t = 0; t < n_st; ++t) {
                const long long s = s_begin + t;
                const int slot = t % stages;
                float* dst = ring + slot * slot_floats;
                const float* x_src = xr + s * (H + F) * RS;
                if (t >= stages) mbar_wait(&empty[slot], ((t / stages) - 1) & 1);
                mbar_expect_tx(&full[slot], bytes);
                bulk_load(dst, gp + ((long long)c * r_stages + s) * G_FLOATS, G_FLOATS * 4,
                          &full[slot]);
                bulk_load(dst + G_FLOATS, x_src + h_lo * RS, h_rows * RS * 4, &full[slot]);
                bulk_load(dst + G_FLOATS + hr * RS, x_src + H * RS, F * RS * 4, &full[slot]);
            }
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
        // This thread's A fragment: rows m1 = m0 + ra and m2 = m1 + 8 (fixed
        // for the whole kernel), columns r = tig and tig + 4 of each k8 step;
        // A[r, m] = xk[b, h, d] * x0[b, f, d] from the slot's rows; 0 past K.
        const int lane = tid & 31;
        const int ra = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
        const int tig = lane & 3;
        const int m1 = m0 + ra, m2 = m1 + 8;
        const bool v1 = m1 < K, v2 = m2 < K;
        const int xk1 = v1 ? (m1 / F - h_lo) * RS : 0, x01 = v1 ? (hr + m1 % F) * RS : 0;
        const int xk2 = v2 ? (m2 / F - h_lo) * RS : 0, x02 = v2 ? (hr + m2 % F) * RS : 0;

        float acc[NT / 2], total[NT / 2];
#pragma unroll
        for (int i = 0; i < NT / 2; ++i) acc[i] = total[i] = 0.f;
        for (int t = 0; t < n_st; ++t) {
            const int slot = t % stages;
            mbar_wait(&full[slot], (t / stages) & 1);
            const float* b = ring + slot * slot_floats;
            const float* xs = b + G_FLOATS;
            Frag a;
#pragma unroll
            for (int k = 0; k < BS / 8; ++k) {
                const int r1 = 8 * k + tig, r2 = r1 + 4;
                const float v[4] = {v1 ? xs[xk1 + r1] * xs[x01 + r1] : 0.f,
                                    v2 ? xs[xk2 + r1] * xs[x02 + r1] : 0.f,
                                    v1 ? xs[xk1 + r2] * xs[x01 + r2] : 0.f,
                                    v2 ? xs[xk2 + r2] * xs[x02 + r2] : 0.f};
                split(v, a.hi[k], a.lo[k]);
            }
            mma_stage<NT>(acc, a, b);
            if (lane == 0) mbar_arrive(&empty[slot]);
#pragma unroll
            for (int i = 0; i < NT / 2; ++i) total[i] += acc[i];
        }

        float* plane = dw_partial == nullptr ? nullptr
                                             : dw_partial + (long long)blockIdx.z * K * N;
#pragma unroll
        for (int j = 0; j < NT / 8; ++j) {
            const int n = c * NT + 8 * j + 2 * tig;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int m = e < 2 ? m1 : m2;
                const int nn = n + (e & 1);
                if (m < K && nn < N) {
                    const long long at = (long long)m * N + nn;
                    if (plane == nullptr) store(dw + at, total[4 * j + e]);
                    else plane[at] = total[4 * j + e];
                }
            }
        }
    }
}

// out[e] = the sum over planes z < splits of partial[z][e], in ascending z.
template <typename T>
__global__ void __launch_bounds__(256)
bwd_reduce_kernel(const float* __restrict__ partial, T* __restrict__ out, long long numel,
                  int splits) {
    const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= numel) return;
    float acc = 0.f;
    for (int z = 0; z < splits; ++z) acc += partial[z * numel + e];
    store(out + e, acc);
}

template <typename T>
cudaError_t reduce(const float* partial, void* out, long long numel, int splits,
                   cudaStream_t stream) {
    bwd_reduce_kernel<T><<<(unsigned)((numel + 255) / 256), 256, 0, stream>>>(
        partial, static_cast<T*>(out), numel, splits);
    return cudaGetLastError();
}

unsigned blocks_of(long long n) { return (unsigned)((n + 255) / 256); }

// the weight product's column tile (kernels/cin.py::n_tile, as csrc/cin.cu's)
int n_tile_of(int N) {
    const int tiles = (N + 199) / 200;
    const int need = (N + tiles - 1) / tiles;
    for (int t : N_TILES)
        if (t >= need) return t;
    return 200;
}

// the data kernel's shared memory before its ring (kernels/cin.py::backward_shared_bytes)
long long data_fixed_bytes(int F, int H, int N, int CW) {
    const int n_stages = (N + BS - 1) / BS;
    return BARRIER_BYTES + ((long long)n_stages * BS * XS + (long long)CW * PS + 2LL * F * BM +
                            2LL * (BM / BS) * h_span(CW, F, H) * RS) * 4;
}

template <typename T, int NT>
int launch_weight(const void* g, const float* xr, float* gp, void* dw, float* dw_partial,
                  long long M, int F, int H, int N, int D, int splits, long long run,
                  cudaStream_t stream) {
    const int K = H * F;
    const int r_stages = (int)((M + BS - 1) / BS);
    const int c_tiles = (N + NT - 1) / NT;
    const long long quads = (long long)c_tiles * r_stages * BS * NT / 4;
    bwd_split_g_kernel<T, NT><<<blocks_of(quads), 256, 0, stream>>>(
        static_cast<const T*>(g), gp, M, N, D, r_stages, quads);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;

    const int hr = h_span(BM, F, H);
    const long long slot_bytes = weight_slot_floats(NT, hr, F) * 4LL;
    const int stages = (int)std::min((long long)MAX_STAGES,
                                     (SMEM_LIMIT - BARRIER_BYTES) / slot_bytes);
    if (stages < MIN_STAGES) return (int)cudaErrorInvalidValue;
    const int smem = (int)(BARRIER_BYTES + stages * slot_bytes);
    // once per process (the port drives one card), outside any graph capture
    static const cudaError_t opt_in = cudaFuncSetAttribute(
        bwd_weight_kernel<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (opt_in != cudaSuccess) return (int)opt_in;
    if (splits == 1) dw_partial = nullptr;
    const dim3 grid((unsigned)((K + BM - 1) / BM), (unsigned)c_tiles, (unsigned)splits);
    bwd_weight_kernel<T, NT><<<grid, THREADS, smem, stream>>>(
        xr, gp, static_cast<T*>(dw), dw_partial, F, H, N, r_stages, (int)(run / BS), hr, stages);
    e = cudaGetLastError();
    if (e != cudaSuccess || dw_partial == nullptr) return (int)e;
    return (int)reduce<T>(dw_partial, dw, (long long)K * N, splits, stream);
}

template <typename T, int CW>
int launch_data(const void* g, const void* x0, const void* w, const float* xr, void* dx0,
                void* dxk, float* wp, float* dx0_partial, long long M, int F, int H, int N,
                int D, int splits, int hp, cudaStream_t stream) {
    const int K = H * F;
    const int n_stages = (N + BS - 1) / BS;
    const long long stage_bytes = 2LL * BS * CW * 4;
    const long long fixed = data_fixed_bytes(F, H, N, CW);
    const int stages = (int)std::min((long long)MAX_STAGES, (SMEM_LIMIT - fixed) / stage_bytes);
    if (stages < MIN_STAGES) return (int)cudaErrorInvalidValue;
    const int smem = (int)(fixed + stages * stage_bytes);
    const int cpr = (hp * F + CW - 1) / CW;
    const long long quads = (long long)splits * cpr * n_stages * BS * CW / 4;
    bwd_split_w_kernel<T, CW><<<blocks_of(quads), 256, 0, stream>>>(
        static_cast<const T*>(w), wp, K, N, F, hp, cpr, n_stages, quads);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    // once per process (the port drives one card), outside any graph capture
    static const cudaError_t opt_in = cudaFuncSetAttribute(
        bwd_data_kernel<T, CW>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (opt_in != cudaSuccess) return (int)opt_in;
    if (splits == 1) dx0_partial = nullptr;
    const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)splits);
    bwd_data_kernel<T, CW><<<grid, DATA_THREADS, smem, stream>>>(
        static_cast<const T*>(g), static_cast<const T*>(x0), wp, xr, static_cast<T*>(dx0),
        static_cast<T*>(dxk), dx0_partial, M, F, H, N, D, hp, cpr, n_stages, stages);
    e = cudaGetLastError();
    if (e != cudaSuccess || dx0_partial == nullptr) return (int)e;
    return (int)reduce<T>(dx0_partial, dx0, M * F, splits, stream);
}

template <typename T>
int launch(const void* g, const void* x0, const void* xk, const void* w, void* dx0, void* dxk,
           void* dw, float* wp, float* gp, float* xr, float* dx0_partial, float* dw_partial,
           int B, int F, int H, int N, int D, int data_splits, int hp, int chunk,
           int weight_splits, long long run, cudaStream_t stream) {
    const long long M = (long long)B * D;
    // the plan must be whole runs with none empty (kernels/cin.py::backward_plan)
    if (hp < 1 || run < 1 || run % BS != 0 || (H + hp - 1) / hp != data_splits ||
        (M + run - 1) / run != weight_splits) {
        return (int)cudaErrorInvalidValue;
    }
    // x's rows, which the data kernel reads xk from and the weight kernel A
    const long long x_numel = (M + BS - 1) / BS * (H + F) * RS;
    bwd_split_x_kernel<T><<<blocks_of(x_numel), 256, 0, stream>>>(
        static_cast<const T*>(x0), static_cast<const T*>(xk), xr, M, F, H, D, x_numel);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;

    // the data gradient: w's planes, then the product and its contractions
    int err;
    switch (chunk) {
        case 64: err = launch_data<T, 64>(g, x0, w, xr, dx0, dxk, wp, dx0_partial, M, F, H, N,
                                          D, data_splits, hp, stream); break;
        case 32: err = launch_data<T, 32>(g, x0, w, xr, dx0, dxk, wp, dx0_partial, M, F, H, N,
                                          D, data_splits, hp, stream); break;
        default: return (int)cudaErrorInvalidValue;
    }
    if (err != 0) return err;

    // the weight gradient: g's planes, then the product
    switch (n_tile_of(N)) {
        case 8: return launch_weight<T, 8>(g, xr, gp, dw, dw_partial, M, F, H, N, D,
                                           weight_splits, run, stream);
        case 16: return launch_weight<T, 16>(g, xr, gp, dw, dw_partial, M, F, H, N, D,
                                             weight_splits, run, stream);
        case 32: return launch_weight<T, 32>(g, xr, gp, dw, dw_partial, M, F, H, N, D,
                                             weight_splits, run, stream);
        case 64: return launch_weight<T, 64>(g, xr, gp, dw, dw_partial, M, F, H, N, D,
                                             weight_splits, run, stream);
        case 128: return launch_weight<T, 128>(g, xr, gp, dw, dw_partial, M, F, H, N, D,
                                               weight_splits, run, stream);
        case 200: return launch_weight<T, 200>(g, xr, gp, dw, dw_partial, M, F, H, N, D,
                                               weight_splits, run, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  g (B, N, D), x0 (B, F, D), xk (B, H, D),
// w (H*F, N) in; dx0, dxk, dw (their inputs' shapes) out.  Float32
// workspaces, as kernels/cin.py's backward_scratch sizes them: w_planes
// (data_splits, ceil(h_run*F / chunk), ceil(N / BS), 2, BS, chunk),
// g_planes (ceil(N / n_tile), ceil(B*D / BS), 2, BS, n_tile), x_rows
// (ceil(B*D / BS), H + F, RS), and for more than one run dx0_partial
// (data_splits, B, F, D) and dw_partial (weight_splits, H*F, N).  The data
// gradient's h values are cut into data_splits runs of h_run, its columns
// into chunks of `chunk` (one of CHUNKS); the weight gradient's B*D rows
// into weight_splits runs of row_run, a multiple of BS; all as
// kernels/cin.py's backward_plan gives them.  Returns the error of the
// first launch CUDA refused, or cudaErrorInvalidValue for arguments the
// kernels do not take (a plan that is not backward_plan's, or F and N too
// large for a block's shared memory).
extern "C" int cin_layer_backward_launch(const void* g, const void* x0, const void* xk,
                                         const void* w, void* dx0, void* dxk, void* dw,
                                         void* w_planes, void* g_planes, void* x_rows,
                                         void* dx0_partial, void* dw_partial, int B, int F,
                                         int H, int N, int D, int data_splits, int h_run,
                                         int chunk, int weight_splits, long long row_run,
                                         int dtype, void* stream) {
    if (B == 0 || D == 0 || N == 0) return 0;     // the wrapper zeroes what is left
    if (F < 1 || H < 1 || data_splits < 1 || data_splits > H || weight_splits < 1 ||
        w_planes == nullptr || g_planes == nullptr || x_rows == nullptr ||
        (data_splits > 1 && dx0_partial == nullptr) ||
        (weight_splits > 1 && dw_partial == nullptr)) {
        return (int)cudaErrorInvalidValue;
    }
    float* wp = static_cast<float*>(w_planes);
    float* gp = static_cast<float*>(g_planes);
    float* xr = static_cast<float*>(x_rows);
    float* pd = static_cast<float*>(dx0_partial);
    float* pw = static_cast<float*>(dw_partial);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) {
        return launch<float>(g, x0, xk, w, dx0, dxk, dw, wp, gp, xr, pd, pw, B, F, H, N, D,
                             data_splits, h_run, chunk, weight_splits, row_run, s);
    }
    if (dtype == 1) {
        return launch<__nv_bfloat16>(g, x0, xk, w, dx0, dxk, dw, wp, gp, xr, pd, pw, B, F, H,
                                     N, D, data_splits, h_run, chunk, weight_splits, row_run, s);
    }
    return (int)cudaErrorInvalidValue;
}
