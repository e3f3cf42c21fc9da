// One xDeepFM Compressed Interaction Network layer for Hopper (sm_90a), on
// the tensor cores.
//
// Replaces the Pallas TPU kernel src/repro/kernels/cin.py::cin_layer:
//     x0 (B, F, D), xk (B, H, D), w (H*F, N) -> out (B, N, D),
//     out[b, n, d] = sum_{h,f} w[h*F + f, n] * xk[b, h, d] * x0[b, f, d].
// float32 and bfloat16 inputs (all three of one type, bfloat16 widened to
// float32 on load); sums are float32, the result is stored in the input's
// type.
//
// Read as one matrix product whose A operand is never stored in device
// memory: rows r = (b, d) (M = B*D), reduction over m = h*F + f (K = H*F),
// columns n (N), A[r, m] = xk[b, h, d] * x0[b, f, d].  The TPU kernel pads
// D to 128 lanes; here nothing is padded.
//
// What bounds it: TF32 tensor-core operations, three passes.  A TF32 value
// keeps 11 significant bits, too few for the float32 checks at K = 7,800,
// so every operand is split, x = hi + lo with hi = tf32(x) and
// lo = tf32(x - hi), and each k8 step issues hi*lo, lo*hi, hi*hi into one
// accumulator (lo*lo, below 2^-22 of a product, is dropped).  At xDeepFM's
// B = 512, K = 7,800, N = 200 that is 3 x 16.0 GFLOP, 0.097 ms at the
// card's 495 TF32 TFLOP/s; the ~16 MB of inputs and output are 0.005 ms at
// 3.35 TB/s.
//
// The design:
//   - wgmma m64nNTk8 .tf32 with A from registers: each thread of a
//     warpgroup owns two rows of A for the whole K loop and four values of
//     each k8 step, which it forms as xk*x0 from a shared-memory copy of
//     its block's x0 and xk rows (loaded once: the factors are tiny next to
//     A) and splits into hi and lo.  Two consumer warpgroups make a block
//     of BM = 128 rows; one warpgroup covers NT <= 200 columns, all of
//     xDeepFM's N = 200 in one instruction.
//   - B = w from shared memory.  TF32 wgmma reads B K-major only and w is
//     stored (K, N), so a pre-pass kernel, in the same launch, writes w^T
//     once as hi and lo TF32 planes already in the core-matrix layout wgmma
//     reads (no swizzle), one contiguous run per (column tile, K stage); a
//     producer thread brings the stages in with plain cp.async.bulk on a ring
//     of mbarriers.  (Splitting w inside the main kernel instead, by
//     converter warps, repeated the split in every row tile and measured
//     several times slower.)  The main kernel and the sum of a split are
//     launched as programmatic dependents, so each starts while the kernel
//     before it drains, and only the producer waits for the planes.
//   - The L2 reads of w: every row tile reads all of w's planes from L2
//     (12.5 MB at K = 7,800; the planes stay in the 50 MB L2 after the
//     pre-pass writes them).  The two warpgroups share each stage, which
//     halves those reads against one warpgroup a block.
//   - The tensor cores add with truncation: summed over all 3K products,
//     the error was five times a float32 GEMM's.  So each stage (BK = 16
//     values of K, six wgmma) starts from a zero accumulator and is then
//     added to a float32 total in registers, rounded to nearest; the
//     producer warpgroup gives its registers to the consumers (setmaxnreg)
//     to hold both.
//   - Split K: when the row x column tiles fill less than 90 % of one wave
//     on the SMs (B = 512 gives 40 tiles), block z of the grid's third axis
//     takes one run of K stages and writes float32 partial sums to plane z
//     of a (splits, B, N, D) workspace; a second kernel adds the planes in
//     a fixed order.  A run needs only its own range of xk rows in shared
//     memory, so a split also lets a large H fit.
//   - The epilogue stages the block's (NT, BM) result through shared memory
//     (over the x tiles, dead by then) so that out is written in whole runs.
// The order of every sum is fixed: two launches on the same inputs give the
// same bits.  Offsets into device memory are 64-bit.  No -use_fast_math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

// kernels/cin.py keeps copies of these to plan the split and the shared
// memory; a test holds them equal.
constexpr int BM = 128;                  // rows (b, d) of a block: two warpgroups of 64
constexpr int BK = 16;                   // K values of a w stage: two k8 steps
constexpr int XS = BM + 8;               // x tile row stride (floats): conflict-free reads
constexpr int ES = BM + 4;               // epilogue tile row stride (floats)
constexpr int MIN_STAGES = 2;            // w stages in the ring, at least
constexpr int MAX_STAGES = 4;
constexpr int BARRIER_BYTES = 128;       // full and empty mbarriers of MAX_STAGES stages
constexpr int SMEM_LIMIT = 232448;       // dynamic shared memory a block may have
// the column tiles (wgmma n) the kernel is built for; a launch of N columns
// takes ceil(N / 200) tiles of the smallest of these that holds their share
constexpr int N_TILES[] = {8, 16, 32, 64, 128, 200};

constexpr int CONSUMERS = 256;           // two warpgroups
constexpr int THREADS = CONSUMERS + 128; // and a producer warpgroup (one thread of it works)
// registers a thread after setmaxnreg: the producers' go to the consumers.
// Registers are allocated by warpgroup: 384 threads launch with 168 each,
// 64,512 of the SM's 65,536, and setmaxnreg only moves them around.
constexpr int LAUNCH_REGS = 65536 / THREADS / 8 * 8;
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
static_assert(CONSUMERS == 2 * BM, "a warpgroup of 128 threads owns 64 rows");
static_assert(BK % 8 == 0, "a stage is whole k8 steps");
static_assert(2 * MAX_STAGES * 8 <= BARRIER_BYTES, "barriers");
static_assert(CONSUMERS * CONSUMER_REGS + (THREADS - CONSUMERS) * PRODUCER_REGS <=
                  THREADS * LAUNCH_REGS, "setmaxnreg must not ask for more than the block holds");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ uint32_t tf32(float x) {         // round to nearest, ties away
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// returns once the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    const uint32_t addr = smem_addr(bar);
    uint32_t done = 0;
    while (!done) {
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    }
}

// bytes (a multiple of 16) from device memory to shared memory, completing on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
        ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// programmatic dependent launch: let the next kernel start its prologue;
// wait until the kernels this one depends on have finished and their writes
// are visible
__device__ __forceinline__ void launch_dependents() {
    asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void wait_prerequisites() {
    asm volatile("griddepcontrol.wait;" ::: "memory");
}

// named barrier 1 over the consumer warpgroups (the producers are not in it)
__device__ __forceinline__ void consumers_sync() {
    asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// ties a register to this point: the compiler may not move its uses across
// nor hand it to another value before it (wgmma reads and writes registers
// asynchronously, which the compiler cannot see)
__device__ __forceinline__ void hold(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void hold(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }

// Shared-memory matrix descriptor of a K-major operand without swizzle:
// core matrices of 8 rows x 16 bytes, 128 contiguous bytes each; lbo is the
// byte distance between core matrices neighbouring in K, sbo in N.
__device__ __forceinline__ uint64_t smem_desc(const float* p, uint32_t lbo, uint32_t sbo) {
    return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
           ((uint64_t)(sbo >> 4) << 32);
}

// d (64 x NT, float32, the wgmma accumulator layout) = a (64 x 8 TF32, A
// fragment in registers) * b (8 x NT TF32 in shared memory, descriptor)
// + (scale_d ? d : 0)
template <int NT>
__device__ __forceinline__ void mma_tf32(float (&d)[NT / 2], const uint32_t (&a)[4], uint64_t b,
                                         uint32_t scale_d);

template <>
__device__ __forceinline__ void mma_tf32<8>(float (&d)[4], const uint32_t (&a)[4],
                                             uint64_t b, uint32_t scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3"
        "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_tf32<16>(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t b, uint32_t scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_tf32<32>(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t b, uint32_t scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_tf32<64>(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t b, uint32_t scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_tf32<128>(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t b, uint32_t scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
        "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
          "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

template <>
__device__ __forceinline__ void mma_tf32<200>(float (&d)[100], const uint32_t (&a)[4],
                                             uint64_t b, uint32_t scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %105, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n200k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
        "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
        "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
        "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
        "%98, %99"
        "}, {%100, %101, %102, %103}, %104, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
          "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
          "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]),
          "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]),
          "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
          "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),
          "+f"(d[98]), "+f"(d[99])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// wt (column tiles, K stages, 2, BK, NT) float32: stage (c, s) holds w^T
// for columns [c*NT, (c+1)*NT) and K values [s*BK, (s+1)*BK), first the hi
// plane, then the lo plane, each as core matrices [BK/4][NT/8][8 n][4 k]
// (zero past N and past K).  One thread per column of a core matrix: it
// reads four rows of w (a warp reads 32 consecutive columns of each) and
// writes 16 bytes to each plane (a warp writes 512 contiguous bytes).
template <typename T, int NT>
__global__ void __launch_bounds__(256)
cin_split_w_kernel(const T* __restrict__ w, float* __restrict__ wt, int K, int N, int n_stages,
                   int quads) {
    constexpr int PLANE = BK * NT;
    launch_dependents();                          // the main kernel may start its prologue
    const int q = blockIdx.x * blockDim.x + threadIdx.x;
    if (q >= quads) return;
    const int stage = q / (PLANE / 4), iq = q - stage * (PLANE / 4);
    const int row = iq & 7, g = (iq >> 3) % (NT / 8), kc = (iq >> 3) / (NT / 8);
    const int k = (stage % n_stages) * BK + kc * 4;
    const int n = (stage / n_stages) * NT + g * 8 + row;
    float v[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
        v[kk] = (k + kk < K && n < N) ? to_float(w[(long long)(k + kk) * N + n]) : 0.f;
    float h[4], l[4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
        h[kk] = __uint_as_float(tf32(v[kk]));
        l[kk] = __uint_as_float(tf32(v[kk] - h[kk]));
    }
    float4* dst = reinterpret_cast<float4*>(wt + (long long)stage * 2 * PLANE) + iq;
    dst[0] = make_float4(h[0], h[1], h[2], h[3]);
    dst[PLANE / 4] = make_float4(l[0], l[1], l[2], l[3]);
}

// Copies `rows` rows of `run` contiguous values (one sample's [lo, lo + rows)
// rows of a (B, rows_total, D) tensor, each D long, flattened) into a tile
// [row][r] of stride XS, r = (b, d) - row0; eight loads in flight a thread.
template <typename T>
__device__ __forceinline__ void load_tile(float* tile, const T* __restrict__ src, long long b0,
                                          int nb, int rows_total, int lo, int rows, int D,
                                          long long row0, int tid) {
    constexpr int U = 8;
    const int run = rows * D;
    for (int e0 = tid; e0 < nb * run; e0 += U * CONSUMERS) {
        float v[U];
        int at[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int e = e0 + u * CONSUMERS;
            at[u] = -1;
            if (e < nb * run) {
                const int bb = e / run;
                const int rem = e - bb * run;
                const int hh = rem / D, d = rem - hh * D;
                const long long r = (b0 + bb) * D + d - row0;
                if (r >= 0 && r < BM) {
                    v[u] = to_float(src[((b0 + bb) * rows_total + lo + hh) * D + d]);
                    at[u] = hh * XS + (int)r;
                }
            }
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
            if (at[u] >= 0) tile[at[u]] = v[u];
    }
}

// One block: rows [row0, row0 + BM) x columns [c*NT, (c+1)*NT) x K stages
// [z*per, (z+1)*per).  partial == nullptr: store the result in out;
// otherwise float32 into plane z of partial.  hr: xk rows held in shared
// memory (the most any run of `per` stages spans); stages: the w ring.
template <typename T, int NT>
__global__ void __launch_bounds__(THREADS, 1)
cin_layer_kernel(const T* __restrict__ x0, const T* __restrict__ xk,
                 const float* __restrict__ wt, T* __restrict__ out, float* __restrict__ partial,
                 long long M, int F, int H, int N, int D, int n_stages, int per, int hr,
                 int stages) {
    constexpr int PLANE = BK * NT;
    constexpr int STAGE_FLOATS = 2 * PLANE;
    extern __shared__ __align__(128) unsigned char smem[];
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);
    uint64_t* empty = full + MAX_STAGES;
    float* ring = reinterpret_cast<float*>(smem + BARRIER_BYTES);
    float* xks = ring + stages * STAGE_FLOATS;        // xk rows [h_lo, h_lo + hr) x BM
    float* x0s = xks + hr * XS;                       // x0 rows [0, F) x BM
    float* es = xks;                                  // the result (NT x BM), at the end

    const int tid = threadIdx.x;
    const long long row0 = (long long)blockIdx.x * BM;
    const int c = blockIdx.y;
    const int s_begin = blockIdx.z * per;
    const int n_st = min(n_stages, s_begin + per) - s_begin;
    const int m_begin = s_begin * BK;
    const int h_lo = m_begin / F;

    if (tid == 0) {
        for (int i = 0; i < stages; ++i) {
            mbar_init(&full[i], 1);
            mbar_init(&empty[i], CONSUMERS / 32);         // lane 0 of each consumer warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (tid >= CONSUMERS) {
        // the producer warpgroup: one thread keeps the ring of w stages in flight
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
        if (tid == CONSUMERS) {
            wait_prerequisites();                     // the pre-pass has written the planes
            const float* src = wt + ((long long)c * n_stages + s_begin) * STAGE_FLOATS;
            for (int s = 0; s < n_st; ++s) {
                const int slot = s % stages;
                if (s >= stages) mbar_wait(&empty[slot], ((s / stages) - 1) & 1);
                mbar_expect_tx(&full[slot], STAGE_FLOATS * 4);
                bulk_load(ring + slot * STAGE_FLOATS, src + (long long)s * STAGE_FLOATS,
                          STAGE_FLOATS * 4, &full[slot]);
            }
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
        // x tiles, widened to float: tile row r is (b, d) = divmod(row0 + r, D).
        // Walked in the inputs' order, so consecutive threads read consecutive
        // addresses; rows past M are left unset and never stored.
        const long long row_end = row0 + BM < M ? row0 + BM : M;
        const long long b0 = row0 / D;
        const int nb = (int)((row_end - 1) / D - b0 + 1);     // samples the tile touches
        const int h_end = min(H, h_lo + hr);              // xk rows held: [h_lo, h_end)
        load_tile(xks, xk, b0, nb, H, h_lo, h_end - h_lo, D, row0, tid);
        load_tile(x0s, x0, b0, nb, F, 0, F, D, row0, tid);
        consumers_sync();

        // This thread's A fragment (wgmma .tf32 m64k8, A in registers): rows
        // ra and ra + 8 of its warpgroup's 64, columns tig and tig + 4 of
        // each k8 step: a[0] = (ra, tig), a[1] = (ra + 8, tig),
        // a[2] = (ra, tig + 4), a[3] = (ra + 8, tig + 4).
        const int lane = tid & 31;
        const int ra = (tid >> 7) * 64 + ((tid >> 5) & 3) * 16 + (lane >> 2);
        const int tig = lane & 3;
        int h1 = (m_begin + tig) / F, f1 = (m_begin + tig) - h1 * F;
        int h2 = (m_begin + tig + 4) / F, f2 = (m_begin + tig + 4) - h2 * F;

        // A[r, h*F + f]; 0 past K
        auto product = [&](int h, int f, int r) -> float {
            return h < h_end ? xks[(h - h_lo) * XS + r] * x0s[f * XS + r] : 0.f;
        };
        float acc[NT / 2], total[NT / 2];
#pragma unroll
        for (int i = 0; i < NT / 2; ++i) acc[i] = total[i] = 0.f;
        for (int s = 0; s < n_st; ++s) {
            // this stage's A, split: hi[j] and lo[j] are k8 step j's fragments
            uint32_t a_hi[BK / 8][4], a_lo[BK / 8][4];
#pragma unroll
            for (int j = 0; j < BK / 8; ++j) {
                const float v[4] = {product(h1, f1, ra), product(h1, f1, ra + 8),
                                    product(h2, f2, ra), product(h2, f2, ra + 8)};
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    a_hi[j][i] = tf32(v[i]);
                    a_lo[j][i] = tf32(v[i] - __uint_as_float(a_hi[j][i]));
                }
                f1 += 8;
                while (f1 >= F) { f1 -= F; ++h1; }
                f2 += 8;
                while (f2 >= F) { f2 -= F; ++h2; }
            }
            const int slot = s % stages;
            mbar_wait(&full[slot], (s / stages) & 1);
            const float* b_hi = ring + slot * STAGE_FLOATS;
#pragma unroll
            for (int i = 0; i < NT / 2; ++i) hold(acc[i]);
            wgmma_fence();
#pragma unroll
            for (int j = 0; j < BK / 8; ++j) {
                // k8 step j: core-matrix columns 2j and 2j + 1 of the stage;
                // the stage's first product starts the accumulator from zero
                const uint64_t d_hi = smem_desc(b_hi + j * 8 * NT, NT * 16, 128);
                const uint64_t d_lo = smem_desc(b_hi + PLANE + j * 8 * NT, NT * 16, 128);
                mma_tf32<NT>(acc, a_hi[j], d_lo, j > 0);   // the small terms first
                mma_tf32<NT>(acc, a_lo[j], d_hi, 1);
                mma_tf32<NT>(acc, a_hi[j], d_hi, 1);
            }
            wgmma_commit();
            wgmma_wait_all();
#pragma unroll
            for (int j = 0; j < BK / 8; ++j)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    hold(a_hi[j][i]);
                    hold(a_lo[j][i]);
                }
            if (lane == 0) mbar_arrive(&empty[slot]);
#pragma unroll
            for (int i = 0; i < NT / 2; ++i) {
                hold(acc[i]);
                total[i] += acc[i];
            }
        }
        launch_dependents();                          // the sum of a split may start

        // epilogue: the totals to es[n][r] (over the x tiles), then out
        consumers_sync();
#pragma unroll
        for (int j = 0; j < NT / 8; ++j) {
            const int n = 8 * j + 2 * tig;
            es[n * ES + ra] = total[4 * j];
            es[(n + 1) * ES + ra] = total[4 * j + 1];
            es[n * ES + ra + 8] = total[4 * j + 2];
            es[(n + 1) * ES + ra + 8] = total[4 * j + 3];
        }
        consumers_sync();
        const int n0 = c * NT;
        const int nt = min(NT, N - n0);
        const int run = nt * D;
        float* plane = partial == nullptr ? nullptr : partial + (long long)blockIdx.z * M * N;
        for (int e = tid; e < nb * run; e += CONSUMERS) {
            const int bb = e / run;
            const int rem = e - bb * run;
            const int nl = rem / D, d = rem - nl * D;
            const long long r = (b0 + bb) * D + d - row0;
            if (r < 0 || r >= row_end - row0) continue;
            const long long at = ((b0 + bb) * N + n0 + nl) * D + d;
            const float v = es[nl * ES + r];
            if (plane == nullptr) store(out + at, v);
            else plane[at] = v;
        }
    }
}

// out[e] = the sum over planes z < splits of partial[z][e], in a fixed
// order: G runs of consecutive planes summed side by side (their loads
// issued U at a time), then the G sums in run order; a block of 256 threads
// sums 256 / G elements.  G = min(8, splits / U): a small batch has ~100
// planes and few elements, and summing them one after another took longer
// than the main kernel; with a few planes, one thread an element is best.
constexpr int REDUCE_LOADS = 16;
__host__ __device__ __forceinline__ int reduce_runs(int splits) {
    return splits / REDUCE_LOADS < 1 ? 1 : (splits / REDUCE_LOADS > 8 ? 8 : splits / REDUCE_LOADS);
}

template <typename T>
__global__ void __launch_bounds__(256)
cin_reduce_kernel(const float* __restrict__ partial, T* __restrict__ out, long long numel,
                  int splits) {
    constexpr int U = REDUCE_LOADS;
    __shared__ float sums[256];
    wait_prerequisites();                             // every plane is written
    const int runs = reduce_runs(splits);
    const int width = 256 / runs;                     // elements of this block
    const int g = threadIdx.x / width, i = threadIdx.x - g * width;
    const long long e = (long long)blockIdx.x * width + i;
    const int per = (splits + runs - 1) / runs;
    const int z_end = min(splits, (g + 1) * per);
    float acc = 0.f;
    if (g < runs && e < numel) {
        for (int z0 = g * per; z0 < z_end; z0 += U) {
            float v[U];
#pragma unroll
            for (int u = 0; u < U; ++u) v[u] = z0 + u < z_end ? partial[(z0 + u) * numel + e] : 0.f;
#pragma unroll
            for (int u = 0; u < U; ++u)
                if (z0 + u < z_end) acc += v[u];
        }
    }
    sums[threadIdx.x] = acc;
    __syncthreads();
    if (g == 0 && e < numel) {
        float total = sums[i];
        for (int r = 1; r < runs; ++r) total += sums[r * width + i];
        store(out + e, total);
    }
}

// launches kernel<<<grid, block, smem, stream>>>(args...) as a programmatic
// dependent of the kernel before it on the stream
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid, dim3 block, int smem,
                             cudaStream_t stream, Args... args) {
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr.val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = block;
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename T, int NT>
cudaError_t launch_split_w(const void* w, float* wt, int K, int N, cudaStream_t stream) {
    const int n_stages = (K + BK - 1) / BK;
    const int quads = (N + NT - 1) / NT * n_stages * BK * NT / 4;
    cin_split_w_kernel<T, NT><<<(unsigned)((quads + 255) / 256), 256, 0, stream>>>(
        static_cast<const T*>(w), wt, K, N, n_stages, quads);
    return cudaGetLastError();
}

template <typename T, int NT>
int launch(const void* x0, const void* xk, const void* w, void* out, float* wt, float* partial,
           long long M, int F, int H, int N, int D, int splits, cudaStream_t stream) {
    const int K = H * F;
    const int n_stages = (K + BK - 1) / BK;
    const int per = (n_stages + splits - 1) / splits;
    splits = (n_stages + per - 1) / per;               // no run without a stage
    if (splits == 1) partial = nullptr;
    int hr = 0;                                        // the most xk rows a run spans
    for (int z = 0; z < splits; ++z) {
        const int m_hi = std::min((z + 1) * per * BK, K) - 1;
        hr = std::max(hr, m_hi / F - z * per * BK / F + 1);
    }
    const long long x_floats = std::max((long long)(hr + F) * XS, (long long)NT * ES);
    const long long stage_bytes = 2LL * BK * NT * 4;
    const long long room = SMEM_LIMIT - BARRIER_BYTES - x_floats * 4;
    const int stages = (int)std::min((long long)MAX_STAGES, room / stage_bytes);
    if (stages < MIN_STAGES) return (int)cudaErrorInvalidValue;
    const int smem = (int)(BARRIER_BYTES + stages * stage_bytes + x_floats * 4);
    const int c_tiles = (N + NT - 1) / NT;

    cudaError_t e = launch_split_w<T, NT>(w, wt, K, N, stream);
    if (e != cudaSuccess) return (int)e;
    // once per process (the port drives one card), outside any graph capture
    static const cudaError_t opt_in = cudaFuncSetAttribute(
        cin_layer_kernel<T, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_LIMIT);
    if (opt_in != cudaSuccess) return (int)opt_in;
    const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)c_tiles, (unsigned)splits);
    e = launch_dependent(cin_layer_kernel<T, NT>, grid, dim3(THREADS), smem, stream,
                         static_cast<const T*>(x0), static_cast<const T*>(xk),
                         static_cast<const float*>(wt), static_cast<T*>(out), partial, M, F, H,
                         N, D, n_stages, per, hr, stages);
    if (e != cudaSuccess || partial == nullptr) return (int)e;
    const long long numel = M * N;
    const int width = 256 / reduce_runs(splits);
    e = launch_dependent(cin_reduce_kernel<T>, dim3((unsigned)((numel + width - 1) / width)),
                         dim3(256), 0, stream, static_cast<const float*>(partial),
                         static_cast<T*>(out), numel, splits);
    return (int)e;
}

// the column tile a launch of N columns takes (kernels/cin.py::n_tile)
int n_tile_of(int N) {
    const int tiles = (N + 199) / 200;
    const int need = (N + tiles - 1) / tiles;
    for (int t : N_TILES)
        if (t >= need) return t;
    return 200;
}

template <typename T>
int launch_n(const void* x0, const void* xk, const void* w, void* out, float* wt,
             float* partial, long long M, int F, int H, int N, int D, int splits, int nt,
             cudaStream_t s) {
    switch (nt) {
        case 8: return launch<T, 8>(x0, xk, w, out, wt, partial, M, F, H, N, D, splits, s);
        case 16: return launch<T, 16>(x0, xk, w, out, wt, partial, M, F, H, N, D, splits, s);
        case 32: return launch<T, 32>(x0, xk, w, out, wt, partial, M, F, H, N, D, splits, s);
        case 64: return launch<T, 64>(x0, xk, w, out, wt, partial, M, F, H, N, D, splits, s);
        case 128: return launch<T, 128>(x0, xk, w, out, wt, partial, M, F, H, N, D, splits, s);
        case 200: return launch<T, 200>(x0, xk, w, out, wt, partial, M, F, H, N, D, splits, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <typename T>
int split_w_n(const void* w, float* wt, int K, int N, int nt, cudaStream_t s) {
    switch (nt) {
        case 8: return (int)launch_split_w<T, 8>(w, wt, K, N, s);
        case 16: return (int)launch_split_w<T, 16>(w, wt, K, N, s);
        case 32: return (int)launch_split_w<T, 32>(w, wt, K, N, s);
        case 64: return (int)launch_split_w<T, 64>(w, wt, K, N, s);
        case 128: return (int)launch_split_w<T, 128>(w, wt, K, N, s);
        case 200: return (int)launch_split_w<T, 200>(w, wt, K, N, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  F, H >= 1 (the wrapper checks).
// n_tile: the column tile, n_tile_of(N) (anything else is refused).
// wt: float32 workspace of ceil(N / n_tile) * ceil(H*F / BK) * 2 * BK *
// n_tile values for w's TF32 planes.  splits: how many runs of K stages to
// sum in separate blocks; for splits > 1, partial is a float32 workspace of
// splits * B * N * D values (fewer planes are used when K has fewer stages
// than that).  Returns the error of the first launch CUDA refused, or
// cudaErrorInvalidValue for arguments the kernel does not take (a run's x
// tiles and MIN_STAGES w stages must fit in a block's shared memory).
extern "C" int cin_layer_launch(const void* x0, const void* xk, const void* w, void* out,
                                void* wt, void* partial, int B, int F, int H, int N, int D,
                                int splits, int n_tile, int dtype, void* stream) {
    if (B == 0 || N == 0 || D == 0) return 0;
    if (F < 1 || H < 1 || splits < 1 || n_tile != n_tile_of(N) || wt == nullptr ||
        (splits > 1 && partial == nullptr)) {
        return (int)cudaErrorInvalidValue;
    }
    const long long M = (long long)B * D;
    float* wts = static_cast<float*>(wt);
    float* ws = static_cast<float*>(partial);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) {
        return launch_n<float>(x0, xk, w, out, wts, ws, M, F, H, N, D, splits, n_tile, s);
    }
    if (dtype == 1) {
        return launch_n<__nv_bfloat16>(x0, xk, w, out, wts, ws, M, F, H, N, D, splits, n_tile, s);
    }
    return (int)cudaErrorInvalidValue;
}

// The pre-pass alone, as cin_layer_launch runs it first: w (K, N) into wt's
// hi and lo TF32 planes.  For timing its share of a launch and for checking
// the planes; not a K3 launch.
extern "C" int cin_split_w_launch(const void* w, void* wt, int K, int N, int n_tile, int dtype,
                                  void* stream) {
    if (K == 0 || N == 0) return 0;
    if (n_tile != n_tile_of(N)) return (int)cudaErrorInvalidValue;
    float* wts = static_cast<float*>(wt);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0) return split_w_n<float>(w, wts, K, N, n_tile, s);
    if (dtype == 1) return split_w_n<__nv_bfloat16>(w, wts, K, N, n_tile, s);
    return (int)cudaErrorInvalidValue;
}
