// Flash-decode attention for Hopper (sm_90a): one new token per sequence
// against its KV cache, grouped-query.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::decode_attention:
//     q (B, Hq, D), k/v (B, T, Hkv, D), pos (B,) int32 -> out (B, Hq, D),
//     query head h*G + g reads KV head h (G = Hq / Hkv);
//     s[t] = q . k[t] / sqrt(D) for t < pos[b], -1e30 for the other slots,
//     out = softmax(s) . v;
// and, where the caller asks (a non-null lse), each query head's
// log-sum-exp of s over the valid slots, lse = m + log(l), float32 (B, Hq):
// -inf where pos <= 0 leaves no valid slot.  A cache cut over time is then
// merged from its slices' (out, lse) (kernels/ref.py::merge_decode_attention).
// float32 and bfloat16 storage (q, k, v and out of one type); every
// product, sum and exponential is float32; the result is stored once.
//
// What bounds it: each (b, h) must read K and V up to pos[b] once, and
// does 4*G*D operations for every 2*D*sizeof(T) bytes of a slot: at
// qwen2-0.5b's G = 7, D = 64 in bfloat16 that is 7 operations a byte,
// far below the ~20 a byte at which the CUDA cores' float32 rate would
// take over from the 3.35 TB/s of device memory.  So the kernel is bound
// by the bytes of K and V up to pos, and its design is about streaming
// them at full rate and touching nothing else:
//   - a block takes one (b, h) and all G query heads of h, so K and V are
//     read from device memory once, not once per query head;
//   - tiles of TT slots of K and V are copied into shared memory with
//     16-byte cp.async loads (consecutive threads on consecutive 16-byte
//     chunks of a slot's row), two stages deep: the copy of tile i+1 is in
//     flight while tile i is computed;
//   - scores: thread j owns slot j of the tile and all G heads, q (scaled
//     by 1/sqrt(D)) is read from shared memory as a broadcast;
//   - online softmax in float32: the running max m and sum l of each head
//     are kept identically by every thread, from warp maxima and sums;
//   - P.V: a thread owns 4 columns of D for all G heads over a strided
//     subset of the tile's slots; the subsets are summed once at the end;
//   - tiles at or past pos[b] hold masked slots only and are not read:
//     a masked slot adds exp(-1e30 - m) = 0 once one slot is valid, so the
//     bytes (and the bound) follow pos, not T.  For pos <= 0 every slot
//     is masked and every slot is read: the softmax is then uniform, the
//     result is the mean of V over all T, as the reference gives.
//   - m starts at -1e30, as in the TPU kernel, not at -inf, so that an
//     all-masked row degenerates to that uniform average without NaN.
// Work split: a sequence's slots are cut into runs of run_slots (the
// caller's plan, kernels/decode_attention.py::plan), and block z of the
// grid's third axis reads slots [z*run_slots, (z+1)*run_slots) below n, its
// sequence's slot count.  n comes from pos on the card, so a short sequence
// gets few runs and a long one many, all of one length: the blocks of an
// uneven batch are as long as those of an even one, and a block whose run
// starts at or past n exits at once.  A sequence of one run writes out
// directly.  Else each run writes its unnormalised (m, l, acc) to a float32
// workspace and a second kernel, launched as a programmatic dependent of the
// first (its blocks start while the first kernel's last blocks run, and
// wait for its results), combines them: a block per (b, h, g) and block of
// columns, threads over runs and columns, sums in a fixed order.  No atomics:
// the result does not change from run to run, nor under a CUDA graph's replay.
// Offsets into device memory are 64-bit.  No -use_fast_math.  Tensor-core
// versions with TMA and warp-specialised loads are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;     // the mask value of the TPU kernel and its reference
constexpr int kGPad = 8;           // a slot's probabilities are stored as 8 floats (G <= 8)
constexpr int kCombineThreads = 128;

// Shapes and shared-memory layout of one instantiation.  kernels/
// decode_attention.py keeps a copy of TT (tile_slots) for its plan.
template <typename T, int D, int G>
struct Cfg {
    static constexpr int ESZ = sizeof(T);
    static constexpr int ROW = D * ESZ;                 // bytes of one slot's K (or V) row
    static constexpr int CPR = ROW / 16;                // 16-byte chunks per row
    static constexpr int EPC = 16 / ESZ;                // elements per chunk
    static constexpr int TT = ROW <= 256 ? 128 : 64;    // slots per tile
    static constexpr int THREADS = TT;                  // one slot per thread for the scores
    static constexpr int WARPS = THREADS / 32;
    static constexpr int PITCH = ROW + 16;              // padded row: conflict-free 16-byte reads
    static constexpr int NC = D / 4;                    // 4-column chunks of D for P.V
    static constexpr int RG = THREADS / NC;             // slot subsets for P.V
    static constexpr int STAGE = 2 * TT * PITCH;        // K and V of one tile
    static constexpr int Q_OFF = 2 * STAGE;             // float [G][D]
    static constexpr int P_OFF = Q_OFF + G * D * 4;     // float [TT][kGPad]
    static constexpr int W_OFF = P_OFF + TT * kGPad * 4;  // float [2][WARPS][kGPad]
    static constexpr int R_OFF = W_OFF + 2 * WARPS * kGPad * 4;  // float [RG][G][D]
    static constexpr int SMEM = R_OFF + RG * G * D * 4;
    static_assert(ROW % 16 == 0, "rows are copied in 16-byte chunks");
    static_assert(D % 4 == 0 && RG >= 1, "P.V layout");
    static_assert(G >= 1 && G <= kGPad, "at most 8 query heads per KV head");
    static_assert(THREADS % 32 == 0, "whole warps");
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// the EPC elements of a 16-byte chunk in shared memory, as floats
__device__ __forceinline__ void load_chunk(const unsigned char* p, float* out, float) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load_chunk(const unsigned char* p, float* out, __nv_bfloat16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        out[2 * i] = __uint_as_float(w[i] << 16);           // bfloat16 is the high half of a float
        out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
}

// 4 consecutive elements in shared memory, as floats
__device__ __forceinline__ void load4(const unsigned char* p, float* out, float) {
    load_chunk(p, out, 0.f);
}
__device__ __forceinline__ void load4(const unsigned char* p, float* out, __nv_bfloat16) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    out[0] = __uint_as_float(v.x << 16);
    out[1] = __uint_as_float(v.x & 0xffff0000u);
    out[2] = __uint_as_float(v.y << 16);
    out[3] = __uint_as_float(v.y & 0xffff0000u);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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

// slots sequence b reads: min(pos, T), or all T when pos <= 0 masks every slot
__device__ __forceinline__ int slot_count(int p, int Tlen) { return p <= 0 ? Tlen : min(p, Tlen); }

// Block (b, h, z): KV head h of sequence b, slots [z*run_slots,
// (z+1)*run_slots) below its slot count n.  A sequence of one run writes
// out (and lse, when given).  Otherwise the unnormalised acc (G, D) goes
// to part_acc[b, h, z] and (m, l) of each head to part_ml[b, h, z], for
// z < ceil(n / run_slots).
// Two blocks an SM, as the shared memory of the main path's instantiation
// (bfloat16, D = 64, G = 7: 94 KB) allows: the hint frees the compiler to
// spend registers on the tile loop (136 instead of 94 there, and faster).
template <typename T, int D, int G>
__global__ void __launch_bounds__(Cfg<T, D, G>::THREADS, 2)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ pos,
                        T* __restrict__ out, float* __restrict__ lse,
                        float* __restrict__ part_acc, float* __restrict__ part_ml, int Tlen,
                        int Hkv, int run_slots, int runs) {
    using C = Cfg<T, D, G>;
    // the combine's blocks may be scheduled once every block here has started
    launch_dependents();
    extern __shared__ __align__(16) unsigned char smem[];
    float* qs = reinterpret_cast<float*>(smem + C::Q_OFF);
    float* ps = reinterpret_cast<float*>(smem + C::P_OFF);
    float* wred = reinterpret_cast<float*>(smem + C::W_OFF);   // [0]: maxima, [1]: sums
    float* red = reinterpret_cast<float*>(smem + C::R_OFF);

    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int b = blockIdx.x, h = blockIdx.y, z = blockIdx.z;

    const int p = pos[b];
    const bool all_masked = p <= 0;
    const int n = slot_count(p, Tlen);                     // slots this sequence reads
    if ((long long)z * run_slots >= n) return;             // past its last run
    const int lo = z * run_slots;
    const int hi = (int)min((long long)n, (long long)lo + run_slots);  // slots [lo, hi)
    const bool direct = n <= run_slots;                    // one run: the result goes to out
    const int tiles = (hi - lo + C::TT - 1) / C::TT;

    const long long bh = (long long)b * Hkv + h;
    const long long slot_stride = (long long)Hkv * D;      // elements from slot t to t+1
    const T* kb = k + (long long)b * Tlen * slot_stride + (long long)h * D;
    const T* vb = v + (long long)b * Tlen * slot_stride + (long long)h * D;

    auto load_tile = [&](int tile, int stage) {
        const int t0 = lo + tile * C::TT;
        const int count = min(C::TT, hi - t0);
        unsigned char* ks = smem + stage * C::STAGE;
        unsigned char* vs = ks + C::TT * C::PITCH;
        for (int i = tid; i < C::TT * C::CPR; i += C::THREADS) {
            const int r = i / C::CPR, c = i - r * C::CPR;
            if (r < count) {
                const long long off = (long long)(t0 + r) * slot_stride;
                cp_async16(ks + r * C::PITCH + c * 16,
                           reinterpret_cast<const unsigned char*>(kb + off) + c * 16);
                cp_async16(vs + r * C::PITCH + c * 16,
                           reinterpret_cast<const unsigned char*>(vb + off) + c * 16);
            }
        }
        cp_async_commit();
    };
    // the first tile's copy is in flight while q is staged (the first
    // __syncthreads of the tile loop publishes qs)
    load_tile(0, 0);
    const float inv_sqrt_d = 1.0f / sqrtf((float)D);
    const T* qb = q + bh * G * D;
    for (int i = tid; i < G * D; i += C::THREADS) qs[i] = to_float(qb[i]) * inv_sqrt_d;

    float m[G], l[G];
#pragma unroll
    for (int g = 0; g < G; ++g) { m[g] = kNeg; l[g] = 0.f; }
    const int pc = tid % C::NC;                           // P.V: columns 4*pc .. 4*pc+3
    const int pr = tid / C::NC;                           // P.V: slots pr, pr+RG, ...
    const bool pv = pr < C::RG;
    float acc[G][4];
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[g][e] = 0.f;

    for (int tile = 0; tile < tiles; ++tile) {
        const int stage = tile & 1;
        const int count = min(C::TT, hi - (lo + tile * C::TT));
        cp_async_wait_all();
        // this tile has landed for every thread, and every thread is done
        // with the other stage (the previous tile's P.V) and with ps
        __syncthreads();
        if (tile + 1 < tiles) load_tile(tile + 1, stage ^ 1);
        const unsigned char* ks = smem + stage * C::STAGE;
        const unsigned char* vs = ks + C::TT * C::PITCH;

        // scores of slot tid for the G heads
        float s[G];
        if (tid < count) {
#pragma unroll
            for (int g = 0; g < G; ++g) s[g] = 0.f;
            if (all_masked) {
#pragma unroll
                for (int g = 0; g < G; ++g) s[g] = kNeg;
            } else {
                const unsigned char* krow = ks + tid * C::PITCH;
#pragma unroll
                for (int c = 0; c < C::CPR; ++c) {
                    float kf[C::EPC];
                    load_chunk(krow + c * 16, kf, T());
#pragma unroll
                    for (int e = 0; e < C::EPC; e += 4) {
#pragma unroll
                        for (int g = 0; g < G; ++g) {
                            const float4 qv = *reinterpret_cast<const float4*>(
                                qs + g * D + c * C::EPC + e);
                            float a = s[g];
                            a = fmaf(qv.x, kf[e], a);
                            a = fmaf(qv.y, kf[e + 1], a);
                            a = fmaf(qv.z, kf[e + 2], a);
                            a = fmaf(qv.w, kf[e + 3], a);
                            s[g] = a;
                        }
                    }
                }
            }
        } else {
#pragma unroll
            for (int g = 0; g < G; ++g) s[g] = -INFINITY;   // not a slot of this tile
        }

        // the tile's maximum of each head
#pragma unroll
        for (int g = 0; g < G; ++g) {
            float x = s[g];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
            if (lane == 0) wred[warp * kGPad + g] = x;
        }
        __syncthreads();
        float alpha[G], pslot[kGPad];
#pragma unroll
        for (int g = 0; g < G; ++g) {
            float tmax = wred[g];
#pragma unroll
            for (int w = 1; w < C::WARPS; ++w) tmax = fmaxf(tmax, wred[w * kGPad + g]);
            const float m_new = fmaxf(m[g], tmax);
            alpha[g] = expf(m[g] - m_new);
            m[g] = m_new;
            pslot[g] = expf(s[g] - m_new);                 // 0 for a slot past the tile
        }
#pragma unroll
        for (int g = G; g < kGPad; ++g) pslot[g] = 0.f;
        *reinterpret_cast<float4*>(ps + tid * kGPad) =
            make_float4(pslot[0], pslot[1], pslot[2], pslot[3]);
        *reinterpret_cast<float4*>(ps + tid * kGPad + 4) =
            make_float4(pslot[4], pslot[5], pslot[6], pslot[7]);
        // the tile's sum of each head
        float* wsum = wred + C::WARPS * kGPad;
#pragma unroll
        for (int g = 0; g < G; ++g) {
            float x = pslot[g];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
            if (lane == 0) wsum[warp * kGPad + g] = x;
        }
        __syncthreads();
#pragma unroll
        for (int g = 0; g < G; ++g) {
            float tsum = 0.f;
#pragma unroll
            for (int w = 0; w < C::WARPS; ++w) tsum += wsum[w * kGPad + g];
            l[g] = l[g] * alpha[g] + tsum;
        }

        // acc = acc * alpha + P . V over this thread's slots and columns
        if (pv) {
#pragma unroll
            for (int g = 0; g < G; ++g)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[g][e] *= alpha[g];
            for (int t = pr; t < count; t += C::RG) {
                float vf[4];
                load4(vs + t * C::PITCH + pc * 4 * C::ESZ, vf, T());
                const float4 p0 = *reinterpret_cast<const float4*>(ps + t * kGPad);
                float pt[kGPad] = {p0.x, p0.y, p0.z, p0.w, 0.f, 0.f, 0.f, 0.f};
                if (G > 4) {
                    const float4 p1 = *reinterpret_cast<const float4*>(ps + t * kGPad + 4);
                    pt[4] = p1.x; pt[5] = p1.y; pt[6] = p1.z; pt[7] = p1.w;
                }
#pragma unroll
                for (int g = 0; g < G; ++g)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[g][e] = fmaf(pt[g], vf[e], acc[g][e]);
            }
        }
    }

    // sum the slot subsets of P.V, in subset order
    if (pv) {
#pragma unroll
        for (int g = 0; g < G; ++g)
            *reinterpret_cast<float4*>(red + (pr * G + g) * D + pc * 4) =
                make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
    }
    if (tid == 0) {                                      // l of each head, for every thread
#pragma unroll
        for (int g = 0; g < G; ++g) wred[g] = l[g];
    }
    __syncthreads();
    for (int i = tid; i < G * D; i += C::THREADS) {
        float a = 0.f;
        for (int r = 0; r < C::RG; ++r) a += red[r * G * D + i];
        if (direct) {
            store(out + bh * G * D + i, a / wred[i / D]);
        } else {
            part_acc[(bh * runs + z) * G * D + i] = a;
        }
    }
    if (tid == 0) {
        if (!direct) {
            float* ml = part_ml + (bh * runs + z) * G * 2;
#pragma unroll
            for (int g = 0; g < G; ++g) { ml[2 * g] = m[g]; ml[2 * g + 1] = l[g]; }
        } else if (lse != nullptr) {
#pragma unroll
            for (int g = 0; g < G; ++g) {
                lse[bh * G + g] = all_masked ? -INFINITY : m[g] + logf(l[g]);
            }
        }
    }
}

// out[b, h*G + g, c0:c0+cols] = sum_z w_z acc_z[g, c0:c0+cols] / sum_z w_z l_z[g],
// w_z = exp(m_z[g] - max_z m_z[g]), over the runs z < ceil(n / run_slots)
// of sequences of more than one run; lse[b, h*G + g] = max_z m_z[g] + log of
// the denominator (-inf where pos <= 0), written by thread 0 of the first
// column block when lse is given.  Block (b*Hkv + h, g, c0 / cols);
// threads over runs for the maximum and the denominator, over (run subset,
// 4 columns) for the numerator.  The plan narrows cols where there are many
// runs, so that a thread has at most kPrefetch: their columns are loaded
// together with the maxima, and the block waits on L2 once.  Each sum is
// taken in a fixed order (a thread's runs in order, then a shuffle tree,
// then warps or subsets in order).
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
decode_attention_combine(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                         const int* __restrict__ pos, T* __restrict__ out,
                         float* __restrict__ lse, int Tlen, int Hkv, int G, int D,
                         int run_slots, int runs, int cols) {
    constexpr int kWarps = kCombineThreads / 32;
    constexpr int kPrefetch = 4;
    __shared__ float wred[kWarps];
    __shared__ __align__(16) float red[kCombineThreads * 4];
    const long long bh = blockIdx.x;
    const int g = blockIdx.y, c0 = blockIdx.z * cols;
    // pos was written before the main kernel started, so it may be read
    // before the wait; the wait comes before any exit, so that this grid
    // ends after the main kernel
    const int p = pos[bh / Hkv];
    const int n = slot_count(p, Tlen);
    const int nr = (n + run_slots - 1) / run_slots;
    wait_prerequisites();
    if (nr <= 1) return;                                 // the main kernel wrote out
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const float* ml = part_ml + (bh * runs * G + g) * 2;  // run z: ml[z * G * 2], m then l
    const long long ml_stride = 2LL * G;
    const int ncg = cols / 4, subsets = kCombineThreads / ncg;
    const int c = tid % ncg, r = tid / ncg;               // numerator: runs r, r + subsets, ...
    const float* acc = part_acc + (bh * runs * G + g) * D + c0 + 4 * c;
    const long long acc_stride = (long long)G * D;

    float4 x[kPrefetch];
    float mz[kPrefetch];
#pragma unroll
    for (int j = 0; j < kPrefetch; ++j) {
        const int z = r + j * subsets;
        x[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        mz[j] = kNeg;
        if (r < subsets && z < nr) {
            x[j] = *reinterpret_cast<const float4*>(acc + z * acc_stride);
            mz[j] = ml[z * ml_stride];
        }
    }
    float mx = kNeg;
    for (int z = tid; z < nr; z += kCombineThreads) mx = fmaxf(mx, ml[z * ml_stride]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) wred[warp] = mx;
    __syncthreads();
    mx = wred[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, wred[w]);
    float den = 0.f;
    for (int z = tid; z < nr; z += kCombineThreads) {
        den = fmaf(expf(ml[z * ml_stride] - mx), ml[z * ml_stride + 1], den);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) den += __shfl_xor_sync(0xffffffffu, den, off);
    __syncthreads();                                     // every thread has read the maxima
    if (lane == 0) wred[warp] = den;

    if (r < subsets) {
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
        auto add = [&](float m, float4 v) {
            const float w = expf(m - mx);
            a.x = fmaf(w, v.x, a.x);
            a.y = fmaf(w, v.y, a.y);
            a.z = fmaf(w, v.z, a.z);
            a.w = fmaf(w, v.w, a.w);
        };
#pragma unroll
        for (int j = 0; j < kPrefetch; ++j) {
            if (r + j * subsets < nr) add(mz[j], x[j]);
        }
        for (int z = r + kPrefetch * subsets; z < nr; z += subsets) {
            add(ml[z * ml_stride], *reinterpret_cast<const float4*>(acc + z * acc_stride));
        }
        *reinterpret_cast<float4*>(red + r * cols + 4 * c) = a;
    }
    __syncthreads();
    den = wred[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) den += wred[w];
    T* o = out + (bh * G + g) * D + c0;
    for (int i = tid; i < cols; i += kCombineThreads) {
        float num = 0.f;
        for (int j = 0; j < subsets; ++j) num += red[j * cols + i];
        store(o + i, num / den);
    }
    if (lse != nullptr && blockIdx.z == 0 && tid == 0) {
        lse[bh * G + g] = p <= 0 ? -INFINITY : mx + logf(den);
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

// how a launch is cut: the plan's run length, the runs of a full cache, the
// combine's columns a block
struct Split {
    int run_slots, runs, cols;
};

template <typename T, int D, int G>
int launch(const void* q, const void* k, const void* v, const int* pos, void* out,
           float* lse, float* part_acc, float* part_ml, int B, int Tlen, int Hkv, Split sp,
           cudaStream_t stream) {
    using C = Cfg<T, D, G>;
    auto kernel = decode_attention_kernel<T, D, G>;
    // above 48 KB of shared memory only on request; set once (at a call
    // outside any graph capture: the first call of a process)
    static bool smem_set = false;
    if (!smem_set) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
        if (e != cudaSuccess) return (int)e;
        smem_set = true;
    }
    kernel<<<dim3((unsigned)B, (unsigned)Hkv, (unsigned)sp.runs), C::THREADS, C::SMEM, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), pos,
        static_cast<T*>(out), lse, part_acc, part_ml, Tlen, Hkv, sp.run_slots, sp.runs);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || sp.runs == 1) return (int)e;
    return (int)launch_dependent(decode_attention_combine<T>,
                                 dim3((unsigned)((long long)B * Hkv), (unsigned)G,
                                      (unsigned)(D / sp.cols)),
                                 dim3(kCombineThreads), 0, stream,
                                 (const float*)part_acc, (const float*)part_ml, pos,
                                 static_cast<T*>(out), lse, Tlen, Hkv, G, D, sp.run_slots,
                                 sp.runs, sp.cols);
}

template <typename T, int D>
int launch_g(int G, const void* q, const void* k, const void* v, const int* pos, void* out,
             float* lse, float* pa, float* pm, int B, int Tlen, int Hkv, Split sp,
             cudaStream_t s) {
    switch (G) {
        case 1: return launch<T, D, 1>(q, k, v, pos, out, lse, pa, pm, B, Tlen, Hkv, sp, s);
        case 2: return launch<T, D, 2>(q, k, v, pos, out, lse, pa, pm, B, Tlen, Hkv, sp, s);
        case 4: return launch<T, D, 4>(q, k, v, pos, out, lse, pa, pm, B, Tlen, Hkv, sp, s);
        case 7: return launch<T, D, 7>(q, k, v, pos, out, lse, pa, pm, B, Tlen, Hkv, sp, s);
        case 8: return launch<T, D, 8>(q, k, v, pos, out, lse, pa, pm, B, Tlen, Hkv, sp, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

template <typename T>
int launch_d(int D, int G, const void* q, const void* k, const void* v, const int* pos,
             void* out, float* lse, float* pa, float* pm, int B, int Tlen, int Hkv, Split sp,
             cudaStream_t s) {
    switch (D) {
        case 8: return launch_g<T, 8>(G, q, k, v, pos, out, lse, pa, pm, B, Tlen, Hkv, sp, s);
        case 16: return launch_g<T, 16>(G, q, k, v, pos, out, lse, pa, pm, B, Tlen, Hkv, sp, s);
        case 32: return launch_g<T, 32>(G, q, k, v, pos, out, lse, pa, pm, B, Tlen, Hkv, sp, s);
        case 64: return launch_g<T, 64>(G, q, k, v, pos, out, lse, pa, pm, B, Tlen, Hkv, sp, s);
        case 96: return launch_g<T, 96>(G, q, k, v, pos, out, lse, pa, pm, B, Tlen, Hkv, sp, s);
        case 128: return launch_g<T, 128>(G, q, k, v, pos, out, lse, pa, pm, B, Tlen, Hkv, sp, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  D in {8, 16, 32, 64, 96, 128},
// G = Hq / Hkv in {1, 2, 4, 7, 8}, T >= 1, run_slots >= 1 (the plan's run
// length); q, k, v 16-byte aligned (the wrapper checks).  With
// runs = ceil(T / run_slots) > 1 (at most 65535) the combine is launched
// too, over column blocks of cols (a multiple of 4 that divides D), and
// needs part_acc (B*Hkv*runs*G*D floats) and part_ml (B*Hkv*runs*G*2
// floats).  lse may be null; else it receives (B, Hq) float32 log-sum-exps.
// Returns cudaGetLastError() after the launches.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* pos, void* out, void* lse, void* part_acc,
                                       void* part_ml, int B, int T, int Hkv, int G, int D,
                                       int run_slots, int cols, int dtype, void* stream) {
    if (B == 0) return 0;
    if (T < 1 || Hkv < 1 || run_slots < 1 || cols < 4 || cols % 4 || D % cols) {
        return (int)cudaErrorInvalidValue;
    }
    const int runs = (int)(((long long)T + run_slots - 1) / run_slots);
    if (runs > 65535 || (runs > 1 && (part_acc == nullptr || part_ml == nullptr))) {
        return (int)cudaErrorInvalidValue;
    }
    const int* p = static_cast<const int*>(pos);
    float* pa = static_cast<float*>(part_acc);
    float* pm = static_cast<float*>(part_ml);
    float* ls = static_cast<float*>(lse);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const Split sp{run_slots, runs, cols};
    if (dtype == 0) return launch_d<float>(D, G, q, k, v, p, out, ls, pa, pm, B, T, Hkv, sp, s);
    if (dtype == 1) {
        return launch_d<__nv_bfloat16>(D, G, q, k, v, p, out, ls, pa, pm, B, T, Hkv, sp, s);
    }
    return (int)cudaErrorInvalidValue;
}
