// Copy + checksum transmit kernels for Hopper (sm_90a), with a plain C
// interface loaded through ctypes by ops/transfer.py.
//
// What they replace (the JAX package's Pallas kernels):
//   K1 copy_csum_blocks + fold_blocks
//        incubator_brpc_tpu/ops/transfer.py:77  _copy_csum_kernel            (pallas_call :112)
//        incubator_brpc_tpu/ops/transfer.py:126 _copy_csum_carry_kernel      (pallas_call :176)
//        incubator_brpc_tpu/ops/transfer.py:144 _copy_csum_carry_slot_kernel (pallas_call :202)
//   K2 copy_csum_staged (+ fold_blocks)
//        incubator_brpc_tpu/ops/transfer.py:312 _dma_copy_csum_body          (pallas_call :388)
//
// The function: copy a lane-aligned (m, n) payload and produce the (1, n)
// float32 lane accumulator acc = carry + sum over row blocks b (in block
// order) of the block's column sums.  The frame checksum is sum(acc).
//
// Bound on the card: the copy reads and writes every byte once, so a frame
// of B bytes moves 2B through device memory (64 MB → 128 MB, ≥ 38 us at
// the H100 SXM's 3.35 TB/s).  The additions (one per element) are far
// below the card's rate: these kernels are bound by bytes.  The design
// therefore touches each payload byte exactly once (the copy and the sum
// share one load), keeps the per-block column sums in a scratch of
// m/block_rows rows (1/block_rows of the payload's element count), and
// reads that scratch once in the fold.
//
// Order of additions.  TPU grids run in order and carried acc from block to
// block in VMEM; CUDA blocks run in no order.  So pass 1 writes each row
// block's column sums to partial[block, n], and the fold adds them in block
// order.  Inside a block every column is summed in ONE fixed order, shared
// by K1 and K2 (block_sum_order below): G row groups, group g sums rows
// g, g+G, g+2G, ... in increasing order starting from 0.0f, then the group
// sums are added g = 0, 1, ..., min(G, rows)-1.  That order does not depend
// on the chunking, on the tile width or on the staging, so the whole frame,
// any chunking aligned to block_rows, the out= slot and K2 produce the same
// float32 additions in the same order: their accumulators are bit-equal.

#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>

namespace {

constexpr int G = 8;              // row groups = warps per CTA
constexpr int TC = 128;           // columns per tile: 32 lanes x 4 columns
constexpr int THREADS = G * 32;
constexpr int STAGE_BYTES = 32768;                    // one K2 stage
constexpr int STAGED_SMEM = 2 * STAGE_BYTES + G * TC * 4;

// ---- element types: storage type S and its exact float32 conversion ----
struct F32 { using S = float; static __device__ __forceinline__ float f(S v) { return v; } };
struct F16 { using S = unsigned short; static __device__ __forceinline__ float f(S v) { return __half2float(__ushort_as_half(v)); } };
struct BF16 { using S = unsigned short; static __device__ __forceinline__ float f(S v) { return __bfloat162float(__ushort_as_bfloat16(v)); } };
struct F64 { using S = double; static __device__ __forceinline__ float f(S v) { return __double2float_rn(v); } };
struct U8 { using S = unsigned char; static __device__ __forceinline__ float f(S v) { return __uint2float_rn(v); } };
struct I8 { using S = signed char; static __device__ __forceinline__ float f(S v) { return __int2float_rn(v); } };
struct I16 { using S = short; static __device__ __forceinline__ float f(S v) { return __int2float_rn(v); } };
struct I32 { using S = int; static __device__ __forceinline__ float f(S v) { return __int2float_rn(v); } };
struct I64 { using S = long long; static __device__ __forceinline__ float f(S v) { return __ll2float_rn(v); } };

// four neighbouring columns of one row: one load and one store per lane
template <typename S>
struct alignas(4 * sizeof(S)) V4 { S v[4]; };

template <typename T>
__device__ __forceinline__ void add4(float (&s)[4], const V4<typename T::S>& v) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] += T::f(v.v[i]);
}

// The fixed in-block order, second half: add the G group sums of one
// column in group order.  `red` holds them as red[g * TC + col].
__device__ __forceinline__ float block_sum_order(const float* red, int col, int rows) {
    const int groups = rows < G ? rows : G;
    float t = red[col];
    for (int g = 1; g < groups; ++g) t += red[g * TC + col];
    return t;
}

// ---- K1 pass 1: one CTA per (row block, column tile) --------------------
template <typename T>
__global__ void __launch_bounds__(THREADS)
copy_csum_blocks_kernel(const typename T::S* __restrict__ x, typename T::S* __restrict__ out,
                        float* __restrict__ partial, long long n, int br, int ntiles) {
    using S = typename T::S;
    __shared__ float red[G * TC];
    const int g = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long b = blockIdx.x / ntiles;
    const int tile = blockIdx.x % ntiles;
    const long long col0 = (long long)tile * TC + lane * 4;
    const long long row0 = b * br;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int r = g; r < br; r += G) {
        const long long off = (row0 + r) * n + col0;
        const V4<S> v = *reinterpret_cast<const V4<S>*>(x + off);
        *reinterpret_cast<V4<S>*>(out + off) = v;
        add4<T>(s, v);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) red[g * TC + lane * 4 + i] = s[i];
    __syncthreads();
    if (threadIdx.x < TC) {
        partial[b * n + (long long)tile * TC + threadIdx.x] = block_sum_order(red, threadIdx.x, br);
    }
}

// ---- pass 2: acc = carry; for b in order: acc += partial[b] -------------
__global__ void fold_blocks_kernel(const float* __restrict__ partial, const float* __restrict__ carry,
                                   float* __restrict__ acc, long long nblocks, long long n) {
    const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= n) return;
    float a = carry != nullptr ? carry[c] : 0.0f;
    // the loads are independent: unrolling lets eight be in flight while
    // the additions still run strictly in block order
#pragma unroll 8
    for (long long b = 0; b < nblocks; ++b) a += partial[b * n + c];
    acc[c] = a;
}

// ---- K2: persistent CTAs, tiles staged through a 2-deep cp.async ring ----
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
copy_csum_staged_kernel(const typename T::S* __restrict__ x, typename T::S* __restrict__ out,
                        float* __restrict__ partial, long long n, int br, int sr, int ntiles,
                        long long nitems) {
    // sr: rows per stage, a multiple of G with sr * TC * sizeof(S) <= STAGE_BYTES
    using S = typename T::S;
    extern __shared__ __align__(16) unsigned char smem[];
    float* red = reinterpret_cast<float*>(smem + 2 * STAGE_BYTES);
    constexpr int CPR = TC * (int)sizeof(S) / 16;  // 16-byte chunks per tile row
    const int g = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int spi = (br + sr - 1) / sr;  // stages per work item
    if (blockIdx.x >= nitems) return;
    const long long my_items = (nitems - blockIdx.x + gridDim.x - 1) / gridDim.x;
    const long long steps = my_items * spi;

    // step k of this CTA: work item blockIdx.x + (k / spi) * gridDim.x, stage k % spi
    auto issue = [&](long long k) {
        const long long item = blockIdx.x + (k / spi) * gridDim.x;
        const int st = (int)(k % spi);
        const long long b = item / ntiles;
        const int tile = (int)(item % ntiles);
        const int r0 = st * sr;
        const int rows = min(sr, br - r0);
        unsigned char* dst = smem + (k & 1) * STAGE_BYTES;
        const unsigned char* src = reinterpret_cast<const unsigned char*>(
            x + (b * br + r0) * n + (long long)tile * TC);
        const long long row_bytes = n * (long long)sizeof(S);
        for (int i = threadIdx.x; i < rows * CPR; i += THREADS) {
            const int r = i / CPR, c = i % CPR;
            cp_async16(dst + r * (TC * (int)sizeof(S)) + c * 16, src + r * row_bytes + c * 16);
        }
        cp_async_commit();
    };

    float s[4] = {0.f, 0.f, 0.f, 0.f};
    issue(0);
    for (long long k = 0; k < steps; ++k) {
        if (k + 1 < steps) {
            issue(k + 1);  // pull the next stage while this one is summed
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const long long item = blockIdx.x + (k / spi) * gridDim.x;
        const int st = (int)(k % spi);
        const long long b = item / ntiles;
        const int tile = (int)(item % ntiles);
        const int r0 = st * sr;
        const int rows = min(sr, br - r0);
        const S* buf = reinterpret_cast<const S*>(smem + (k & 1) * STAGE_BYTES);
        if (st == 0) {
#pragma unroll
            for (int i = 0; i < 4; ++i) s[i] = 0.f;
        }
        // r0 is a multiple of G, so local row lr belongs to group lr % G:
        // the same rows, in the same order, as K1's thread for this column
        const long long col0 = (long long)tile * TC + lane * 4;
#pragma unroll 4
        for (int lr = g; lr < rows; lr += G) {
            const V4<S> v = *reinterpret_cast<const V4<S>*>(buf + lr * TC + lane * 4);
            *reinterpret_cast<V4<S>*>(out + (b * br + r0 + lr) * n + col0) = v;
            add4<T>(s, v);
        }
        if (st == spi - 1) {
#pragma unroll
            for (int i = 0; i < 4; ++i) red[g * TC + lane * 4 + i] = s[i];
            __syncthreads();
            if (threadIdx.x < TC) {
                partial[b * n + (long long)tile * TC + threadIdx.x] = block_sum_order(red, threadIdx.x, br);
            }
        }
        __syncthreads();  // this stage's buffer (and red) is free for reuse
    }
}

template <typename T>
int launch_blocks(const void* x, void* out, float* partial, long long m, long long n, int br,
                  cudaStream_t stream) {
    using S = typename T::S;
    const int ntiles = (int)(n / TC);
    const long long grid = (m / br) * ntiles;
    copy_csum_blocks_kernel<T><<<(unsigned)grid, THREADS, 0, stream>>>(
        static_cast<const S*>(x), static_cast<S*>(out), partial, n, br, ntiles);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_staged(const void* x, void* out, float* partial, long long m, long long n, int br,
                  int sr, int grid, cudaStream_t stream) {
    using S = typename T::S;
    if (sr <= 0 || sr % G != 0 || (long long)sr * TC * (long long)sizeof(S) > STAGE_BYTES)
        return (int)cudaErrorInvalidValue;
    // the opt-in above 48 KB holds only for the device current at the call,
    // so it is made before every launch (cheap) rather than once per process
    const cudaError_t e = cudaFuncSetAttribute(copy_csum_staged_kernel<T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, STAGED_SMEM);
    if (e != cudaSuccess) return (int)e;
    const int ntiles = (int)(n / TC);
    const long long nitems = (m / br) * ntiles;
    copy_csum_staged_kernel<T><<<grid, THREADS, STAGED_SMEM, stream>>>(
        static_cast<const S*>(x), static_cast<S*>(out), partial, n, br, sr, ntiles, nitems);
    return (int)cudaGetLastError();
}

}  // namespace

// dtype codes, kept in step with _DTYPE_CODES in ops/transfer.py
#define DISPATCH_DTYPE(code, CALL)      \
    switch (code) {                     \
        case 0: { using T = F32; return CALL; }  \
        case 1: { using T = F16; return CALL; }  \
        case 2: { using T = BF16; return CALL; } \
        case 3: { using T = F64; return CALL; }  \
        case 4: { using T = U8; return CALL; }   \
        case 5: { using T = I8; return CALL; }   \
        case 6: { using T = I16; return CALL; }  \
        case 7: { using T = I32; return CALL; }  \
        case 8: { using T = I64; return CALL; }  \
        default: return (int)cudaErrorInvalidValue; \
    }

extern "C" {

// K1 pass 1: x, out (m, n) of dtype `code`, contiguous; partial (m/br, n) f32.
int copy_csum_blocks(const void* x, void* out, void* partial, long long m, long long n, int br,
                     int code, void* stream) {
    DISPATCH_DTYPE(code, launch_blocks<T>(x, out, static_cast<float*>(partial), m, n, br,
                                          static_cast<cudaStream_t>(stream)))
}

// pass 2: acc (n) = carry (n, or NULL for zeros) + partial rows 0..nblocks-1 in order.
int fold_blocks(const void* partial, const void* carry, void* acc, long long nblocks, long long n,
                void* stream) {
    // narrow CTAs: a 2048-lane accumulator spreads over 16 SMs, not 8
    const unsigned grid = (unsigned)((n + 127) / 128);
    fold_blocks_kernel<<<grid, 128, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(partial), static_cast<const float*>(carry), static_cast<float*>(acc),
        nblocks, n);
    return (int)cudaGetLastError();
}

// K2: same contract as copy_csum_blocks, one launch of `grid` persistent CTAs
// staging `sr` rows of a column tile at a time.
int copy_csum_staged(const void* x, void* out, void* partial, long long m, long long n, int br,
                     int sr, int code, int grid, void* stream) {
    DISPATCH_DTYPE(code, launch_staged<T>(x, out, static_cast<float*>(partial), m, n, br, sr, grid,
                                          static_cast<cudaStream_t>(stream)))
}

const char* transfer_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
