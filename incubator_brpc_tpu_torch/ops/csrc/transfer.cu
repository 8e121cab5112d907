// Copy + checksum transmit kernels for Hopper (sm_90a), with a plain C
// interface loaded through ctypes by ops/transfer.py.
//
// What they replace (the JAX package's Pallas kernels):
//   K1 copy_csum_blocks
//        incubator_brpc_tpu/ops/transfer.py:77  _copy_csum_kernel            (pallas_call :112)
//        incubator_brpc_tpu/ops/transfer.py:126 _copy_csum_carry_kernel      (pallas_call :176)
//        incubator_brpc_tpu/ops/transfer.py:144 _copy_csum_carry_slot_kernel (pallas_call :202)
//   K2 copy_csum_staged
//        incubator_brpc_tpu/ops/transfer.py:312 _dma_copy_csum_body          (pallas_call :388)
//   copy_blocks
//        incubator_brpc_tpu/ops/transfer.py:54  _copy_kernel                 (pallas_call :68)
//
// The function: copy a lane-aligned (m, n) payload and produce the (1, n)
// float32 lane accumulator acc = carry + sum over row blocks b (in block
// order) of the block's column sums.  The frame checksum is sum(acc).
//
// Bound on the card: the copy reads and writes every byte once, so a frame
// of B bytes moves 2B through device memory (64 MB → 128 MB, ≥ 38 us at
// the H100 SXM's 3.35 TB/s; one 8 MB chunk ≥ 5 us).  The additions (one per
// element) are far below the card's rate: these kernels are bound by
// bytes.  The design therefore touches each payload byte exactly once (the
// copy and the sum share one load) and keeps the per-block column sums in a
// scratch of m/block_rows rows (1/block_rows of the payload's elements).
//
// Order of additions.  TPU grids run in order and carried acc from block to
// block in VMEM; CUDA blocks run in no order.  So each CTA writes its row
// block's column sums to partial[block, n], and the fold adds them in block
// order onto the carry.  Inside a block every column is summed in ONE fixed
// order, shared by K1 and K2 (block_sum_order below): G row groups, group g
// sums rows g, g+G, g+2G, ... in increasing order starting from 0.0f, then
// the group sums are added g = 0, 1, ..., min(G, rows)-1.  That order does
// not depend on the chunking, on the tile width, on the load depth or on
// the staging, so the whole frame, any chunking aligned to block_rows, the
// out= slot and K2 produce the same float32 additions in the same order:
// their accumulators are bit-equal (and equal to ops/transfer.py's plain
// version, which adds in this order too).
//
// The fold is the kernels' tail, not a launch of its own (on an H100 a
// launch of its own took ~1.7 us for ~0.1 us of bytes).  A K1 CTA writes
// its (block, column tile) partial; after a barrier one thread fences and
// bumps that tile's arrival counter; the CTA whose arrival completes the
// count (nblocks arrivals) reads the tile's partials through L2
// (ld.global.cg), adds them onto the carry in block order, writes acc and
// resets the counter to 0 for the next launch on the stream (K2 does the
// same a warp's slice of a tile at a time, below).  The counters
// belong to ops/transfer.py (one zeroed int32 buffer per device and stream).
//
// K2 and copy_blocks move their bytes on Hopper's bulk-copy engine (the
// Tensor Memory Accelerator), as the TPU kernels move theirs on the TPU's
// DMA engine: HBM -> shared memory -> HBM, no payload byte passing through
// a register.  Each persistent CTA keeps a ring of shared-memory stages,
// driven by one thread of a load warp and one of a store warp.  The load
// thread issues each stage's load (cp.async.bulk[.tensor], its bytes
// completing the stage's "full" mbarrier) as soon as the stage's slot is
// released on its "empty" mbarrier; the store thread, once a stage has
// landed, issues the bulk store of the same stage to `out` (one bulk
// group), and releases the slot when that store has read it
// (cp.async.bulk.wait_group.read, a few stores behind).  In K2 the
// summing warps release each stage too.
//
// K2's tiles are sized in bytes, not elements: a column tile is TILE_BYTES
// (512) of a row whatever the dtype (128 f32, 256 bf16/f16/i16, 512 u8/i8,
// 64 f64/i64 columns), and a lane reads 16 bytes of a stage row for the
// sum.  A stage is at most STAGE_BYTES of one tile: whole row groups (64
// rows), or the whole block when the block has fewer than 8 rows.  So
// every dtype moves the same bytes a stage, and the (32, 1048576) u8 stack
// is 2048 (block, tile) items of 16 KB where 128-column tiles made 8192 of
// 4 KB.  The tensor map sees the payload as (nblocks, block rows, row
// words) of 8-byte words, whatever its dtype: a box is one tile's 64 words
// x the stage's rows x one block, so a box that runs past its block's rows
// or past a ragged row's end (384-byte u8 rows, one 512-byte tile) is
// clipped by the engine: zeros come in, nothing goes out, and the sum
// never writes a column beyond n.  (The TPU kernel's DMA is 2D; the third
// dimension is what lets a box stop at its block's last row.)  Eight summing warps (warp g is row
// group g) wait only on a stage's mbarrier; they meet once per (block,
// tile) item, on a named barrier, to add their group sums in group order
// (two buffers of group sums, so that one barrier an item is enough).
// Then each warp publishes its slice of the item's columns and counts its
// own arrival (counter tile * G + g); the warp that completes a slice's
// count folds it.  A frame of one row block writes acc = 0 + block sum
// directly: the fold of one block onto a zero carry, without the counter.
//
// copy_blocks is the same ring without the sum: one thread a CTA, an
// equal share of the payload a CTA, 1D bulk copies of COPY_CHUNK bytes.
// Both take evict-first L2 hints: every payload byte is read once and
// written once.
//
// K1's tiling: one CTA per (row block, 64-column tile), 8 row groups x 16
// lanes of 4 columns, each thread loading all of its group's rows of the
// block (32 of a 256-row block; 16 for 8-byte types) before it stores and
// adds them.  One 8 MB (1024, 2048) f32 chunk is then 4 x 32 = 128 CTAs
// with the whole chunk's loads in flight at once.  With 128-column tiles
// and 4 rows in flight a thread, the same chunk is 64 CTAs on a 132-SM
// card, 1 MB in flight and eight round trips to memory per thread.  Of
// the tile widths 32, 64 and 128, each with 4 rows or all of them in
// flight, this one was the fastest or level on the chunk, on the 64 MB
// frame and on the parameter server's (6144, 6144) W on an H100
// (PERF.md), so every shape takes it.

#include <cuda.h>  // CUtensorMap and its encoder's types (the entry point is fetched at run time)
#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <climits>
#include <cstdint>
#include <cstring>

namespace {

constexpr int G = 8;              // row groups
constexpr int K1_TW = 64;         // K1's column tile: 16 lanes x 4 columns
constexpr int K1_THREADS = G * K1_TW / 4;
constexpr int FOLD_DEPTH = 16;    // partial loads in flight in the fold tail

// The bulk-copy rings of K2 and copy_blocks (ops/transfer.py mirrors the
// sizes and the CTAs an SM).  Stages, their bytes, CTAs an SM, store lags
// and L2 policies were chosen by timing variants on an H100
// (chip_smoke.py --tune; PERF.md).
constexpr int STAGES = 6;                        // K2's shared-memory stages a CTA
constexpr int STAGED_CTAS_PER_SM = 1;            // K2's persistent CTAs an SM
constexpr int TILE_BYTES = 512;                  // K2's column tile, any dtype
constexpr int TILE_WORDS = TILE_BYTES / 8;       // ... in the tensor map's 8-byte words
constexpr int STAGE_BYTES = 32768;               // one K2 stage: at most 64 rows of a tile
constexpr int STORE_LAG = 1;                     // K2's stores whose reads may be pending
constexpr int CONSUMERS = G * 32;                // K2's summing warps, warp g row group g
constexpr int STAGED_THREADS = CONSUMERS + 64;   // ... a store warp and a load warp
constexpr int RED_FLOATS = G * TILE_BYTES;       // one item's group sums (u8: 512 columns)
constexpr int SMEM_ALIGN = 1024;                 // slack to align the stages
constexpr int STAGED_SMEM = SMEM_ALIGN + STAGES * STAGE_BYTES + 2 * RED_FLOATS * 4 + 2 * STAGES * 8;
constexpr int COPY_STAGES = 12;                  // copy_blocks' stages a CTA
constexpr int COPY_CHUNK = 16384;                // one copy_blocks bulk copy
constexpr int COPY_CTAS_PER_SM = 1;              // copy_blocks' persistent CTAs an SM
constexpr int COPY_STORE_LAG = 2;                // copy_blocks' stores whose reads may be pending
constexpr int COPY_SMEM = SMEM_ALIGN + COPY_STAGES * COPY_CHUNK + 2 * COPY_STAGES * 8;
constexpr int LOAD_EVICT = 1;                    // L2 policy of the bulk loads: 0 normal, 1 first, 2 last
constexpr int STORE_EVICT = 1;                   // ... of the bulk stores
constexpr long long WAIT_LIMIT = 1LL << 35;      // cycles (~17 s): a lost phase traps, not hangs

// codes of ours beside cudaError_t's (transfer_error_string names them)
constexpr int ERR_NO_ENCODER = 10000;  // libcuda offers no cuTensorMapEncodeTiled
constexpr int ERR_ENCODE = 20000;      // + the CUresult cuTensorMapEncodeTiled returned

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

// K1's loads and stores of four neighbouring columns, with the streaming
// cache hint (ld/st.global.cs, evict first): K1 touches each payload byte
// once.  Done in the 4-, 8- or 16-byte words that __ldcs and __stcs take.
// (Plain loads and stores made the 64 MB frame 30% slower on an H100:
// PERF.md.)
template <typename S>
__device__ __forceinline__ V4<S> load_stream(const S* p) {
    V4<S> v;
    if constexpr (sizeof(V4<S>) == 4) {
        *reinterpret_cast<unsigned*>(&v) = __ldcs(reinterpret_cast<const unsigned*>(p));
    } else if constexpr (sizeof(V4<S>) == 8) {
        *reinterpret_cast<uint2*>(&v) = __ldcs(reinterpret_cast<const uint2*>(p));
    } else {
#pragma unroll
        for (int i = 0; i < (int)sizeof(V4<S>) / 16; ++i)
            reinterpret_cast<uint4*>(&v)[i] = __ldcs(reinterpret_cast<const uint4*>(p) + i);
    }
    return v;
}

template <typename S>
__device__ __forceinline__ void store_stream(S* p, const V4<S>& v) {
    if constexpr (sizeof(V4<S>) == 4) {
        __stcs(reinterpret_cast<unsigned*>(p), *reinterpret_cast<const unsigned*>(&v));
    } else if constexpr (sizeof(V4<S>) == 8) {
        __stcs(reinterpret_cast<uint2*>(p), *reinterpret_cast<const uint2*>(&v));
    } else {
#pragma unroll
        for (int i = 0; i < (int)sizeof(V4<S>) / 16; ++i)
            __stcs(reinterpret_cast<uint4*>(p) + i, reinterpret_cast<const uint4*>(&v)[i]);
    }
}

template <typename T>
__device__ __forceinline__ void add4(float (&s)[4], const V4<typename T::S>& v) {
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i] += T::f(v.v[i]);
}

// The fixed in-block order, second half: add the G group sums of one
// column in group order.  `red` holds them as red[g * tw + col].
__device__ __forceinline__ float block_sum_order(const float* red, int col, int rows, int tw) {
    const int groups = rows < G ? rows : G;
    float t = red[col];
    for (int g = 1; g < groups; ++g) t += red[g * tw + col];
    return t;
}

// The fold of one column: acc = carry (or 0) + p[0], p[n], ... in block
// order.  The loads are independent, FOLD_DEPTH of them in flight; the
// additions run strictly in block order, as in a fold of its own.  (A
// predicated full round in place of the serial remainder made K2 slower.)
__device__ __forceinline__ void fold_tile(const float* p, const float* carry, float* acc,
                                          long long n, long long nblocks) {
    float a = carry != nullptr ? *carry : 0.0f;
    long long k = 0;
    for (; k + FOLD_DEPTH <= nblocks; k += FOLD_DEPTH) {
        float v[FOLD_DEPTH];
#pragma unroll
        for (int i = 0; i < FOLD_DEPTH; ++i) v[i] = __ldcg(p + (k + i) * n);
#pragma unroll
        for (int i = 0; i < FOLD_DEPTH; ++i) a += v[i];
    }
    for (; k < nblocks; ++k) a += __ldcg(p + k * n);
    *acc = a;
}

// The tail shared by K1 and K2, run by every thread of the CTA once `red`
// holds the group sums of row block b, column tile `tile` (tw columns):
// publish the block's column sums, count the arrival, and when it is the
// tile's last, fold the tile: acc = carry (or 0) + partial[0..nblocks-1].
__device__ __forceinline__ void finish_tile(const float* red, int rows, int tw, long long b, int tile,
                                            long long n, long long nblocks, float* partial,
                                            const float* carry, float* acc, int* counters) {
    __shared__ int last;
    const long long c = (long long)tile * tw + threadIdx.x;
    if (threadIdx.x < tw) partial[b * n + c] = block_sum_order(red, threadIdx.x, rows, tw);
    __syncthreads();
    if (threadIdx.x == 0) {
        // release: the barrier orders the CTA's partial stores before this
        // fence, the fence before the arrival (the pattern of a grid sync)
        __threadfence();
        const int prev = atomicAdd(counters + tile, 1);
        last = prev == nblocks - 1;
        if (last) {
            counters[tile] = 0;  // every arrival is in: ready for the next launch
            __threadfence();     // acquire: the other CTAs' partials are read after it
        }
    }
    __syncthreads();
    if (!last || threadIdx.x >= tw) return;
    fold_tile(partial + c, carry != nullptr ? carry + c : nullptr, acc + c, n, nblocks);
}

// One round of a K1 thread: rows r = base, base+G, ... (D of them, those
// below br when GUARD), all loaded before the first is stored and added,
// so that D loads are in flight.  The pointers advance a row group at a
// time rather than holding D addresses.
template <typename T, int D, bool GUARD>
__device__ __forceinline__ void copy_rows(const typename T::S* src, typename T::S* dst,
                                          long long step, int base, int br, float (&s)[4]) {
    using S = typename T::S;
    V4<S> v[D];
#pragma unroll
    for (int k = 0; k < D; ++k, src += step)
        if (!GUARD || base + k * G < br) v[k] = load_stream<S>(src);
#pragma unroll
    for (int k = 0; k < D; ++k, dst += step) {
        if (!GUARD || base + k * G < br) {
            store_stream<S>(dst, v[k]);
            add4<T>(s, v[k]);
        }
    }
}

// ---- K1: one CTA per (row block, column tile of K1_TW columns) -----------
template <typename T>
__global__ void __launch_bounds__(K1_THREADS)
copy_csum_blocks_kernel(const typename T::S* __restrict__ x, typename T::S* __restrict__ out,
                        float* __restrict__ partial, const float* __restrict__ carry,
                        float* __restrict__ acc, int* __restrict__ counters, long long n, int br,
                        int ntiles, long long nblocks) {
    // rows a thread keeps in flight: its group's whole share of a 256-row
    // block (32), or 16 for 8-byte types, so the loads fit in 128 registers
    constexpr int D = sizeof(typename T::S) == 8 ? 16 : 32;
    constexpr int lanes = K1_TW / 4;  // threads across one row of the tile
    __shared__ float red[G * K1_TW];
    const int g = threadIdx.x / lanes, l = threadIdx.x % lanes;
    const long long b = blockIdx.x / ntiles;
    const int tile = blockIdx.x % ntiles;
    const long long off0 = b * br * n + (long long)tile * K1_TW + l * 4;
    const long long step = G * n;  // one row group down
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int base = g; base < br; base += G * D) {
        const long long off = off0 + base * n;
        if (base + (D - 1) * G < br)  // a full round: no row needs its guard
            copy_rows<T, D, false>(x + off, out + off, step, base, br, s);
        else
            copy_rows<T, D, true>(x + off, out + off, step, base, br, s);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) red[g * K1_TW + l * 4 + i] = s[i];
    __syncthreads();
    finish_tile(red, br, K1_TW, b, tile, n, nblocks, partial, carry, acc, counters);
}

// ---- the bulk-copy engine: mbarriers, bulk loads and stores -------------
__device__ __forceinline__ unsigned smem_addr(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned char* align_smem(unsigned char* p) {
    return reinterpret_cast<unsigned char*>(
        (reinterpret_cast<uintptr_t>(p) + SMEM_ALIGN - 1) & ~(uintptr_t)(SMEM_ALIGN - 1));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
                 "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(unsigned bar, unsigned parity) {
    unsigned done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    return done != 0;
}

// Wait for the phase of `parity` to complete.  A phase that never
// completes (a parity or reuse fault) traps after WAIT_LIMIT cycles, so
// the launch fails where a spin would hang the card.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
    const unsigned a = smem_addr(bar);
    if (mbar_try_wait(a, parity)) return;
    const long long t0 = clock64();
    while (!mbar_try_wait(a, parity))
        if (clock64() - t0 > WAIT_LIMIT) __trap();
}

template <int E>
__device__ __forceinline__ unsigned long long l2_policy() {
    unsigned long long policy;
    if constexpr (E == 1)
        asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
    else if constexpr (E == 2)
        asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n" : "=l"(policy));
    else
        asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;\n" : "=l"(policy));
    return policy;
}

// the engine's reads of shared memory follow what this thread saw land
__device__ __forceinline__ void fence_async_smem() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                         unsigned long long* bar, unsigned long long policy) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
        " [%0], [%1, {%2, %3, %4}], [%5], %6;\n"
        ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
          "r"(smem_addr(bar)), "l"(policy)
        : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0, int c1,
                                          int c2, unsigned long long policy) {
    asm volatile(
        "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group.L2::cache_hint"
        " [%0, {%2, %3, %4}], [%1], %5;\n"
        ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)), "r"(c0), "r"(c1), "r"(c2),
          "l"(policy)
        : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar, unsigned long long policy) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
        " [%0], [%1], %2, [%3], %4;\n"
        ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)), "l"(policy)
        : "memory");
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src, unsigned bytes,
                                           unsigned long long policy) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint [%0], [%1], %2, %3;\n"
                 ::"l"(dst), "r"(smem_addr(src)), "r"(bytes), "l"(policy)
                 : "memory");
}

__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void bulk_wait_read() {
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bulk_wait_all() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// The ring of R slots, driven by two threads in two warps of their own.
// The load thread fills slot k % R with step k (load(k): expect_tx and the
// bulk load, completing on full[slot]) once the slot's step k - R has been
// released on empty[slot] by all its readers.  The store thread waits for
// step k to land, stores the slot back out (store(k), one bulk group) and,
// once step k - LAG's store has read its slot, releases that slot.  So up
// to LAG + 1 stores and R - LAG - 1 loads are in flight.
template <int R>
__device__ __forceinline__ int ring_parity(int k) { return (k / R) & 1; }

template <int R, class Load>
__device__ __forceinline__ void ring_loads(int steps, unsigned long long* empty, Load load) {
    for (int k = 0; k < steps; ++k) {
        if (k >= R) mbar_wait(empty + k % R, (unsigned)ring_parity<R>(k - R));
        load(k);
    }
}

template <int R, int LAG, class Store>
__device__ __forceinline__ void ring_stores(int steps, unsigned long long* full, unsigned long long* empty,
                                            Store store) {
    for (int k = 0; k < steps; ++k) {
        mbar_wait(full + k % R, (unsigned)ring_parity<R>(k));
        fence_async_smem();
        store(k);
        bulk_commit();
        if (k >= LAG) {
            bulk_wait_read<LAG>();
            mbar_arrive(empty + (k - LAG) % R);
        }
    }
    bulk_wait_all();  // every store done before the CTA's shared memory goes
}

// ---- K2: persistent CTAs, a TMA ring of byte-sized tiles -----------------
// A lane's 16 bytes of one stage row, added column by column onto s.
template <typename T>
__device__ __forceinline__ void add16(float (&s)[16 / sizeof(typename T::S)], const uint4& w) {
    using S = typename T::S;
    constexpr int V = 16 / (int)sizeof(S);
    S v[V];
    memcpy(v, &w, 16);
#pragma unroll
    for (int i = 0; i < V; ++i) s[i] += T::f(v[i]);
}

// u8 and i8 without the conversion unit (16 results a clock an SM): the
// float with bits 0x4B000000 | b is 2^23 + b exactly, so subtracting 2^23
// leaves b exactly, the value __uint2float_rn gives; an i8 is biased by 128
// (its sign bit flipped) and 2^23 + 128 subtracted.
template <>
__device__ __forceinline__ void add16<U8>(float (&s)[16], const uint4& w) {
    const unsigned q[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 16; ++i)
        s[i] += __int_as_float(__byte_perm(q[i / 4], 0x4B000000u, 0x7540 + i % 4)) - 8388608.0f;
}

template <>
__device__ __forceinline__ void add16<I8>(float (&s)[16], const uint4& w) {
    const unsigned q[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u, w.z ^ 0x80808080u, w.w ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 16; ++i)
        s[i] += __int_as_float(__byte_perm(q[i / 4], 0x4B000000u, 0x7540 + i % 4)) - 8388736.0f;
}

__device__ __forceinline__ void consumers_sync() {
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS) : "memory");
}

// The tail of one (block b, tile) item, run by every summing thread once
// `red` holds the item's group sums (red[g * TW + col]).  Thread t takes
// the tile's columns t, t + CONSUMERS, ... below n, so warp g owns the same
// slice of every block's tile.  One block: acc = 0 + block sum (the fold
// of one block onto a zero carry).  Else the block sums go to partial, and
// each warp with columns counts its arrival on counter tile * G + g; the
// warp completing that count folds its slice in block order.
template <int TW>
__device__ __forceinline__ void finish_item(const float* red, int br, long long b, int tile, long long n,
                                            long long nblocks, float* partial, float* acc,
                                            int* counters) {
    constexpr int PER = (TW + CONSUMERS - 1) / CONSUMERS;
    const long long col0 = (long long)tile * TW;
    bool mine = false;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
        const int c = threadIdx.x + j * CONSUMERS;
        if (c < TW && col0 + c < n) {
            const float t = block_sum_order(red, c, br, TW);
            if (nblocks == 1)
                acc[col0 + c] = 0.0f + t;
            else
                partial[b * n + col0 + c] = t;
            mine = true;
        }
    }
    if (nblocks == 1 || !__any_sync(0xffffffffu, mine)) return;
    const int slice = tile * G + (threadIdx.x >> 5);
    int last = 0;
    __syncwarp();
    if ((threadIdx.x & 31) == 0) {
        // release: the warp barrier orders its lanes' partial stores
        // before this fence, the fence before the arrival
        __threadfence();
        const int prev = atomicAdd(counters + slice, 1);
        last = prev == nblocks - 1;
        if (last) {
            counters[slice] = 0;  // every arrival is in: ready for the next launch
            __threadfence();      // acquire: the other CTAs' partials are read after it
        }
    }
    last = __shfl_sync(0xffffffffu, last, 0);
    __syncwarp();
    if (!last) return;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
        const int c = threadIdx.x + j * CONSUMERS;
        if (c < TW && col0 + c < n)
            fold_tile(partial + col0 + c, nullptr, acc + col0 + c, n, nblocks);
    }
}

template <typename T>
__global__ void __launch_bounds__(STAGED_THREADS, STAGED_CTAS_PER_SM)
copy_csum_staged_kernel(const __grid_constant__ CUtensorMap in_map,
                        const __grid_constant__ CUtensorMap out_map, float* __restrict__ partial,
                        float* __restrict__ acc, int* __restrict__ counters, long long n, int br,
                        int sr, int ntiles, int nitems) {
    // sr: rows a stage, whole row groups (or br when br < G), sr * TILE_BYTES <= STAGE_BYTES
    using S = typename T::S;
    constexpr int TW = TILE_BYTES / (int)sizeof(S);  // columns of a tile
    constexpr int V = 16 / (int)sizeof(S);           // columns of a lane
    extern __shared__ unsigned char smem_raw[];
    unsigned char* stages = align_smem(smem_raw);
    float* red = reinterpret_cast<float*>(stages + STAGES * STAGE_BYTES);  // 2 x RED_FLOATS
    unsigned long long* full = reinterpret_cast<unsigned long long*>(red + 2 * RED_FLOATS);
    unsigned long long* empty = full + STAGES;
    // a CTA without work returns before its first arrival: the tiles'
    // counts are of work items, not of CTAs
    if ((int)blockIdx.x >= nitems) return;
    const int spi = (br + sr - 1) / sr;  // stages a work item
    const long long nblocks = nitems / ntiles;
    const int steps = (nitems - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x * spi;
    if (threadIdx.x == 0) {
        for (int i = 0; i < STAGES; ++i) {
            mbar_init(full + i, 1);       // the load's expect_tx; the bytes complete it
            mbar_init(empty + i, G + 1);  // a release by each summing warp and the store
        }
        mbar_fence_init();
    }
    __syncthreads();
    // step k of this CTA: work item blockIdx.x + (k / spi) * gridDim.x, stage k % spi
    auto item_of = [&](int k) { return (int)blockIdx.x + (k / spi) * (int)gridDim.x; };
    auto box = [&](int k, int& c0, int& c1, int& c2) {
        const int item = item_of(k);
        c0 = (item % ntiles) * TILE_WORDS;
        c1 = (k % spi) * sr;
        c2 = item / ntiles;
    };
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    if (warp >= G) {  // the store warp and the load warp: one thread each drives the engine
        if (lane != 0) return;
        if (warp == G) {
            const unsigned long long policy = l2_policy<STORE_EVICT>();
            ring_stores<STAGES, STORE_LAG>(steps, full, empty, [&](int k) {
                int c0, c1, c2;
                box(k, c0, c1, c2);
                tma_store(&out_map, stages + (k % STAGES) * STAGE_BYTES, c0, c1, c2, policy);
            });
        } else {
            const unsigned long long policy = l2_policy<LOAD_EVICT>();
            const unsigned box_bytes = (unsigned)sr * TILE_BYTES;  // clipped parts arrive as zeros
            ring_loads<STAGES>(steps, empty, [&](int k) {
                int c0, c1, c2;
                box(k, c0, c1, c2);
                mbar_expect_tx(full + k % STAGES, box_bytes);
                tma_load(stages + (k % STAGES) * STAGE_BYTES, &in_map, c0, c1, c2, full + k % STAGES,
                         policy);
            });
        }
        return;
    }

    // the summing warps; r0 below is a multiple of G, so a stage's local
    // row lr is block row group lr % G: warp g adds the same rows, in the
    // same order, as K1's thread for these columns
    const int g = warp;
    float s[V];
    int buf = 0;  // which of the two group-sum buffers this item fills
    for (int k = 0; k < steps; ++k) {
        const int st = k % spi;
        const int rows = min(sr, br - st * sr);
        if (st == 0) {
#pragma unroll
            for (int i = 0; i < V; ++i) s[i] = 0.f;
        }
        mbar_wait(full + k % STAGES, (unsigned)ring_parity<STAGES>(k));
        const unsigned char* col = stages + (k % STAGES) * STAGE_BYTES + lane * 16;
#pragma unroll 4
        for (int lr = g; lr < rows; lr += G)
            add16<T>(s, *reinterpret_cast<const uint4*>(col + lr * TILE_BYTES));
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + k % STAGES);  // this warp is done with the stage
        if (st == spi - 1) {  // uniform across the summing warps
            float* r = red + buf * RED_FLOATS;
#pragma unroll
            for (int i = 0; i < V; ++i) r[g * TW + lane * V + i] = s[i];
            consumers_sync();
            const int item = item_of(k);
            finish_item<TW>(r, br, item / ntiles, item % ntiles, n, nblocks, partial, acc, counters);
            buf ^= 1;
        }
    }
}

template <typename T>
int launch_blocks(const void* x, void* out, float* partial, const float* carry, float* acc,
                  int* counters, long long m, long long n, int br, cudaStream_t stream) {
    using S = typename T::S;
    if (n % K1_TW != 0) return (int)cudaErrorInvalidValue;
    const long long nblocks = m / br;
    const int ntiles = (int)(n / K1_TW);
    const long long grid = nblocks * ntiles;
    if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
    copy_csum_blocks_kernel<T><<<(unsigned)grid, K1_THREADS, 0, stream>>>(
        static_cast<const S*>(x), static_cast<S*>(out), partial, carry, acc, counters, n, br,
        ntiles, nblocks);
    return (int)cudaGetLastError();
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled lives in libcuda, which this library does not link:
// its entry point is asked of the runtime once, or null when it has none.
EncodeTiledFn encoder() {
    static const EncodeTiledFn fn = [] {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
        const cudaError_t e =
            cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
        const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
        return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiledFn>(p)
                                                                     : nullptr;
    }();
    return fn;
}

// K2's view of a payload at `base`: (nblocks, br, row_bytes / 8) 8-byte
// words, boxes of one tile's words x sr rows x one block.
int stage_map(CUtensorMap* map, const void* base, long long row_bytes, int br, long long nblocks,
              int sr) {
    const EncodeTiledFn encode = encoder();
    if (encode == nullptr) return ERR_NO_ENCODER;
    const cuuint64_t dims[3] = {(cuuint64_t)(row_bytes / 8), (cuuint64_t)br, (cuuint64_t)nblocks};
    const cuuint64_t strides[2] = {(cuuint64_t)row_bytes, (cuuint64_t)row_bytes * (cuuint64_t)br};
    const cuuint32_t box[3] = {(cuuint32_t)TILE_WORDS, (cuuint32_t)sr, 1};
    const cuuint32_t unit[3] = {1, 1, 1};
    const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT64, 3, const_cast<void*>(base), dims,
                              strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + (int)r;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int launch_staged(const void* x, void* out, float* partial, float* acc, int* counters, long long m,
                  long long n, int br, int sr, int grid, cudaStream_t stream) {
    const long long row_bytes = n * (long long)sizeof(typename T::S);
    const bool whole_groups = sr % G == 0 || (sr == br && br < G);
    if (br <= 0 || m % br != 0 || sr <= 0 || !whole_groups || sr * TILE_BYTES > STAGE_BYTES ||
        row_bytes % 16 != 0 || grid <= 0 || !aligned16(x) || !aligned16(out))
        return (int)cudaErrorInvalidValue;
    const long long nblocks = m / br;
    const long long ntiles = (row_bytes + TILE_BYTES - 1) / TILE_BYTES;
    if (nblocks * ntiles > INT_MAX) return (int)cudaErrorInvalidValue;
    // The encoder needs the device's context current on this thread, which
    // a thread that has only named the device (a server's worker) may not
    // have yet: setting the device makes it so.
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaSetDevice(dev);
    if (e != cudaSuccess) return (int)e;
    // the maps are encoded on the host a launch: they hold x's and out's addresses
    CUtensorMap in_map, out_map;
    int rc = stage_map(&in_map, x, row_bytes, br, nblocks, sr);
    if (rc == 0) rc = stage_map(&out_map, out, row_bytes, br, nblocks, sr);
    if (rc != 0) return rc;
    // the opt-in above 48 KB holds only for the device current at the call,
    // so it is made before every launch (cheap) rather than once per process
    e = cudaFuncSetAttribute(copy_csum_staged_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             STAGED_SMEM);
    if (e != cudaSuccess) return (int)e;
    copy_csum_staged_kernel<T><<<grid, STAGED_THREADS, STAGED_SMEM, stream>>>(
        in_map, out_map, partial, acc, counters, n, br, sr, (int)ntiles, (int)(nblocks * ntiles));
    return (int)cudaGetLastError();
}

// ---- copy_blocks: the plain copy on the bulk-copy engine ------------------
// The TPU kernel walks row blocks of _fit_block_rows(m, chunk_rows) rows
// through VMEM; its output is the input's bytes.  Nothing is carried from
// block to block, so here the payload (contiguous, a multiple of 16 bytes:
// a lane-aligned row is a multiple of 128 elements) is cut into chunks of
// at most COPY_CHUNK bytes, a multiple of 256, sized so that every
// persistent CTA gets the same number, and CTA c walks chunks c, c + grid,
// ... through a ring of COPY_STAGES slots, one thread loading and one
// storing.  Bound by bytes: the payload is read once and written once.
__global__ void __launch_bounds__(64, COPY_CTAS_PER_SM)
copy_blocks_kernel(const unsigned char* __restrict__ x, unsigned char* __restrict__ out,
                   long long nbytes) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char* stages = align_smem(smem_raw);
    unsigned long long* full = reinterpret_cast<unsigned long long*>(stages + COPY_STAGES * COPY_CHUNK);
    unsigned long long* empty = full + COPY_STAGES;
    const long long per_cta = (nbytes + gridDim.x - 1) / gridDim.x;
    const long long per_step = (per_cta + COPY_CHUNK - 1) / COPY_CHUNK;
    const long long chunk = ((per_cta + per_step - 1) / per_step + 255) / 256 * 256;
    const long long nchunks = (nbytes + chunk - 1) / chunk;
    if ((long long)blockIdx.x >= nchunks) return;
    if (threadIdx.x == 0) {
        for (int i = 0; i < COPY_STAGES; ++i) {
            mbar_init(full + i, 1);
            mbar_init(empty + i, 1);  // the store's release
        }
        mbar_fence_init();
    }
    __syncthreads();
    if ((threadIdx.x & 31) != 0) return;
    const int steps = (int)((nchunks - blockIdx.x + gridDim.x - 1) / gridDim.x);
    auto at = [&](int k, long long& off) {
        off = ((long long)blockIdx.x + (long long)k * gridDim.x) * chunk;
        return (unsigned)min(chunk, nbytes - off);
    };
    if (threadIdx.x == 0) {
        const unsigned long long policy = l2_policy<STORE_EVICT>();
        ring_stores<COPY_STAGES, COPY_STORE_LAG>(steps, full, empty, [&](int k) {
            long long off;
            const unsigned bytes = at(k, off);
            bulk_store(out + off, stages + (k % COPY_STAGES) * COPY_CHUNK, bytes, policy);
        });
    } else {
        const unsigned long long policy = l2_policy<LOAD_EVICT>();
        ring_loads<COPY_STAGES>(steps, empty, [&](int k) {
            long long off;
            const unsigned bytes = at(k, off);
            mbar_expect_tx(full + k % COPY_STAGES, bytes);
            bulk_load(stages + (k % COPY_STAGES) * COPY_CHUNK, x + off, bytes, full + k % COPY_STAGES,
                      policy);
        });
    }
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

// K1: x, out (m, n) of dtype `code`, contiguous; partial (m/br, n) f32
// scratch; carry (n) f32 or NULL for zeros; acc (n) f32; counters at least
// n/64 int32, all 0 (left 0).
int copy_csum_blocks(const void* x, void* out, void* partial, const void* carry, void* acc,
                     void* counters, long long m, long long n, int br, int code, void* stream) {
    DISPATCH_DTYPE(code, launch_blocks<T>(x, out, static_cast<float*>(partial),
                                          static_cast<const float*>(carry), static_cast<float*>(acc),
                                          static_cast<int*>(counters), m, n, br,
                                          static_cast<cudaStream_t>(stream)))
}

// K2: the same outputs as copy_csum_blocks from a zero carry, one launch of
// `grid` persistent CTAs staging `sr` rows of a TILE_BYTES-wide tile at a
// time; x and out 16-byte aligned; counters at least G x the tile count
// (ceil(row bytes / TILE_BYTES)) int32, all 0 (left 0).
int copy_csum_staged(const void* x, void* out, void* partial, void* acc, void* counters,
                     long long m, long long n, int br, int sr, int code, int grid, void* stream) {
    DISPATCH_DTYPE(code, launch_staged<T>(x, out, static_cast<float*>(partial), static_cast<float*>(acc),
                                          static_cast<int*>(counters), m, n, br, sr, grid,
                                          static_cast<cudaStream_t>(stream)))
}

// device_copy: out = x, nbytes (a multiple of 16) of 16-byte aligned memory,
// copied by at most `max_grid` CTAs.
int copy_blocks(const void* x, void* out, long long nbytes, int max_grid, void* stream) {
    if (nbytes <= 0 || nbytes % 16 != 0 || max_grid <= 0 || !aligned16(x) || !aligned16(out))
        return (int)cudaErrorInvalidValue;
    const long long need = (nbytes + COPY_CHUNK - 1) / COPY_CHUNK;
    const unsigned grid = (unsigned)(need < max_grid ? need : max_grid);
    const cudaError_t e = cudaFuncSetAttribute(copy_blocks_kernel,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, COPY_SMEM);
    if (e != cudaSuccess) return (int)e;
    copy_blocks_kernel<<<grid, 64, COPY_SMEM, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const unsigned char*>(x), static_cast<unsigned char*>(out), nbytes);
    return (int)cudaGetLastError();
}

const char* transfer_error_string(int err) {
    if (err == ERR_NO_ENCODER) return "libcuda offers no cuTensorMapEncodeTiled";
    if (err >= ERR_ENCODE) return "cuTensorMapEncodeTiled refused the payload's tensor map";
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
