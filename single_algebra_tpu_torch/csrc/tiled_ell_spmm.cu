// Sparse x dense products over the column-tiled padded-ELL payload (Hopper).
//
// Replaces the Pallas TPU kernels tiled_ell_spmm_t and tiled_ell_rmv_t
// (single_algebra_tpu/ops/pallas/spmm_kernel.py). Input: the transposed
// payload td/tl [ntiles*wt, R] (bf16 or f32 values, int32 tile-local
// column ids; slot w of tile t for row r at [t*wt + w, r]; padding slots
// (v=0, lid=0)). Products (f32 accumulation and output):
//
//   spmm: out[k, r]    = sum_{t,w} v[t*wt+w, r] * B[t*ct + lid, k]  ((A @ B)^T, [kp, R])
//   rmv:  out[t*ct + c, k] = sum_{r,w: lid == c} v[t*wt+w, r] * C[r, k]  (A^T @ C, [ntiles*ct, kp])
//
// Operands are bf16 (the fast products) or f32 (the f32-class products).
// Every slot's product v*x is formed in f32: bf16 x bf16 and bf16 x f32
// products round once, in the FMA. Ids outside [0, ct) and slots with
// v == 0 (padding) contribute nothing; duplicate ids each add their term.
// The wrappers (ops/spmm_kernel.py) lay the operands out for the kernels
// once per call, in their own dtype: spmm's B tile-major
// [nch][ntiles][ct][KC], rmv's C row-major [nch][R][KC] (nch = ceil(kp /
// KC) chunks of KC output columns), the 16-byte units of each row XOR-
// swizzled by (row & 7) (fewer for rows of under 8 units). The payload's
// rows are copied in 16-byte units: R must be a multiple of 8.
//
// The TPU kernels densify each [ct, rows] tile with a one-hot compare and
// contract it on the matrix unit. Here every stored slot is one gather,
// ct/wt times fewer multiply-adds and no tensor cores: the products are
// bound by memory.
//
// What bounds them: the payload, 6 bytes a slot for bf16 (8 for f32),
// which must be read once; the stored entries (15.7 % of the slots at the
// tiled path's shape: 237 tiles x 16 slots x 500,736 rows, 11.4 GB) are
// not known until their slots are read. That is 3.4 ms at 3.35 TB/s; the
// multiply-adds (297 M stored entries x kp 64) need 0.6 ms at the f32 rate.
// All slot, row and output offsets are 64-bit: that payload holds 1.90e9
// slots, 88 % of 2^31. Both kernels are deterministic: no atomics, every
// sum is taken in an order fixed by the data layout. rmv also re-reads C
// once per column tile (15.2 GB at kp 64 in bf16), mostly from L2: the
// blocks of one row range run together.
//
// spmm design. A block owns RB (512, 256 or 128) consecutive rows, one per
// consumer thread, and a chunk of KC output columns held in registers; a
// producer warp streams, with 1-D TMA bulk copies (cp.async.bulk) and
// mbarriers, every column tile's operand block [ct][KC] (contiguous thanks
// to the tile-major layout) into a 2-stage ring, and every tile's payload
// for the block's rows (wt rows of RB values and of RB ids) into a ring
// of 2-3 stages, so tile t+1's payload and operand arrive while tile t is
// summed, with no block-wide barrier (each consumer warp releases a stage
// on an "empty" mbarrier). Each stored slot gathers its operand row as
// 16-byte shared-memory loads in the operand's own dtype (bf16 is widened
// in registers); the XOR swizzle spreads the rows that the lanes of a
// warp gather over the banks. Faults of the first version and what this
// does about them: (1) each 256-row block restaged every operand tile
// through 2-byte loads and integer division (15.2 GB of L2 traffic, more
// than the payload): now a bulk copy per tile and 512-row blocks (7.6 GB
// at the path's shape, below the payload); (2) two __syncthreads per tile
// kept loads from overlapping the sums: now rings and mbarriers; (3) the
// transposed f32 staging stores conflicted 8-way: the copies no longer go
// through threads and the gathers are swizzled; (4) low occupancy and
// serialized latency: 16 consumer warps a block, the payload of the next
// tiles in flight. Accumulation order is fixed (tile, then slot).
//
// rmv design. A block owns one column tile (up to 256 columns), one row
// range and a KC-column chunk of the output; thread c accumulates column c
// of the tile in KC registers for the whole range. The block walks its
// range in items of 256 rows x 16 slots. Each item's payload (16 rows of
// 256 values and of 256 ids) comes by 1-D TMA bulk copies into a ring of
// 1-2 stages, two items ahead of its use; each row chunk's operand rows
// [256][KC] (contiguous in the row-major layout) by one bulk copy. Per
// item each warp, on its own: reads its 32 rows' slots from the stage,
// counts the stored entries per column (lanes of one slot that hit one
// column are ranked with __match_any_sync), takes the exclusive sum over
// columns and places each entry (value, row) in its column's bucket, in
// (slot, lane) order. After a __syncthreads, thread c walks column c's
// buckets of warps 0..7 in order and gathers, per entry, the operand row
// as 16-byte shared-memory loads (rows swizzled like spmm's), KC FMAs
// each; a second __syncthreads frees the item buffer. Range partials are
// added in range order by a second kernel. Faults of the first version and
// what this does about them: (1) 12 warps a SM: now 16 (two 8-warp blocks,
// 104-113 KB of shared memory each), ~1,200 blocks at the path's shape;
// (2) each payload byte was read by all four warps of a block: now once,
// by a bulk copy; (3) a ballot, shuffles and shared-memory read-modify-
// writes of the accumulator per slot, mostly for padding: padding now
// costs one shared-memory read and a compare, and each stored entry KC
// independent FMAs into registers; (4) 140 MB of range partials: now 5
// ranges (78 MB at kp 64). What holds it back now (timing variants at the
// path's geometry): the payload stream (register prefetch one item ahead
// left too few bytes in flight; the ring gave 20.0 -> 16.3 ms), then
// counting with __match_any_sync and the sums, whose warps run as long
// as their fullest column (~2.8x the mean for uniform columns, more for
// the skewed columns of real data).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// -- mbarriers and 1-D TMA bulk copies ----------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory; completion is counted on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// -- spmm -----------------------------------------------------------------------

constexpr int kSpmmMaxRows = 512;  // consumer threads (rows) of a block, at most
constexpr int kSpmmThreads = kSpmmMaxRows + 32;  // + the producer warp
constexpr int kSpmmBarBytes = 128;  // mbarriers at the start of shared memory
constexpr int kSpmmMaxStages = 3;
constexpr int kSlotBatch = 8;  // slots read from shared memory ahead of their FMAs

// acc[j] += v * B[lid, j] from the swizzled [ct][KC] operand tile in shared
// memory: 16-byte unit u of row lid sits at unit u ^ (lid & SW)
template <int KC>
__device__ __forceinline__ void gather_fma(float (&acc)[KC], const __nv_bfloat16* op, int lid,
                                           float v) {
  constexpr int U = KC / 8;
  constexpr int SW = (U < 8 ? U : 8) - 1;
  const uint4* row = reinterpret_cast<const uint4*>(op) + lid * U;
  const int s = lid & SW;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const uint4 q = row[u ^ s];
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      acc[8 * u + 2 * e] = fmaf(v, __uint_as_float(w[e] << 16), acc[8 * u + 2 * e]);
      acc[8 * u + 2 * e + 1] =
          fmaf(v, __uint_as_float(w[e] & 0xffff0000u), acc[8 * u + 2 * e + 1]);
    }
  }
}

template <int KC>
__device__ __forceinline__ void gather_fma(float (&acc)[KC], const float* op, int lid, float v) {
  constexpr int U = KC / 4;
  constexpr int SW = (U < 8 ? U : 8) - 1;
  const float4* row = reinterpret_cast<const float4*>(op) + lid * U;
  const int s = lid & SW;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float4 q = row[u ^ s];
    acc[4 * u + 0] = fmaf(v, q.x, acc[4 * u + 0]);
    acc[4 * u + 1] = fmaf(v, q.y, acc[4 * u + 1]);
    acc[4 * u + 2] = fmaf(v, q.z, acc[4 * u + 2]);
    acc[4 * u + 3] = fmaf(v, q.w, acc[4 * u + 3]);
  }
}

// grid (ceil(R / RB), nch), block RB + 32 threads (RB a multiple of 32).
// Shared memory: the mbarriers, 2 operand stages of [ct][KC] OT, then `ps`
// payload stages of [ws][RB] PT values followed by [ws][RB] int32 ids.
template <typename PT, typename OT, int KC>
__global__ void __launch_bounds__(kSpmmThreads, 1)
    spmm_kernel(const PT* __restrict__ td, const int32_t* __restrict__ tl,
                const OT* __restrict__ bt, float* __restrict__ out, long long R, int wt,
                int ntiles, int ct, int kp, int ws, int ps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nwarps = blockDim.x / 32 - 1;  // consumer warps
  const int RB = nwarps * 32;
  uint64_t* pfull = reinterpret_cast<uint64_t*>(smem);
  uint64_t* pempty = pfull + ps;
  uint64_t* ofull = pempty + ps;
  uint64_t* oempty = ofull + 2;
  const size_t op_stage = (size_t)ct * KC;  // elements
  OT* ops = reinterpret_cast<OT*>(smem + kSpmmBarBytes);
  unsigned char* pay = reinterpret_cast<unsigned char*>(ops + 2 * op_stage);
  const size_t pay_stage = (size_t)ws * RB * (sizeof(PT) + sizeof(int32_t));  // bytes

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r0 = (long long)blockIdx.x * RB;
  const int rb = (int)min((long long)RB, R - r0);
  const int chunk = blockIdx.y;
  const int nj = (wt + ws - 1) / ws;  // payload items per tile

  if (threadIdx.x == 0) {
    for (int s = 0; s < ps; ++s) {
      mbar_init(pfull + s, 1);
      mbar_init(pempty + s, nwarps);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(ofull + s, 1);
      mbar_init(oempty + s, nwarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == nwarps) {  // the producer warp
    const OT* bsrc = bt + (size_t)chunk * ntiles * op_stage;
    const uint32_t obytes = (uint32_t)(op_stage * sizeof(OT));
    int i = 0;
    for (int t = 0; t < ntiles; ++t) {
      const int os = t & 1;
      if (t >= 2) mbar_wait(oempty + os, ((t >> 1) - 1) & 1);
      if (lane == 0) {
        mbar_expect_tx(ofull + os, obytes);
        bulk_load(ops + os * op_stage, bsrc + (size_t)t * op_stage, obytes, ofull + os);
      }
      for (int j = 0; j < nj; ++j, ++i) {
        const int s = i % ps;
        if (i >= ps) mbar_wait(pempty + s, (uint32_t)((i / ps - 1) & 1));
        const int w0 = j * ws, n = min(ws, wt - w0);
        PT* pv = reinterpret_cast<PT*>(pay + s * pay_stage);
        int32_t* pl = reinterpret_cast<int32_t*>(pv + (size_t)ws * RB);
        if (lane == 0)
          mbar_expect_tx(pfull + s, (uint32_t)((size_t)n * rb * (sizeof(PT) + sizeof(int32_t))));
        __syncwarp();
        for (int w = lane; w < n; w += 32) {
          const long long src = ((long long)t * wt + w0 + w) * R + r0;
          bulk_load(pv + (size_t)w * RB, td + src, (uint32_t)(rb * sizeof(PT)), pfull + s);
          bulk_load(pl + (size_t)w * RB, tl + src, (uint32_t)(rb * sizeof(int32_t)), pfull + s);
        }
      }
    }
    return;
  }

  float acc[KC];
#pragma unroll
  for (int j = 0; j < KC; ++j) acc[j] = 0.f;
  const int row = threadIdx.x;
  const bool live = row < rb;
  int i = 0;
  for (int t = 0; t < ntiles; ++t) {
    const int os = t & 1;
    mbar_wait(ofull + os, (t >> 1) & 1);
    const OT* op = ops + os * op_stage;
    for (int j = 0; j < nj; ++j, ++i) {
      const int s = i % ps;
      mbar_wait(pfull + s, (uint32_t)((i / ps) & 1));
      const int n = min(ws, wt - j * ws);
      const PT* pv = reinterpret_cast<const PT*>(pay + s * pay_stage);
      const int32_t* pl = reinterpret_cast<const int32_t*>(pv + (size_t)ws * RB);
      if (live) {
        for (int w0 = 0; w0 < n; w0 += kSlotBatch) {
          float v[kSlotBatch];
          int lid[kSlotBatch];
#pragma unroll
          for (int u = 0; u < kSlotBatch; ++u) {
            const bool in = w0 + u < n;
            v[u] = in ? to_f32(pv[(w0 + u) * RB + row]) : 0.f;
            lid[u] = in ? pl[(w0 + u) * RB + row] : 0;
          }
#pragma unroll
          for (int u = 0; u < kSlotBatch; ++u) {
            if (v[u] == 0.f || (unsigned)lid[u] >= (unsigned)ct) continue;
            gather_fma<KC>(acc, op, lid[u], v[u]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(pempty + s);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(oempty + os);
  }
  if (!live) return;
#pragma unroll
  for (int j = 0; j < KC; ++j) {
    const int k = chunk * KC + j;
    if (k < kp) out[(long long)k * R + r0 + row] = acc[j];
  }
}

template <typename PT, typename OT, int KC>
cudaError_t spmm_launch(const void* td, const void* tl, const void* bt, void* out, long long R,
                        int wt, int ntiles, int ct, int kp, int rows, int ws, int ps,
                        size_t smem, cudaStream_t stream) {
  const size_t need = kSpmmBarBytes + 2 * (size_t)ct * KC * sizeof(OT) +
                      (size_t)ps * ws * rows * (sizeof(PT) + sizeof(int32_t));
  if (need > smem || rows % 32 || rows > kSpmmMaxRows || ps < 2 || ps > kSpmmMaxStages ||
      ws < 1)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      spmm_kernel<PT, OT, KC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((R + rows - 1) / rows), (kp + KC - 1) / KC);
  spmm_kernel<PT, OT, KC><<<grid, rows + 32, smem, stream>>>(
      static_cast<const PT*>(td), static_cast<const int32_t*>(tl), static_cast<const OT*>(bt),
      static_cast<float*>(out), R, wt, ntiles, ct, kp, ws, ps);
  return cudaGetLastError();
}

template <typename PT, typename OT>
cudaError_t spmm_dispatch(int kc, const void* td, const void* tl, const void* bt, void* out,
                          long long R, int wt, int ntiles, int ct, int kp, int rows, int ws,
                          int ps, size_t smem, cudaStream_t s) {
  switch (kc) {
    case 16:
      return spmm_launch<PT, OT, 16>(td, tl, bt, out, R, wt, ntiles, ct, kp, rows, ws, ps,
                                     smem, s);
    case 32:
      return spmm_launch<PT, OT, 32>(td, tl, bt, out, R, wt, ntiles, ct, kp, rows, ws, ps,
                                     smem, s);
    case 64:
      return spmm_launch<PT, OT, 64>(td, tl, bt, out, R, wt, ntiles, ct, kp, rows, ws, ps,
                                     smem, s);
    default:
      return cudaErrorInvalidValue;
  }
}

// -- rmv ------------------------------------------------------------------------

constexpr int kRmvRows = 256;                 // rows per item = threads of a block
constexpr int kRmvWarps = kRmvRows / 32;
constexpr int kRmvCols = 256;                 // columns of a block (a column group)
constexpr int kRmvSlots = 16;                 // slots per item
constexpr int kRmvColBits = 10;               // column bits of a packed (rank, column)
constexpr int kRmvStride = kRmvCols + 4;      // a warp's bucket starts (16-byte rows)
constexpr int kRmvWarpEnts = 32 * kRmvSlots;  // a warp's entries of one item, at most
constexpr int kRmvMaxStages = 2;
// shared-memory layout (bytes): mbarriers pfull[kRmvMaxStages], cfull at 0;
// from 128 the item buffer (per warp: bucket starts [kRmvStride] ints, then
// entries [kRmvWarpEnts]); then `ps` payload stages ([kRmvSlots][kRmvRows]
// PT values, then as many int32 ids); then the operand block [kRmvRows][KC] OT
constexpr size_t kRmvBufOff = 128;

// a stored entry in its column's bucket: the value and the row in the item
template <typename PT>
struct Entry;

template <>
struct Entry<__nv_bfloat16> {  // bf16 value bits over the row
  using T = uint32_t;
  static __device__ __forceinline__ T pack(float v, int row) {
    return (__float_as_uint(v) & 0xffff0000u) | (uint32_t)row;
  }
  static __device__ __forceinline__ float value(T e) { return __uint_as_float(e & 0xffff0000u); }
  static __device__ __forceinline__ int row(T e) { return (int)(e & 0xffffu); }
};

template <>
struct Entry<float> {
  using T = uint2;
  static __device__ __forceinline__ T pack(float v, int row) {
    return make_uint2(__float_as_uint(v), (uint32_t)row);
  }
  static __device__ __forceinline__ float value(T e) { return __uint_as_float(e.x); }
  static __device__ __forceinline__ int row(T e) { return (int)e.y; }
};

template <typename PT>
__host__ __device__ constexpr size_t rmv_item_bytes() {
  return kRmvWarps * (sizeof(int) * kRmvStride + sizeof(typename Entry<PT>::T) * kRmvWarpEnts);
}

template <typename PT>
__host__ __device__ constexpr size_t rmv_stage_bytes() {
  return (size_t)kRmvSlots * kRmvRows * (sizeof(PT) + sizeof(int32_t));
}

template <typename PT, typename OT, int KC>
__host__ __device__ constexpr size_t rmv_smem_bytes(int ps) {
  return kRmvBufOff + rmv_item_bytes<PT>() + ps * rmv_stage_bytes<PT>() +
         sizeof(OT) * kRmvRows * KC;
}

// grid (ntiles, nranges, nch * ncg), block kRmvRows threads. cop is the
// operand row-major by chunk, [nch][R][KC], swizzled by row; part[q] the
// [ntiles*ct, kp] sums of row range q (the output itself when there is
// one range). ps (1 to kRmvMaxStages) payload stages: item i + ps is
// copied as soon as item i is counted.
template <typename PT, typename OT, int KC>
__global__ void __launch_bounds__(kRmvRows, 2)
    rmv_partial_kernel(const PT* __restrict__ td, const int32_t* __restrict__ tl,
                       const OT* __restrict__ cop, float* __restrict__ part, long long R, int wt,
                       int ntiles, int ct, int kp, long long rows_per_range, int nch, int ps) {
  using E = typename Entry<PT>::T;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* pfull = reinterpret_cast<uint64_t*>(smem);
  uint64_t* cfull = pfull + kRmvMaxStages;
  int* st = reinterpret_cast<int*>(smem + kRmvBufOff);  // [kRmvWarps][kRmvStride]
  E* en = reinterpret_cast<E*>(st + kRmvWarps * kRmvStride);  // [kRmvWarps][kRmvWarpEnts]
  unsigned char* ring = smem + kRmvBufOff + rmv_item_bytes<PT>();
  OT* cs = reinterpret_cast<OT*>(ring + ps * rmv_stage_bytes<PT>());

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lanes_below = (1u << lane) - 1;
  const int t = blockIdx.x;
  const int kch = blockIdx.z % nch;
  const int c0 = (blockIdx.z / nch) * kRmvCols;
  const int ncols = min(kRmvCols, ct - c0);
  const long long r_begin = (long long)blockIdx.y * rows_per_range;
  const long long r_end = min(R, r_begin + rows_per_range);
  const int nrc = (int)((r_end - r_begin + kRmvRows - 1) / kRmvRows);  // row chunks
  const int nj = (wt + kRmvSlots - 1) / kRmvSlots;                     // slot chunks
  const int nitems = nrc * nj;
  const OT* csrc = cop + (long long)kch * R * KC;
  int* hs = st + warp * kRmvStride;  // this warp's counts, then bucket starts
  E* we = en + warp * kRmvWarpEnts;

  // warp 0: item i's payload (its slots of its rows) into stage i % ps
  auto fetch = [&](int i) {
    const int rc = i / nj, w0 = (i % nj) * kRmvSlots;
    const long long ra = r_begin + (long long)rc * kRmvRows;
    const int rows = (int)min((long long)kRmvRows, r_end - ra);
    const int n = min(kRmvSlots, wt - w0);
    PT* sv = reinterpret_cast<PT*>(ring + (i % ps) * rmv_stage_bytes<PT>());
    int32_t* sl = reinterpret_cast<int32_t*>(sv + kRmvSlots * kRmvRows);
    if (lane == 0)
      mbar_expect_tx(pfull + i % ps, (uint32_t)(n * rows * (sizeof(PT) + sizeof(int32_t))));
    __syncwarp();
    if (lane < n) {
      const long long src = ((long long)t * wt + w0 + lane) * R + ra;
      bulk_load(sv + lane * kRmvRows, td + src, (uint32_t)(rows * sizeof(PT)), pfull + i % ps);
      bulk_load(sl + lane * kRmvRows, tl + src, (uint32_t)(rows * sizeof(int32_t)),
                pfull + i % ps);
    }
  };
  // thread 0: the operand rows of row chunk rc
  auto stage = [&](int rc) {
    const long long ra = r_begin + (long long)rc * kRmvRows;
    const uint32_t bytes = (uint32_t)(min((long long)kRmvRows, r_end - ra) * KC * sizeof(OT));
    mbar_expect_tx(cfull, bytes);
    bulk_load(cs, csrc + ra * KC, bytes, cfull);
  };

  if (tid == 0) {
    for (int s = 0; s < kRmvMaxStages; ++s) mbar_init(pfull + s, 1);
    mbar_init(cfull, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (warp == 0)
    for (int i = 0; i < min(ps, nitems); ++i) fetch(i);
  if (tid == 0 && nrc > 0) stage(0);

  float acc[KC];  // column tid of the group, output columns of chunk kch
#pragma unroll
  for (int j = 0; j < KC; ++j) acc[j] = 0.f;

  for (int i = 0; i < nitems; ++i) {
    const int rc = i / nj, j = i % nj;
    const int rows = (int)min((long long)kRmvRows, r_end - r_begin - (long long)rc * kRmvRows);
    const int n = min(kRmvSlots, wt - j * kRmvSlots);

    // 1. count this warp's stored entries per column; lid[u] becomes the
    // entry's (rank in its column, column), or -1
    float v[kRmvSlots];
    int lid[kRmvSlots];
    {
      mbar_wait(pfull + i % ps, (uint32_t)((i / ps) & 1));
      const PT* sv = reinterpret_cast<const PT*>(ring + (i % ps) * rmv_stage_bytes<PT>());
      const int32_t* sl = reinterpret_cast<const int32_t*>(sv + kRmvSlots * kRmvRows);
#pragma unroll
      for (int u = 0; u < kRmvSlots; ++u) {
        const bool in = u < n && tid < rows;
        v[u] = in ? to_f32(sv[u * kRmvRows + tid]) : 0.f;
        lid[u] = in ? sl[u * kRmvRows + tid] : 0;
      }
    }
    for (int c = lane; c < kRmvCols; c += 32) hs[c] = 0;
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kRmvSlots; ++u) {
      const int col = lid[u] - c0;
      const bool stored = v[u] != 0.f && (unsigned)col < (unsigned)ncols;
      int key = -1;
      const unsigned any = __ballot_sync(kAll, stored);
      if (any) {
        // lanes of this slot that hit the same column (one lane: no match)
        const unsigned peers = (any & (any - 1))
                                   ? __match_any_sync(kAll, stored ? col : kRmvCols + lane)
                                   : any;
        const int old = stored ? hs[col] : 0;
        __syncwarp();
        if (stored && !(peers & lanes_below)) hs[col] = old + __popc(peers);
        __syncwarp();
        if (stored) key = ((old + __popc(peers & lanes_below)) << kRmvColBits) | col;
      }
      lid[u] = key;
    }

    // 2. bucket starts: exclusive sum of the counts over columns, lane l
    // summing columns [8l, 8l + 8)
    {
      int4* h4 = reinterpret_cast<int4*>(hs) + 2 * lane;
      const int4 a = h4[0], b = h4[1];
      const int mine = a.x + a.y + a.z + a.w + b.x + b.y + b.z + b.w;
      int inc = mine;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kAll, inc, o);
        if (lane >= o) inc += y;
      }
      int s = inc - mine;
      int4 sa, sb;
      sa.x = s; s += a.x; sa.y = s; s += a.y; sa.z = s; s += a.z; sa.w = s; s += a.w;
      sb.x = s; s += b.x; sb.y = s; s += b.y; sb.z = s; s += b.z; sb.w = s; s += b.w;
      __syncwarp();
      h4[0] = sa;
      h4[1] = sb;
      if (lane == 31) hs[kRmvCols] = s;
      __syncwarp();
    }

    // 3. place each stored entry in its column's bucket: (slot, lane) order
#pragma unroll
    for (int u = 0; u < kRmvSlots; ++u) {
      if (lid[u] >= 0) {
        const int col = lid[u] & ((1 << kRmvColBits) - 1);
        we[hs[col] + (lid[u] >> kRmvColBits)] = Entry<PT>::pack(v[u], tid);
      }
    }
    if (j == 0) mbar_wait(cfull, rc & 1);
    __syncthreads();  // every warp placed this item; its payload stage is free
    if (warp == 0 && i + ps < nitems) fetch(i + ps);

    // 4. sums: thread c walks column c's buckets of warps 0..7 in one loop
    // (a warp runs as many steps as its fullest column); each entry
    // gathers its operand row as 16-byte loads (swizzled rows: the lanes'
    // rows fall on different banks) and adds KC FMAs
    {
      int w = 0, q = st[tid], e = st[tid + 1];
      for (;;) {
        while (q == e && w + 1 < kRmvWarps) {
          ++w;
          q = st[w * kRmvStride + tid];
          e = st[w * kRmvStride + tid + 1];
        }
        if (q == e) break;
        const E ent = en[w * kRmvWarpEnts + q++];
        gather_fma<KC>(acc, cs, Entry<PT>::row(ent), Entry<PT>::value(ent));
      }
    }
    __syncthreads();  // the item buffer (and, after a row chunk, the operand block) is free
    if (tid == 0 && j == nj - 1 && rc + 1 < nrc) stage(rc + 1);
  }

  const int c = c0 + tid;  // this thread's column
  if (c < ct) {
    float* dst = part + (long long)blockIdx.y * ntiles * ct * kp + ((long long)t * ct + c) * kp;
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      const int k = kch * KC + j;
      if (k < kp) dst[k] = acc[j];
    }
  }
}

// out[i] = sum over ranges q, in order, of part[q][i]
__global__ void rmv_reduce_kernel(const float* __restrict__ part, float* __restrict__ out,
                                  long long n, int nranges) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = part[i];
  for (int q = 1; q < nranges; ++q) s += part[(long long)q * n + i];
  out[i] = s;
}

template <typename PT, typename OT, int KC>
cudaError_t rmv_launch(const void* td, const void* tl, const void* cop, void* part, void* out,
                       long long R, int wt, int ntiles, int ct, int kp, long long rows_per_range,
                       int nranges, int nch, int ncg, int ps, size_t smem,
                       cudaStream_t stream) {
  if (ps < 1 || ps > kRmvMaxStages || rmv_smem_bytes<PT, OT, KC>(ps) > smem ||
      rows_per_range % kRmvRows || nch < 1 || ncg < 1)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      rmv_partial_kernel<PT, OT, KC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  float* dst = nranges == 1 ? static_cast<float*>(out) : static_cast<float*>(part);
  dim3 grid(ntiles, nranges, nch * ncg);
  rmv_partial_kernel<PT, OT, KC><<<grid, kRmvRows, smem, stream>>>(
      static_cast<const PT*>(td), static_cast<const int32_t*>(tl), static_cast<const OT*>(cop),
      dst, R, wt, ntiles, ct, kp, rows_per_range, nch, ps);
  err = cudaGetLastError();
  if (err != cudaSuccess || nranges == 1) return err;
  const long long n = (long long)ntiles * ct * kp;
  rmv_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(out), n, nranges);
  return cudaGetLastError();
}

template <typename PT, typename OT>
cudaError_t rmv_dispatch(int kc, const void* td, const void* tl, const void* cop, void* part,
                         void* out, long long R, int wt, int ntiles, int ct, int kp,
                         long long rows_per_range, int nranges, int nch, int ncg, int ps,
                         size_t smem, cudaStream_t s) {
  switch (kc) {
    case 32:
      return rmv_launch<PT, OT, 32>(td, tl, cop, part, out, R, wt, ntiles, ct, kp,
                                    rows_per_range, nranges, nch, ncg, ps, smem, s);
    case 64:
      return rmv_launch<PT, OT, 64>(td, tl, cop, part, out, R, wt, ntiles, ct, kp,
                                    rows_per_range, nranges, nch, ncg, ps, smem, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// payload_bf16 / operand_bf16: 1 = bf16, 0 = f32. The caller guarantees
// contiguous, 16-byte aligned [ntiles*wt, R] payload arrays with R a
// multiple of 8, the operand laid out [ceil(kp/kc)][ntiles][ct][kc]
// (swizzled, see the header), a contiguous f32 [kp, R] output, kc in
// {16, 32, 64}, `rows` a multiple of 32 up to 512 and `smem` bytes of
// shared memory (the plan's) within the card's limit. Returns the launch's
// cudaError_t (0 = launched).
extern "C" int tiled_ell_spmm_t_launch(const void* td, const void* tl, const void* bt, void* out,
                                       long long R, int wt, int ntiles, int ct, int kp, int kc,
                                       int rows, int slots, int stages, long long smem,
                                       int payload_bf16, int operand_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sm = (size_t)smem;
  if (payload_bf16 && operand_bf16)
    return spmm_dispatch<__nv_bfloat16, __nv_bfloat16>(kc, td, tl, bt, out, R, wt, ntiles, ct,
                                                       kp, rows, slots, stages, sm, s);
  if (payload_bf16)
    return spmm_dispatch<__nv_bfloat16, float>(kc, td, tl, bt, out, R, wt, ntiles, ct, kp, rows,
                                               slots, stages, sm, s);
  if (operand_bf16)
    return spmm_dispatch<float, __nv_bfloat16>(kc, td, tl, bt, out, R, wt, ntiles, ct, kp, rows,
                                               slots, stages, sm, s);
  return spmm_dispatch<float, float>(kc, td, tl, bt, out, R, wt, ntiles, ct, kp, rows, slots,
                                     stages, sm, s);
}

// The caller guarantees contiguous, 16-byte aligned [ntiles*wt, R]
// payload arrays with R a multiple of 8, the operand laid out [nch][R][kc]
// (swizzled like spmm's, by row), a contiguous f32 [ntiles*ct, kp] output,
// kc in {32, 64}, nch = ceil(kp / kc), ncg =
// ceil(ct / 256), rows_per_range a multiple of 256 with nranges =
// ceil(R / rows_per_range) <= 65535, ps payload stages (1 or 2), `smem`
// bytes of shared memory and,
// when nranges > 1, f32 scratch `part` of nranges * ntiles * ct * kp
// elements. Returns the cudaError_t of the launches (0 = launched).
extern "C" int tiled_ell_rmv_t_launch(const void* td, const void* tl, const void* cop, void* part,
                                      void* out, long long R, int wt, int ntiles, int ct, int kp,
                                      int kc, long long rows_per_range, int nranges, int nch,
                                      int ncg, int ps, long long smem, int payload_bf16,
                                      int operand_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sm = (size_t)smem;
  if (payload_bf16 && operand_bf16)
    return rmv_dispatch<__nv_bfloat16, __nv_bfloat16>(kc, td, tl, cop, part, out, R, wt, ntiles,
                                                      ct, kp, rows_per_range, nranges, nch, ncg,
                                                      ps, sm, s);
  if (payload_bf16)
    return rmv_dispatch<__nv_bfloat16, float>(kc, td, tl, cop, part, out, R, wt, ntiles, ct, kp,
                                              rows_per_range, nranges, nch, ncg, ps, sm,
                                              s);
  if (operand_bf16)
    return rmv_dispatch<float, __nv_bfloat16>(kc, td, tl, cop, part, out, R, wt, ntiles, ct, kp,
                                              rows_per_range, nranges, nch, ncg, ps, sm,
                                              s);
  return rmv_dispatch<float, float>(kc, td, tl, cop, part, out, R, wt, ntiles, ct, kp,
                                    rows_per_range, nranges, nch, ncg, ps, sm, s);
}
