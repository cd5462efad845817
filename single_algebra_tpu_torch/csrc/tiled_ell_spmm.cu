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
// What bounds spmm: the payload, 6 bytes a slot for bf16 (8 for f32),
// which must be read once; the stored entries (15.7 % of the slots at the
// tiled path's shape: 237 tiles x 16 slots x 500,736 rows, 11.4 GB) are
// not known until their slots are read. That is 3.4 ms at 3.35 TB/s; the
// multiply-adds (297 M stored entries x kp 64) need 0.6 ms at the f32 rate.
// rmv reads a bucketed form of the payload instead (below). All slot, row,
// entry and output offsets are 64-bit: that payload holds 1.90e9 slots, 88 %
// of 2^31. The products are deterministic: no atomics in any sum (the
// bucketing counts with shared-memory atomics; counts do not depend on
// their order), every sum taken in an order fixed by the data layout.
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
// rmv design: bucket once, sum every call. The sums of a column need its
// stored entries in column order; the payload keeps them in row order, padded.
// The first rmv kernel re-sorted every 256-row x 16-slot item on every call
// (11.4 GB of padded slots read, a ballot and a match per slot, a scan, two
// block barriers per item: 21.6 ms at kp 64 on the path's payload). Nothing of
// that depends on the call: the engine's payload never changes.
//
// The form (rmv_count_kernel, then rmv_bucket_kernel; once per payload array,
// kept by the engine's operator): item (t, rc) is column tile t's rows [256 rc,
// 256 rc + 256). Its stored entries lie contiguous from start[item] by column,
// within a column in (slot chunk of 16, warp, slot, lane) order, the first
// kernel's order of addition, so the sums come out as before, bit for bit; each
// packed as (bf16 value bits, row in the item), 4 bytes, or (f32, row), 8 bytes;
// int32 column offsets per item (off[item][c], the item's count from c = ct on);
// and a schedule per item and 256-column group (below). The count pass reads the
// payload once and the bucket pass once more: at the tiled path's shape 297.4 M
// entries (1.19 GB), 0.48 GB of offsets and 0.12 GB of schedules, 14.6-14.9 ms once.
//
// The sums (rmv_partial_kernel). A block owns one column tile, one row range and
// a KC-column chunk of the output, one block a SM. A producer warp reads 32 row
// chunks' starts and spans at a time and streams, by 1-D TMA bulk copies and
// mbarriers, each row chunk's operand rows [256][KC] into a ring of 2 stages and
// its entries of the block's columns, with the offsets and the schedule, in
// pieces of up to 8 KB into a ring of 2-4 stages. 16 consumer warps sum; no
// ballot, match, scan or placement is left, only gathers of operand rows from
// shared memory and FMAs. What bounded that walk, measured on the path's payload
// (H100, bf16 operand, kp 64): not the copies (the pipeline without sums, 2.1
// ms; the sums without operand copies, as slow as with them) but the columns'
// skew. Half of a row chunk's columns are empty in this data and the rest
// gamma-distributed, so one thread per column keeps 18 % of the lanes busy
// (11.2 ms), and any fixed column-to-warp split leaves one warp the heaviest for
// a whole cluster of row chunks, which the shared rings make the block wait for
// (every fixed split tried: 11-14 ms). Hence the schedule, made once in the form:
// per row chunk, the group's columns sorted by entry count, in quadruples dealt
// to the 16 warps in snake order, so each warp gets about a 16th of the work and
// its 16 slots hold columns of similar counts side by side. A group of KC *
// sizeof(OT) / 16 lanes walks one column, each lane one 16-byte unit of the
// operand row (swizzled like spmm's), so a warp walks 2 (f32 operand, KC 64), 4
// or 8 columns at once; the step's columns, offsets and running sums are read
// before the walk, and the next entry and its row are read ahead. Columns change
// warps between row chunks, so the [256][KC] f32 sums live in shared memory and
// the consumer warps meet at a named barrier before each row chunk. On the path's
// payload: 8.0-8.3 ms (bf16 operand, kp 64), 9.0 ms (f32), 5.2 ms (f32, kp 8).
// Range partials are added in range order by rmv_reduce_kernel. A bare call (no
// form given) counts, buckets, then sums.

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

constexpr int kRmvRows = 256;              // rows of an item (threads of a form block)
constexpr int kRmvWarps = kRmvRows / 32;
constexpr int kRmvCols = 256;              // columns of a block (a column group)
constexpr int kRmvSlots = 16;              // slots of a slot chunk (the order's outer key)
constexpr int kRmvColBits = 10;            // column bits of a packed (rank, column): ct <= 1024
constexpr int kRmvMaxStages = 6;
constexpr int kRmvBarBytes = 128;          // mbarriers at the start of shared memory
constexpr int kRmvHdrBytes = 16;           // a piece's header: (p0, p1, shift, last)
constexpr int kRmvOffInts = kRmvCols + 4;  // column offsets a piece holds (a 16-byte multiple)
constexpr int kRmvPieceBytes = 8192;       // entries a piece holds, in bytes
constexpr int kRmvSchedWarps = 16;         // consumer warps a schedule deals the columns to
constexpr int kRmvSchedCols = 4;           // the schedule's columns of similar counts, together
constexpr int kRmvSchedBytes = kRmvCols;   // a schedule: the group's columns in slot order

// a stored entry of the bucketed form: the value and the row in the item
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

__device__ __forceinline__ bool is_stored(float v, int32_t id, int ct) {
  return v != 0.f && (unsigned)id < (unsigned)ct;
}

// -- the bucketed form (built once per payload) --

// grid (nrc, ntiles), block kRmvRows: cnt[t * nrc + rc] = the stored entries of item
// (t, rc), the rows [256 rc, 256 rc + 256) of column tile t
template <typename PT>
__global__ void __launch_bounds__(kRmvRows)
    rmv_count_kernel(const PT* __restrict__ td, const int32_t* __restrict__ tl, long long R,
                     int wt, int ct, long long* __restrict__ cnt) {
  __shared__ int wsum[kRmvWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long rc = blockIdx.x, nrc = gridDim.x, t = blockIdx.y;
  const long long r = rc * kRmvRows + tid;
  int n = 0;
  if (r < R) {
    const long long o = t * wt * R + r;
#pragma unroll 4
    for (int w = 0; w < wt; ++w)
      n += is_stored(to_f32(td[o + w * R]), tl[o + w * R], ct);
  }
  n = __reduce_add_sync(kAll, n);
  if (lane == 0) wsum[warp] = n;
  __syncthreads();
  if (tid == 0) {
    int s = 0;
    for (int w = 0; w < kRmvWarps; ++w) s += wsum[w];
    cnt[t * nrc + rc] = s;
  }
}

// grid (nrc, ntiles), block kRmvRows. Writes item (t, rc)'s stored entries from
// ent[start[item]] on, by column, and within a column in (slot chunk, warp, slot,
// lane) order, the order in which the first rmv kernel added them; and its column
// offsets off[item][c] (entries before column c, the item's count from c = ct on,
// ostride a row). Shared memory: 4 * (kRmvWarps + 1) * ctp bytes (ctp = ct rounded up
// to 4): the column cursors, then each warp's counts of one slot chunk.
template <typename PT>
__global__ void __launch_bounds__(kRmvRows)
    rmv_bucket_kernel(const PT* __restrict__ td, const int32_t* __restrict__ tl, long long R,
                      int wt, int ct, const long long* __restrict__ start,
                      typename Entry<PT>::T* __restrict__ ent, int32_t* __restrict__ off,
                      int ostride, uint8_t* __restrict__ sched) {
  extern __shared__ __align__(16) int fsm[];
  __shared__ int wsum[kRmvWarps];
  __shared__ int skey[kRmvRows];
  const int ctp = (ct + 3) & ~3;
  int* cur = fsm;        // [ct]
  int* cw = fsm + ctp;   // [kRmvWarps][ctp]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lanes_below = (1u << lane) - 1;
  const long long rc = blockIdx.x, nrc = gridDim.x, t = blockIdx.y;
  const long long item = t * nrc + rc;
  const long long r = rc * kRmvRows + tid;
  const bool live = r < R;
  const long long o = t * wt * R + r;

  // 1. stored entries per column
  for (int c = tid; c < ct; c += kRmvRows) cur[c] = 0;
  __syncthreads();
  if (live)
    for (int w = 0; w < wt; ++w) {
      const int32_t id = tl[o + w * R];
      if (is_stored(to_f32(td[o + w * R]), id, ct)) atomicAdd(cur + id, 1);
    }
  __syncthreads();

  // 2. the schedule of each 256-column group: its columns by entry count,
  // descending (bitonic sort of (count, column) keys), in quadruples of
  // similar counts dealt to kRmvSchedWarps warps in snake order: slots 16 w ..
  // 16 w + 15 are warp w's, round r's quadruple in slots 16 w + 4 r ..
  for (int cg = 0; cg * kRmvCols < ct; ++cg) {
    const int c = cg * kRmvCols + tid;
    skey[tid] = c < ct ? cur[c] << 8 | tid : tid;
    __syncthreads();
    for (int kk = 2; kk <= kRmvRows; kk <<= 1)
      for (int j = kk >> 1; j > 0; j >>= 1) {
        const int o = tid ^ j;
        if (o > tid) {
          const int a = skey[tid], b = skey[o];
          if ((a < b) == ((tid & kk) == 0)) {
            skey[tid] = b;
            skey[o] = a;
          }
        }
        __syncthreads();
      }
    const int qd = tid / kRmvSchedCols, r = qd / kRmvSchedWarps, pos = qd % kRmvSchedWarps;
    const int w = r & 1 ? kRmvSchedWarps - 1 - pos : pos;
    sched[(item * ((ct + kRmvCols - 1) / kRmvCols) + cg) * kRmvCols + 16 * w + kRmvSchedCols * r +
          tid % kRmvSchedCols] = (uint8_t)(skey[tid] & 255);
    __syncthreads();
  }

  // 3. column starts: the exclusive sum over columns, thread i summing columns
  // [per * i, per * i + per)
  const int per = (ct + kRmvRows - 1) / kRmvRows;  // 1 to 4
  int loc[4], mine = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = tid * per + k;
    loc[k] = k < per && c < ct ? cur[c] : 0;
    mine += loc[k];
  }
  int inc = mine;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kAll, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  int s = inc - mine, total = 0;
  for (int w = 0; w < kRmvWarps; ++w) {
    if (w < warp) s += wsum[w];
    total += wsum[w];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = tid * per + k;
    if (k < per && c < ct) {
      cur[c] = s;
      s += loc[k];
    }
  }
  __syncthreads();
  int32_t* orow = off + item * ostride;
  for (int c = tid; c < ostride; c += kRmvRows) orow[c] = c < ct ? cur[c] : total;
  typename Entry<PT>::T* dst = ent + start[item];

  // 4. slot chunk by slot chunk: each warp ranks its stored entries per column in
  // (slot, lane) order (lanes of one slot that hit one column with __match_any_sync),
  // the cursors give each warp's start in each column, then every entry is placed
  int* hs = cw + warp * ctp;
  for (int j0 = 0; j0 < wt; j0 += kRmvSlots) {
    const int n = min(kRmvSlots, wt - j0);
    for (int c = lane; c < ct; c += 32) hs[c] = 0;
    __syncwarp();
    float v[kRmvSlots];
    int key[kRmvSlots];
#pragma unroll
    for (int u = 0; u < kRmvSlots; ++u) {
      const bool in = live && u < n;
      const long long i = o + (long long)(j0 + u) * R;
      v[u] = in ? to_f32(td[i]) : 0.f;
      const int32_t id = in ? tl[i] : -1;
      const bool stored = in && is_stored(v[u], id, ct);
      int k = -1;
      const unsigned any = __ballot_sync(kAll, stored);
      if (any) {
        // lanes of this slot that hit the same column (one lane: no match)
        const unsigned peers =
            (any & (any - 1)) ? __match_any_sync(kAll, stored ? id : -1 - lane) : any;
        const int old = stored ? hs[id] : 0;
        __syncwarp();
        if (stored && !(peers & lanes_below)) hs[id] = old + __popc(peers);
        __syncwarp();
        if (stored) k = ((old + __popc(peers & lanes_below)) << kRmvColBits) | id;
      }
      key[u] = k;
    }
    __syncthreads();
    for (int c = tid; c < ct; c += kRmvRows) {
      int p = cur[c];
      for (int w = 0; w < kRmvWarps; ++w) {
        const int x = cw[w * ctp + c];
        cw[w * ctp + c] = p;
        p += x;
      }
      cur[c] = p;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kRmvSlots; ++u)
      if (key[u] >= 0) {
        const int col = key[u] & ((1 << kRmvColBits) - 1);
        dst[hs[col] + (key[u] >> kRmvColBits)] = Entry<PT>::pack(v[u], tid);
      }
    __syncthreads();
  }
}

// -- the sums (every call) --

constexpr int kRmvThreads = (kRmvSchedWarps + 1) * 32;  // + the producer warp

// A group of G = KC * sizeof(OT) / 16 lanes shares an operand row: lane s holds
// its 16-byte unit s (the row's unit s ^ (row & SW) in the swizzled [256][KC]
// block), KPL values widened to f32 (bf16 x0 is the low half of a 32-bit word).
template <typename OT, int KC>
struct GroupRow {
  static constexpr int G = KC * (int)sizeof(OT) / 16;  // lanes a row: 4, 8 or 16
  static constexpr int KPL = 16 / (int)sizeof(OT);    // values a lane
  static constexpr int SW = (G < 8 ? G : 8) - 1;
  int s;
  __device__ __forceinline__ explicit GroupRow(int lane) : s(lane % G) {}
  __device__ __forceinline__ void load(float (&x)[KPL], const OT* op, int row) const {
    const uint4 q = reinterpret_cast<const uint4*>(op)[row * G + (s ^ (row & SW))];
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(OT) == 2) {
        x[2 * i] = __uint_as_float(w[i] << 16);
        x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      } else {
        x[i] = __uint_as_float(w[i]);
      }
    }
  }
};

// a piece stage: header (p0, p1, shift, last), the group's column offsets, its
// schedule, then the entries (+16 bytes: the copy starts at a 16-byte boundary at
// or before the piece's first entry)
constexpr int kRmvStageBytes =
    kRmvHdrBytes + 4 * kRmvOffInts + kRmvSchedBytes + kRmvPieceBytes + 16;

// shared memory: mbarriers, 2 operand stages [256][KC] OT, the sums [256][KC] f32,
// ps piece stages
template <typename OT, int KC>
__host__ __device__ constexpr size_t rmv_smem_bytes(int ps) {
  return kRmvBarBytes + 2 * sizeof(OT) * kRmvRows * KC + sizeof(float) * kRmvCols * KC +
         (size_t)ps * kRmvStageBytes;
}

// grid (ntiles, nranges, nch * ncg), block kRmvThreads. ent / off / start / sched:
// the bucketed form (rmv_bucket_kernel; ceil(R / 256) items a tile). cop is the
// operand row-major by chunk, [nch][R][KC], swizzled by row; part[q] the [ntiles*ct,
// kp] sums of row range q (the output itself when there is one range). The
// producer warp streams each row chunk's operand rows into a ring of 2 stages and
// the chunk's entries of the block's columns, with their offsets and schedule, in
// pieces of at most kRmvPieceBytes into a ring of ps stages. The 16 consumer warps
// follow the schedule: in each row chunk, lane group g of warp w sums the column in
// slot 16 w + S j + g in step j (S groups a warp), every group of a step on columns
// of similar counts; a column's sums move between warps from one row chunk to the
// next, so they live in shared memory and the consumer warps meet at a barrier
// before each row chunk.
template <typename PT, typename OT, int KC>
__global__ void __launch_bounds__(kRmvThreads, 1)
    rmv_partial_kernel(const typename Entry<PT>::T* __restrict__ ent,
                       const int32_t* __restrict__ off, const long long* __restrict__ start,
                       const uint8_t* __restrict__ sched, const OT* __restrict__ cop,
                       float* __restrict__ part, long long R, int ntiles, int ct, int kp,
                       long long rows_per_range, int nch, int ps, int ostride) {
  using E = typename Entry<PT>::T;
  using GR = GroupRow<OT, KC>;
  constexpr int KPL = GR::KPL;
  constexpr int S = 32 / GR::G;                // columns a warp walks at once: 2, 4 or 8
  constexpr int kRmvSteps = 16 / S;            // steps over the warp's 16 schedule slots
  constexpr int kPiece = kRmvPieceBytes / (int)sizeof(E);  // entries
  constexpr int kCStage = kRmvRows * KC;                    // operand elements
  constexpr int NW = kRmvSchedWarps;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* pfull = reinterpret_cast<uint64_t*>(smem);
  uint64_t* pempty = pfull + ps;
  uint64_t* cfull = pempty + ps;
  uint64_t* cempty = cfull + 2;
  OT* cs = reinterpret_cast<OT*>(smem + kRmvBarBytes);
  float* acc_s = reinterpret_cast<float*>(cs + 2 * kCStage);  // [256][KC]
  unsigned char* ring = reinterpret_cast<unsigned char*>(acc_s + kRmvCols * KC);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = blockIdx.x;
  const int kch = blockIdx.z % nch;
  const int c0 = (blockIdx.z / nch) * kRmvCols;
  const int ncols = min(kRmvCols, ct - c0);
  const int ngroups = (ct + kRmvCols - 1) / kRmvCols;
  const long long r_begin = (long long)blockIdx.y * rows_per_range;
  const long long r_end = min(R, r_begin + rows_per_range);
  const int nrc = (int)((r_end - r_begin + kRmvRows - 1) / kRmvRows);  // row chunks
  const long long item0 = (long long)t * ((R + kRmvRows - 1) / kRmvRows) + r_begin / kRmvRows;

  if (tid == 0) {
    for (int s = 0; s < ps; ++s) {
      mbar_init(pfull + s, 1);
      mbar_init(pempty + s, NW);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(cfull + s, 1);
      mbar_init(cempty + s, NW);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == NW) {  // the producer warp
    const OT* csrc = cop + (long long)kch * R * KC;
    const uint32_t obytes = (uint32_t)(4 * ((ncols + 4) & ~3));  // offsets c0 .. c0 + ncols
    int k = 0;                                                  // pieces issued
    for (int b = 0; b < nrc; b += 32) {
      // lane j reads row chunk b + j's start and its entries' span in the block's columns
      long long m_start = 0;
      int m_lo = 0, m_hi = 0;
      if (b + lane < nrc) {
        const long long it = item0 + b + lane;
        m_start = start[it];
        m_lo = off[it * ostride + c0];
        m_hi = off[it * ostride + c0 + ncols];
      }
      const int nb = min(32, nrc - b);
      for (int j = 0; j < nb; ++j) {
        const int rc = b + j;
        const long long item = item0 + rc;
        const long long base = __shfl_sync(kAll, m_start, j);
        const int lo = __shfl_sync(kAll, m_lo, j), hi = __shfl_sync(kAll, m_hi, j);
        const int cst = rc & 1;
        if (rc >= 2) mbar_wait(cempty + cst, ((rc >> 1) - 1) & 1);
        if (lane == 0) {
          const long long ra = r_begin + (long long)rc * kRmvRows;
          const uint32_t bytes = (uint32_t)(min((long long)kRmvRows, r_end - ra) * KC * sizeof(OT));
          mbar_expect_tx(cfull + cst, bytes);
          bulk_load(cs + cst * kCStage, csrc + ra * KC, bytes, cfull + cst);
        }
        int p0 = lo;
        do {
          const int p1 = min(hi, p0 + kPiece);
          const int s = k % ps;
          if (k >= ps) mbar_wait(pempty + s, (uint32_t)((k / ps - 1) & 1));
          if (lane == 0) {
            unsigned char* st = ring + (size_t)s * kRmvStageBytes;
            const long long a0 = (base + p0) * (long long)sizeof(E);
            const long long ga = a0 & ~15ll;
            const long long gb = p1 > p0 ? ((base + p1) * (long long)sizeof(E) + 15) & ~15ll : ga;
            *reinterpret_cast<int4*>(st) =
                make_int4(p0, p1, (int)((a0 - ga) / (long long)sizeof(E)), p1 == hi);
            mbar_expect_tx(pfull + s, obytes + kRmvSchedBytes + (uint32_t)(gb - ga));
            bulk_load(st + kRmvHdrBytes, off + item * ostride + c0, obytes, pfull + s);
            bulk_load(st + kRmvHdrBytes + 4 * kRmvOffInts,
                      sched + (item * ngroups + c0 / kRmvCols) * kRmvCols, kRmvSchedBytes,
                      pfull + s);
            if (gb > ga)
              bulk_load(st + kRmvHdrBytes + 4 * kRmvOffInts + kRmvSchedBytes,
                        reinterpret_cast<const unsigned char*>(ent) + ga, (uint32_t)(gb - ga),
                        pfull + s);
          }
          __syncwarp();
          ++k;
          p0 = p1;
        } while (p0 < hi);
      }
    }
    return;
  }

  const int g = lane / GR::G, sl = lane % GR::G;
  const GR gr(lane);
  for (int i = tid; i < kRmvCols * KC; i += NW * 32) acc_s[i] = 0.f;
  int k = 0;
  for (int rc = 0; rc < nrc; ++rc) {
    const int cst = rc & 1;
    // the previous row chunk's sums are in place (and, first, the zeros)
    asm volatile("bar.sync 1, %0;" ::"r"(NW * 32) : "memory");
    mbar_wait(cfull + cst, (rc >> 1) & 1);
    const OT* cb = cs + cst * kCStage;
    int last;
    do {
      const int s = k % ps;
      mbar_wait(pfull + s, (uint32_t)((k / ps) & 1));
      const unsigned char* st = ring + (size_t)s * kRmvStageBytes;
      const int4 h = *reinterpret_cast<const int4*>(st);  // (p0, p1, shift, last)
      const int* so = reinterpret_cast<const int*>(st + kRmvHdrBytes);
      const uint8_t* sc = st + kRmvHdrBytes + 4 * kRmvOffInts + 16 * warp + g;  // + S j
      const E* se =
          reinterpret_cast<const E*>(st + kRmvHdrBytes + 4 * kRmvOffInts + kRmvSchedBytes);
      // the group's column of each step, its first entry in the stage and its
      // entries in this piece, the step's fullest column, its running sums: all
      // read before the walk
      int col[kRmvSteps], q[kRmvSteps], n[kRmvSteps], nmax[kRmvSteps];
#pragma unroll
      for (int j = 0; j < kRmvSteps; ++j) {
        col[j] = sc[S * j];
        q[j] = h.x;  // a group with no entries here reads the piece's first
        n[j] = 0;
        if (col[j] < ncols) {
          const int a = max(so[col[j]], h.x);
          n[j] = max(0, min(so[col[j] + 1], h.y) - a);
          if (n[j]) q[j] = a;
        }
        q[j] += h.z - h.x;  // item entry q lies at se[q - p0 + shift]
      }
#pragma unroll
      for (int j = 0; j < kRmvSteps; ++j) nmax[j] = __reduce_max_sync(kAll, n[j]);
      float a[kRmvSteps][KPL];
#pragma unroll
      for (int j = 0; j < kRmvSteps; ++j)
        if (n[j]) {
#pragma unroll
          for (int u = 0; u < KPL; ++u) a[j][u] = acc_s[col[j] * KC + sl * KPL + u];
        }
      // each entry in the form's order gathers the lanes' slices of its operand
      // row (16-byte loads) and adds KPL FMAs a lane; the next entry and its row
      // are read ahead
#pragma unroll
      for (int j = 0; j < kRmvSteps; ++j) {
        if (nmax[j] == 0) continue;
        const int lim = max(n[j] - 1, 0);  // a group reads its own entries only
        E e = se[q[j]];
        float x[KPL];
        gr.load(x, cb, Entry<PT>::row(e));
        for (int i = 0; i < nmax[j]; ++i) {
          const E en = se[q[j] + min(i + 1, lim)];
          float xn[KPL];
          gr.load(xn, cb, Entry<PT>::row(en));
          if (i < n[j]) {
            const float v = Entry<PT>::value(e);
#pragma unroll
            for (int u = 0; u < KPL; ++u) a[j][u] = fmaf(v, x[u], a[j][u]);
          }
          e = en;
#pragma unroll
          for (int u = 0; u < KPL; ++u) x[u] = xn[u];
        }
      }
#pragma unroll
      for (int j = 0; j < kRmvSteps; ++j)
        if (n[j]) {
#pragma unroll
          for (int u = 0; u < KPL; ++u) acc_s[col[j] * KC + sl * KPL + u] = a[j][u];
        }
      last = h.w;
      __syncwarp();
      if (lane == 0) mbar_arrive(pempty + s);
      ++k;
    } while (!last);
    if (lane == 0) mbar_arrive(cempty + cst);
  }
  asm volatile("bar.sync 1, %0;" ::"r"(NW * 32) : "memory");
  float* dst =
      part + (long long)blockIdx.y * ntiles * ct * kp + ((long long)t * ct + c0) * kp + kch * KC;
  const int kn = min(KC, kp - kch * KC);
  for (int i = tid; i < ncols * KC; i += NW * 32) {
    const int c = i / KC, u = i % KC;
    if (u < kn) dst[(long long)c * kp + u] = acc_s[i];
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

template <typename PT>
cudaError_t form_launch(const void* td, const void* tl, const void* start, void* cnt, void* ent,
                        void* off, void* sched, long long R, int wt, int ntiles, int ct,
                        int ostride, cudaStream_t stream) {
  const long long nrc = (R + kRmvRows - 1) / kRmvRows;
  if (ct < 1 || ct > (1 << kRmvColBits) || ostride % 4 || ostride < ct + 1 || ntiles > 65535 ||
      nrc > 0x7fffffffll)
    return cudaErrorInvalidValue;
  dim3 grid((unsigned)nrc, ntiles);
  if (cnt) {  // the count pass
    rmv_count_kernel<PT><<<grid, kRmvRows, 0, stream>>>(
        static_cast<const PT*>(td), static_cast<const int32_t*>(tl), R, wt, ct,
        static_cast<long long*>(cnt));
    return cudaGetLastError();
  }
  const size_t smem = 4 * (size_t)(kRmvWarps + 1) * ((ct + 3) & ~3);
  rmv_bucket_kernel<PT><<<grid, kRmvRows, smem, stream>>>(
      static_cast<const PT*>(td), static_cast<const int32_t*>(tl), R, wt, ct,
      static_cast<const long long*>(start), static_cast<typename Entry<PT>::T*>(ent),
      static_cast<int32_t*>(off), ostride, static_cast<uint8_t*>(sched));
  return cudaGetLastError();
}

template <typename PT, typename OT, int KC>
cudaError_t rmv_launch(const void* ent, const void* off, const void* start, const void* sched,
                       const void* cop, void* part, void* out, long long R, int ntiles, int ct,
                       int kp, long long rows_per_range, int nranges, int nch, int ncg, int ps,
                       int ostride, size_t smem, cudaStream_t stream) {
  if (ps < 2 || ps > kRmvMaxStages || rmv_smem_bytes<OT, KC>(ps) > smem ||
      rows_per_range % kRmvRows || nch < 1 || ncg < 1 || ostride % 4 || ostride < ct + 1)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      rmv_partial_kernel<PT, OT, KC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  float* dst = nranges == 1 ? static_cast<float*>(out) : static_cast<float*>(part);
  dim3 grid(ntiles, nranges, nch * ncg);
  rmv_partial_kernel<PT, OT, KC><<<grid, kRmvThreads, smem, stream>>>(
      static_cast<const typename Entry<PT>::T*>(ent), static_cast<const int32_t*>(off),
      static_cast<const long long*>(start), static_cast<const uint8_t*>(sched),
      static_cast<const OT*>(cop), dst, R, ntiles, ct, kp, rows_per_range, nch, ps, ostride);
  err = cudaGetLastError();
  if (err != cudaSuccess || nranges == 1) return err;
  const long long n = (long long)ntiles * ct * kp;
  rmv_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(out), n, nranges);
  return cudaGetLastError();
}

template <typename PT, typename OT>
cudaError_t rmv_dispatch(int kc, const void* ent, const void* off, const void* start,
                         const void* sched, const void* cop, void* part, void* out, long long R,
                         int ntiles, int ct,
                         int kp, long long rows_per_range, int nranges, int nch, int ncg, int ps,
                         int ostride, size_t smem, cudaStream_t s) {
  switch (kc) {
    case 32:
      return rmv_launch<PT, OT, 32>(ent, off, start, sched, cop, part, out, R, ntiles, ct, kp,
                                    rows_per_range, nranges, nch, ncg, ps, ostride, smem, s);
    case 64:
      return rmv_launch<PT, OT, 64>(ent, off, start, sched, cop, part, out, R, ntiles, ct, kp,
                                    rows_per_range, nranges, nch, ncg, ps, ostride, smem, s);
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

// The bucketed form of a contiguous [ntiles*wt, R] payload (bf16 or f32 values,
// int32 ids; ct <= 1024), in two calls. With `cnt` (int64 [ntiles * nrc], nrc =
// ceil(R / 256)): each item's stored entries. Then, with `cnt` null: `start` (int64
// [ntiles * nrc + 1], the exclusive sums of the counts), `ent` (4 bytes an entry for
// bf16 payloads, 8 for f32, 16-byte aligned) and `off` (int32 [ntiles * nrc][ostride],
// ostride a multiple of 4 above ct) are filled. Returns the launch's cudaError_t.
extern "C" int tiled_ell_rmv_form_launch(const void* td, const void* tl, const void* start,
                                         void* cnt, void* ent, void* off, void* sched,
                                         long long R, int wt, int ntiles, int ct, int ostride,
                                         int payload_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (payload_bf16)
    return form_launch<__nv_bfloat16>(td, tl, start, cnt, ent, off, sched, R, wt, ntiles, ct,
                                      ostride, s);
  return form_launch<float>(td, tl, start, cnt, ent, off, sched, R, wt, ntiles, ct, ostride, s);
}

// The caller guarantees the bucketed form of a [ntiles*wt, R] payload
// (tiled_ell_rmv_form_launch) with its entries padded by 16 bytes, the operand laid
// out [nch][R][kc] (swizzled like spmm's, by row; R a multiple of 8), a contiguous f32
// [ntiles*ct, kp] output, kc in {32, 64}, nch = ceil(kp / kc), ncg = ceil(ct / 256),
// rows_per_range a multiple of 256 with nranges = ceil(R / rows_per_range) <= 65535,
// ps piece stages (2 to 6), `smem` bytes of shared memory and, when nranges > 1, f32
// scratch `part` of nranges * ntiles * ct * kp elements. Returns the cudaError_t of
// the launches (0 = launched).
extern "C" int tiled_ell_rmv_t_launch(const void* ent, const void* off, const void* start,
                                      const void* sched, const void* cop, void* part, void* out, long long R,
                                      int ntiles, int ct, int kp, int kc,
                                      long long rows_per_range, int nranges, int nch, int ncg,
                                      int ps, int ostride, long long smem, int payload_bf16,
                                      int operand_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sm = (size_t)smem;
  if (payload_bf16 && operand_bf16)
    return rmv_dispatch<__nv_bfloat16, __nv_bfloat16>(kc, ent, off, start, sched, cop, part, out, R,
                                                      ntiles, ct, kp, rows_per_range, nranges,
                                                      nch, ncg, ps, ostride, sm, s);
  if (payload_bf16)
    return rmv_dispatch<__nv_bfloat16, float>(kc, ent, off, start, sched, cop, part, out, R, ntiles, ct,
                                              kp, rows_per_range, nranges, nch, ncg, ps, ostride,
                                              sm, s);
  if (operand_bf16)
    return rmv_dispatch<float, __nv_bfloat16>(kc, ent, off, start, sched, cop, part, out, R, ntiles, ct,
                                              kp, rows_per_range, nranges, nch, ncg, ps, ostride,
                                              sm, s);
  return rmv_dispatch<float, float>(kc, ent, off, start, sched, cop, part, out, R, ntiles, ct, kp,
                                    rows_per_range, nranges, nch, ncg, ps, ostride, sm, s);
}
