// Densify one row slab of the column-tiled padded-ELL payload (Hopper).
//
// Replaces the Pallas TPU kernel tiled_ell_densify_t
// (single_algebra_tpu/ops/pallas/spmm_kernel.py). Input: the transposed
// bucket payload tdata/tlocal [ntiles*wt, ld] (f32 values, int32
// tile-local column ids, padding slots (v=0, lid=0)); the slab is the
// column window [row_offset, row_offset + R) of it. Output: the dense
// transposed slab out[ntiles*ct, R] in int8, bf16 or f32, where
// out[t*ct + c, r] is the float32 sum, in slot order, of the slab row's
// values in tile t whose id is c, cast once. The TPU kernel built the same
// sum as a one-hot compare/select over all ct columns for each slot,
// because the TPU has no scatter.
//
// What bounds it: the write of the dense slab. At the north-star shape
// (ct=256, ntiles=120, R=8192, wt=8) one slab reads 63 MB of payload and
// writes 251 MB (int8), 503 MB (bf16) or 1007 MB (f32). Nothing is
// multiplied, so the bound is those bytes over the memory rate.
//
// densify_tile_kernel, the kernel the port launches for every wt. A block
// is 256 threads and owns one column tile and 256 consecutive slab rows;
// thread i owns row r0+i.
//   1. The thread loads its row's first WT (value, id) slots into
//      registers, all 2*WT loads issued before the first use (WT is a
//      template parameter in {4, 8, 16}, or 32 in the tail; wt is rounded
//      up to it with the extra slots masked), as coalesced 128-byte warp
//      loads.
//   2. In registers it forms, for each slot, the float32 sum in slot
//      order of the later slots with the same id (WT^2 compares), and
//      marks the first slot of each id: that slot alone will write, once,
//      the sum already cast to the output type. So the staging tile is
//      held in the OUTPUT type (4x smaller than a float32 accumulator for
//      int8), is never read back as float32, and zero-filling it is the
//      only pass over it that does not carry output bytes.
//   3. The tile's ct columns go out in chunks of CC columns through two
//      16 KB staging buffers [CC][256] in shared memory: zero-fill, the
//      marked slots scatter their cast sums, then the chunk leaves as
//      16-byte vector stores, a staged column being 256 consecutive
//      outputs of one dense row (256 B in int8, 1 KB in float32), so a
//      warp's store covers whole 128-byte lines. With two buffers a chunk
//      costs two block barriers and the zero-fill of the next chunk
//      overlaps the stores of this one. Row groups are the fastest grid
//      dimension, so blocks that run together write neighbouring pieces
//      of the same dense rows.
// The tail, wt > 16 (the rare buckets of heavy rows; instantiated apart,
// kTail, so that it costs the common widths no register): the row's slots
// are taken 32 at a time. A group's sums also take in, still in slot
// order, the same-id slots of the later groups, and a slot is first only
// if no earlier group holds its id; those other groups' slots are read
// again from memory (they sit in the cache: the block's payload is wt x
// 2 KB). Group 0 stays in registers as above, so up to wt 32 nothing is
// formed twice; each later group is formed again for every chunk and
// scatters into the same staging buffer.
// 32 KB of shared memory a block leaves room for 6 blocks (48 warps) an
// SM, each warp with 2*WT loads in flight. Measured on an H100 at the
// north-star slab: 81-84 % of the byte bound in every output type at wt 8
// and 16, and 58 %, 62 % and 73 % at wt 32, where the 226-254 registers of
// the tail leave one block an SM. A block of one warp with a float32
// [ct][32] accumulator in shared memory, one shared-memory add a slot,
// reached 36 %, 62 % and 72 % (int8, bf16, f32) at wt 8 and 16 and
// 29-55 % at wt 32. Bulk asynchronous stores (cp.async.bulk shared ->
// global) in place of the vector stores, and blocks of 128 rows, gave the
// same times within 8 %.
//
// It drops ids outside [0, ct), sums duplicate ids in slot order in
// float32 starting from +0, and saturates float -> int8 with NaN -> 0, so
// it agrees bit for bit with the one-hot form.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// float -> int8 saturates (and maps NaN to 0), as XLA's convert does
__device__ __forceinline__ signed char to_i8(float x) {
  int i = __float2int_rz(x);
  return static_cast<signed char>(max(-128, min(127, i)));
}

template <typename OutT>
__device__ __forceinline__ OutT cast_out(float x);
template <>
__device__ __forceinline__ float cast_out<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 cast_out<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ int8_t cast_out<int8_t>(float x) {
  return to_i8(x);
}

constexpr int kBufBytes = 16384;  // one staging buffer; a block has two

constexpr int kTileRows = 256;  // slab rows (and threads) per block

// Slots [g0, g0 + WT) of one slab row (its slot 0 at `base`): for each, the
// float32 sum in slot order of this and every later slot of the row with
// the same id, and in `col` that id if the slot is the row's first with
// it (else -1: the slot writes nothing). Ids outside [0, ct) are dropped,
// as the one-hot drops them. With kTail the row may have slots outside
// the group, which are read one by one; without it wt <= WT.
template <int WT, bool kTail>
__device__ __forceinline__ void group_sums(const float* __restrict__ tdata,
                                           const int32_t* __restrict__ tlocal, long long base,
                                           long long ld, int g0, int wt, int ct, bool live_row,
                                           float (&s)[WT], int (&col)[WT]) {
  // every load issued before the first use
  float v[WT];
  int id[WT];
#pragma unroll
  for (int w = 0; w < WT; ++w) {
    const bool live = live_row && g0 + w < wt;
    const long long at = base + (long long)(g0 + w) * ld;
    v[w] = live ? __ldg(tdata + at) : 0.f;
    id[w] = live ? __ldg(tlocal + at) : -1;
  }
#pragma unroll
  for (int w = 0; w < WT; ++w)
    if ((unsigned)id[w] >= (unsigned)ct) id[w] = -1;
#pragma unroll
  for (int w = 0; w < WT; ++w) {
    float acc = __fadd_rn(0.f, v[w]);  // the one-hot sum starts from +0
    bool first = true;
#pragma unroll
    for (int u = 0; u < WT; ++u) {
      if (u < w) first = first && (id[u] != id[w]);
      if (u > w && id[u] == id[w]) acc = __fadd_rn(acc, v[u]);
    }
    s[w] = acc;
    col[w] = first ? id[w] : -1;
  }
  if (kTail && live_row) {
    for (int u = 0; u < g0; ++u) {  // earlier groups: is the id theirs?
      const int idu = __ldg(tlocal + base + (long long)u * ld);
#pragma unroll
      for (int w = 0; w < WT; ++w)
        if (idu == id[w]) col[w] = -1;
    }
    for (int u = g0 + WT; u < wt; ++u) {  // later groups: still in slot order
      const long long at = base + (long long)u * ld;
      const int idu = __ldg(tlocal + at);
      const float vu = __ldg(tdata + at);
#pragma unroll
      for (int w = 0; w < WT; ++w)
        if (idu == id[w]) s[w] = __fadd_rn(s[w], vu);
    }
  }
}

template <typename OutT, int WT, bool kTail>
__global__ void __launch_bounds__(kTileRows)
    densify_tile_kernel(const float* __restrict__ tdata, const int32_t* __restrict__ tlocal,
                        OutT* __restrict__ out, long long ld, long long row_offset, int R,
                        int wt, int ct) {
  constexpr int RB = kTileRows;
  constexpr int CC = kBufBytes / (RB * (int)sizeof(OutT));  // columns staged per chunk
  constexpr int V = RB * (int)sizeof(OutT) / 16;  // 16-byte vectors a staged column
  constexpr int kVecs = kBufBytes / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  const int t = blockIdx.y;
  const int r0 = blockIdx.x * RB;
  const int tid = threadIdx.x;
  const int valid = min(RB, R - r0);  // a multiple of 32
  const bool live_row = tid < valid;

  // 1, 2. this row's first WT slots of tile t, and their sums per id
  const long long base = (long long)t * wt * ld + row_offset + r0 + tid;
  float s[WT];
  int col[WT];
  group_sums<WT, kTail>(tdata, tlocal, base, ld, 0, wt, ct, live_row, s, col);

  // 3. the tile's columns, CC at a time, through the two staging buffers
  unsigned char* orow = reinterpret_cast<unsigned char*>(out + (long long)t * ct * R + r0);
  const long long pitch = (long long)R * sizeof(OutT);  // bytes between dense rows
  const int vvalid = valid * (int)sizeof(OutT) / 16;  // vectors of a column inside the slab
  const int nchunks = (ct + CC - 1) / CC;
  for (int i = 0; i < nchunks; ++i) {
    unsigned char* raw = smem + (i & 1) * kBufBytes;
    OutT* buf = reinterpret_cast<OutT*>(raw);  // [CC][RB]
    uint4* buf4 = reinterpret_cast<uint4*>(raw);
    const int c0 = i * CC;
    const int ncols = min(CC, ct - c0);
#pragma unroll
    for (int j = tid; j < kVecs; j += RB) buf4[j] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
#pragma unroll
    for (int w = 0; w < WT; ++w) {
      const int c = col[w] - c0;
      if ((unsigned)c < (unsigned)CC) buf[c * RB + tid] = cast_out<OutT>(s[w]);
    }
    if (kTail) {
      for (int g0 = WT; g0 < wt; g0 += WT) {
        float sg[WT];
        int colg[WT];
        group_sums<WT, true>(tdata, tlocal, base, ld, g0, wt, ct, live_row, sg, colg);
#pragma unroll
        for (int w = 0; w < WT; ++w) {
          const int c = colg[w] - c0;
          if ((unsigned)c < (unsigned)CC) buf[c * RB + tid] = cast_out<OutT>(sg[w]);
        }
      }
    }
    __syncthreads();
    for (int j = tid; j < ncols * V; j += RB) {
      const int c = j / V, q = j % V;
      if (q < vvalid) *reinterpret_cast<uint4*>(orow + (c0 + c) * pitch + q * 16) = buf4[j];
    }
  }
}

template <typename OutT, int WT, bool kTail>
cudaError_t launch_tile_wt(const float* tdata, const int32_t* tlocal, void* out, long long ld,
                           long long row_offset, int R, int wt, int ntiles, int ct,
                           cudaStream_t stream) {
  dim3 grid((R + kTileRows - 1) / kTileRows, ntiles);
  densify_tile_kernel<OutT, WT, kTail><<<grid, kTileRows, 2 * kBufBytes, stream>>>(
      tdata, tlocal, static_cast<OutT*>(out), ld, row_offset, R, wt, ct);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_tile(const float* tdata, const int32_t* tlocal, void* out, long long ld,
                        long long row_offset, int R, int wt, int ntiles, int ct,
                        cudaStream_t stream) {
  if (wt <= 4)
    return launch_tile_wt<OutT, 4, false>(tdata, tlocal, out, ld, row_offset, R, wt, ntiles, ct,
                                          stream);
  if (wt <= 8)
    return launch_tile_wt<OutT, 8, false>(tdata, tlocal, out, ld, row_offset, R, wt, ntiles, ct,
                                          stream);
  if (wt <= 16)
    return launch_tile_wt<OutT, 16, false>(tdata, tlocal, out, ld, row_offset, R, wt, ntiles,
                                           ct, stream);
  return launch_tile_wt<OutT, 32, true>(tdata, tlocal, out, ld, row_offset, R, wt, ntiles, ct,
                                        stream);
}

}  // namespace

// out_kind: 0 = int8, 1 = bf16, 2 = f32. The caller guarantees R % 32 ==
// 0, contiguous [ntiles*wt, ld] inputs and a contiguous 16-byte-aligned
// [ntiles*ct, R] output. Returns the launch's cudaError_t (0 = launched).

// The tile kernel: any wt >= 1, any ct >= 1, ntiles <= 65535.
extern "C" int tiled_ell_densify_t_f32(const void* tdata, const void* tlocal,
                                       void* out, long long ld,
                                       long long row_offset, int R, int wt,
                                       int ntiles, int ct, int out_kind,
                                       void* stream) {
  const float* td = static_cast<const float*>(tdata);
  const int32_t* tl = static_cast<const int32_t*>(tlocal);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_kind) {
    case 0:
      return launch_tile<int8_t>(td, tl, out, ld, row_offset, R, wt, ntiles, ct, s);
    case 1:
      return launch_tile<__nv_bfloat16>(td, tl, out, ld, row_offset, R, wt, ntiles, ct, s);
    case 2:
      return launch_tile<float>(td, tl, out, ld, row_offset, R, wt, ntiles, ct, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
