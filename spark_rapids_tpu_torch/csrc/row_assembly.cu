// JCUDF row conversion on Hopper (sm_90a).
//
// srt_to_rows replaces the TPU tile kernel assemble_rows_pallas
// (spark_rapids_tpu/ops/row_assembly_pallas.py:47); srt_from_rows replaces
// disassemble_rows_pallas (:136) together with the typed-column rebuild of
// convert_from_rows_pallas (:201).  Both compute the whole fixed-width
// conversion: the TPU's split of 8-byte values into u32 halves is not
// needed here, each field moves in its native width.  srt_to_rows_var
// replaces paste_strings_pallas (:281) and computes the whole
// variable-width to-rows (tables with strings): the TPU's padded
// (rows, max_row) matrix, its per-column (rows, pad) char matrices and
// the compaction gather are shape workarounds that are not needed here;
// each row is written once, straight to its offset.
//
// All three are pure data movement, bound by device-memory bytes.  At the
// bench shape (212 cycled fixed-width columns, 2^19 rows, 1096-byte rows):
//   to-rows   reads 960 B/row of columns, writes 1096 B/row of rows:
//             1.078 GB, at least 0.32 ms at 3.35 TB/s (H100 SXM).
//   from-rows reads 1096 B/row, writes 960 B/row of columns and 212 B/row
//             of validity: 1.19 GB, at least 0.36 ms.
// At the string main-path shape (155 cycled columns with 15 strings of
// 0-32 random bytes, 2^20 rows, an 888-byte fixed section):
//   to-rows-var reads 484 B/row of fixed-width columns, 52 B/row of
//             validity, about 240 B/row of chars and 64 B/row of string and
//             row offsets, and writes about 1132 B/row of rows: about
//             2.07 GB, at least about 0.62 ms (chip_smoke.py computes the
//             exact bound from its data).
// The design moves every byte through device memory once: one block owns
// a tile of rows in shared memory; column traffic is coalesced (consecutive
// threads take consecutive rows of one column) and the tile's rows, which
// are contiguous in the row buffer, move with 16-byte accesses.  Fields
// never overlap, so no atomics or ORs are needed.
//
// Plain C interface (bound with ctypes).  Kernels launch on the caller's
// stream, do not synchronise, allocate nothing; each entry point returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// One per column, in device memory (the bench schema has 212 columns, too
// many for kernel parameters).  Layout matches the (ncols, 5) int64 tensor
// the Python wrapper builds.
struct ToRowsCol {
  const uint8_t* data;   // (rows,) values of `width` bytes; DECIMAL128:
                         // (rows, 4) int32 limbs, width 16; STRING: chars
  const uint8_t* valid;  // (rows,) uint8, nonzero = valid; null = all valid
  long long width;       // 1, 2, 4, 8 or 16 (8 for a string's pair)
  long long start;       // byte offset of the field in the row
  const int* offsets;    // STRING: (rows+1,) int32 into data; else null
};

struct FromRowsCol {
  uint8_t* out;          // (rows,) values of `width` bytes
  long long width;
  long long start;
  long long unused;
};

// dst and src are aligned to min(width, 8): fields start at multiples of
// their size within rows that are multiples of 8 bytes, and the wrappers
// check the columns' base addresses.
__device__ __forceinline__ void copy_field(uint8_t* dst, const uint8_t* src,
                                           int width) {
  switch (width) {
    case 1:
      *dst = *src;
      break;
    case 2:
      *reinterpret_cast<uint16_t*>(dst) =
          *reinterpret_cast<const uint16_t*>(src);
      break;
    case 4:
      *reinterpret_cast<uint32_t*>(dst) =
          *reinterpret_cast<const uint32_t*>(src);
      break;
    case 8:
      *reinterpret_cast<uint64_t*>(dst) =
          *reinterpret_cast<const uint64_t*>(src);
      break;
    default:  // 16
      reinterpret_cast<uint64_t*>(dst)[0] =
          reinterpret_cast<const uint64_t*>(src)[0];
      reinterpret_cast<uint64_t*>(dst)[1] =
          reinterpret_cast<const uint64_t*>(src)[1];
      break;
  }
}

// Copy `bytes` (a multiple of 8) between shared and global memory with
// 16-byte accesses where the global side allows it, else 8-byte ones.
// The shared side is 16-byte aligned.
__device__ __forceinline__ void copy_block(uint8_t* dst, const uint8_t* src,
                                           int bytes, bool global_aligned16) {
  int done = 0;
  if (global_aligned16) {
    const int n16 = bytes >> 4;
    uint4* d = reinterpret_cast<uint4*>(dst);
    const uint4* s = reinterpret_cast<const uint4*>(src);
    for (int i = threadIdx.x; i < n16; i += blockDim.x) d[i] = s[i];
    done = n16 << 4;
  }
  const int n8 = (bytes - done) >> 3;
  uint2* d = reinterpret_cast<uint2*>(dst + done);
  const uint2* s = reinterpret_cast<const uint2*>(src + done);
  for (int i = threadIdx.x; i < n8; i += blockDim.x) d[i] = s[i];
}

__global__ void __launch_bounds__(kThreads)
to_rows_kernel(const ToRowsCol* __restrict__ cols, int ncols,
               long long rows, int row_size, int validity_offset,
               int log2_tile, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t tile[];
  const int tile_rows = 1 << log2_tile;
  const long long row0 = static_cast<long long>(blockIdx.x) << log2_tile;
  const int n = static_cast<int>(min(static_cast<long long>(tile_rows),
                                     rows - row0));
  const int tile_bytes = n * row_size;

  // alignment gaps and the row's tail padding are zero
  uint2* t8 = reinterpret_cast<uint2*>(tile);
  for (int i = threadIdx.x; i < (tile_bytes >> 3); i += blockDim.x)
    t8[i] = make_uint2(0u, 0u);
  __syncthreads();

  // fields: thread i takes row i % tile_rows of column i / tile_rows
  for (int i = threadIdx.x; i < (ncols << log2_tile); i += blockDim.x) {
    const int r = i & (tile_rows - 1);
    if (r >= n) continue;
    const ToRowsCol col = cols[i >> log2_tile];
    const int w = static_cast<int>(col.width);
    copy_field(tile + r * row_size + col.start, col.data + (row0 + r) * w, w);
  }

  // validity: one thread per (validity byte, row) packs up to 8 bits
  const int nvbytes = (ncols + 7) >> 3;
  for (int i = threadIdx.x; i < (nvbytes << log2_tile); i += blockDim.x) {
    const int r = i & (tile_rows - 1);
    if (r >= n) continue;
    const int c0 = (i >> log2_tile) << 3;
    unsigned bits = 0;
    for (int k = 0; k < 8 && c0 + k < ncols; ++k) {
      const uint8_t* v = cols[c0 + k].valid;
      if (v == nullptr || v[row0 + r] != 0) bits |= 1u << k;
    }
    tile[r * row_size + validity_offset + (c0 >> 3)] =
        static_cast<uint8_t>(bits);
  }
  __syncthreads();

  uint8_t* dst = out + row0 * row_size;
  copy_block(dst, tile, tile_bytes,
             (reinterpret_cast<uintptr_t>(dst) & 15) == 0);
}

__global__ void __launch_bounds__(kThreads)
from_rows_kernel(const uint8_t* __restrict__ in, long long rows,
                 int row_size, int validity_offset,
                 const FromRowsCol* __restrict__ cols, int ncols,
                 uint8_t* __restrict__ valid_out, int log2_tile) {
  extern __shared__ __align__(16) uint8_t tile[];
  const int tile_rows = 1 << log2_tile;
  const long long row0 = static_cast<long long>(blockIdx.x) << log2_tile;
  const int n = static_cast<int>(min(static_cast<long long>(tile_rows),
                                     rows - row0));
  const uint8_t* src = in + row0 * row_size;
  copy_block(tile, src, n * row_size,
             (reinterpret_cast<uintptr_t>(src) & 15) == 0);
  __syncthreads();

  // thread i writes row i % tile_rows of column i / tile_rows, value and
  // validity
  for (int i = threadIdx.x; i < (ncols << log2_tile); i += blockDim.x) {
    const int r = i & (tile_rows - 1);
    if (r >= n) continue;
    const int c = i >> log2_tile;
    const FromRowsCol col = cols[c];
    const int w = static_cast<int>(col.width);
    const uint8_t* row = tile + r * row_size;
    copy_field(col.out + (row0 + r) * w, row + col.start, w);
    valid_out[c * rows + row0 + r] =
        (row[validity_offset + (c >> 3)] >> (c & 7)) & 1;
  }
}

// Variable-width rows (tables with strings).  Row r starts at
// row_offsets[r] (a multiple of 8) and is: the fixed section of
// fixed_size bytes (fields, each string's (start in row, length) uint32
// pair, validity), each string column's bytes in column order, then zeros
// up to the row's end.
//
// One block per tile of 2^log2_tile rows.  Phase 1 builds the tile's fixed
// sections in shared memory (stride fixed_row = fixed_size rounded up to
// 8): one thread per row walks the string columns to get each string's
// start; fixed fields and validity as in to_rows_kernel.  Phase 2 writes
// each row with one warp: the fixed section with 8-byte stores where the
// whole word is fixed-section bytes, then each string's bytes with the
// lanes striding over them, then the zero tail.  The byte ranges are
// disjoint, so no write races another.  A null string's bytes are copied
// too, as the reference copies them.
__global__ void __launch_bounds__(kThreads)
to_rows_var_kernel(const ToRowsCol* __restrict__ cols, int ncols,
                   const long long* __restrict__ str_idx, int nstr,
                   long long rows, int fixed_size, int validity_offset,
                   const int* __restrict__ row_offsets, int log2_tile,
                   uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t tile[];
  const int fixed_row = (fixed_size + 7) & ~7;
  const int tile_rows = 1 << log2_tile;
  const long long row0 = static_cast<long long>(blockIdx.x) << log2_tile;
  const int n = static_cast<int>(min(static_cast<long long>(tile_rows),
                                     rows - row0));
  int* row_end = reinterpret_cast<int*>(tile + (fixed_row << log2_tile));

  uint2* t8 = reinterpret_cast<uint2*>(tile);
  for (int i = threadIdx.x; i < ((n * fixed_row) >> 3); i += blockDim.x)
    t8[i] = make_uint2(0u, 0u);
  __syncthreads();

  // string (start in row, length) pairs: one thread per row
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    const long long g = row0 + r;
    unsigned cur = static_cast<unsigned>(fixed_size);
    for (int k = 0; k < nstr; ++k) {
      const ToRowsCol col = cols[str_idx[k]];
      const unsigned len =
          static_cast<unsigned>(col.offsets[g + 1] - col.offsets[g]);
      unsigned* pair =
          reinterpret_cast<unsigned*>(tile + r * fixed_row + col.start);
      pair[0] = cur;
      pair[1] = len;
      cur += len;
    }
    row_end[r] = static_cast<int>(cur);
  }

  // fixed-width fields: thread i takes row i % tile_rows of column
  // i / tile_rows
  for (int i = threadIdx.x; i < (ncols << log2_tile); i += blockDim.x) {
    const int r = i & (tile_rows - 1);
    if (r >= n) continue;
    const ToRowsCol col = cols[i >> log2_tile];
    if (col.offsets != nullptr) continue;
    const int w = static_cast<int>(col.width);
    copy_field(tile + r * fixed_row + col.start, col.data + (row0 + r) * w,
               w);
  }

  const int nvbytes = (ncols + 7) >> 3;
  for (int i = threadIdx.x; i < (nvbytes << log2_tile); i += blockDim.x) {
    const int r = i & (tile_rows - 1);
    if (r >= n) continue;
    const int c0 = (i >> log2_tile) << 3;
    unsigned bits = 0;
    for (int k = 0; k < 8 && c0 + k < ncols; ++k) {
      const uint8_t* v = cols[c0 + k].valid;
      if (v == nullptr || v[row0 + r] != 0) bits |= 1u << k;
    }
    tile[r * fixed_row + validity_offset + (c0 >> 3)] =
        static_cast<uint8_t>(bits);
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int nfw = fixed_size >> 3;  // whole 8-byte words of fixed section
  for (int r = threadIdx.x >> 5; r < n; r += nwarps) {
    const long long g = row0 + r;
    const uint8_t* src = tile + r * fixed_row;
    uint8_t* dst = out + row_offsets[g];
    for (int i = lane; i < nfw; i += 32)
      reinterpret_cast<uint2*>(dst)[i] =
          reinterpret_cast<const uint2*>(src)[i];
    for (int i = (nfw << 3) + lane; i < fixed_size; i += 32) dst[i] = src[i];
    for (int k = 0; k < nstr; ++k) {
      const ToRowsCol col = cols[str_idx[k]];
      const unsigned* pair =
          reinterpret_cast<const unsigned*>(src + col.start);
      const uint8_t* chars = col.data + col.offsets[g];
      uint8_t* d = dst + pair[0];
      const int len = static_cast<int>(pair[1]);
      for (int j = lane; j < len; j += 32) d[j] = chars[j];
    }
    const int row_size = row_offsets[g + 1] - row_offsets[g];
    for (int i = row_end[r] + lane; i < row_size; i += 32) dst[i] = 0;
  }
}

template <typename Kernel>
cudaError_t reserve_shared(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

}  // namespace

extern "C" int srt_to_rows(const void* cols, int ncols, long long rows,
                           int row_size, int validity_offset, int log2_tile,
                           void* out, void* stream) {
  const size_t smem = static_cast<size_t>(row_size) << log2_tile;
  cudaError_t err = reserve_shared(to_rows_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (rows + (1LL << log2_tile) - 1) >> log2_tile;
  to_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const ToRowsCol*>(cols), ncols, rows, row_size,
      validity_offset, log2_tile, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int srt_from_rows(const void* in, long long rows, int row_size,
                             int validity_offset, const void* cols,
                             int ncols, void* valid_out, int log2_tile,
                             void* stream) {
  const size_t smem = static_cast<size_t>(row_size) << log2_tile;
  cudaError_t err = reserve_shared(from_rows_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (rows + (1LL << log2_tile) - 1) >> log2_tile;
  from_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), rows, row_size, validity_offset,
      static_cast<const FromRowsCol*>(cols), ncols,
      static_cast<uint8_t*>(valid_out), log2_tile);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int srt_to_rows_var(const void* cols, int ncols,
                               const void* str_idx, int nstr,
                               long long rows, int fixed_size,
                               int validity_offset, const void* row_offsets,
                               int log2_tile, void* out, void* stream) {
  const int fixed_row = (fixed_size + 7) & ~7;
  const size_t smem = (static_cast<size_t>(fixed_row) + sizeof(int))
                      << log2_tile;
  cudaError_t err = reserve_shared(to_rows_var_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (rows + (1LL << log2_tile) - 1) >> log2_tile;
  to_rows_var_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const ToRowsCol*>(cols), ncols,
      static_cast<const long long*>(str_idx), nstr, rows, fixed_size,
      validity_offset, static_cast<const int*>(row_offsets), log2_tile,
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
