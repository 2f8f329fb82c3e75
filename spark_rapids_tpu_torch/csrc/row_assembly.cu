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
// a tile's rows are built in shared memory and written once, as the one
// contiguous range they are in the output.
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
// threads take consecutive rows of one column, a string column's chars
// for the tile are read as one run) and the tile's rows, which are
// contiguous in the row buffer, move with 16-byte accesses.  Fields never
// overlap, so no atomics or ORs are needed.
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

// Field loads and stores for the variable-width kernel, split so that a
// thread can have several loads in flight before it stores.  Alignment as
// for copy_field.
__device__ __forceinline__ uint4 load_field(const uint8_t* src, int width) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  switch (width) {
    case 1:
      v.x = *src;
      break;
    case 2:
      v.x = *reinterpret_cast<const uint16_t*>(src);
      break;
    case 4:
      v.x = *reinterpret_cast<const uint32_t*>(src);
      break;
    case 8: {
      const uint2 t = *reinterpret_cast<const uint2*>(src);
      v.x = t.x;
      v.y = t.y;
      break;
    }
    default: {  // 16
      const uint2 t0 = reinterpret_cast<const uint2*>(src)[0];
      const uint2 t1 = reinterpret_cast<const uint2*>(src)[1];
      v = make_uint4(t0.x, t0.y, t1.x, t1.y);
      break;
    }
  }
  return v;
}

__device__ __forceinline__ void store_field(uint8_t* dst, uint4 v,
                                            int width) {
  switch (width) {
    case 1:
      *dst = static_cast<uint8_t>(v.x);
      break;
    case 2:
      *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>(v.x);
      break;
    case 4:
      *reinterpret_cast<uint32_t*>(dst) = v.x;
      break;
    case 8:
      *reinterpret_cast<uint2*>(dst) = make_uint2(v.x, v.y);
      break;
    default:  // 16
      reinterpret_cast<uint2*>(dst)[0] = make_uint2(v.x, v.y);
      reinterpret_cast<uint2*>(dst)[1] = make_uint2(v.z, v.w);
      break;
  }
}

// Shared memory of the variable-width kernel, in bytes from its start:
// the row buffer (buf_bytes, a multiple of 16), then the column
// descriptors, the tile's string offsets (nstr x (tile_rows + 1) int32),
// each string's position (nstr x tile_rows), the rows' starts in the tile
// (tile_rows + 1), each row's fixed section in the buffer (tile_rows), the
// string column indices (nstr) and the chars items' prefix (nstr + 1).
// row_assembly_cuda.var_smem_bytes mirrors `end`.
struct VarSmem {
  int desc, soff, vpos, rstart, at, sidx, items, end;
};

__host__ __device__ inline VarSmem var_smem_layout(int buf_bytes, int ncols,
                                                   int nstr, int tile_rows) {
  VarSmem l;
  l.desc = buf_bytes;
  l.soff = l.desc + ncols * static_cast<int>(sizeof(ToRowsCol));
  l.vpos = l.soff + nstr * (tile_rows + 1) * 4;
  l.rstart = l.vpos + nstr * tile_rows * 4;
  l.at = l.rstart + (tile_rows + 1) * 4;
  l.sidx = l.at + tile_rows * 4;
  l.items = l.sidx + nstr * 4;
  l.end = l.items + (nstr + 1) * 4;
  return l;
}

// Variable-width rows (tables with strings).  Row r starts at
// row_offsets[r] (a multiple of 8) and is: the fixed section of
// fixed_size bytes (fields, each string's (start in row, length) uint32
// pair, validity), each string column's bytes in column order, then zeros
// up to the row's end.
//
// One block per tile of 2^log2_tile rows.  The tile's rows are one
// contiguous range of the output, [row_offsets[row0], row_offsets[row0+n]).
// The block first stages in shared memory the column descriptors, the
// tile's row starts and each string column's n+1 offsets.  Then it takes
// one of two paths, decided from its own row offsets:
//   staged, when the range fits the row buffer (span + 8 <= buf_bytes):
//     the whole tile is built in the zeroed buffer at its tile-local
//     offsets.  Fixed fields as in to_rows_kernel (thread i takes row
//     i % tile of column i / tile), four loads in flight a thread;
//     validity bits with the eight columns' loads in flight together;
//     the (start, length) pairs by one thread per row, reading shared
//     memory only.  Each string column's chars for the tile are one
//     contiguous run, chars[offsets[row0] : offsets[row0+n]]: the threads
//     stride over it in items, a byte at the unaligned head and tail and a
//     16-byte load between, two items in flight a thread, and find each
//     item's row by a binary search over the staged offsets.  Then the
//     block writes the range with 16-byte stores; the buffer starts 8
//     bytes in when the range starts 8 mod 16, so that its 16-byte words
//     line up with the output's, and that head goes out as one 8-byte
//     store.
//   direct, for a tile of long rows: the fixed sections are built in the
//     buffer at a stride of fixed_size rounded up to 8, then the block
//     writes one row after another straight to device memory: the fixed
//     section in 8-byte words, each string's bytes with the threads
//     striding over them (eight loads in flight a thread), the zero tail.
// The wrapper sizes the buffer from the mean row (the offsets' total), so
// that a typical tile takes the staged path.  A null string's bytes are
// copied too, as the reference copies them.
//
// What bounds it: each tile waits on a chain of dependent rounds (its
// offsets, then its fields, then its chars, then the store), and
// registers and shared memory hold four blocks an SM, so the chains are
// not hidden; larger tiles lengthen the chains and cost blocks.
__global__ void __launch_bounds__(kThreads)
to_rows_var_kernel(const ToRowsCol* __restrict__ cols, int ncols,
                   const long long* __restrict__ str_idx, int nstr,
                   long long rows, int fixed_size, int validity_offset,
                   const int* __restrict__ row_offsets, int log2_tile,
                   int buf_bytes, uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tile_rows = 1 << log2_tile;
  const long long row0 = static_cast<long long>(blockIdx.x) << log2_tile;
  const int n = static_cast<int>(min(static_cast<long long>(tile_rows),
                                     rows - row0));
  const VarSmem l = var_smem_layout(buf_bytes, ncols, nstr, tile_rows);
  ToRowsCol* desc = reinterpret_cast<ToRowsCol*>(smem + l.desc);
  int* soff = reinterpret_cast<int*>(smem + l.soff);  // [k*(tile_rows+1)+i]
  int* vpos = reinterpret_cast<int*>(smem + l.vpos);  // [k*tile_rows+r]
  int* rstart = reinterpret_cast<int*>(smem + l.rstart);
  int* at = reinterpret_cast<int*>(smem + l.at);
  int* sidx = reinterpret_cast<int*>(smem + l.sidx);
  int* items = reinterpret_cast<int*>(smem + l.items);

  const int base = row_offsets[row0];
  const int span = row_offsets[row0 + n] - base;
  const int fixed_row = (fixed_size + 7) & ~7;
  uint8_t* dst = out + base;
  const bool staged = span + 8 <= buf_bytes;
  // staged: byte i of the range sits at smem[sh + i], sh = dst mod 16
  const int sh = static_cast<int>(reinterpret_cast<uintptr_t>(dst) & 15);

  {
    const long long* s = reinterpret_cast<const long long*>(cols);
    long long* d = reinterpret_cast<long long*>(desc);
    for (int i = threadIdx.x; i < ncols * 5; i += blockDim.x) d[i] = s[i];
  }
  for (int k = threadIdx.x; k < nstr; k += blockDim.x)
    sidx[k] = static_cast<int>(str_idx[k]);
  for (int i = threadIdx.x; i <= n; i += blockDim.x) {
    const int rs = row_offsets[row0 + i] - base;
    rstart[i] = rs;
    if (i < n) at[i] = staged ? sh + rs : i * fixed_row;
  }
  for (int i = threadIdx.x; i < nstr * (n + 1); i += blockDim.x) {
    const int k = i / (n + 1);
    const int j = i - k * (n + 1);
    soff[k * (tile_rows + 1) + j] = cols[str_idx[k]].offsets[row0 + j];
  }
  // gaps, the rows' tails and the direct path's unused bytes are zero
  const int zero_bytes = staged ? sh + span : n * fixed_row;
  uint4* z = reinterpret_cast<uint4*>(smem);
  for (int i = threadIdx.x; i < ((zero_bytes + 15) >> 4); i += blockDim.x)
    z[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // (start in row, length) pairs and each string's position (in the
  // buffer when staged, in the row when direct): one thread per row
  for (int r = threadIdx.x; r < n; r += blockDim.x) {
    uint8_t* row = smem + at[r];
    int cur = fixed_size;
    for (int k = 0; k < nstr; ++k) {
      const int* o = soff + k * (tile_rows + 1);
      const int len = o[r + 1] - o[r];
      unsigned* pair = reinterpret_cast<unsigned*>(
          row + desc[sidx[k]].start);
      pair[0] = static_cast<unsigned>(cur);
      pair[1] = static_cast<unsigned>(len);
      vpos[k * tile_rows + r] = staged ? at[r] + cur : cur;
      cur += len;
    }
  }
  // the chars items of each string column (see the staged copy below)
  if (staged && threadIdx.x == blockDim.x - 1) {
    int acc = 0;
    items[0] = 0;
    for (int k = 0; k < nstr; ++k) {
      const int* o = soff + k * (tile_rows + 1);
      const int len = o[n] - o[0];
      const uintptr_t a =
          reinterpret_cast<uintptr_t>(desc[sidx[k]].data + o[0]);
      const int head = min(len, static_cast<int>((16 - (a & 15)) & 15));
      const int rest = len - head;
      acc += head + (rest >> 4) + (rest & 15);
      items[k + 1] = acc;
    }
  }

  // fixed-width fields: thread i takes row i % tile_rows of column
  // i / tile_rows, four loads in flight before the stores
  const int nfield = ncols << log2_tile;
  for (int i0 = threadIdx.x; i0 < nfield; i0 += 4 * blockDim.x) {
    uint4 v[4];
    int w[4];
    int d[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u * static_cast<int>(blockDim.x);
      const int r = i & (tile_rows - 1);
      w[u] = 0;
      if (i < nfield && r < n) {
        const ToRowsCol& col = desc[i >> log2_tile];
        if (col.offsets == nullptr) {
          w[u] = static_cast<int>(col.width);
          d[u] = at[r] + static_cast<int>(col.start);
          v[u] = load_field(col.data + (row0 + r) * w[u], w[u]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (w[u]) store_field(smem + d[u], v[u], w[u]);
  }

  const int nvbytes = (ncols + 7) >> 3;
  for (int i = threadIdx.x; i < (nvbytes << log2_tile); i += blockDim.x) {
    const int r = i & (tile_rows - 1);
    if (r >= n) continue;
    const int c0 = (i >> log2_tile) << 3;
    uint8_t x[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint8_t* v = c0 + k < ncols ? desc[c0 + k].valid : nullptr;
      x[k] = v != nullptr ? v[row0 + r] : 1;
    }
    unsigned bits = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (x[k] != 0 && c0 + k < ncols) bits |= 1u << k;
    smem[at[r] + validity_offset + (c0 >> 3)] = static_cast<uint8_t>(bits);
  }
  __syncthreads();

  if (staged) {
    // chars: item j of column k is byte j of the run's unaligned head,
    // then a 16-byte word, then a byte of the tail; two loads in flight
    int k = 0;
    for (int i0 = threadIdx.x; i0 < items[nstr]; i0 += 2 * blockDim.x) {
      uint4 q[2];
      int ik[2];
      int ip[2];
      int irow[2];
      int iw[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = i0 + u * static_cast<int>(blockDim.x);
        iw[u] = 0;
        if (i >= items[nstr]) continue;
        while (items[k + 1] <= i) ++k;
        const int* o = soff + k * (tile_rows + 1);
        const uint8_t* chars = desc[sidx[k]].data;
        const int a = o[0];
        const int len = o[n] - a;
        const int head = min(len, static_cast<int>(
            (16 - (reinterpret_cast<uintptr_t>(chars + a) & 15)) & 15));
        const int nw = (len - head) >> 4;
        const int j = i - items[k];
        int p;
        int w = 1;
        if (j < head) {
          p = a + j;
        } else if (j < head + nw) {
          p = a + head + ((j - head) << 4);
          w = 16;
        } else {
          p = a + head + (nw << 4) + (j - head - nw);
        }
        int lo = 0;
        int hi = n;
        while (hi - lo > 1) {
          const int mid = (lo + hi) >> 1;
          if (o[mid] <= p) lo = mid; else hi = mid;
        }
        if (w == 16)
          q[u] = *reinterpret_cast<const uint4*>(chars + p);
        else
          q[u].x = chars[p];
        ik[u] = k;
        ip[u] = p;
        irow[u] = lo;
        iw[u] = w;
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (iw[u] == 0) continue;
        const int* o = soff + ik[u] * (tile_rows + 1);
        const int* pos = vpos + ik[u] * tile_rows;
        const int p = ip[u];
        int lo = irow[u];
        if (iw[u] == 1) {
          smem[pos[lo] + p - o[lo]] = static_cast<uint8_t>(q[u].x);
          continue;
        }
        const unsigned words[4] = {q[u].x, q[u].y, q[u].z, q[u].w};
#pragma unroll
        for (int t = 0; t < 16; ++t) {
          while (p + t >= o[lo + 1]) ++lo;
          smem[pos[lo] + p + t - o[lo]] =
              static_cast<uint8_t>(words[t >> 2] >> ((t & 3) << 3));
        }
      }
    }
    __syncthreads();

    const uint8_t* tile = smem + sh;
    const int head = sh ? 8 : 0;  // dst + 8 is 16-byte aligned
    const int n16 = (span - head) >> 4;
    const int done = head + (n16 << 4);
    if (head && threadIdx.x == 0)
      *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(tile);
    if (done < span && threadIdx.x == blockDim.x - 1)
      *reinterpret_cast<uint2*>(dst + done) =
          *reinterpret_cast<const uint2*>(tile + done);
    uint4* d16 = reinterpret_cast<uint4*>(dst + head);
    const uint4* s16 = reinterpret_cast<const uint4*>(tile + head);
    for (int i = threadIdx.x; i < n16; i += blockDim.x) d16[i] = s16[i];
    return;
  }

  // direct: the block writes one row after another
  const int nfw = fixed_size >> 3;  // whole 8-byte words of fixed section
  for (int r = 0; r < n; ++r) {
    const uint8_t* src = smem + at[r];
    uint8_t* row = dst + rstart[r];
    for (int i = threadIdx.x; i < nfw; i += blockDim.x)
      reinterpret_cast<uint2*>(row)[i] =
          reinterpret_cast<const uint2*>(src)[i];
    for (int i = (nfw << 3) + threadIdx.x; i < fixed_size; i += blockDim.x)
      row[i] = src[i];
    int end = fixed_size;
    for (int k = 0; k < nstr; ++k) {
      const int* o = soff + k * (tile_rows + 1);
      const uint8_t* chars = desc[sidx[k]].data + o[r];
      const int len = o[r + 1] - o[r];
      uint8_t* d = row + vpos[k * tile_rows + r];
      for (int j0 = threadIdx.x; j0 < len; j0 += 8 * blockDim.x) {
        uint8_t c[8];  // eight loads in flight before the stores
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int j = j0 + u * static_cast<int>(blockDim.x);
          if (j < len) c[u] = chars[j];
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int j = j0 + u * static_cast<int>(blockDim.x);
          if (j < len) d[j] = c[u];
        }
      }
      end = vpos[k * tile_rows + r] + len;
    }
    const int row_size = rstart[r + 1] - rstart[r];
    for (int i = end + threadIdx.x; i < row_size; i += blockDim.x) row[i] = 0;
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
                               int log2_tile, int buf_bytes, void* out,
                               void* stream) {
  // the buffer holds a tile's fixed sections for the direct path
  const long long fixed_tile =
      static_cast<long long>((fixed_size + 7) & ~7) << log2_tile;
  if (buf_bytes % 16 != 0 || buf_bytes < ((fixed_tile + 15) & ~15LL))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      var_smem_layout(buf_bytes, ncols, nstr, 1 << log2_tile).end;
  cudaError_t err = reserve_shared(to_rows_var_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (rows + (1LL << log2_tile) - 1) >> log2_tile;
  to_rows_var_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const ToRowsCol*>(cols), ncols,
      static_cast<const long long*>(str_idx), nstr, rows, fixed_size,
      validity_offset, static_cast<const int*>(row_offsets), log2_tile,
      buf_bytes, static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
