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
// main-path shapes of to-rows:
//   bench (212 cycled fixed-width columns, 2^19 rows, 1096-byte rows):
//             reads 960 B/row of columns, writes 1096 B/row of rows:
//             1.078 GB, at least 0.32 ms at 3.35 TB/s (H100 SXM);
//   flagship (INT64, INT32, FLOAT64, 2^22 rows, 32-byte rows): reads
//             20 B/row, writes 32 B/row: 218 MB, at least 0.065 ms.
// At the bench shape:
//   from-rows reads 1096 B/row, writes 960 B/row of columns and 212 B/row
//             of validity: 1.19 GB, at least 0.36 ms.
// At the string main-path shape (155 cycled columns with 15 strings of
// 0-32 random bytes, 2^20 rows, an 888-byte fixed section):
//   to-rows-var reads 484 B/row of fixed-width columns, 52 B/row of
//             validity, about 240 B/row of chars and 64 B/row of string and
//             row offsets, and writes about 1132 B/row of rows: about
//             2.07 GB, at least about 0.62 ms (chip_smoke.py computes the
//             exact bound from its data).
// The design moves every byte through device memory once: column traffic
// is coalesced (a tile's rows of one column are one run), the rows, which
// are contiguous in the row buffer, move with 16-byte accesses, and
// fields never overlap, so no atomics are needed.  What else bounds each
// kernel is noted above it.  to-rows keeps its loads from stalling the
// threads: a tile's fields are in flight as asynchronous copies
// (cp.async) into a ring of shared-memory tile buffers, the wider fields
// straight to their place in the rows and the narrow columns and the
// validity as 16-byte runs of a column, while the block fills and stores
// another tile; the rows' gaps are zeroed once a block, not once a tile.
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

// ------------------------------------------------------------ to-rows
//
// The fixed-width to-rows kernel follows a plan of int32s that the
// wrapper builds once per schema and tile size (row_assembly_cuda.
// to_rows_plan; `ToRowsShape` carries its counts):
//   runs   [nruns] int4   the staged runs: each narrow (1- or 2-byte)
//                         column, then each nullable column's validity:
//                         (column, byte of the staging area where its
//                         tile rows go, width or 0 for validity, start
//                         in the row)
//   pieces [npieces] int2 the wider fields, in 4- or 8-byte pieces:
//                         (column, start in the row << 8 | the second
//                         half of a 16-byte field (bit 5) | log2 of the
//                         column's width << 2 | 8-byte piece (bit 0))
//   dyn    [ndyn] int2    validity bytes with a nullable column: (byte
//                         in the row, constant bits | nullable mask << 8
//                         | index of the byte << 16)
//   cst    [ncst] int2    validity bytes without one: the same
//   chunks [nchunks]      the staging area's 16-byte chunks: run << 8 |
//                         chunk of the run
//   vq     [ncols]        each column's validity run in the staging
//                         area, -1 for none
// to_rows_plan mirrors this layout.
struct ToRowsShape {
  long long rows;
  int ncols, nruns, nnarrow, npieces, ndyn, ncst, nchunks;
  int stage_bytes;  // staging area of one buffer (multiple of 16)
  int row_size, log2_tile, stages, flags;
};

constexpr int kPlanInShared = 1;
constexpr int kDescInShared = 2;
constexpr int kNarrowStaged = 4;
constexpr int kMaxStages = 4;

struct ToRowsPlan {
  int runs, pieces, dyn, cst, chunks, vq, end;
};

__host__ __device__ inline ToRowsPlan to_rows_plan_layout(
    const ToRowsShape& s) {
  ToRowsPlan p;
  p.runs = 0;
  p.pieces = 4 * s.nruns;
  p.dyn = p.pieces + 2 * s.npieces;
  p.cst = p.dyn + 2 * s.ndyn;
  p.chunks = p.cst + 2 * s.ncst;
  p.vq = p.chunks + s.nchunks;
  p.end = p.vq + s.ncols;
  return p;
}

__host__ __device__ inline int align16(int x) { return (x + 15) & ~15; }

// Shared memory of the to-rows kernel, in bytes from its start: a ring
// of `stages` buffers, each a row-major tile then its staging area; the
// plan and the descriptors where the flags say so.
// row_assembly_cuda.to_rows_smem_bytes mirrors `end`.
struct ToRowsSmem {
  int tile, buf, plan, desc, end;
};

__host__ __device__ inline ToRowsSmem to_rows_smem_layout(
    const ToRowsShape& s) {
  ToRowsSmem l;
  l.tile = align16(s.row_size << s.log2_tile);
  l.buf = l.tile + ((s.flags & kNarrowStaged) ? s.stage_bytes : 0);
  l.plan = s.stages * l.buf;
  l.desc = l.plan + ((s.flags & kPlanInShared)
                         ? align16(4 * to_rows_plan_layout(s).end) : 0);
  l.end = l.desc + ((s.flags & kDescInShared) ? 40 * s.ncols : 0);
  return l;
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async8(unsigned dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(unsigned dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {  // the count is an immediate
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

struct ToRowsCtx {
  ToRowsShape s;
  ToRowsPlan pl;
  ToRowsSmem l;
  const ToRowsCol* desc;  // in shared memory or device memory
  const int* plan;        // the same
};

// Put the tile at row0 (n rows) in flight into `buf`: each wider field
// straight to its place in the tile's rows, and each staged run (a
// narrow column's or a validity's n bytes a width) into the staging
// area in 16-byte chunks, by cp.async where the source is 16-byte
// aligned and the chunk whole, else with ordinary loads.
__device__ __forceinline__ void issue_tile(const ToRowsCtx& c,
                                           long long row0, int n,
                                           uint8_t* buf) {
  const int lg = c.s.log2_tile;
  const int mask = (1 << lg) - 1;
  const int2* pieces = reinterpret_cast<const int2*>(c.plan + c.pl.pieces);
  for (int i = threadIdx.x; i < (c.s.npieces << lg); i += blockDim.x) {
    const int r = i & mask;
    if (r >= n) continue;
    const int2 q = pieces[i >> lg];
    const int w = 1 << ((q.y >> 2) & 7);
    const uint8_t* src =
        c.desc[q.x].data + (row0 + r) * w + ((q.y & 32) ? 8 : 0);
    const unsigned dst = shared_addr(buf + r * c.s.row_size + (q.y >> 8));
    if (q.y & 1) cp_async8(dst, src); else cp_async4(dst, src);
  }
  if (!(c.s.flags & kNarrowStaged)) return;
  const int4* runs = reinterpret_cast<const int4*>(c.plan + c.pl.runs);
  uint8_t* st = buf + c.l.tile;
  for (int j = threadIdx.x; j < c.s.nchunks; j += blockDim.x) {
    const int ck = c.plan[c.pl.chunks + j];
    const int4 run = runs[ck >> 8];
    const int off = (ck & 255) << 4;
    const int w = run.z ? run.z : 1;
    const int have = n * w - off;  // bytes of the run left
    if (have <= 0) continue;
    const uint8_t* src =
        (run.z ? c.desc[run.x].data + row0 * w : c.desc[run.x].valid + row0) +
        off;
    uint8_t* dst = st + run.y + off;
    if (have >= 16 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      cp_async16(shared_addr(dst), src);
    } else {
      for (int b = 0; b < min(have, 16); b += w)
        copy_field(dst + b, src + b, w);
    }
  }
}

// The rest of the tile at row0, once its copies have landed: the narrow
// fields from their staged runs (or device memory when not staged), and
// the validity bytes of nullable columns, the eight loads in flight
// together.
__device__ __forceinline__ void fill_tile(const ToRowsCtx& c, long long row0,
                                          int n, uint8_t* buf) {
  const int lg = c.s.log2_tile;
  const int mask = (1 << lg) - 1;
  const bool staged = c.s.flags & kNarrowStaged;
  const uint8_t* st = buf + c.l.tile;
  const int4* runs = reinterpret_cast<const int4*>(c.plan + c.pl.runs);
  for (int i = threadIdx.x; i < (c.s.nnarrow << lg); i += blockDim.x) {
    const int r = i & mask;
    if (r >= n) continue;
    const int4 run = runs[i >> lg];
    const uint8_t* src = staged ? st + run.y + r * run.z
                                : c.desc[run.x].data + (row0 + r) * run.z;
    copy_field(buf + r * c.s.row_size + run.w, src, run.z);
  }
  const int2* dyn = reinterpret_cast<const int2*>(c.plan + c.pl.dyn);
  for (int i = threadIdx.x; i < (c.s.ndyn << lg); i += blockDim.x) {
    const int r = i & mask;
    if (r >= n) continue;
    const int2 q = dyn[i >> lg];
    const int c0 = (q.y >> 16) << 3;
    const unsigned m = (q.y >> 8) & 0xff;
    uint8_t v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      v[k] = 0;
      if ((m >> k) & 1)
        v[k] = staged ? st[c.plan[c.pl.vq + c0 + k] + r]
                      : c.desc[c0 + k].valid[row0 + r];
    }
    unsigned bits = q.y & 0xff;
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (v[k] != 0) bits |= 1u << k;
    buf[r * c.s.row_size + q.x] = static_cast<uint8_t>(bits);
  }
}

// Fixed-width rows.  A persistent grid: each block stages the plan and
// the descriptors once (where they fit), zeroes its ring of tile buffers
// and writes the constant validity bytes into them once: no field covers
// a gap, so gaps stay zero and no tile is zeroed again.  Then it walks
// the tiles blockIdx.x, blockIdx.x + gridDim.x, ..., keeping the next
// `stages` - 1 tiles' copies in flight while it fills the current tile's
// narrow fields and validity in shared memory and stores its rows, one
// contiguous range of the output, with 16-byte stores.
//
// What bounds it.  The parent kernel stalled on its loads: each thread
// read a descriptor, then made one dependent load of 1 to 16 bytes,
// about 26 times a tile, after a barrier on a whole-tile zero pass.
// Here the loads are copies (cp.async) that cost no registers and stall
// no thread until the tile is needed, and the narrow columns move as
// 16-byte runs of a column; what remains is bytes and the three
// barriers a tile.  The wrapper sizes the ring (to_rows_tile) for the
// most tiles in flight on an SM: at the bench shape that is one buffer
// a block and four blocks an SM, at the flagship shape two buffers.
__global__ void __launch_bounds__(kThreads)
to_rows_kernel(const ToRowsCol* __restrict__ cols,
               const int* __restrict__ plan, ToRowsShape shape,
               uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint8_t smem[];
  ToRowsCtx c;
  c.s = shape;
  c.pl = to_rows_plan_layout(shape);
  c.l = to_rows_smem_layout(shape);
  c.desc = cols;
  c.plan = plan;
  if (shape.flags & kPlanInShared) {
    int* d = reinterpret_cast<int*>(smem + c.l.plan);
    for (int i = threadIdx.x; i < c.pl.end; i += blockDim.x) d[i] = plan[i];
    c.plan = d;
  }
  if (shape.flags & kDescInShared) {
    long long* d = reinterpret_cast<long long*>(smem + c.l.desc);
    const long long* s = reinterpret_cast<const long long*>(cols);
    for (int i = threadIdx.x; i < 5 * shape.ncols; i += blockDim.x)
      d[i] = s[i];
    c.desc = reinterpret_cast<const ToRowsCol*>(d);
  }
  uint4* z = reinterpret_cast<uint4*>(smem);
  for (int i = threadIdx.x; i < (c.l.plan >> 4); i += blockDim.x)
    z[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  const int lg = shape.log2_tile;
  const int2* cst = reinterpret_cast<const int2*>(c.plan + c.pl.cst);
  const int per_buf = shape.ncst << lg;
  for (int i = threadIdx.x; i < shape.stages * per_buf; i += blockDim.x) {
    const int b = i / per_buf;
    const int e = i - b * per_buf;
    const int2 q = cst[e >> lg];
    smem[b * c.l.buf + (e & ((1 << lg) - 1)) * shape.row_size + q.x] =
        static_cast<uint8_t>(q.y & 0xff);
  }

  const long long tile_rows = 1LL << lg;
  const long long ntiles = (shape.rows + tile_rows - 1) >> lg;
  for (int b = 0; b < shape.stages; ++b) {
    const long long t = blockIdx.x + static_cast<long long>(b) * gridDim.x;
    if (t < ntiles) {
      const long long row0 = t << lg;
      issue_tile(c, row0, static_cast<int>(min(tile_rows, shape.rows - row0)),
                 smem + b * c.l.buf);
    }
    cp_async_commit();
  }
  int b = 0;
  for (long long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const long long row0 = t << lg;
    const int n = static_cast<int>(min(tile_rows, shape.rows - row0));
    uint8_t* buf = smem + b * c.l.buf;
    cp_async_wait(shape.stages - 1);
    __syncthreads();
    fill_tile(c, row0, n, buf);
    __syncthreads();
    uint8_t* dst = out + row0 * shape.row_size;
    copy_block(dst, buf, n * shape.row_size,
               (reinterpret_cast<uintptr_t>(dst) & 15) == 0);
    __syncthreads();  // every thread is done with the buffer: refill it
    const long long tn = t + static_cast<long long>(shape.stages) * gridDim.x;
    if (tn < ntiles) {
      const long long rn = tn << lg;
      issue_tile(c, rn, static_cast<int>(min(tile_rows, shape.rows - rn)),
                 buf);
    }
    cp_async_commit();
    b = b + 1 == shape.stages ? 0 : b + 1;
  }
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

extern "C" int srt_to_rows(const void* cols, const void* plan, long long rows,
                           int ncols, int nruns, int nnarrow, int npieces,
                           int ndyn, int ncst, int nchunks, int stage_bytes,
                           int row_size, int log2_tile, int stages, int flags,
                           void* out, void* stream) {
  const ToRowsShape s = {rows, ncols, nruns, nnarrow, npieces, ndyn, ncst,
                         nchunks, stage_bytes, row_size, log2_tile, stages,
                         flags};
  if (stages < 1 || stages > kMaxStages || stage_bytes % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = to_rows_smem_layout(s).end;
  cudaError_t err = reserve_shared(to_rows_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0;
  int sms = 0;
  int per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, to_rows_kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long tiles = (rows + (1LL << log2_tile) - 1) >> log2_tile;
  const long long most = static_cast<long long>(sms) * per_sm;
  to_rows_kernel<<<static_cast<unsigned>(tiles < most ? tiles : most),
                   kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const ToRowsCol*>(cols), static_cast<const int*>(plan), s,
      static_cast<uint8_t*>(out));
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
