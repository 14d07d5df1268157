// The fused stage segment of the port: one interpreter of a flat expression
// program (expressions/program.py), one thread per row.  Built for sm_90a
// by kernels/_lib.py and called through ctypes from kernels/fused.py.
// Every entry point launches on the caller's stream, allocates nothing, and
// returns the cudaError_t of its launches.
//
// fused segment <- spark_rapids_tpu/plan/fused.py:943 _make_program (the
//                  per-batch program of TpuFusedSegmentExec :301, with
//                  compaction_map / gather_batch inside it, :1044-1049) and
//                  spark_rapids_tpu/plan/execs/aggregate.py:274
//                  _global_update (a partial aggregate with no keys)
//   The reference traces a segment's Project / Filter / partial aggregate
//   into one XLA program per batch.  Here the program is data: a short
//   array of instructions {op, kind, dst, a, b, c} (one 64-bit word each)
//   and a table of 8-byte literals, uploaded once per segment and device.
//   A CUDA interpreter over a fixed instruction set is built once with the
//   other sources, where Triton would need source generated and compiled
//   per segment at query time (cuDF's AST evaluator takes the same road).
//   Each block copies the program into shared memory, so every thread of a
//   warp reads the same instruction word (a broadcast).  A thread's
//   registers live in dynamic shared memory, register r of thread t at
//   [r * kThreads + t] (neighbouring threads, neighbouring banks), and their
//   validity bits in one 64-bit word the thread keeps in a register; the
//   program's registers are allocated with reuse, so q6 needs a few.
//   Double arithmetic uses __dadd_rn / __dsub_rn / __dmul_rn / __ddiv_rn:
//   with nvcc's default --fmad=true a plain a * b + c may become one FMA,
//   and the result would no longer equal the plain version's bit for bit.
//
//   Global mode (a partial aggregate with no keys; q6): one launch
//   evaluates the filter and every aggregate input, and each block
//   reduces, per slot, the f64 or i64 sum and the valid count of its kept
//   rows, and the kept-row count (COUNT_STAR), into one partial per tile;
//   a second one-block launch folds the tile partials in a fixed order and
//   writes the one-row partial: no host read, no compacted copy, the same
//   result from run to run.  i64 sums add as uint64, so they wrap.
//   Bound: bytes: each loaded column's data and validity read once; q6's
//   4 columns are 32 bytes a row, 33.6 MB a batch of 1,048,576 rows,
//   0.0100 ms at 3.35 TB/s.
//
//   Compact mode (a filter or projection, or a grouped partial aggregate;
//   q1): pass 1 evaluates only the filter's instructions (the lowering
//   puts them first) and counts the kept rows per tile; csrc/scan.cuh's
//   scan turns the counts into tile offsets and the total, which the
//   wrapper reads back once to allocate the outputs at their exact size
//   (compaction_map's count, one read, allocate).  Pass 2 evaluates the
//   whole program and writes each computed column, and the gather map
//   when the caller needs it, at the kept rows' compacted positions: a
//   block scan per item of the tile gives stable ranks.  A chain with no
//   filter skips pass 1 and writes row i at i.  Bound: bytes: the loaded
//   columns read once (twice where pass 1 reads them too), each output
//   written once.
#include <cstdint>
#include <cuda_runtime.h>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>

#include "scan.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;
constexpr int kFinalThreads = 1024;
// the lowering's limits (expressions/program.py MAX_*)
constexpr int kMaxInstrs = 128;
constexpr int kMaxLits = 64;
constexpr int kMaxRegs = 48;   // validity bits fit one 64-bit word
constexpr int kMaxIn = 32;
constexpr int kMaxOut = 32;
constexpr int kMaxSlots = 16;
constexpr size_t kDefaultSmem = 48 * 1024;

enum Op : int {
  LOAD = 0, CONST, CAST_DEC_F64, WIDEN, RESCALE, ADD, SUB, MUL,
  LT, LE, GT, GE, EQ, AND, IS_NULL, IF
};
enum Kind : int { K_BOOL = 0, K_I32, K_I64, K_F64 };
enum SumKind : int { SUM_F64 = 0, SUM_I64, SUM_NONE };

struct Program {
  const unsigned long long* words;   // n_instr instructions, n_lits literals
  int n_instr, n_pred, keep, n_lits, n_regs;
  const void* in_data[kMaxIn];
  const uint8_t* in_valid[kMaxIn];
};

struct Outputs {
  void* data[kMaxOut];
  uint8_t* valid[kMaxOut];
  int8_t kind[kMaxOut];
  int8_t reg[kMaxOut];
  int n;
};

struct Slots {
  int8_t reg[kMaxSlots];
  int8_t kind[kMaxSlots];
  int8_t sum[kMaxSlots];
  int n;
};

struct SharedProgram {
  unsigned long long code[kMaxInstrs];
  long long lit[kMaxLits];
};

__device__ __forceinline__ void load_program(const Program& p,
                                             SharedProgram& s) {
  for (int i = threadIdx.x; i < p.n_instr + p.n_lits; i += blockDim.x) {
    const unsigned long long w = p.words[i];
    if (i < p.n_instr) {
      s.code[i] = w;
    } else {
      s.lit[i - p.n_instr] = static_cast<long long>(w);
    }
  }
  __syncthreads();
}

__device__ __forceinline__ double as_f64(long long x) {
  return __longlong_as_double(x);
}

__device__ __forceinline__ long long f64_bits(double d) {
  return __double_as_longlong(d);
}

// expressions/predicates.py _lt and _eq: NaN is above every other double
// and equals NaN; -0.0 == 0.0 by IEEE-754
__device__ __forceinline__ bool spark_lt(double l, double r) {
  return isnan(r) ? !isnan(l) : l < r;
}

__device__ __forceinline__ bool spark_eq(double l, double r) {
  return l == r || (isnan(l) && isnan(r));
}

__device__ __forceinline__ bool compare(int op, int kind, long long a,
                                        long long b) {
  if (kind == K_F64) {
    const double l = as_f64(a), r = as_f64(b);
    switch (op) {
      case LT: return spark_lt(l, r);
      case LE: return spark_lt(l, r) || spark_eq(l, r);
      case GT: return spark_lt(r, l);
      case GE: return spark_lt(r, l) || spark_eq(l, r);
      default: return spark_eq(l, r);
    }
  }
  // bool, int32 and int64 registers hold their value sign-extended
  switch (op) {
    case LT: return a < b;
    case LE: return a <= b;
    case GT: return a > b;
    case GE: return a >= b;
    default: return a == b;
  }
}

__device__ __forceinline__ long long arith(int op, int kind, long long a,
                                           long long b) {
  if (kind == K_F64) {
    const double l = as_f64(a), r = as_f64(b);
    return f64_bits(op == ADD ? __dadd_rn(l, r)
                    : op == SUB ? __dsub_rn(l, r) : __dmul_rn(l, r));
  }
  const unsigned long long ua = a, ub = b;
  const unsigned long long v = op == ADD ? ua + ub
                               : op == SUB ? ua - ub : ua * ub;
  // an int32 result wraps at 32 bits, as torch's int32 ops do
  return kind == K_I32
             ? static_cast<long long>(static_cast<int32_t>(
                   static_cast<uint32_t>(v)))
             : static_cast<long long>(v);
}

__device__ __forceinline__ long long load_value(const void* data, int kind,
                                                int64_t row) {
  switch (kind) {
    case K_BOOL: return static_cast<const uint8_t*>(data)[row] != 0;
    case K_I32: return static_cast<const int32_t*>(data)[row];
    default: return static_cast<const long long*>(data)[row];  // i64, f64 bits
  }
}

// Instructions [from, to) for one row.  reg points at this thread's
// register 0; register r is reg[r * kThreads].
__device__ __forceinline__ void run(const Program& p, const SharedProgram& s,
                                    int from, int to, int64_t row,
                                    long long* reg, unsigned long long& vm) {
#define R(i) reg[(i) * kThreads]
#define V(i) (((vm) >> (i)) & 1ull)
  for (int pc = from; pc < to; ++pc) {
    const unsigned long long w = s.code[pc];
    const int op = static_cast<int>(w & 0xff);
    const int kind = static_cast<int>((w >> 8) & 0xff);
    const int dst = static_cast<int>((w >> 16) & 0xff);
    const int a = static_cast<int>((w >> 24) & 0xff);
    const int b = static_cast<int>((w >> 32) & 0xff);
    const int c = static_cast<int>((w >> 40) & 0xff);
    long long x;
    bool v;
    switch (op) {
      case LOAD:   // a: the load slot
        x = load_value(p.in_data[a], kind, row);
        v = p.in_valid[a][row] != 0;
        break;
      case CONST:  // a: the literal
        x = s.lit[a];
        v = true;
        break;
      case CAST_DEC_F64:   // b: the literal 10^scale as a double
        x = f64_bits(__ddiv_rn(__ll2double_rn(R(a)), as_f64(s.lit[b])));
        v = V(a);
        break;
      case WIDEN:
        x = f64_bits(__ll2double_rn(R(a)));
        v = V(a);
        break;
      case RESCALE:   // b: the literal multiplier
        x = static_cast<long long>(static_cast<unsigned long long>(R(a)) *
                                   static_cast<unsigned long long>(s.lit[b]));
        v = V(a);
        break;
      case ADD:
      case SUB:
      case MUL:
        x = arith(op, kind, R(a), R(b));
        v = V(a) && V(b);
        break;
      case AND: {   // three-valued: FALSE AND null is FALSE
        const bool av = V(a), bv = V(b);
        const bool ad = R(a) != 0, bd = R(b) != 0;
        x = (ad && av) && (bd && bv);
        v = (av && bv) || (!ad && av) || (!bd && bv);
        break;
      }
      case IS_NULL:
        x = !V(a);
        v = true;
        break;
      case IF: {    // a null predicate takes the false branch
        const bool take = R(a) != 0 && V(a);
        x = take ? R(b) : R(c);
        v = take ? V(b) : V(c);
        break;
      }
      default:      // LT, LE, GT, GE, EQ; kind is the operands'
        x = compare(op, kind, R(a), R(b));
        v = V(a) && V(b);
        break;
    }
    R(dst) = x;
    vm = v ? (vm | (1ull << dst)) : (vm & ~(1ull << dst));
  }
#undef R
#undef V
}

__device__ __forceinline__ bool kept(const Program& p, const long long* reg,
                                     unsigned long long vm) {
  return p.keep < 0 ||
         (reg[p.keep * kThreads] != 0 && ((vm >> p.keep) & 1ull));
}

__global__ void __launch_bounds__(kThreads)
fused_count_kernel(const __grid_constant__ Program p, int64_t n,
                   int32_t* __restrict__ tile_counts) {
  using Reduce = cub::BlockReduce<int, kThreads>;
  __shared__ SharedProgram s;
  __shared__ typename Reduce::TempStorage tmp;
  extern __shared__ long long regs[];
  load_program(p, s);
  long long* reg = regs + threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  int count = 0;
#pragma unroll 1
  for (int i = 0; i < kItems; ++i) {
    // striped: neighbouring threads read neighbouring rows
    const int64_t row = base + static_cast<int64_t>(i) * kThreads + threadIdx.x;
    if (row < n) {
      unsigned long long vm = 0;
      run(p, s, 0, p.n_pred, row, reg, vm);
      count += kept(p, reg, vm);
    }
  }
  const int total = Reduce(tmp).Sum(count);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
fused_write_kernel(const __grid_constant__ Program p,
                   const __grid_constant__ Outputs o, int64_t n,
                   const int32_t* __restrict__ tile_offsets,
                   int32_t* __restrict__ out_map) {
  using Scan = cub::BlockScan<int, kThreads>;
  __shared__ SharedProgram s;
  __shared__ typename Scan::TempStorage tmp;
  extern __shared__ long long regs[];
  load_program(p, s);
  long long* reg = regs + threadIdx.x;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  int64_t carry = tile_offsets != nullptr ? tile_offsets[blockIdx.x] : 0;
#pragma unroll 1
  for (int i = 0; i < kItems; ++i) {
    const int64_t row = base + static_cast<int64_t>(i) * kThreads + threadIdx.x;
    unsigned long long vm = 0;
    bool keep = false;
    if (row < n) {
      run(p, s, 0, p.n_instr, row, reg, vm);
      keep = kept(p, reg, vm);
    }
    int64_t pos = row;
    if (tile_offsets != nullptr) {   // the same branch in every thread
      int rank, total;
      Scan(tmp).ExclusiveSum(keep ? 1 : 0, rank, total);
      pos = carry + rank;
      carry += total;
      __syncthreads();   // tmp is reused by the next item's scan
    }
    if (!keep) continue;
    for (int j = 0; j < o.n; ++j) {
      const int r = o.reg[j];
      const bool valid = (vm >> r) & 1ull;
      const long long x = valid ? reg[r * kThreads] : 0;   // nulls hold 0
      switch (o.kind[j]) {
        case K_BOOL:
          static_cast<uint8_t*>(o.data[j])[pos] = x != 0;
          break;
        case K_I32:
          static_cast<int32_t*>(o.data[j])[pos] = static_cast<int32_t>(x);
          break;
        default:
          static_cast<long long*>(o.data[j])[pos] = x;
          break;
      }
      o.valid[j][pos] = valid;
    }
    if (out_map != nullptr) out_map[pos] = static_cast<int32_t>(row);
  }
}

// Per tile: slot s's sum at tile_sum[s * ntiles + tile] (double bits or
// uint64), its valid count at tile_cnt[s * ntiles + tile], the kept rows at
// tile_cnt[nslots * ntiles + tile].  Each thread's per-slot accumulators
// sit in dynamic shared memory after its registers.
__global__ void __launch_bounds__(kThreads)
fused_global_tiles(const __grid_constant__ Program p,
                   const __grid_constant__ Slots sl, int64_t n,
                   int64_t ntiles, long long* __restrict__ tile_sum,
                   long long* __restrict__ tile_cnt) {
  using ReduceF = cub::BlockReduce<double, kThreads>;
  using ReduceU = cub::BlockReduce<unsigned long long, kThreads>;
  __shared__ SharedProgram s;
  __shared__ union {
    typename ReduceF::TempStorage f;
    typename ReduceU::TempStorage u;
  } tmp;
  extern __shared__ long long regs[];
  load_program(p, s);
  long long* reg = regs + threadIdx.x;
  long long* acc = regs + p.n_regs * kThreads + threadIdx.x;
  long long* cnt = acc + sl.n * kThreads;
  for (int k = 0; k < sl.n; ++k) {
    acc[k * kThreads] = 0;   // 0 and +0.0 have the same bits
    cnt[k * kThreads] = 0;
  }
  unsigned long long nkept = 0;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
#pragma unroll 1
  for (int i = 0; i < kItems; ++i) {
    const int64_t row = base + static_cast<int64_t>(i) * kThreads + threadIdx.x;
    if (row >= n) continue;
    unsigned long long vm = 0;
    run(p, s, 0, p.n_instr, row, reg, vm);
    if (!kept(p, reg, vm)) continue;
    ++nkept;
    for (int k = 0; k < sl.n; ++k) {
      const int r = sl.reg[k];
      if (!((vm >> r) & 1ull)) continue;
      ++cnt[k * kThreads];
      const long long x = reg[r * kThreads];
      if (sl.sum[k] == SUM_F64) {
        const double d = sl.kind[k] == K_F64 ? as_f64(x) : __ll2double_rn(x);
        acc[k * kThreads] = f64_bits(__dadd_rn(as_f64(acc[k * kThreads]), d));
      } else if (sl.sum[k] == SUM_I64) {
        acc[k * kThreads] = static_cast<long long>(
            static_cast<unsigned long long>(acc[k * kThreads]) +
            static_cast<unsigned long long>(x));
      }
    }
  }
  for (int k = 0; k <= sl.n; ++k) {
    const bool is_kept = k == sl.n;
    const unsigned long long c =
        ReduceU(tmp.u).Sum(is_kept ? nkept
                                   : static_cast<unsigned long long>(
                                         cnt[k * kThreads]));
    __syncthreads();
    long long total = 0;
    if (!is_kept && sl.sum[k] == SUM_F64) {
      total = f64_bits(ReduceF(tmp.f).Sum(as_f64(acc[k * kThreads])));
      __syncthreads();
    } else if (!is_kept && sl.sum[k] == SUM_I64) {
      total = static_cast<long long>(ReduceU(tmp.u).Sum(
          static_cast<unsigned long long>(acc[k * kThreads])));
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      tile_cnt[k * ntiles + blockIdx.x] = static_cast<long long>(c);
      if (!is_kept) tile_sum[k * ntiles + blockIdx.x] = total;
    }
  }
}

// One block: res[k] the slot's sum (0 where no row is valid), res[nslots
// + k] its valid count, res[2 * nslots] the kept rows; flags[k] = count >
// 0, flags[nslots] = 1 (the never-null validity of the counts).
__global__ void __launch_bounds__(kFinalThreads)
fused_global_final(const __grid_constant__ Slots sl, int64_t ntiles,
                   const long long* __restrict__ tile_sum,
                   const long long* __restrict__ tile_cnt,
                   long long* __restrict__ res, uint8_t* __restrict__ flags) {
  using ReduceF = cub::BlockReduce<double, kFinalThreads>;
  using ReduceU = cub::BlockReduce<unsigned long long, kFinalThreads>;
  __shared__ union {
    typename ReduceF::TempStorage f;
    typename ReduceU::TempStorage u;
  } tmp;
  for (int k = 0; k <= sl.n; ++k) {
    const bool is_kept = k == sl.n;
    const int sum = is_kept ? SUM_NONE : sl.sum[k];
    unsigned long long c = 0, u = 0;
    double f = 0.0;
    for (int64_t i = threadIdx.x; i < ntiles; i += kFinalThreads) {
      c += static_cast<unsigned long long>(tile_cnt[k * ntiles + i]);
      if (sum == SUM_F64) {
        f = __dadd_rn(f, as_f64(tile_sum[k * ntiles + i]));
      } else if (sum == SUM_I64) {
        u += static_cast<unsigned long long>(tile_sum[k * ntiles + i]);
      }
    }
    const unsigned long long count = ReduceU(tmp.u).Sum(c);
    __syncthreads();
    long long total = 0;
    if (sum == SUM_F64) {
      total = f64_bits(ReduceF(tmp.f).Sum(f));
      __syncthreads();
    } else if (sum == SUM_I64) {
      total = static_cast<long long>(ReduceU(tmp.u).Sum(u));
      __syncthreads();
    }
    if (threadIdx.x == 0) {
      if (is_kept) {
        res[2 * sl.n] = static_cast<long long>(count);
        flags[sl.n] = 1;
      } else {
        res[k] = count > 0 ? total : 0;
        res[sl.n + k] = static_cast<long long>(count);
        flags[k] = count > 0;
      }
    }
  }
}

int fill_program(Program& p, const void* words, int n_instr, int n_pred,
                 int keep, int n_lits, int n_regs, int n_in,
                 const void* in_data, const void* in_valid) {
  if (n_instr < 0 || n_instr > kMaxInstrs || n_pred < 0 || n_pred > n_instr ||
      n_lits < 0 || n_lits > kMaxLits || n_regs < 0 || n_regs > kMaxRegs ||
      keep >= n_regs || n_in < 0 || n_in > kMaxIn) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.words = static_cast<const unsigned long long*>(words);
  p.n_instr = n_instr;
  p.n_pred = n_pred;
  p.keep = keep;
  p.n_lits = n_lits;
  p.n_regs = n_regs;
  const void* const* d = static_cast<const void* const*>(in_data);
  const void* const* v = static_cast<const void* const*>(in_valid);
  for (int i = 0; i < n_in; ++i) {
    p.in_data[i] = d[i];
    p.in_valid[i] = static_cast<const uint8_t*>(v[i]);
  }
  return 0;
}

// Dynamic shared memory above the default 48 KB must be asked for.
template <typename Kernel>
int reserve_smem(Kernel kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

size_t reg_bytes(int rows_of_regs) {
  return static_cast<size_t>(rows_of_regs) * kThreads * sizeof(long long);
}

}  // namespace

extern "C" {

int srt_fused_tile() { return kTile; }

// Pass 1 of compact mode: tile_counts[0..ntiles] become the exclusive
// offsets of each tile's kept rows and their total (int32), total[0] the
// total as int64.  tile_counts holds ntiles + 1 int32, scan_scratch
// ceil(ntiles / scan tile) int64 (at least one).
int srt_fused_count(const void* words, int n_instr, int n_pred, int keep,
                    int n_lits, int n_regs, int n_in, const void* in_data,
                    const void* in_valid, int64_t n, int32_t* tile_counts,
                    int64_t* scan_scratch, int64_t* total,
                    cudaStream_t stream) {
  Program p;
  int err = fill_program(p, words, n_instr, n_pred, keep, n_lits, n_regs,
                         n_in, in_data, in_valid);
  if (err != 0) return err;
  if (keep < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t ntiles = (n + kTile - 1) / kTile;
  const size_t smem = reg_bytes(n_regs);
  if ((err = reserve_smem(fused_count_kernel, smem)) != 0) return err;
  if (ntiles > 0) {
    fused_count_kernel<<<static_cast<unsigned>(ntiles), kThreads, smem,
                         stream>>>(p, n, tile_counts);
    if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  }
  scan::ScanCols cols{};
  cols.v[0] = tile_counts;
  return scan::scan_columns(cols, 1, ntiles, scan_scratch, total, stream);
}

// Pass 2 of compact mode (or the only pass, with tile_offsets null: no
// filter, row i written at i).  out_* are host arrays of n_out device
// pointers and of the outputs' kinds and registers (int32).
int srt_fused_write(const void* words, int n_instr, int keep, int n_lits,
                    int n_regs, int n_in, const void* in_data,
                    const void* in_valid, int n_out, const void* out_data,
                    const void* out_valid, const void* out_kind,
                    const void* out_reg, int64_t n,
                    const int32_t* tile_offsets, int32_t* out_map,
                    cudaStream_t stream) {
  Program p;
  int err = fill_program(p, words, n_instr, n_instr, keep, n_lits, n_regs,
                         n_in, in_data, in_valid);
  if (err != 0) return err;
  if (n_out < 0 || n_out > kMaxOut) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Outputs o;
  o.n = n_out;
  for (int j = 0; j < n_out; ++j) {
    o.data[j] = static_cast<void* const*>(out_data)[j];
    o.valid[j] = static_cast<uint8_t* const*>(out_valid)[j];
    o.kind[j] = static_cast<int8_t>(static_cast<const int32_t*>(out_kind)[j]);
    o.reg[j] = static_cast<int8_t>(static_cast<const int32_t*>(out_reg)[j]);
    if (o.reg[j] < 0 || o.reg[j] >= n_regs) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int64_t ntiles = (n + kTile - 1) / kTile;
  if (ntiles == 0) return 0;
  const size_t smem = reg_bytes(n_regs);
  if ((err = reserve_smem(fused_write_kernel, smem)) != 0) return err;
  fused_write_kernel<<<static_cast<unsigned>(ntiles), kThreads, smem,
                       stream>>>(p, o, n, tile_offsets, out_map);
  return static_cast<int>(cudaGetLastError());
}

// Global mode.  slot_* are host int32 arrays of n_slots registers, input
// kinds and sum kinds.  tile_sum holds n_slots * ntiles int64 and tile_cnt
// (n_slots + 1) * ntiles (each at least one); res 2 * n_slots + 1 int64
// and flags n_slots + 1 bytes (see fused_global_final).
int srt_fused_global(const void* words, int n_instr, int keep, int n_lits,
                     int n_regs, int n_in, const void* in_data,
                     const void* in_valid, int n_slots, const void* slot_reg,
                     const void* slot_kind, const void* slot_sum, int64_t n,
                     int64_t* tile_sum, int64_t* tile_cnt, int64_t* res,
                     uint8_t* flags, cudaStream_t stream) {
  Program p;
  int err = fill_program(p, words, n_instr, n_instr, keep, n_lits, n_regs,
                         n_in, in_data, in_valid);
  if (err != 0) return err;
  if (n_slots < 0 || n_slots > kMaxSlots) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Slots sl;
  sl.n = n_slots;
  for (int k = 0; k < n_slots; ++k) {
    sl.reg[k] = static_cast<int8_t>(static_cast<const int32_t*>(slot_reg)[k]);
    sl.kind[k] = static_cast<int8_t>(static_cast<const int32_t*>(slot_kind)[k]);
    sl.sum[k] = static_cast<int8_t>(static_cast<const int32_t*>(slot_sum)[k]);
    if (sl.reg[k] < 0 || sl.reg[k] >= n_regs) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const int64_t ntiles = (n + kTile - 1) / kTile;
  long long* ts = reinterpret_cast<long long*>(tile_sum);
  long long* tc = reinterpret_cast<long long*>(tile_cnt);
  if (ntiles > 0) {
    const size_t smem = reg_bytes(n_regs + 2 * n_slots);
    if ((err = reserve_smem(fused_global_tiles, smem)) != 0) return err;
    fused_global_tiles<<<static_cast<unsigned>(ntiles), kThreads, smem,
                         stream>>>(p, sl, n, ntiles, ts, tc);
    if ((err = static_cast<int>(cudaGetLastError())) != 0) return err;
  }
  fused_global_final<<<1, kFinalThreads, 0, stream>>>(
      sl, ntiles, ts, tc, reinterpret_cast<long long*>(res), flags);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
