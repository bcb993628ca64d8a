// Hand-written Hopper (sm_90a) kernels for the bitplane read path.
//
// Built by ops/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o _build/libbitplane_kernels.so bitplane_kernels.cu
// and bound with ctypes: the entry points below take raw device pointers
// and a cudaStream_t, launch on that stream, never synchronise, allocate
// nothing, and return cudaGetLastError() so a refused launch surfaces in
// the Python wrapper at once.
//
// Planes are uint32 words. The torch side stores them as int32 tensors
// bit for bit; here the same memory is read as uint32_t / uint4.
//
// ---------------------------------------------------------------------
// K1  gather_expr_count
//
// Replaces the TPU kernel batched_gather_expr_count
// (pilosa_tpu/ops/pallas_kernels.py:61, pl.pallas_call at :145): for each
// query q, popcount(expr(stacked[idxs[0][q]], ..., stacked[idxs[L-1][q]]))
// summed over every shard and word, without materialising the (Q, S, W)
// gather.
//
// Bound: bytes, a few integer ops per byte. The function must read each
// DISTINCT slot the batch names once: U'*S*W*4 bytes (U' unique idxs),
// while evaluating every query's expression (Q*L*S*W*4 bytes of operands).
//
// The expression is a postfix op tape (ops/kernels.py documents the
// codes) because CUDA cannot take the TPU kernel's traced closure. It
// travels to the device with the slot ids in one buffer and is read with
// uniform __ldg loads (every lane of a warp reads the same code: one
// broadcast from L1). The evaluation keeps the top of the stack in
// registers; fused ops (top = top OP plane[slot]) cover a left-folded
// k-ary node, so only a nested subtree pushes. Pushed values go to a
// small per-thread array in local memory (MAX_STACK deep; the tape
// compiler bounds the depth by floor(log2 leaves) + 1), touched only by
// trees that nest (384 B a thread in the streaming variant, 1.5 KB in the
// staged one, which keeps ST_QB queries' stacks).
//
// Two variants; ops/kernels.py k1_plan picks one from (distinct slots, Q).
//
// (a) k1_staged_kernel, batches (Q > 1) whose distinct slots fit the ring.
//     Persistent blocks (as many as fit on the 132 SMs) walk the S*W axis
//     in chunks of RING_CHUNK uint4 (512 B) per slot. For each chunk the
//     block copies that chunk of every distinct slot of its query tile
//     into a ring of NS stages in shared memory, NS-1 chunks ahead of the
//     compute, so each distinct slot is read from HBM once per tile. The
//     copies are cp.async 16-byte copies issued by all threads (each warp
//     copies one slot's 512 contiguous bytes per step). Not TMA: the
//     slots are scattered rows of the stack, so a tensor map's box would
//     need one row per slot and a bulk copy per slot, the ragged tail
//     would need its own byte count on the mbarrier, and the per-thread
//     16-byte form handles the tail by skipping copies past the plane's
//     end; at ~8 copies per thread per chunk its issue cost is small next
//     to the evaluation. Consumers: warp w evaluates queries
//     q = w, w + WARPS, ... of the tile, lane = uint4 within the chunk,
//     reading the ring (32 lanes x 16 B contiguous: no bank conflicts).
//     All queries share one tape, so a warp runs it for ST_QB = 4 queries
//     at once: each code is decoded once and its 4 ring loads are
//     independent. One query at a time left each warp waiting on a chain
//     of dependent loads (tape code, ring position, ring). tools/
//     k1_qb_sweep.py times ST_QB = 1, 2, 4, 8 (PERF.md has the numbers); 8
//     is barely faster than 4 and needs ~120 registers and a 3 KB local
//     stack per thread.
//     Per-query counts stay in registers across all chunks; at the end
//     each block does one warp reduction and one 64-bit atomicAdd per
//     query. Queries come in tiles of Q_TILE; each tile stages only its
//     own distinct slots (grid y = tile).
//     Hoisting. A batch's queries share one tape, and where a span of it
//     names the same slots for every query (a BSI compare over one
//     predicate, a shared filter), evaluating it per query repeats the
//     same work Q times: at the BSI count_batch shape (Q = 64, a depth-17
//     compare beside one row each) that made the kernel bound by issue
//     and ring reads at ~5x its bytes bound. The host (ops/kernels.py
//     k1_split) cuts each such maximal span out as a hoist program and
//     gives the queries a tape that reads its result as one more leaf.
//     Each stage of the ring then starts with H synthetic rows. After the
//     barrier that lands chunk k, the block evaluates each program once
//     over the chunk, one 32-bit word a thread (RING_WORDS = 128 words a
//     row: 4 warps a program), writes synthetic row h, and takes a second
//     barrier; then the per-query tapes run as before (at that shape
//     `hoisted & row` and a popcount), so the compare's 18 rows are read
//     from the ring once per chunk, not 64 times. The programs' rows sit
//     first among the staged rows, in the same place in every tile. A
//     template parameter (HOIST) compiles this in only for launches that
//     have programs, so a launch without one runs the code it ran before.
//     What bounds a hoisted launch is each program's walk over its codes:
//     a short dependent chain per chunk, on 4 of the block's 16 warps, that
//     the copies and the queries wait on. Two things shorten it: the
//     program's codes and operand words are loaded HOIST_BATCH at a time
//     (eval_word; PERF.md has the times of 1, 2, 4 and 8 at a time), and
//     when the query tape is set-op only (the usual case: the compare was
//     hoisted) the kernel is built for two blocks an SM (64 registers) and
//     the host sizes the ring so that two fit (ops/kernels.py
//     k1_hoist_stages): one block's chain runs while the other's copies
//     land (PERF.md has the times of one and two blocks an SM). Programs
//     always run the evaluator with the BSI codes, whatever they hold.
// (b) k1_streaming_kernel, Q = 1 (engine.count) and batches whose slots
//     do not fit the ring. A block evaluates one (query, plane chunk)
//     item: each thread streams 16-byte (uint4) loads of the query's
//     leaf planes, neighbouring threads on neighbouring addresses,
//     evaluates the tape per uint4, counts with __popc, then a warp
//     shuffle + shared-memory block sum and ONE 64-bit atomicAdd per
//     block into out[q]. Items are numbered query-fastest, so the blocks
//     in flight at once cover one chunk for many queries and queries
//     that share a leaf meet its chunk in L2.
//
// Counts are int64 (the caller zero-fills out).
//
// BSI compares (Range(v < x), v >< [lo, hi], ...) reach K1 as codes of
// the same tape: the host unrolls each bit-serial compare of reference
// fragment.go:683-851 into one code per value plane (ops/kernels.py
// documents them), settling the predicate's bits, its leading zeros and
// the strict last step at compile time. The evaluator keeps the two
// compare masks keep1/keep2 in registers beside the top of the stack, so
// a depth-D compare reads each of its D+1 planes once, like D+1 fused
// leaves. Tapes with such codes run a second instantiation of each
// variant (template BSI = true). Set-op tapes keep the first: run through
// the BSI one, the staged variant was 4.5% slower at the serving shape
// (PERF.md), from the extra op tests on every code. In the staged variant
// the choice is made for the query tape alone: a hoisted compare leaves a
// set-op query tape.
//
// ---------------------------------------------------------------------
// K3  bsi_minmax
//
// Replaces the XLA min/max program of the TPU engine's bsi_val_count
// (pilosa_tpu/parallel/engine.py:2099-2119): over a (D+1, S, W) BSI stack
// (plane D = not-null row), optionally ANDed with a filter plane, a D-step
// bit scan that keeps `consider` = the columns still able to be extreme
// and needs a GLOBAL "popcount(x) > 0" at every step.
//
// Bound: bytes, (D+1 + 1 if filtered) * S * W * 4 (each plane read once).
// Design: the scan is sequential only globally. Max and min are
// associative, so each block runs the whole D-step scan on its own chunk
// (4096 words of every plane), `consider` in registers (4 uint4 a thread),
// the block's "nonzero" from __syncthreads_or, the next plane's chunk
// loaded before the barrier. A block writes (local extreme, local count).
// A second launch of one block reduces them: the best value among blocks
// whose count > 0 wins and the counts of the blocks holding it add up;
// with no such block the bits are all 0 (max) or all 1 (min), count 0,
// which is what the global scan gives an empty `consider`.
//
// ---------------------------------------------------------------------
// K2  masked_plane_counts
//
// Replaces the XLA popcount reductions of the TPU engine's TopN and
// per-shard paths (pilosa_tpu/parallel/engine.py:1922-1928, 1941-1954,
// 2011-2035; pilosa_tpu/ops/bitplane.py:83-105): out[r][s] =
// popcount(stack[r][s] & mask[s]) summed over the W words (mask optional).
//
// Bound: bytes, (R*S*W + S*W)*4. Design: a block owns one (shard, W-chunk),
// keeps the mask chunk in registers and loops over the R rows, so the mask
// is read from HBM once, not R times. Per row: warp shuffle reduce, warp
// sums for a group of 32 rows gather in shared memory, then one int32
// atomicAdd per (row, block) into the (R, S) output (caller zero-fills).
// ---------------------------------------------------------------------

#include <cuda_runtime.h>
#include <stdint.h>

// Must match ops/kernels.py.
#define MAX_STACK 24
#define OP_PUSH 0
#define OP_AND 1
#define OP_OR 2
#define OP_XOR 3
#define OP_ANDNOT 4
#define OP_NOTAND 5
#define OP_ACC 8
#define OP_BSI_PUSH 0x10
#define OP_BSI_KEEP1 0x20
#define OP_BSI_KEEP2 0x21
#define GT_KEEP 1
#define GT_CLEAR 2
#define LT_CLEAR 1
#define LT_KEEP 2
#define RING_CHUNK 32
#define RING_WORDS (RING_CHUNK * 4)  // 32-bit words of a chunk's row
#define HOIST_BATCH 4  // hoist program codes whose loads are issued together
#define Q_TILE 256

#define THREADS 256
#define WARPS (THREADS / 32)
#define K1_ITERS 8
#define K2_ITERS 4
#define K2_ROW_GROUP 32
#define ST_THREADS 512
#define ST_WARPS (ST_THREADS / 32)
#define ST_QPW (Q_TILE / ST_WARPS)  // queries per warp in a tile
#ifndef ST_QB
#define ST_QB 4  // queries evaluated together by one tape pass
#endif
#define K3_THREADS 256
#define K3_WARPS (K3_THREADS / 32)
#define K3_VEC 4  // uint4 of each plane per thread: 4096 words a block
#define K3_REDUCE_THREADS 1024

__device__ __forceinline__ uint4 apply_op(int op, uint4 a, uint4 b) {
  uint4 r;
  if (op == OP_AND) {
    r.x = a.x & b.x; r.y = a.y & b.y; r.z = a.z & b.z; r.w = a.w & b.w;
  } else if (op == OP_OR) {
    r.x = a.x | b.x; r.y = a.y | b.y; r.z = a.z | b.z; r.w = a.w | b.w;
  } else if (op == OP_XOR) {
    r.x = a.x ^ b.x; r.y = a.y ^ b.y; r.z = a.z ^ b.z; r.w = a.w ^ b.w;
  } else if (op == OP_ANDNOT) {
    r.x = a.x & ~b.x; r.y = a.y & ~b.y; r.z = a.z & ~b.z; r.w = a.w & ~b.w;
  } else {  // OP_NOTAND
    r.x = ~a.x & b.x; r.y = ~a.y & b.y; r.z = ~a.z & b.z; r.w = ~a.w & b.w;
  }
  return r;
}

// One 32-bit word: the hoist programs' unit (a block spreads a program's
// RING_WORDS words of a chunk over its threads).
__device__ __forceinline__ unsigned int apply_op(int op, unsigned int a, unsigned int b) {
  if (op == OP_AND) return a & b;
  if (op == OP_OR) return a | b;
  if (op == OP_XOR) return a ^ b;
  if (op == OP_ANDNOT) return a & ~b;
  return ~a & b;  // OP_NOTAND
}

__device__ __forceinline__ unsigned int popc4(uint4 v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

__device__ __forceinline__ unsigned int warp_sum(unsigned int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ unsigned long long warp_sum64(unsigned long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ uint4 and4(uint4 a, uint4 b) {
  return make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}

__device__ __forceinline__ uint4 or4(uint4 a, uint4 b) {
  return make_uint4(a.x | b.x, a.y | b.y, a.z | b.z, a.w | b.w);
}

__device__ __forceinline__ uint4 not4(uint4 a) { return make_uint4(~a.x, ~a.y, ~a.z, ~a.w); }

// Evaluates the tape for QB independent operand sets at once (QB queries
// of the staged variant, or QB = 1): each code is decoded once and its QB
// loads are independent, so they overlap. fetch(b, slot) returns set b's
// uint4 of that leaf position. stk is the caller's (local-memory) stack
// below the top; the tape is validated on the host (depth <= MAX_STACK,
// BSI steps and keeps only inside a compare). BSI: the tape may hold BSI
// compare codes, evaluated with the masks keep1/keep2 in registers.
template <int QB, bool BSI, class Fetch>
__device__ __forceinline__ void eval_tape(const int* __restrict__ tape, int n, Fetch fetch,
                                          uint4 (*stk)[QB], uint4 (&top)[QB]) {
  uint4 keep1[QB], keep2[QB];
  if (BSI) {
#pragma unroll
    for (int b = 0; b < QB; ++b) keep1[b] = keep2[b] = make_uint4(0u, 0u, 0u, 0u);
  }
  {
    // A valid tape starts with a PUSH or a BSI_PUSH (keeps already 0).
    const int slot = __ldg(tape) >> 8;
#pragma unroll
    for (int b = 0; b < QB; ++b) top[b] = fetch(b, slot);
  }
  int sp = 0;
  for (int t = 1; t < n; ++t) {
    const int code = __ldg(tape + t);
    const int op = code & 0xff;
    if (op == OP_PUSH || (BSI && op == OP_BSI_PUSH)) {
#pragma unroll
      for (int b = 0; b < QB; ++b) {
        stk[sp][b] = top[b];
        top[b] = fetch(b, code >> 8);
        if (BSI && op == OP_BSI_PUSH) keep1[b] = keep2[b] = make_uint4(0u, 0u, 0u, 0u);
      }
      ++sp;
    } else if (BSI && op >= OP_BSI_KEEP1) {
#pragma unroll
      for (int b = 0; b < QB; ++b) top[b] = op == OP_BSI_KEEP1 ? keep1[b] : keep2[b];
    } else if (BSI && op > OP_BSI_PUSH) {  // a plane step: ">" part, then "<" part
      const int gt = op & 3, lt = (op >> 2) & 3;
#pragma unroll
      for (int b = 0; b < QB; ++b) {
        const uint4 row = fetch(b, code >> 8);
        if (gt == GT_KEEP) {
          keep1[b] = or4(keep1[b], and4(top[b], row));
        } else if (gt == GT_CLEAR) {
          top[b] = and4(top[b], or4(row, keep1[b]));
        }
        if (lt == LT_CLEAR) {
          top[b] = and4(top[b], or4(not4(row), keep2[b]));
        } else if (lt == LT_KEEP) {
          keep2[b] = or4(keep2[b], and4(top[b], not4(row)));
        }
      }
    } else if (op & OP_ACC) {
#pragma unroll
      for (int b = 0; b < QB; ++b) top[b] = apply_op(op & ~OP_ACC, top[b], fetch(b, code >> 8));
    } else {
      --sp;
#pragma unroll
      for (int b = 0; b < QB; ++b) top[b] = apply_op(op, stk[sp][b], top[b]);
    }
  }
}

// One hoist program over one word. The program is the same for every
// chunk, and its operand reads do not depend on the values: codes come in
// batches of HOIST_BATCH, each batch's codes and then its operand words
// are loaded together (independent loads, in flight at once), then the
// batch is applied in order from registers. eval_tape's code-by-code walk
// left each step waiting on a chain of two loads (the code, then the
// ring). Codes without a slot (binary ops, keeps), which the host points
// at `idle_row`, and the codes past the end load that row and never use
// it: the block's first staged row, landed and written by no thread while
// the programs run. It knows the BSI codes whatever the program holds.
template <class Fetch>
__device__ __forceinline__ unsigned int eval_word(const int* __restrict__ prog, int n,
                                                  int idle_row, Fetch fetch,
                                                  unsigned int* stk) {
  unsigned int top = 0, keep1 = 0, keep2 = 0;
  int sp = 0;
  for (int t0 = 0; t0 < n; t0 += HOIST_BATCH) {
    int code[HOIST_BATCH];
    unsigned int row[HOIST_BATCH];
#pragma unroll
    for (int i = 0; i < HOIST_BATCH; ++i)
      code[i] = t0 + i < n ? __ldg(prog + t0 + i) : idle_row << 8;
#pragma unroll
    for (int i = 0; i < HOIST_BATCH; ++i) row[i] = fetch(code[i] >> 8);
#pragma unroll
    for (int i = 0; i < HOIST_BATCH; ++i) {
      if (t0 + i >= n) break;
      const int op = code[i] & 0xff;
      if (t0 + i == 0) {  // the first code pushes (keeps already 0)
        top = row[i];
      } else if (op == OP_PUSH || op == OP_BSI_PUSH) {
        stk[sp++] = top;
        top = row[i];
        if (op == OP_BSI_PUSH) keep1 = keep2 = 0u;
      } else if (op >= OP_BSI_KEEP1) {
        top = op == OP_BSI_KEEP1 ? keep1 : keep2;
      } else if (op > OP_BSI_PUSH) {
        const int gt = op & 3, lt = (op >> 2) & 3;
        if (gt == GT_KEEP) {
          keep1 |= top & row[i];
        } else if (gt == GT_CLEAR) {
          top &= row[i] | keep1;
        }
        if (lt == LT_CLEAR) {
          top &= ~row[i] | keep2;
        } else if (lt == LT_KEEP) {
          keep2 |= top & ~row[i];
        }
      } else if (op & OP_ACC) {
        top = apply_op(op & ~OP_ACC, top, row[i]);
      } else {
        top = apply_op(op, stk[--sp], top);
      }
    }
  }
  return top;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned int s = (unsigned int)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// tiles: (n_tiles, 2) = (offset into urows, distinct slots nu) per tile of
// Q_TILE queries; urows: the tiles' distinct stack rows; qpos: (Q, L) stage
// row of each query's leaf positions; hoists: H + 1 offsets, then the H
// hoist programs (their slots stage rows); dynamic shared memory: NS
// stages of (H + nu_max, RING_CHUNK) uint4, the H synthetic rows first.
// HOIST: the launch has hoist programs (H > 0).
template <int NS, bool BSI, bool HOIST>
__global__ void __launch_bounds__(ST_THREADS, HOIST && !BSI ? 2 : 1)
k1_staged_kernel(const uint4* __restrict__ stacked, long long plane_vec,
                 const int* __restrict__ tape, int tape_len, int n_leaves,
                 const int* __restrict__ tiles, const int* __restrict__ urows,
                 const int* __restrict__ qpos, int q_total,
                 const int* __restrict__ hoists, int n_hoist,
                 unsigned long long* __restrict__ out) {
  extern __shared__ uint4 ring[];
  const int tile = blockIdx.y;
  const int q0 = tile * Q_TILE;
  const int qn = min(Q_TILE, q_total - q0);
  const int* rows = urows + tiles[2 * tile];
  const int nu = tiles[2 * tile + 1];
  const int nh = HOIST ? n_hoist : 0;
  const int stage_rows = nh + nu;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long n_chunks = (plane_vec + RING_CHUNK - 1) / RING_CHUNK;
  const long long my_n =
      blockIdx.x < n_chunks ? (n_chunks - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  uint4 stk[MAX_STACK][ST_QB];
  unsigned int hstk[MAX_STACK];
  unsigned int cnt[ST_QPW];
#pragma unroll
  for (int j = 0; j < ST_QPW; ++j) cnt[j] = 0;

  // Copy chunk k of this block into stage k % NS, after its synthetic
  // rows: nu * RING_CHUNK uint4, one warp per slot row of 512 contiguous
  // bytes, the tail skipped.
  auto stage = [&](long long k) {
    const long long c0 = (blockIdx.x + k * gridDim.x) * RING_CHUNK;
    uint4* dst = ring + ((k % NS) * stage_rows + nh) * RING_CHUNK;
    for (int e = threadIdx.x; e < nu * RING_CHUNK; e += ST_THREADS) {
      const long long gi = c0 + (e & (RING_CHUNK - 1));
      if (gi < plane_vec) {
        cp_async16(dst + e, stacked + (long long)__ldg(rows + e / RING_CHUNK) * plane_vec + gi);
      }
    }
  };

#pragma unroll
  for (int k = 0; k < NS - 1; ++k) {
    if (k < my_n) stage(k);
    cp_async_commit();
  }
  for (long long k = 0; k < my_n; ++k) {
    // Stage (k + NS - 1) % NS was last read in iteration k - 1, which
    // ended with a barrier.
    if (k + NS - 1 < my_n) stage(k + NS - 1);
    cp_async_commit();
    cp_async_wait<NS - 1>();  // this thread's copies of chunk k landed
    __syncthreads();          // and every other thread's
    uint4* st = ring + (k % NS) * stage_rows * RING_CHUNK;
    if (HOIST) {
      // What every query shares, once per chunk: program h over the
      // chunk's RING_WORDS words into synthetic row h, one word a thread
      // (a program takes RING_WORDS / 32 warps). Programs read staged
      // rows only (row nh, the first, where a code reads none), never a
      // synthetic one.
      unsigned int* words = reinterpret_cast<unsigned int*>(st);
      for (int e = threadIdx.x; e < nh * RING_WORDS; e += ST_THREADS) {
        const int h = e / RING_WORDS, word = e % RING_WORDS;
        const int at = __ldg(hoists + h);
        words[h * RING_WORDS + word] = eval_word(
            hoists + nh + 1 + at, __ldg(hoists + h + 1) - at, nh,
            [&](int row) { return words[row * RING_WORDS + word]; }, hstk);
      }
      __syncthreads();
    }
    const uint4* chunk = st + lane;
    const bool valid = (blockIdx.x + k * gridDim.x) * RING_CHUNK + lane < plane_vec;
    // Warp w owns queries w + j * ST_WARPS of the tile, ST_QB at a time.
#pragma unroll
    for (int j0 = 0; j0 < ST_QPW; j0 += ST_QB) {
      if (warp + j0 * ST_WARPS < qn) {
        const int* pos[ST_QB];
#pragma unroll
        for (int b = 0; b < ST_QB; ++b) {
          // A query past the tile's end reads query 0's slots; its count
          // is dropped below.
          const int qi = warp + (j0 + b) * ST_WARPS;
          pos[b] = qpos + (long long)(q0 + (qi < qn ? qi : 0)) * n_leaves;
        }
        uint4 top[ST_QB];
        eval_tape<ST_QB, BSI>(
            tape, tape_len,
            [&](int b, int slot) { return chunk[__ldg(pos[b] + slot) * RING_CHUNK]; }, stk,
            top);
        if (valid) {
#pragma unroll
          for (int b = 0; b < ST_QB; ++b) cnt[j0 + b] += popc4(top[b]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < ST_QPW; ++j) {
    const int qi = warp + j * ST_WARPS;
    if (qi < qn) {
      const unsigned long long total = warp_sum64(cnt[j]);
      if (lane == 0 && total) atomicAdd(out + q0 + qi, total);
    }
  }
}

// idxs: (L, Q) slot ids; items are (query, chunk) pairs numbered
// query-fastest.
template <bool BSI>
__global__ void __launch_bounds__(THREADS)
k1_streaming_kernel(const uint4* __restrict__ stacked, long long plane_vec,
                    const int* __restrict__ tape, int tape_len,
                    const int* __restrict__ idxs, int q_total, long long n_items,
                    unsigned long long* __restrict__ out) {
  __shared__ unsigned int warp_sums[WARPS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  uint4 stk[MAX_STACK][1];

  for (long long b = blockIdx.x; b < n_items; b += gridDim.x) {
    const int q = (int)(b % q_total);
    const long long chunk0 = (b / q_total) * (THREADS * K1_ITERS);
    unsigned int cnt = 0;
#pragma unroll
    for (int it = 0; it < K1_ITERS; ++it) {
      const long long i = chunk0 + (long long)it * THREADS + threadIdx.x;
      if (i < plane_vec) {
        uint4 v[1];
        eval_tape<1, BSI>(
            tape, tape_len,
            [&](int, int slot) {
              return __ldg(stacked + (long long)__ldg(idxs + (long long)slot * q_total + q) *
                                         plane_vec + i);
            },
            stk, v);
        cnt += popc4(v[0]);
      }
    }
    cnt = warp_sum(cnt);
    if (lane == 0) warp_sums[warp] = cnt;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long total = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) total += warp_sums[w];
      if (total) atomicAdd(out + q, total);
    }
    __syncthreads();  // warp_sums[] is rewritten by the next item
  }
}

__global__ void __launch_bounds__(THREADS)
masked_plane_counts_kernel(const uint4* __restrict__ stack, const uint4* __restrict__ mask,
                           int n_rows, int n_shards, long long wvec,
                           int* __restrict__ out) {
  __shared__ unsigned int part[WARPS][K2_ROW_GROUP];
  const long long col0 = (long long)blockIdx.x * (THREADS * K2_ITERS) + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int s = blockIdx.y; s < n_shards; s += gridDim.y) {
    uint4 m[K2_ITERS];
#pragma unroll
    for (int it = 0; it < K2_ITERS; ++it) {
      const long long i = col0 + (long long)it * THREADS;
      if (i >= wvec) {
        m[it] = make_uint4(0u, 0u, 0u, 0u);
      } else if (mask != nullptr) {
        m[it] = __ldg(mask + (long long)s * wvec + i);
      } else {
        m[it] = make_uint4(~0u, ~0u, ~0u, ~0u);
      }
    }

    for (int r0 = 0; r0 < n_rows; r0 += K2_ROW_GROUP) {
      const int group = min(K2_ROW_GROUP, n_rows - r0);
      for (int rr = 0; rr < group; ++rr) {
        const uint4* row = stack + ((long long)(r0 + rr) * n_shards + s) * wvec;
        unsigned int cnt = 0;
#pragma unroll
        for (int it = 0; it < K2_ITERS; ++it) {
          const long long i = col0 + (long long)it * THREADS;
          if (i < wvec) {
            const uint4 v = __ldg(row + i);
            cnt += __popc(v.x & m[it].x) + __popc(v.y & m[it].y) +
                   __popc(v.z & m[it].z) + __popc(v.w & m[it].w);
          }
        }
        cnt = warp_sum(cnt);
        if (lane == 0) part[warp][rr] = cnt;
      }
      __syncthreads();
      if (threadIdx.x < group) {
        unsigned int total = 0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) total += part[w][threadIdx.x];
        if (total) atomicAdd(out + (long long)(r0 + threadIdx.x) * n_shards + s, (int)total);
      }
      __syncthreads();  // part[] is rewritten by the next row group
    }
  }
}

// K3, first pass. planes: (depth + 1, plane_vec) uint4, plane `depth` the
// not-null row; mask: (plane_vec) uint4 or null. part: (gridDim.x, 2) =
// (the block's extreme value, how many of its columns hold it).
template <bool MAX>
__global__ void __launch_bounds__(K3_THREADS)
bsi_minmax_kernel(const uint4* __restrict__ planes, const uint4* __restrict__ mask, int depth,
                  long long plane_vec, unsigned long long* __restrict__ part) {
  __shared__ unsigned int warp_sums[K3_WARPS];
  const long long i0 = (long long)blockIdx.x * (K3_THREADS * K3_VEC) + threadIdx.x;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  uint4 consider[K3_VEC], next[K3_VEC];
  // Lanes past the plane's end hold 0 and never count.
  auto load = [&](int plane, uint4 (&dst)[K3_VEC]) {
#pragma unroll
    for (int it = 0; it < K3_VEC; ++it) {
      const long long i = i0 + (long long)it * K3_THREADS;
      dst[it] = i < plane_vec ? __ldg(planes + (long long)plane * plane_vec + i) : zero;
    }
  };
  load(depth, consider);
  if (mask != nullptr) {
#pragma unroll
    for (int it = 0; it < K3_VEC; ++it) {
      const long long i = i0 + (long long)it * K3_THREADS;
      consider[it] = and4(consider[it], i < plane_vec ? __ldg(mask + i) : zero);
    }
  }
  if (depth > 0) load(depth - 1, next);
  unsigned long long value = 0;
  for (int bit = depth - 1; bit >= 0; --bit) {
    uint4 row[K3_VEC];
#pragma unroll
    for (int it = 0; it < K3_VEC; ++it) row[it] = next[it];
    if (bit > 0) load(bit - 1, next);  // in flight across the barrier
    uint4 x[K3_VEC];
    unsigned int any = 0;
#pragma unroll
    for (int it = 0; it < K3_VEC; ++it) {
      x[it] = MAX ? and4(row[it], consider[it]) : and4(consider[it], not4(row[it]));
      any |= x[it].x | x[it].y | x[it].z | x[it].w;
    }
    const int nonzero = __syncthreads_or(any != 0);
    if (nonzero) {
#pragma unroll
      for (int it = 0; it < K3_VEC; ++it) consider[it] = x[it];
    }
    if (MAX ? nonzero : !nonzero) value |= 1ull << bit;
  }
  unsigned int cnt = 0;
#pragma unroll
  for (int it = 0; it < K3_VEC; ++it) cnt += popc4(consider[it]);
  cnt = warp_sum(cnt);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long total = 0;
#pragma unroll
    for (int w = 0; w < K3_WARPS; ++w) total += warp_sums[w];
    part[2 * blockIdx.x] = value;
    part[2 * blockIdx.x + 1] = total;
  }
}

// K3, second pass: one block of K3_REDUCE_THREADS over the n_blocks
// partials; writes bits (depth,) int32 and count int64.
template <bool MAX>
__global__ void __launch_bounds__(K3_REDUCE_THREADS)
bsi_minmax_reduce_kernel(const unsigned long long* __restrict__ part, int n_blocks, int depth,
                         int* __restrict__ bits, unsigned long long* __restrict__ count) {
  __shared__ unsigned long long sh[K3_REDUCE_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = K3_REDUCE_THREADS / 32;
  // The neutral value of the combine, and the answer when no block
  // considered a column: bits all 0 (max) or all 1 (min). Values hold at
  // most 63 bits, so no real minimum equals it.
  const unsigned long long empty = MAX ? 0ull : ~0ull;
  unsigned long long best = empty;
  for (int b = threadIdx.x; b < n_blocks; b += K3_REDUCE_THREADS) {
    if (part[2 * b + 1]) {
      const unsigned long long v = part[2 * b];
      best = MAX ? (v > best ? v : best) : (v < best ? v : best);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_down_sync(0xffffffffu, best, off);
    best = MAX ? (o > best ? o : best) : (o < best ? o : best);
  }
  if (lane == 0) sh[warp] = best;
  __syncthreads();
  best = sh[0];
  for (int w = 1; w < n_warps; ++w) best = MAX ? (sh[w] > best ? sh[w] : best)
                                               : (sh[w] < best ? sh[w] : best);
  __syncthreads();  // every thread has read sh[] before it is reused
  unsigned long long total = 0;
  for (int b = threadIdx.x; b < n_blocks; b += K3_REDUCE_THREADS) {
    if (part[2 * b + 1] && part[2 * b] == best) total += part[2 * b + 1];
  }
  total = warp_sum64(total);
  if (lane == 0) sh[warp] = total;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long sum = 0;
    for (int w = 0; w < n_warps; ++w) sum += sh[w];
    *count = sum;
  }
  for (int i = threadIdx.x; i < depth; i += K3_REDUCE_THREADS) bits[i] = (int)((best >> i) & 1ull);
}

template <bool MAX>
static int launch_bsi_minmax(const void* planes, const void* mask, int depth,
                             long long plane_vec, void* part, int n_blocks, void* bits,
                             void* count, cudaStream_t stream) {
  bsi_minmax_kernel<MAX><<<(unsigned int)n_blocks, K3_THREADS, 0, stream>>>(
      (const uint4*)planes, (const uint4*)mask, depth, plane_vec, (unsigned long long*)part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bsi_minmax_reduce_kernel<MAX><<<1, K3_REDUCE_THREADS, 0, stream>>>(
      (const unsigned long long*)part, n_blocks, depth, (int*)bits,
      (unsigned long long*)count);
  return (int)cudaGetLastError();
}

// The staged variant's arguments, one launch's worth.
struct StagedArgs {
  const void* stacked;
  long long plane_vec;
  const void* tape;
  int tape_len, n_leaves;
  const void* tiles;
  int n_tiles;
  const void* urows;
  const void* qpos;
  int q, nu_max;
  const void* hoists;
  int n_hoist;
  void* out;
};

template <int NS, bool BSI, bool HOIST>
static int launch_staged(const StagedArgs& a, cudaStream_t stream) {
  const size_t smem = (size_t)NS * (a.n_hoist + a.nu_max) * RING_CHUNK * sizeof(uint4);
  auto kern = k1_staged_kernel<NS, BSI, HOIST>;
  int dev = 0, sms = 0, per_sm = 0, optin = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)) !=
      cudaSuccess)
    return (int)err;
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  // The limit is a property of the kernel for the whole process: threads
  // launching rings of different sizes must not lower it under each
  // other's launches, so it is always the device's opt-in maximum (each
  // launch still asks for its own `smem`).
  if ((err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin)) !=
      cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, ST_THREADS, smem)) !=
      cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  // Persistent: as many blocks as fit at once, shared among the tiles.
  const long long n_chunks = (a.plane_vec + RING_CHUNK - 1) / RING_CHUNK;
  long long bx = ((long long)sms * per_sm + a.n_tiles - 1) / a.n_tiles;
  if (bx > n_chunks) bx = n_chunks;
  if (bx < 1) bx = 1;
  kern<<<dim3((unsigned int)bx, (unsigned int)a.n_tiles), ST_THREADS, smem, stream>>>(
      (const uint4*)a.stacked, a.plane_vec, (const int*)a.tape, a.tape_len, a.n_leaves,
      (const int*)a.tiles, (const int*)a.urows, (const int*)a.qpos, a.q,
      (const int*)a.hoists, a.n_hoist, (unsigned long long*)a.out);
  return (int)cudaGetLastError();
}

typedef int (*StagedLaunch)(const StagedArgs&, cudaStream_t);

// One instantiation per (ring stages, BSI query tape, hoist programs).
template <int NS>
static StagedLaunch staged_for(int bsi, int hoist) {
  static const StagedLaunch table[2][2] = {
      {launch_staged<NS, false, false>, launch_staged<NS, false, true>},
      {launch_staged<NS, true, false>, launch_staged<NS, true, true>}};
  return table[bsi ? 1 : 0][hoist ? 1 : 0];
}

extern "C" {

// K1, streaming variant. tape: tape_len codes; idxs: (L, q) slot ids;
// both in one device buffer built by ops/kernels.py. out: (q,) int64,
// zero-filled by the caller. Returns a cudaError_t (0 = launched).
int pt_k1_streaming(const void* stacked, long long plane_words, const void* tape,
                    int tape_len, const void* idxs, int q, int bsi, void* out, void* stream) {
  if (q <= 0 || plane_words <= 0) return (int)cudaSuccess;
  if (tape_len <= 0 || plane_words % 4 != 0) return (int)cudaErrorInvalidValue;
  const long long plane_vec = plane_words / 4;
  const long long per_block = (long long)THREADS * K1_ITERS;
  const long long n_items = (plane_vec + per_block - 1) / per_block * q;
  const long long grid = n_items < (1LL << 30) ? n_items : (1LL << 30);
  auto kern = bsi ? k1_streaming_kernel<true> : k1_streaming_kernel<false>;
  kern<<<(unsigned int)grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)stacked, plane_vec, (const int*)tape, tape_len, (const int*)idxs, q,
      n_items, (unsigned long long*)out);
  return (int)cudaGetLastError();
}

// K1, staged variant. tiles: (n_tiles, 2) int32 (offset into urows,
// distinct slots); urows: the tiles' distinct stack rows; qpos: (q, L)
// stage rows; n_stages: ring stages (2..4) of n_hoist + nu_max rows each;
// bsi: the tape holds BSI compare codes; hoists: n_hoist + 1 offsets and
// the hoist programs (null when n_hoist is 0), each code's slot a stage
// row.
int pt_k1_staged(const void* stacked, long long plane_words, const void* tape, int tape_len,
                 int n_leaves, const void* tiles, int n_tiles, const void* urows,
                 const void* qpos, int q, int nu_max, int n_stages, int bsi,
                 const void* hoists, int n_hoist, void* out, void* stream) {
  if (q <= 0 || plane_words <= 0) return (int)cudaSuccess;
  if (tape_len <= 0 || plane_words % 4 != 0 || nu_max <= 0 || n_tiles <= 0 ||
      n_tiles > 65535 || (long long)n_tiles * Q_TILE < q || n_hoist < 0 ||
      (n_hoist > 0) != (hoists != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  const StagedArgs a{stacked, plane_words / 4, tape, tape_len, n_leaves, tiles, n_tiles,
                     urows, qpos, q, nu_max, hoists, n_hoist, out};
  const int hoist = n_hoist > 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (n_stages) {
    case 2:
      return staged_for<2>(bsi, hoist)(a, st);
    case 3:
      return staged_for<3>(bsi, hoist)(a, st);
    case 4:
      return staged_for<4>(bsi, hoist)(a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// stack: (n_rows, n_shards, w) words; mask: (n_shards, w) words or null;
// out: (n_rows, n_shards) int32, zero-filled by the caller.
int pt_masked_plane_counts(const void* stack, const void* mask, int n_rows, int n_shards,
                           long long w, void* out, void* stream) {
  if (n_rows <= 0 || n_shards <= 0 || w <= 0) return (int)cudaSuccess;
  if (w % 4 != 0) return (int)cudaErrorInvalidValue;
  const long long wvec = w / 4;
  const long long per_block = (long long)THREADS * K2_ITERS;
  const long long chunks = (wvec + per_block - 1) / per_block;
  if (chunks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned int)chunks, (unsigned int)(n_shards < 65535 ? n_shards : 65535));
  masked_plane_counts_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)stack, (const uint4*)mask, n_rows, n_shards, wvec, (int*)out);
  return (int)cudaGetLastError();
}

// K3. planes: (depth + 1, plane_words) words, plane `depth` the not-null
// row; mask: (plane_words) words or null; part: (n_blocks, 2) int64
// scratch, n_blocks = ceil(plane_words / 4096); bits: (depth,) int32;
// count: one int64.
int pt_bsi_minmax(const void* planes, const void* mask, int depth, long long plane_words,
                  int maximize, void* part, int n_blocks, void* bits, void* count,
                  void* stream) {
  if (plane_words <= 0 || plane_words % 4 != 0 || depth < 0 || depth > 63)
    return (int)cudaErrorInvalidValue;
  const long long plane_vec = plane_words / 4;
  const long long per_block = (long long)K3_THREADS * K3_VEC;
  if ((plane_vec + per_block - 1) / per_block != n_blocks) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return maximize ? launch_bsi_minmax<true>(planes, mask, depth, plane_vec, part, n_blocks,
                                            bits, count, st)
                  : launch_bsi_minmax<false>(planes, mask, depth, plane_vec, part, n_blocks,
                                             bits, count, st);
}

}  // extern "C"
