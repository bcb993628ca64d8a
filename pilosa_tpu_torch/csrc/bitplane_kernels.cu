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
// DISTINCT slot the batch names once: U'*S*W*4 bytes (U' unique idxs).
// This kernel streams Q*L*S*W*4 bytes from L2/HBM instead: its grid puts
// chunks in x, so all chunks of one query run before the next query's and
// queries that share a leaf rarely meet its chunk in L2. A grid order
// that lets them share it is the next speed-up (ROADMAP).
// Design: grid (plane chunk, query). A block reads its query's L slot ids
// once into shared memory; each thread streams 16-byte (uint4) loads so
// neighbouring threads read neighbouring addresses, evaluates the postfix
// op tape per 32-bit lane in registers, and counts with __popc. The
// expression is a tape because CUDA cannot take the TPU kernel's traced
// closure; the tape is a by-value kernel parameter (constant bank,
// broadcast to all threads, uniform branch). Its evaluation stack is a
// shift register of MAX_STACK uint4 values with compile-time indices, so
// it stays in registers. Blocks run unordered on 132 SMs, so the TPU
// kernel's sequential W loop with a VMEM accumulator becomes a warp
// shuffle + shared-memory block reduction and ONE 64-bit atomicAdd per
// block into out[q] (sums are int64; the caller zero-fills out).
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

#define MAX_TAPE 64
#define MAX_STACK 8
#define MAX_LEAVES 32

#define OP_PUSH 0
#define OP_AND 1
#define OP_OR 2
#define OP_XOR 3
#define OP_ANDNOT 4

#define THREADS 256
#define WARPS (THREADS / 32)
#define K1_ITERS 8
#define K2_ITERS 4
#define K2_ROW_GROUP 32

struct Tape {
  int n;
  int ops[MAX_TAPE];  // op | (slot << 8)
};

__device__ __forceinline__ uint4 apply_op(int op, uint4 a, uint4 b) {
  uint4 r;
  if (op == OP_AND) {
    r.x = a.x & b.x; r.y = a.y & b.y; r.z = a.z & b.z; r.w = a.w & b.w;
  } else if (op == OP_OR) {
    r.x = a.x | b.x; r.y = a.y | b.y; r.z = a.z | b.z; r.w = a.w | b.w;
  } else if (op == OP_XOR) {
    r.x = a.x ^ b.x; r.y = a.y ^ b.y; r.z = a.z ^ b.z; r.w = a.w ^ b.w;
  } else {  // OP_ANDNOT
    r.x = a.x & ~b.x; r.y = a.y & ~b.y; r.z = a.z & ~b.z; r.w = a.w & ~b.w;
  }
  return r;
}

__device__ __forceinline__ unsigned int popc4(uint4 v) {
  return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
}

__device__ __forceinline__ unsigned int warp_sum(unsigned int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(THREADS)
gather_expr_count_kernel(const uint4* __restrict__ stacked, long long plane_vec,
                         const int* __restrict__ idxs, int q_total, int n_leaves,
                         Tape tape, unsigned long long* __restrict__ out) {
  __shared__ const uint4* planes[MAX_LEAVES];
  __shared__ unsigned int warp_sums[WARPS];
  const long long chunk0 = (long long)blockIdx.x * (THREADS * K1_ITERS);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int q = blockIdx.y; q < q_total; q += gridDim.y) {
    if (threadIdx.x < n_leaves) {
      planes[threadIdx.x] =
          stacked + (long long)idxs[(long long)threadIdx.x * q_total + q] * plane_vec;
    }
    __syncthreads();

    unsigned int cnt = 0;
#pragma unroll
    for (int it = 0; it < K1_ITERS; ++it) {
      const long long i = chunk0 + (long long)it * THREADS + threadIdx.x;
      if (i < plane_vec) {
        uint4 st[MAX_STACK];
#pragma unroll
        for (int k = 0; k < MAX_STACK; ++k) st[k] = make_uint4(0u, 0u, 0u, 0u);
        for (int t = 0; t < tape.n; ++t) {
          const int code = tape.ops[t];
          const int op = code & 0xff;
          if (op == OP_PUSH) {
            const uint4 v = __ldg(planes[code >> 8] + i);
#pragma unroll
            for (int k = MAX_STACK - 1; k > 0; --k) st[k] = st[k - 1];
            st[0] = v;
          } else {
            st[0] = apply_op(op, st[1], st[0]);
#pragma unroll
            for (int k = 1; k < MAX_STACK - 1; ++k) st[k] = st[k + 1];
          }
        }
        cnt += popc4(st[0]);
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
    __syncthreads();  // planes[] and warp_sums[] are rewritten for the next q
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

extern "C" {

// out: (q,) int64, zero-filled by the caller. tape_ops: host array of
// tape_len codes (op | slot << 8), copied into the by-value kernel
// parameter. Returns a cudaError_t (0 = launched).
int pt_gather_expr_count(const void* stacked, long long plane_words, const void* idxs,
                         int q, int n_leaves, const int* tape_ops, int tape_len,
                         void* out, void* stream) {
  if (q <= 0 || plane_words <= 0) return (int)cudaSuccess;
  if (tape_len <= 0 || tape_len > MAX_TAPE || n_leaves <= 0 || n_leaves > MAX_LEAVES ||
      plane_words % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  Tape tape;
  tape.n = tape_len;
  for (int t = 0; t < MAX_TAPE; ++t) tape.ops[t] = t < tape_len ? tape_ops[t] : 0;
  const long long plane_vec = plane_words / 4;
  const long long per_block = (long long)THREADS * K1_ITERS;
  const long long chunks = (plane_vec + per_block - 1) / per_block;
  if (chunks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  dim3 grid((unsigned int)chunks, (unsigned int)(q < 65535 ? q : 65535));
  gather_expr_count_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)stacked, plane_vec, (const int*)idxs, q, n_leaves, tape,
      (unsigned long long*)out);
  return (int)cudaGetLastError();
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

}  // extern "C"
