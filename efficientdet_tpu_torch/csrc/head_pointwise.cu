// Anchor-major head pointwise: (M, Cin) @ (Cin, A*out) + bias, stored per
// anchor plane, with the per-row max of each anchor's outputs.
//
// Replaces: efficientdet_tpu/ops/head_pallas.py, _head_pw_kernel (wrapper
// head_pointwise_anchor_major), the heads' final 1x1 conv on TPU.
//
//   z[a, m, c]  = sum_k x[m, k] * w[k, a*out + c] + bias[a*out + c]   (x dtype)
//   amax[a, m]  = max_c of the float32 sums                           (x dtype)
//
// Rows m >= M (up to Mp) read x as zero, so they hold the bias only, as the
// TPU kernel's padded rows do. x itself is not padded: no load is made past
// its row M-1.
//
// What bounds it on an H100: the store of z. At D0@512, batch 128, bf16, the
// class launch (A=9, out=90) reads 89 MB of x and writes 1.13 GB of z and
// 12.6 MB of amax: about 0.37 ms at 3.35 TB/s, against 72 GFLOP of products,
// about 0.07 ms on the bf16 tensor cores but about 1 ms of float32 FMAs on
// the CUDA cores. So the bf16 path (the main path) multiplies on the tensor
// cores, and its design has one aim: keep the z store streaming. The class
// launch does 1,620 Cin FLOP a row (2 x 810 outputs) and moves 2 Cin + 1,638
// bytes a row, so the products' share of the byte bound grows with Cin: 0.27
// at Cin 88, 0.59 at 224, 0.88 at 384 (D6/D7), where only wgmma, overlapped
// with the loads and the store, gets near the bound.
//
// The bf16 epilogue (store_rows): a warp adds the bias, rounds z to bf16 from
// the float32 sum and amax from the max of the float32 sums, and writes its
// 16*G rows of one anchor, one contiguous run of 16*G*out values in z, into
// its own staging tile in shared memory; after fence.proxy.async its lane 0
// sends the tile with one 1-D bulk copy (cp.async.bulk, bulk_group). The copy
// drains while the warp multiplies the next anchor: the warp waits on it
// (cp.async.bulk.wait_group.read) only before it writes that staging tile
// again. amax goes out with plain stores. No barrier of the block.
//
// The launcher picks one of two bf16 plans from Cin and the shared memory:
//   resident (Cin <= 64: D0's width): persistent blocks of eight warps, every
//     anchor's weight columns and biases in shared memory for the block's
//     lifetime, mma.sync m16n8k16 with float32 accumulation over NT =
//     ceil(out/8) column tiles. Each warp walks units of 32 rows (two m16
//     tiles) in a grid-stride loop. It holds a unit's x rows in registers,
//     read straight from device memory in 16-byte loads (zero for rows >= M
//     and columns >= Cin; the next unit's rows are in flight while this
//     unit's anchors run), and runs all A anchors over them, so x is read
//     once. The fragments take the K order those loads give: thread t holds
//     k = 16t..16t+15 of its rows, so at k-step s it has k = 16t+4s..16t+4s+3
//     where mma.sync names k = 2t, 2t+1, 2t+8, 2t+9; the weights are read in
//     the same order (two 16-byte shared loads a column tile), the same
//     products in another order of summation. Shared rows are 72 values (64
//     padded by 8), an odd number of 16-byte units, so the fragment loads hit
//     distinct banks. Shared memory at D0's class launch: weights 9 x 96 x 72
//     x 2 = 124,416 B, bias 3,456, staging 8 warps x 32 x 90 x 2 = 46,080:
//     173,952 B of the 232,448 a block may have, one block an SM. The box
//     launch (A 1, out 36) needs 24,352 B.
//   streamed (Cin > 64, or resident weights that do not fit: every phi from
//     D1, Cin 88-384): warp-specialised and persistent, one block an SM, 288
//     threads: two consumer warpgroups and one producer warp. A block walks
//     128-row tiles of x (tile blockIdx.x + i * gridDim.x) and stages each
//     tile once, across all of Cin, as NK = ceil(Cin/64) chunks of 128 x 64
//     (16 KB); every anchor runs over it, so x is read from device memory
//     once. The weights stream through a ring of (anchor, K chunk) slabs of
//     NCOLS = 8*NT rows x 64: anchor a's slab is the box of NCOLS rows that
//     starts at row a*out of w (A*out, Cin); its rows past `out` belong to the
//     next anchor or lie out of bounds (zero), and the epilogue drops those
//     columns, so w is not padded. All of A*out x Cin is 622 KB at D6/D7's
//     class launch, read from L2 by every tile.
//     - Producer (warp 8, lane 0): TMA (cp.async.bulk.tensor.2d, 128-byte
//       swizzle, boxes of 64 x 128 rows for x and 64 x NCOLS for w) onto
//       full/empty mbarrier pairs, one pair a ring slot and one an x chunk.
//       TMA's out-of-bounds fill gives the zeros for rows >= M and columns >=
//       Cin (Cin 88 is not a multiple of 64: its second chunk holds 24 real
//       columns). An x chunk is refilled with a later tile's rows as soon as
//       both warpgroups have finished the last anchor's product over it; with
//       XSETS = 2 tile sets (when they fit: Cin <= 224) the next tile loads
//       while this one runs.
//     - Consumers: warpgroup g multiplies rows 64g..64g+63 of the tile,
//       wgmma.mma_async m64nNk16 (N = NCOLS: 96 for out 90, 40 for out 36),
//       both operands in shared memory through matrix descriptors (K-major,
//       128-byte swizzle: a 64-value K chunk is one swizzle row, 8-row groups
//       1024 B apart; the k16 steps advance the start address by 32 B), one
//       commit group a slab. After each commit, wgmma.wait_group 1 completes
//       the slab before it, which the warpgroup's first thread then releases
//       (and, at the last anchor, its x chunk). Two accumulator sets (2 x 48
//       floats a thread at N 96) take the anchors in turn, so anchor a's
//       epilogue (store16: bias, row max, bf16, 16 rows a bulk copy, two
//       staging tiles a warp) runs while anchor a+1's slabs multiply; the
//       two warpgroups store at different slabs of the anchor (0 and NK/2),
//       so that one multiplies while the other stores.
//     Shared memory (a 1024-aligned base; 1,024 B of slack for it): x XSETS x
//     NK x 16,384 | ring RING x NCOLS x 128 | bias A x NCOLS x 4 | staging 8
//     warps x 2 x 16 x out x 2 | mbarriers 8 B each. The launcher takes XSETS =
//     2 with the largest ring of 4-8 slabs that fits, else XSETS = 1 with the
//     largest of 2-8. Class launch at Cin 384: 98,304 + 6 x 12,288 + 3,456 +
//     46,080 + 1,024 + 24 x 8 = 222,784 B; at Cin 224: 131,072 + 4 x 12,288 +
//     3,456 + 46,080 + 1,024 + 24 x 8 = 230,976 B, of the 232,448 a block may
//     have. ops/head_kernel.streamed_smem_bytes mirrors it, held against
//     head_pointwise_streamed_smem.
//     What bounds it: the byte bound is the z store at every Cin (the
//     products are 0.27 of it at Cin 88, 0.88 at 384). On the card the time
//     goes as about 7.7 us a tile plus 0.49 us a weight slab (PERF.md):
//     it follows the slabs a tile walks (A x NK), not the bytes, and neither a
//     deeper ring, a cluster of two blocks sharing each slab by TMA multicast,
//     L2 eviction hints, nor more slabs in flight behind the newest moved it.
// Both need Cin % 8 == 0 (16-byte rows for the loads and TMA's strides).
//
// float32 (head_pw_kernel, the card-vs-CPU check's path): 64 rows, float32
// FMAs (TF32 would round the inputs), each thread an 8-row by CPT-column
// tile (columns tx + 16*j), K staged in chunks of 32; the block owns one
// anchor plane of a row tile and stores it through a staging tile in
// 16-byte writes.

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up in libcuda at run time
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;       // rows per block
constexpr int KC = 32;       // K chunk staged in shared memory
constexpr int TX = 16;       // threads across columns
constexpr int TY = 8;        // threads across rows
constexpr int RPT = TM / TY; // rows per thread
constexpr int NTHREADS = TX * TY;

template <int CPT>
struct Smem {
  static constexpr int kCols = TX * CPT;
  static constexpr int kCompute = TM * (KC + 1) + KC * kCols;  // floats
  static constexpr int kStage = TM * kCols;                     // >= TM*out floats
  static constexpr int kFloats = kCompute > kStage ? kCompute : kStage;
};

template <int CPT>
__global__ void __launch_bounds__(NTHREADS)
head_pw_kernel(const float* __restrict__ x, const float* __restrict__ wt,
               const float* __restrict__ bias, float* __restrict__ z,
               float* __restrict__ amax, int M, int Mp, int Cin, int A, int out) {
  constexpr int COLS = Smem<CPT>::kCols;
  __shared__ __align__(16) float smem[Smem<CPT>::kFloats];
  float* xs = smem;                    // [TM][KC+1]
  float* ws = smem + TM * (KC + 1);    // [KC][COLS]

  const int a = blockIdx.x % A;
  const int m0 = (blockIdx.x / A) * TM;
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;

  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < Cin; k0 += KC) {
    for (int idx = tid; idx < TM * KC; idx += NTHREADS) {
      const int r = idx / KC, c = idx % KC;
      const int m = m0 + r, k = k0 + c;
      xs[r * (KC + 1) + c] = (m < M && k < Cin) ? x[(size_t)m * Cin + k] : 0.f;
    }
    for (int idx = tid; idx < KC * COLS; idx += NTHREADS) {
      const int kk = idx / COLS, c = idx % COLS;
      const int k = k0 + kk;
      ws[idx] = (k < Cin && c < out) ? wt[(size_t)(a * out + c) * Cin + k] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < KC; ++kk) {
      float xr[RPT], wc[CPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) xr[i] = xs[(ty + TY * i) * (KC + 1) + kk];
#pragma unroll
      for (int j = 0; j < CPT; ++j) wc[j] = ws[kk * COLS + tx + TX * j];
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(xr[i], wc[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: bias, row max, staged coalesced store.
  float* stage = smem;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty + TY * i;
    float rmax = __int_as_float(0xff800000);  // -inf
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = tx + TX * j;
      if (c < out) {
        const float v = acc[i][j] + bias[a * out + c];
        stage[r * out + c] = v;
        rmax = fmaxf(rmax, v);
      }
    }
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1)
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, off));
    if (tx == 0) amax[(size_t)a * Mp + m0 + r] = rmax;
  }
  __syncthreads();
  // TM*out*4 bytes is a multiple of 16 and so is the tile's offset in z
  // (Mp and m0 are multiples of 64), so the copy moves uint4s.
  const int nvec = TM * out * 4 / 16;
  const uint4* src = reinterpret_cast<const uint4*>(stage);
  uint4* dst = reinterpret_cast<uint4*>(z + ((size_t)a * Mp + m0) * out);
  for (int v = tid; v < nvec; v += NTHREADS) dst[v] = src[v];
}

cudaError_t launch_f32(const void* x, const void* w, const float* bias, void* z,
                       void* amax, int M, int Mp, int Cin, int A, int out,
                       cudaStream_t stream) {
  const dim3 grid((unsigned)A * (unsigned)(Mp / TM));
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w);
  float* zp = static_cast<float*>(z);
  float* ap = static_cast<float*>(amax);
  const int cpt = (out + TX - 1) / TX;
#define HEAD_PW_CASE(C)                                                     \
  case C:                                                                   \
    head_pw_kernel<C><<<grid, NTHREADS, 0, stream>>>(                       \
        xp, wp, bias, zp, ap, M, Mp, Cin, A, out);                          \
    break;
  switch (cpt) {
    HEAD_PW_CASE(1) HEAD_PW_CASE(2) HEAD_PW_CASE(3) HEAD_PW_CASE(4)
    HEAD_PW_CASE(5) HEAD_PW_CASE(6) HEAD_PW_CASE(7) HEAD_PW_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef HEAD_PW_CASE
  return cudaGetLastError();
}

// ---------------------------------------------------------------- bf16 MMA

typedef __nv_bfloat16 bf16;

constexpr int MM_THREADS = 256;
constexpr int MM_WARPS = MM_THREADS / 32;
constexpr int MM_KC = 64;          // the resident plan's whole K
constexpr int MM_LDS = MM_KC + 8;  // a shared row, in bf16 values
constexpr int RES_ROWS = 32;       // the resident plan's unit: two m16 tiles a warp

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with full == false nothing is read and the
// destination is zero-filled
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(full ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until this thread's cp.asyncs have landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// 32-bit word i of a 16-byte vector (i known at compile time once unrolled)
__device__ __forceinline__ uint32_t word(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}


// One warp's epilogue of one anchor over its 16*G rows: bias (bias_s, the
// anchor's 8*NT biases in shared memory, 0 past `out`), row max (the 4
// threads of a group share a row), z staged in staging tile it % STAGES of
// `stage` ([STAGES][16*G*out]) and sent to zdst by one bulk copy, issued and
// waited on by lane 0. No barrier of the block.
template <int NT, int G, int STAGES>
__device__ __forceinline__ void store_rows(const float (&acc)[G][NT][4], bf16* stage, int it,
                                           const float* bias_s, int out, bf16* zdst,
                                           bf16* __restrict__ amax_dst) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  bf16* st = stage + (it % STAGES) * 16 * G * out;
  // the bulk copy that last read this staging tile is the oldest of the (at
  // most) STAGES in flight
  if (lane == 0) asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(STAGES - 1) : "memory");
  __syncwarp();
  const bool pairs = out % 2 == 0;  // then c < out implies c + 1 < out
#pragma unroll
  for (int i = 0; i < G; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = 16 * i + g + 8 * half;
      float rmax = __int_as_float(0xff800000);  // -inf
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = nt * 8 + 2 * t;
        const float2 bb = *reinterpret_cast<const float2*>(bias_s + c);
        const float v0 = acc[i][nt][half * 2] + bb.x, v1 = acc[i][nt][half * 2 + 1] + bb.y;
        if (c < out) rmax = fmaxf(rmax, v0);
        if (c + 1 < out) rmax = fmaxf(rmax, v1);
        bf16* s = st + r * out + c;
        if (pairs) {
          if (c < out) *reinterpret_cast<__nv_bfloat162*>(s) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (c < out) s[0] = __float2bfloat16_rn(v0);
          if (c + 1 < out) s[1] = __float2bfloat16_rn(v1);
        }
      }
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 1));
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 2));
      if (t == 0) amax_dst[r] = __float2bfloat16_rn(rmax);
    }
  // the staged values, written by the generic proxy, must be visible to
  // the bulk copy (the async proxy) before it is issued
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
  if (lane == 0) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                 :: "l"(zdst), "r"(smem_addr(st)), "r"(16 * G * out * 2) : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
}

// before the block ends: every bulk copy this warp issued is complete
__device__ __forceinline__ void drain_stores() {
  if (threadIdx.x % 32 == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <int NT>
__global__ void __launch_bounds__(MM_THREADS, 1)
head_pw_resident_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                        const float* __restrict__ bias, bf16* __restrict__ z,
                        bf16* __restrict__ amax, int M, int Mp, int Cin, int A, int out) {
  constexpr int NCOLS = NT * 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ws = reinterpret_cast<bf16*>(smem);                       // [A * NCOLS][MM_LDS]
  float* bs = reinterpret_cast<float*>(ws + A * NCOLS * MM_LDS);  // [A * NCOLS]
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  bf16* stage = reinterpret_cast<bf16*>(bs + A * NCOLS) + warp * RES_ROWS * out;  // this warp's

  // every anchor's weight columns and bias, once; columns n >= out are 0
  for (int v = threadIdx.x; v < A * NCOLS * (MM_KC / 8); v += MM_THREADS) {
    const int row = v / (MM_KC / 8), c8 = (v % (MM_KC / 8)) * 8;
    const int a = row / NCOLS, n = row - a * NCOLS;
    const bool in = n < out && c8 < Cin;
    cp_async16(ws + row * MM_LDS + c8, in ? wt + (size_t)(a * out + n) * Cin + c8 : wt, in);
  }
  for (int v = threadIdx.x; v < A * NCOLS; v += MM_THREADS) {
    const int a = v / NCOLS, n = v - a * NCOLS;
    bs[v] = n < out ? bias[a * out + n] : 0.f;
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // a unit's x rows, per thread: [m16 tile][row g, row g + 8][k 16t + 8j ..]
  auto load_x = [&](int unit, uint4 (&dst)[2][2][2]) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = unit * RES_ROWS + 16 * i + g + 8 * h;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int k = 16 * t + 8 * j;
          dst[i][h][j] = row < M && k < Cin
                             ? __ldg(reinterpret_cast<const uint4*>(x + (size_t)row * Cin + k))
                             : make_uint4(0u, 0u, 0u, 0u);
        }
      }
  };
  const int units = Mp / RES_ROWS, stride = gridDim.x * MM_WARPS;
  int unit = blockIdx.x * MM_WARPS + warp;
  uint4 xr[2][2][2], xn[2][2][2];
  if (unit < units) load_x(unit, xr);
  int it = 0;  // anchor outputs so far
  for (; unit < units; unit += stride) {
    if (unit + stride < units) load_x(unit + stride, xn);  // lands while this unit runs
    const int row0 = unit * RES_ROWS;
    for (int a = 0; a < A; ++a, ++it) {
      float acc[2][NT][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.f;
      const bf16* wa = ws + (a * NCOLS + g) * MM_LDS + 16 * t;  // column nt*8 + g, k 16t..
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint4 w[2] = {*reinterpret_cast<const uint4*>(wa + nt * 8 * MM_LDS),
                            *reinterpret_cast<const uint4*>(wa + nt * 8 * MM_LDS + 8)};
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          // k-step s: words 2(s&1) and 2(s&1)+1 of vector s>>1 hold
          // k = 16t+4s..+1 and 16t+4s+2..+3, in the A and B fragments alike
          const int j = s >> 1, c = 2 * (s & 1);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            mma_bf16(acc[i][nt], word(xr[i][0][j], c), word(xr[i][1][j], c),
                     word(xr[i][0][j], c + 1), word(xr[i][1][j], c + 1), word(w[j], c),
                     word(w[j], c + 1));
        }
      }
      store_rows<NT, 2, 1>(acc, stage, it, bs + a * NCOLS, out,
                           z + ((size_t)a * Mp + row0) * out, amax + (size_t)a * Mp + row0);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 2; ++j) xr[i][h][j] = xn[i][h][j];
  }
  drain_stores();
}

// ------------------------------------------- the streamed plan: TMA + wgmma

constexpr int ST_THREADS = 288;                 // two consumer warpgroups, then the producer warp
constexpr int ST_CONSUMERS = 256;
constexpr int ST_ROWS = 128;                    // an x tile: 64 rows a consumer warpgroup
constexpr int ST_KC = 64;                       // a K chunk: one 128-byte swizzle row of bf16
constexpr int ST_XCHUNK = ST_ROWS * ST_KC * 2;  // bytes of one x chunk
constexpr int ST_STAGES = 2;                    // staging tiles a warp
constexpr int ST_MAX_RING = 8;

// Byte offsets of the streamed plan's shared memory from its 1024-aligned
// base (x at 0), and the bytes the launch asks for (see the note at the top).
struct StreamedLayout {
  int nk, xsets, ring, lag;  // lag: 1, or 0 when one x set holds a single chunk
  int w_off, bias_off, stage_off, bar_off, bytes;
};

StreamedLayout streamed_layout(int Cin, int A, int out, int xsets, int ring) {
  const int ncols = (out + 7) / 8 * 8;
  StreamedLayout L;
  L.nk = (Cin + ST_KC - 1) / ST_KC;
  L.xsets = xsets;
  L.ring = ring;
  // slabs a consumer warpgroup keeps in flight behind the newest (see the
  // kernel); with one x set and one chunk, the next tile's chunk would wait
  // on a slab that is released only after it
  L.lag = xsets == 1 && L.nk == 1 ? 0 : 1;
  L.w_off = xsets * L.nk * ST_XCHUNK;
  L.bias_off = L.w_off + ring * ncols * ST_KC * 2;
  L.stage_off = L.bias_off + A * ncols * 4;
  L.bar_off = L.stage_off + (ST_CONSUMERS / 32) * ST_STAGES * 16 * out * 2;
  L.bytes = 1024 + L.bar_off + (2 * xsets * L.nk + 2 * ring) * 8;
  return L;
}

// two x tile sets with a ring of 4-8 slabs if they fit, else one set with
// 2-8; bytes == 0 if nothing fits in `smem_max`
StreamedLayout pick_streamed(int Cin, int A, int out, int smem_max) {
  for (int xsets = 2; xsets >= 1; --xsets)
    for (int ring = ST_MAX_RING; ring >= (xsets == 2 ? 4 : 2); --ring) {
      const StreamedLayout L = streamed_layout(Cin, A, out, xsets, ring);
      if (L.bytes <= smem_max) return L;
    }
  StreamedLayout none = streamed_layout(Cin, A, out, 1, 2);
  none.bytes = 0;
  return none;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_addr(bar)) : "memory");
}

// until the phase of parity `parity` has completed. A wait that polls 2^24
// times (over 0.1 s; a healthy wait ends within microseconds) traps: a fault
// in the pipeline then fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (int polls = 0; !done; ++polls) {
    if (polls == (1 << 24)) __trap();
    asm volatile("{\n.reg .pred p;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// the box at (column k, row) of `map` into dst; completes on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int k,
                                         int row) {
  asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
               " [%0], [%1, {%3, %4}], [%2];\n"
               :: "r"(smem_addr(dst)), "l"(map), "r"(smem_addr(bar)), "r"(k), "r"(row)
               : "memory");
}

// wgmma matrix descriptor of a K-major, 128-byte-swizzled tile at shared
// address `saddr`: 8-row groups 1024 B apart (stride byte offset); the
// leading byte offset is unused in this layout (1, as CUTLASS sets it)
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)(1024 >> 4) << 32) |
         ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// the compiler may not move reads or writes of the accumulators across this
// point (wgmma writes them asynchronously); it emits no instruction
template <int NT>
__device__ __forceinline__ void fence_acc(float (&d)[1][NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[0][nt][e]) :: "memory");
}

// d (+)= A (64 x 16, descriptor a) x B (N x 16, descriptor b)^T, N = 8*NT,
// float32 accumulation; scale_d == 0 overwrites d. d[nt][e] is the
// accumulator mma.sync's m16n8 tile nt would hold: row 16*warp + lane/4 (+8
// for e >= 2), column 8*nt + 2*(lane%4) + (e & 1).
template <int NT>
struct Wgmma;
#define WG_D(i) "+f"(d[i][0]), "+f"(d[i][1]), "+f"(d[i][2]), "+f"(d[i][3])
template <> struct Wgmma<1> {
  static __device__ __forceinline__ void run(float (&d)[1][4], uint64_t a, uint64_t b, int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3}, "
                 "%4, %5, p, 1, 1, 0, 0;\n}\n"
                 : WG_D(0)
                 : "l"(a), "l"(b), "r"(scale_d));
  }
};
template <> struct Wgmma<2> {
  static __device__ __forceinline__ void run(float (&d)[2][4], uint64_t a, uint64_t b, int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7}, "
                 "%8, %9, p, 1, 1, 0, 0;\n}\n"
                 : WG_D(0), WG_D(1)
                 : "l"(a), "l"(b), "r"(scale_d));
  }
};
template <> struct Wgmma<3> {
  static __device__ __forceinline__ void run(float (&d)[3][4], uint64_t a, uint64_t b, int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %14, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n24k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
                 "%12, %13, p, 1, 1, 0, 0;\n}\n"
                 : WG_D(0), WG_D(1), WG_D(2)
                 : "l"(a), "l"(b), "r"(scale_d));
  }
};
template <> struct Wgmma<4> {
  static __device__ __forceinline__ void run(float (&d)[4][4], uint64_t a, uint64_t b, int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
                 "%16, %17, p, 1, 1, 0, 0;\n}\n"
                 : WG_D(0), WG_D(1), WG_D(2), WG_D(3)
                 : "l"(a), "l"(b), "r"(scale_d));
  }
};
template <> struct Wgmma<5> {
  static __device__ __forceinline__ void run(float (&d)[5][4], uint64_t a, uint64_t b, int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %22, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19}, "
                 "%20, %21, p, 1, 1, 0, 0;\n}\n"
                 : WG_D(0), WG_D(1), WG_D(2), WG_D(3), WG_D(4)
                 : "l"(a), "l"(b), "r"(scale_d));
  }
};
template <> struct Wgmma<6> {
  static __device__ __forceinline__ void run(float (&d)[6][4], uint64_t a, uint64_t b, int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19, %20, %21, %22, %23}, "
                 "%24, %25, p, 1, 1, 0, 0;\n}\n"
                 : WG_D(0), WG_D(1), WG_D(2), WG_D(3), WG_D(4), WG_D(5)
                 : "l"(a), "l"(b), "r"(scale_d));
  }
};
template <> struct Wgmma<7> {
  static __device__ __forceinline__ void run(float (&d)[7][4], uint64_t a, uint64_t b, int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %30, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27}, "
                 "%28, %29, p, 1, 1, 0, 0;\n}\n"
                 : WG_D(0), WG_D(1), WG_D(2), WG_D(3), WG_D(4), WG_D(5),
                   WG_D(6)
                 : "l"(a), "l"(b), "r"(scale_d));
  }
};
template <> struct Wgmma<8> {
  static __device__ __forceinline__ void run(float (&d)[8][4], uint64_t a, uint64_t b, int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
                 "%32, %33, p, 1, 1, 0, 0;\n}\n"
                 : WG_D(0), WG_D(1), WG_D(2), WG_D(3), WG_D(4), WG_D(5),
                   WG_D(6), WG_D(7)
                 : "l"(a), "l"(b), "r"(scale_d));
  }
};
template <> struct Wgmma<9> {
  static __device__ __forceinline__ void run(float (&d)[9][4], uint64_t a, uint64_t b, int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %38, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n72k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
                 "%32, %33, %34, %35}, "
                 "%36, %37, p, 1, 1, 0, 0;\n}\n"
                 : WG_D(0), WG_D(1), WG_D(2), WG_D(3), WG_D(4), WG_D(5),
                   WG_D(6), WG_D(7), WG_D(8)
                 : "l"(a), "l"(b), "r"(scale_d));
  }
};
template <> struct Wgmma<10> {
  static __device__ __forceinline__ void run(float (&d)[10][4], uint64_t a, uint64_t b, int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
                 "%32, %33, %34, %35, %36, %37, %38, %39}, "
                 "%40, %41, p, 1, 1, 0, 0;\n}\n"
                 : WG_D(0), WG_D(1), WG_D(2), WG_D(3), WG_D(4), WG_D(5),
                   WG_D(6), WG_D(7), WG_D(8), WG_D(9)
                 : "l"(a), "l"(b), "r"(scale_d));
  }
};
template <> struct Wgmma<11> {
  static __device__ __forceinline__ void run(float (&d)[11][4], uint64_t a, uint64_t b, int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %46, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n88k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43}, "
                 "%44, %45, p, 1, 1, 0, 0;\n}\n"
                 : WG_D(0), WG_D(1), WG_D(2), WG_D(3), WG_D(4), WG_D(5),
                   WG_D(6), WG_D(7), WG_D(8), WG_D(9), WG_D(10)
                 : "l"(a), "l"(b), "r"(scale_d));
  }
};
template <> struct Wgmma<12> {
  static __device__ __forceinline__ void run(float (&d)[12][4], uint64_t a, uint64_t b, int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
                 "%48, %49, p, 1, 1, 0, 0;\n}\n"
                 : WG_D(0), WG_D(1), WG_D(2), WG_D(3), WG_D(4), WG_D(5),
                   WG_D(6), WG_D(7), WG_D(8), WG_D(9), WG_D(10), WG_D(11)
                 : "l"(a), "l"(b), "r"(scale_d));
  }
};
template <> struct Wgmma<13> {
  static __device__ __forceinline__ void run(float (&d)[13][4], uint64_t a, uint64_t b, int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %54, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
                 "%48, %49, %50, %51}, "
                 "%52, %53, p, 1, 1, 0, 0;\n}\n"
                 : WG_D(0), WG_D(1), WG_D(2), WG_D(3), WG_D(4), WG_D(5),
                   WG_D(6), WG_D(7), WG_D(8), WG_D(9), WG_D(10), WG_D(11),
                   WG_D(12)
                 : "l"(a), "l"(b), "r"(scale_d));
  }
};
template <> struct Wgmma<14> {
  static __device__ __forceinline__ void run(float (&d)[14][4], uint64_t a, uint64_t b, int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
                 "%48, %49, %50, %51, %52, %53, %54, %55}, "
                 "%56, %57, p, 1, 1, 0, 0;\n}\n"
                 : WG_D(0), WG_D(1), WG_D(2), WG_D(3), WG_D(4), WG_D(5),
                   WG_D(6), WG_D(7), WG_D(8), WG_D(9), WG_D(10), WG_D(11),
                   WG_D(12), WG_D(13)
                 : "l"(a), "l"(b), "r"(scale_d));
  }
};
template <> struct Wgmma<15> {
  static __device__ __forceinline__ void run(float (&d)[15][4], uint64_t a, uint64_t b, int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %62, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n120k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
                 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59}, "
                 "%60, %61, p, 1, 1, 0, 0;\n}\n"
                 : WG_D(0), WG_D(1), WG_D(2), WG_D(3), WG_D(4), WG_D(5),
                   WG_D(6), WG_D(7), WG_D(8), WG_D(9), WG_D(10), WG_D(11),
                   WG_D(12), WG_D(13), WG_D(14)
                 : "l"(a), "l"(b), "r"(scale_d));
  }
};
template <> struct Wgmma<16> {
  static __device__ __forceinline__ void run(float (&d)[16][4], uint64_t a, uint64_t b, int scale_d) {
    asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
                 "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
                 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
                 "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
                 "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
                 "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
                 "%64, %65, p, 1, 1, 0, 0;\n}\n"
                 : WG_D(0), WG_D(1), WG_D(2), WG_D(3), WG_D(4), WG_D(5),
                   WG_D(6), WG_D(7), WG_D(8), WG_D(9), WG_D(10), WG_D(11),
                   WG_D(12), WG_D(13), WG_D(14), WG_D(15)
                 : "l"(a), "l"(b), "r"(scale_d));
  }
};
#undef WG_D

// One warp's epilogue of one anchor over its 16 rows in the streamed plan:
// what store_rows does for G = 1, with each column tile's biases read once
// for both of the thread's rows and the column test only in the last tile
// (8*(NT-1) < out <= 8*NT). EVEN: out is even, so a thread's two columns
// are both in or both out; they go out as one bf16x2 store, and the row max
// is taken over the rounded pairs (__hmax2), which is the rounded max since
// rounding is monotonic. `st` is the warp's staging tile for this anchor;
// the bulk copy that last read it is the older of the (at most) two in
// flight.
template <int NT, bool EVEN>
__device__ __forceinline__ void store16(const float (&acc)[1][NT][4], bf16* st, const float* bias_s,
                                        int out, bf16* zdst, bf16* __restrict__ amax_dst) {
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  if (lane == 0) asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(ST_STAGES - 1) : "memory");
  __syncwarp();
  float m0 = __int_as_float(0xff800000), m1 = m0;  // -inf: rows g and g + 8
  __nv_bfloat162 h0 = __floats2bfloat162_rn(m0, m0), h1 = h0;
  bf16* r0 = st + g * out + 2 * t;
  bf16* r1 = r0 + 8 * out;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = nt * 8 + 2 * t;
    const bool in0 = nt < NT - 1 || c < out, in1 = nt < NT - 1 || c + 1 < out;
    const float2 bb = *reinterpret_cast<const float2*>(bias_s + c);
    const float v00 = acc[0][nt][0] + bb.x, v01 = acc[0][nt][1] + bb.y;
    const float v10 = acc[0][nt][2] + bb.x, v11 = acc[0][nt][3] + bb.y;
    if (EVEN) {
      if (in0) {
        const __nv_bfloat162 p0 = __floats2bfloat162_rn(v00, v01);
        const __nv_bfloat162 p1 = __floats2bfloat162_rn(v10, v11);
        h0 = __hmax2(h0, p0);
        h1 = __hmax2(h1, p1);
        *reinterpret_cast<__nv_bfloat162*>(r0 + nt * 8) = p0;
        *reinterpret_cast<__nv_bfloat162*>(r1 + nt * 8) = p1;
      }
    } else {
      if (in0) {
        m0 = fmaxf(m0, v00);
        m1 = fmaxf(m1, v10);
        r0[nt * 8] = __float2bfloat16_rn(v00);
        r1[nt * 8] = __float2bfloat16_rn(v10);
      }
      if (in1) {
        m0 = fmaxf(m0, v01);
        m1 = fmaxf(m1, v11);
        r0[nt * 8 + 1] = __float2bfloat16_rn(v01);
        r1[nt * 8 + 1] = __float2bfloat16_rn(v11);
      }
    }
  }
  if (EVEN) {
    m0 = fmaxf(__low2float(h0), __high2float(h0));
    m1 = fmaxf(__low2float(h1), __high2float(h1));
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
    m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
  }
  if (t == 0) {
    amax_dst[g] = __float2bfloat16_rn(m0);
    amax_dst[g + 8] = __float2bfloat16_rn(m1);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncwarp();
  if (lane == 0) {
    asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
                 :: "l"(zdst), "r"(smem_addr(st)), "r"(16 * out * 2) : "memory");
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  }
}

template <int NT, bool EVEN>
__global__ void __launch_bounds__(ST_THREADS, 1)
head_pw_streamed_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap wmap, const float* __restrict__ bias,
                        bf16* __restrict__ z, bf16* __restrict__ amax, int Mp, int A, int out,
                        const StreamedLayout L) {
  constexpr int NCOLS = NT * 8;
  constexpr int SLAB = NCOLS * ST_KC * 2;  // bytes of one weight slab
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* xs = base;                                   // [XSETS * NK][128 x 64]
  unsigned char* ws = base + L.w_off;                         // [RING][NCOLS x 64]
  float* bs = reinterpret_cast<float*>(base + L.bias_off);    // [A * NCOLS]
  const int nx = L.xsets * L.nk;
  uint64_t* x_full = reinterpret_cast<uint64_t*>(base + L.bar_off);
  uint64_t* x_empty = x_full + nx;
  uint64_t* w_full = x_empty + nx;
  uint64_t* w_empty = w_full + L.ring;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    // a full barrier completes on its TMA bytes, an empty one on one arrival
    // from each consumer warpgroup
    for (int i = 0; i < nx; ++i) {
      mbar_init(&x_full[i], 1);
      mbar_init(&x_empty[i], 2);
    }
    for (int i = 0; i < L.ring; ++i) {
      mbar_init(&w_full[i], 1);
      mbar_init(&w_empty[i], 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int v = threadIdx.x; v < A * NCOLS; v += ST_THREADS) {
    const int a = v / NCOLS, n = v - a * NCOLS;
    bs[v] = n < out ? bias[a * out + n] : 0.f;
  }
  __syncthreads();

  // this block's tiles: blockIdx.x + i * gridDim.x
  const int ntiles = Mp / ST_ROWS;
  const int my_tiles = (ntiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  auto tile_row0 = [&](int i) { return ((int)blockIdx.x + i * (int)gridDim.x) * ST_ROWS; };

  if (warp == ST_CONSUMERS / 32) {
    // the producer: tile i's x chunks go into set i % XSETS, each just ahead
    // of anchor 0's slab over it; the slabs into the ring slots in turn
    if (threadIdx.x % 32 == 0) {
      int slot = 0, xset = 0;
      uint32_t wpar = 1, xpar = 1;  // a fresh barrier's preceding phase counts as complete
      for (int i = 0; i < my_tiles; ++i) {
        const int row0 = tile_row0(i);
        for (int a = 0; a < A; ++a)
          for (int kc = 0; kc < L.nk; ++kc) {
            if (a == 0) {
              const int xi = xset * L.nk + kc;
              mbar_wait(&x_empty[xi], xpar);
              mbar_expect_tx(&x_full[xi], ST_XCHUNK);
              tma_load(xs + xi * ST_XCHUNK, &xmap, &x_full[xi], kc * ST_KC, row0);
            }
            mbar_wait(&w_empty[slot], wpar);
            mbar_expect_tx(&w_full[slot], SLAB);
            tma_load(ws + slot * SLAB, &wmap, &w_full[slot], kc * ST_KC, a * out);
            if (++slot == L.ring) {
              slot = 0;
              wpar ^= 1;
            }
          }
        if (++xset == L.xsets) {
          xset = 0;
          xpar ^= 1;
        }
      }
    }
  } else {
    // the consumers. A unit is one anchor of one tile; its NK slabs are
    // issued in turn, one commit group each. After each commit the warpgroup
    // waits until at most LAG (1) groups are in flight and releases the slab
    // that has completed (with its x chunk, at the last anchor). Once unit
    // u's first slab is issued, unit u-1 has completed; it is stored after
    // slab store_at of unit u, while that slab multiplies. The two
    // accumulator sets take the units in turn, so the unit loop is written
    // out for a pair.
    const int wg = warp / 4;
    const bool releaser = threadIdx.x % 128 == 0;  // arrives on the empty barriers for its warpgroup
    bf16* stage = reinterpret_cast<bf16*>(base + L.stage_off) + warp * ST_STAGES * 16 * out;
    const int row_in_tile = wg * 64 + (warp % 4) * 16;
    // the slab of unit u after which unit u-1 is stored: the warpgroups take
    // different ones, so that one multiplies while the other stores
    const int store_at = wg == 1 ? L.nk / 2 : 0;
    float acc0[1][NT][4], acc1[1][NT][4];
    int slot = 0, xset = 0;          // the issue cursor: ring slot, x set of tile i
    uint32_t wpar = 0, xpar = 0;     // and the full barriers' phase parities
    int rslot = 0, rkc = 0, ra = 0, rxset = 0;  // the release cursor
    int pending = 0;                 // committed groups not yet released
    int it = 0;                      // anchor outputs this warp has stored

    auto release_completed = [&]() {
      if (L.lag) wgmma_wait<1>();
      else wgmma_wait<0>();
      for (; pending > L.lag; --pending) {
        if (releaser) {
          mbar_arrive(&w_empty[rslot]);
          if (ra == A - 1) mbar_arrive(&x_empty[rxset * L.nk + rkc]);
        }
        if (++rslot == L.ring) rslot = 0;
        if (++rkc == L.nk) {
          rkc = 0;
          if (++ra == A) {
            ra = 0;
            if (++rxset == L.xsets) rxset = 0;
          }
        }
      }
    };
    auto store_unit = [&](const float (&acc)[1][NT][4], int i, int a) {
      const int m0 = tile_row0(i) + row_in_tile;
      store16<NT, EVEN>(acc, stage + (it++ & 1) * 16 * out, bs + a * NCOLS, out,
                        z + ((size_t)a * Mp + m0) * out, amax + (size_t)a * Mp + m0);
    };
    int i = 0, a = 0;  // the unit being issued
    auto run_unit = [&](float (&cur)[1][NT][4], float (&prev)[1][NT][4], bool has_prev) {
      const int pi = a > 0 ? i : i - 1, pa = a > 0 ? a - 1 : A - 1;  // unit u-1
      for (int kc = 0; kc < L.nk; ++kc) {
        const int xi = xset * L.nk + kc;
        if (a == 0) mbar_wait(&x_full[xi], xpar);
        mbar_wait(&w_full[slot], wpar);
        const uint64_t da = wgmma_desc(smem_addr(xs + xi * ST_XCHUNK + wg * (ST_XCHUNK / 2)));
        const uint64_t db = wgmma_desc(smem_addr(ws + slot * SLAB));
        fence_acc(cur);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < ST_KC / 16; ++k)  // 16 values = 32 B = 2 descriptor units
          Wgmma<NT>::run(cur[0], da + 2 * k, db + 2 * k, kc > 0 || k > 0);
        wgmma_commit();
        fence_acc(cur);
        ++pending;
        if (++slot == L.ring) {
          slot = 0;
          wpar ^= 1;
        }
        release_completed();
        if (kc == store_at && has_prev) {
          fence_acc(prev);
          store_unit(prev, pi, pa);
        }
      }
      if (++a == A) {
        a = 0;
        ++i;
        if (++xset == L.xsets) {
          xset = 0;
          xpar ^= 1;
        }
      }
    };

    const int units = my_tiles * A;
    for (int u = 0; u < units; u += 2) {
      run_unit(acc0, acc1, u > 0);
      if (u + 1 < units) run_unit(acc1, acc0, true);
    }
    wgmma_wait<0>();
    const int li = (units - 1) / A, la = units - 1 - li * A;
    if (units % 2) {
      fence_acc(acc0);
      store_unit(acc0, li, la);
    } else if (units > 0) {
      fence_acc(acc1);
      store_unit(acc1, li, la);
    }
    drain_stores();
  }
}

typedef void (*mma_kernel_t)(const bf16*, const bf16*, const float*, bf16*, bf16*, int, int,
                             int, int, int);

// Shared memory of the resident plan, in bytes (see the note at the top).
size_t resident_bytes(int A, int out) {
  const size_t ncols = (size_t)((out + 7) / 8) * 8;
  return (size_t)A * ncols * (MM_LDS * 2 + 4) + (size_t)MM_WARPS * RES_ROWS * out * 2;
}

// 1 = resident, 2 = streamed, 0 = neither fits in `smem_max` bytes
int pick_plan(int Cin, int A, int out, int smem_max) {
  if (Cin <= MM_KC && resident_bytes(A, out) <= (size_t)smem_max) return 1;
  if (pick_streamed(Cin, A, out, smem_max).bytes > 0) return 2;
  return 0;
}

cudaError_t smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

typedef CUresult (*encode_tiled_t)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in libcuda (the library links the CUDA runtime only)
cudaError_t encoder(encode_tiled_t* fn) {
  static encode_tiled_t cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorNotSupported;
    cached = reinterpret_cast<encode_tiled_t>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// the map of a (rows, cols) row-major bf16 matrix read in boxes of box_rows x
// 64, 128-byte swizzled, zero outside the matrix
cudaError_t tensor_map(CUtensorMap* map, const void* ptr, int rows, int cols, int box_rows) {
  encode_tiled_t encode = nullptr;
  const cudaError_t err = encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)ST_KC, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                              strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int NT>
cudaError_t launch_streamed(const void* x, const void* w, const float* bias, void* z, void* amax,
                            int M, int Mp, int Cin, int A, int out, int nsm, int optin,
                            cudaStream_t stream) {
  const StreamedLayout L = pick_streamed(Cin, A, out, optin);
  if (L.bytes == 0) return cudaErrorInvalidValue;
  // TMA's global strides and the bulk stores' addresses must be multiples of
  // 16 bytes: Cin * 2, and z + (a*Mp + m0) * out * 2 with m0 % 16 == 0 (the
  // sizes, 16 * out * 2, are)
  if (M < 1 || (Cin * 2) % 16 != 0 || reinterpret_cast<uintptr_t>(z) % 16 != 0)
    return cudaErrorInvalidValue;
  CUtensorMap xmap, wmap;
  cudaError_t err = tensor_map(&xmap, x, M, Cin, ST_ROWS);
  if (err == cudaSuccess) err = tensor_map(&wmap, w, A * out, Cin, NT * 8);
  if (err != cudaSuccess) return err;
  const auto kern = out % 2 == 0 ? head_pw_streamed_kernel<NT, true> : head_pw_streamed_kernel<NT, false>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return err;
  const int ntiles = Mp / ST_ROWS;
  const int grid = ntiles < nsm ? ntiles : nsm;
  kern<<<grid, ST_THREADS, L.bytes, stream>>>(xmap, wmap, bias, static_cast<bf16*>(z),
                                              static_cast<bf16*>(amax), Mp, A, out, L);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_mma_nt(const void* x, const void* w, const float* bias, void* z, void* amax,
                          int M, int Mp, int Cin, int A, int out, cudaStream_t stream) {
  int dev = 0, nsm = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = smem_optin(&optin);
  if (err != cudaSuccess) return err;
  const int plan = pick_plan(Cin, A, out, optin);
  if (plan == 0) return cudaErrorInvalidValue;
  if (plan == 2)
    return launch_streamed<NT>(x, w, bias, z, amax, M, Mp, Cin, A, out, nsm, optin, stream);
  const mma_kernel_t kern = head_pw_resident_kernel<NT>;
  const int smem = (int)resident_bytes(A, out);
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, MM_THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // blocks with work: a warp takes 32-row units
  const int work = (Mp / RES_ROWS + MM_WARPS - 1) / MM_WARPS;
  const int grid = work < nsm * per_sm ? work : nsm * per_sm;
  kern<<<grid, MM_THREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w), bias, static_cast<bf16*>(z),
      static_cast<bf16*>(amax), M, Mp, Cin, A, out);
  return cudaGetLastError();
}

cudaError_t launch_mma(const void* x, const void* w, const float* bias, void* z,
                       void* amax, int M, int Mp, int Cin, int A, int out,
                       cudaStream_t stream) {
#define HEAD_MMA_CASE(NT_) \
  case NT_:                \
    return launch_mma_nt<NT_>(x, w, bias, z, amax, M, Mp, Cin, A, out, stream);
  switch ((out + 7) / 8) {
    HEAD_MMA_CASE(1) HEAD_MMA_CASE(2) HEAD_MMA_CASE(3) HEAD_MMA_CASE(4)
    HEAD_MMA_CASE(5) HEAD_MMA_CASE(6) HEAD_MMA_CASE(7) HEAD_MMA_CASE(8)
    HEAD_MMA_CASE(9) HEAD_MMA_CASE(10) HEAD_MMA_CASE(11) HEAD_MMA_CASE(12)
    HEAD_MMA_CASE(13) HEAD_MMA_CASE(14) HEAD_MMA_CASE(15) HEAD_MMA_CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef HEAD_MMA_CASE
}

}  // namespace

// x (M, Cin) and w (A*out, Cin), both in dtype (0 = float32, 1 = bfloat16;
// w is the kernel transposed, so each output column's weights are
// contiguous), bias (A*out) float32. Mp must be a multiple of 64 (128 for
// bf16) and out <= 128; bf16 also needs Cin % 8 == 0 and x, w 16-byte
// aligned. Returns the launch's cudaError_t (0 on success).
extern "C" int head_pointwise_launch(const void* x, const void* w,
                                     const void* bias, void* z, void* amax,
                                     int M, int Mp, int Cin, int A, int out,
                                     int dtype, void* stream) {
  if (M < 0 || Mp % TM != 0 || Mp < M || out < 1 || out > TX * 8 || A < 1 || Cin < 1)
    return (int)cudaErrorInvalidValue;
  if (Mp == 0) return 0;
  const float* b = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch_f32(x, w, b, z, amax, M, Mp, Cin, A, out, s);
  if (dtype == 1) {
    if (Cin % 8 != 0 || Mp % ST_ROWS != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(w) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    return (int)launch_mma(x, w, b, z, amax, M, Mp, Cin, A, out, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The bf16 plan the launcher takes for these widths on the current device:
// 1 resident, 2 streamed, 0 none (the launch would be refused); a negative
// cudaError_t if the device cannot be queried.
extern "C" int head_pointwise_plan(int Cin, int A, int out) {
  int optin = 0;
  const cudaError_t err = smem_optin(&optin);
  if (err != cudaSuccess) return -(int)err;
  return pick_plan(Cin, A, out, optin);
}

// Shared memory the streamed plan asks for at these widths on the current
// device (0 if it does not fit); a negative cudaError_t if the device cannot
// be queried. ops/head_kernel.streamed_smem_bytes mirrors it.
extern "C" int head_pointwise_streamed_smem(int Cin, int A, int out) {
  int optin = 0;
  const cudaError_t err = smem_optin(&optin);
  if (err != cudaSuccess) return -(int)err;
  return pick_streamed(Cin, A, out, optin).bytes;
}

extern "C" const char* head_pointwise_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
