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
// cores, and its design has one aim: keep the z store streaming.
//
// bf16: persistent blocks, as many as fit on the SMs, of eight warps that
// work on their own (no barrier of the block once the weights are in).
// mma.sync m16n8k16 with float32 accumulation over NT = ceil(out/8) column
// tiles. A warp's epilogue adds the bias, rounds z to bf16 from the float32
// sum and amax from the max of the float32 sums, and writes its rows of one
// anchor, one contiguous run of rows*out values in z, into its own staging
// tile in shared memory; after fence.proxy.async its lane 0 sends the tile
// with one 1-D bulk copy (cp.async.bulk, bulk_group). The copy drains while
// the warp multiplies the next anchor: the warp waits on it
// (cp.async.bulk.wait_group.read) only before it writes that staging tile
// again. amax goes out with plain stores.
//
// The launcher picks one of two plans from Cin and the shared memory:
//   resident (Cin <= 64: D0's width, the main path): every anchor's weight
//     columns and biases stay in shared memory for the block's lifetime, and
//     each warp walks units of 32 rows (two m16 tiles) in a grid-stride
//     loop. It holds a unit's x rows in registers, read straight from device
//     memory in 16-byte loads (zero for rows >= M and columns >= Cin; the
//     next unit's rows are in flight while this unit's anchors run), and
//     runs all A anchors over them, so x is read once. The fragments take
//     the K order those loads give: thread t holds k = 16t..16t+15 of its
//     rows, so at k-step s it has k = 16t+4s..16t+4s+3 where mma.sync names
//     k = 2t, 2t+1, 2t+8, 2t+9; the weights are read in the same order (two
//     16-byte shared loads a column tile), the same products in another
//     order of summation. Shared memory at D0's class launch: weights
//     9 x 96 x 72 x 2 = 124,416 B, bias 3,456, staging 8 warps x 32 x 90 x 2
//     = 46,080: 173,952 B of the 232,448 a block may have, one block an SM.
//     The box launch (A 1, out 36) needs 24,352 B.
//   streamed (Cin > 64, or weights that do not fit; D1's class launch from
//     Cin 88 up, and the D6/D7 width 384, whose class weights alone are
//     622 KB): a block walks 128-row tiles and stages the x tile and one
//     anchor's weight columns per K chunk of 64, double-buffered by cp.async
//     (16 B, zero-fill for rows >= M and columns >= Cin), so it reads each x
//     chunk once per anchor (from L2 after the first); each warp stores its
//     16 rows as above, through two staging tiles. At most 2 x (128 + 128)
//     x 72 x 2 + bias 9 x 128 x 4 + 2 x 128 x 128 x 2 = 143,872 B (A 9).
// Shared rows are 72 values (a K chunk of 64 padded by 8), an odd number of
// 16-byte units, so the fragment loads hit distinct banks. Needs Cin % 8 == 0.
//
// float32 (head_pw_kernel, the card-vs-CPU check's path): 64 rows, float32
// FMAs (TF32 would round the inputs), each thread an 8-row by CPT-column
// tile (columns tx + 16*j), K staged in chunks of 32; the block owns one
// anchor plane of a row tile and stores it through a staging tile in
// 16-byte writes.

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
constexpr int MM_ROWS = 128;       // Mp's granule; the streamed plan's row tile
constexpr int MM_KC = 64;          // the resident plan's whole K, the streamed plan's K chunk
constexpr int MM_LDS = MM_KC + 8;  // a shared row, in bf16 values
constexpr int RES_ROWS = 32;       // the resident plan's unit: two m16 tiles a warp
constexpr int STR_STAGES = 2;      // staging tiles a warp in the streamed plan

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t ld_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

// rows [0, rows) and columns [0, 8*kv) of a shared tile with row stride lds,
// from rows row0 + r of a (., Cin) global matrix, columns k0 + c: zero for
// rows >= row_end and columns >= Cin (Cin % 8 == 0, so a 16-byte vector is
// wholly in or out)
__device__ __forceinline__ void load_tile(bf16* dst, int lds, const bf16* src, int row0,
                                          int row_end, int rows, int Cin, int k0, int kv) {
  for (int v = threadIdx.x; v < rows * kv; v += MM_THREADS) {
    const int r = v / kv, c8 = (v - r * kv) * 8;
    const int row = row0 + r, k = k0 + c8;
    const bool in = row < row_end && k < Cin;
    cp_async16(dst + r * lds + c8, in ? src + (size_t)row * Cin + k : src, in);
  }
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

// acc += x tile rows (this warp's 16) x weight columns (8*NT), k in [0, kn)
template <int NT>
__device__ __forceinline__ void mma_tile(float (&acc)[NT][4], const bf16* xs, const bf16* ws,
                                         int lds, int kn) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const bf16* pa = xs + (warp * 16 + g) * lds + 2 * t;
  const bf16* pb = ws + g * lds + 2 * t;
#pragma unroll 2
  for (int kb = 0; kb < kn; kb += 16) {
    const uint32_t a0 = ld_u32(pa + kb), a1 = ld_u32(pa + 8 * lds + kb);
    const uint32_t a2 = ld_u32(pa + kb + 8), a3 = ld_u32(pa + 8 * lds + kb + 8);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const bf16* q = pb + nt * 8 * lds + kb;
      mma_bf16(acc[nt], a0, a1, a2, a3, ld_u32(q), ld_u32(q + 8));
    }
  }
}

template <int NT>
__global__ void __launch_bounds__(MM_THREADS, 1)
head_pw_streamed_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                        const float* __restrict__ bias, bf16* __restrict__ z,
                        bf16* __restrict__ amax, int M, int Mp, int Cin, int A, int out) {
  constexpr int NCOLS = NT * 8;
  constexpr int BUF = (MM_ROWS + NCOLS) * MM_LDS;  // x chunk, then weight chunk
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* buf = reinterpret_cast<bf16*>(smem);                   // [2][BUF]
  float* bs = reinterpret_cast<float*>(buf + 2 * BUF);         // [A * NCOLS]
  bf16* stage = reinterpret_cast<bf16*>(bs + A * NCOLS) +
                (threadIdx.x / 32) * STR_STAGES * 16 * out;  // this warp's
  for (int v = threadIdx.x; v < A * NCOLS; v += MM_THREADS) {
    const int a = v / NCOLS, n = v - a * NCOLS;
    bs[v] = n < out ? bias[a * out + n] : 0.f;
  }

  const int nk = (Cin + MM_KC - 1) / MM_KC;
  const int per_tile = A * nk;
  const int ntiles = Mp / MM_ROWS;
  const int my_tiles = (ntiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  const long long nsteps = (long long)my_tiles * per_tile;
  // step s: tile blockIdx.x + (s / per_tile) * gridDim.x, anchor
  // (s % per_tile) / nk, K chunk s % nk
  auto load_step = [&](long long s, bf16* dst) {
    const int tile = (int)blockIdx.x + (int)(s / per_tile) * (int)gridDim.x;
    const int rem = (int)(s % per_tile), a = rem / nk, k0 = (rem % nk) * MM_KC;
    load_tile(dst, MM_LDS, x, tile * MM_ROWS, M, MM_ROWS, Cin, k0, MM_KC / 8);
    load_tile(dst + MM_ROWS * MM_LDS, MM_LDS, wt, a * out, (a + 1) * out, NCOLS, Cin, k0, MM_KC / 8);
  };
  load_step(0, buf);
  cp_async_commit();

  float acc[1][NT][4];
  int it = 0;
  for (long long s = 0; s < nsteps; ++s) {
    // one barrier a step: this step's chunk has landed for every thread,
    // and every warp is done with step s-1, whose buffer the next step's
    // chunk now goes into
    cp_async_wait_all();
    __syncthreads();
    if (s + 1 < nsteps) load_step(s + 1, buf + ((s + 1) & 1) * BUF);
    cp_async_commit();
    const int tile = (int)blockIdx.x + (int)(s / per_tile) * (int)gridDim.x;
    const int rem = (int)(s % per_tile), a = rem / nk, kc = rem % nk;
    if (kc == 0) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[0][nt][e] = 0.f;
    }
    const bf16* xs = buf + (s & 1) * BUF;
    mma_tile<NT>(acc[0], xs, xs + MM_ROWS * MM_LDS, MM_LDS, MM_KC);
    if (kc == nk - 1) {
      const int m0 = tile * MM_ROWS + (threadIdx.x / 32) * 16;
      store_rows<NT, 1, STR_STAGES>(acc, stage, it, bs + a * NCOLS, out,
                                    z + ((size_t)a * Mp + m0) * out, amax + (size_t)a * Mp + m0);
      ++it;
    }
  }
  drain_stores();
}

typedef void (*mma_kernel_t)(const bf16*, const bf16*, const float*, bf16*, bf16*, int, int,
                             int, int, int);

// Shared memory of each plan, in bytes (see the note at the top).
size_t resident_bytes(int A, int out) {
  const size_t ncols = (size_t)((out + 7) / 8) * 8;
  return (size_t)A * ncols * (MM_LDS * 2 + 4) + (size_t)MM_WARPS * RES_ROWS * out * 2;
}

size_t streamed_bytes(int A, int out) {
  const size_t ncols = (size_t)((out + 7) / 8) * 8;
  return 2 * (MM_ROWS + ncols) * MM_LDS * 2 + (size_t)A * ncols * 4 +
         (size_t)MM_WARPS * STR_STAGES * 16 * out * 2;
}

// 1 = resident, 2 = streamed, 0 = neither fits in `smem_max` bytes
int pick_plan(int Cin, int A, int out, int smem_max) {
  if (Cin <= MM_KC && resident_bytes(A, out) <= (size_t)smem_max) return 1;
  if (streamed_bytes(A, out) <= (size_t)smem_max) return 2;
  return 0;
}

cudaError_t smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
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
  const mma_kernel_t kern = plan == 1 ? head_pw_resident_kernel<NT> : head_pw_streamed_kernel<NT>;
  const int smem = (int)(plan == 1 ? resident_bytes(A, out) : streamed_bytes(A, out));
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, MM_THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  // blocks with work: a resident warp takes 32-row units, a streamed block 128-row tiles
  const int work = plan == 1 ? (Mp / RES_ROWS + MM_WARPS - 1) / MM_WARPS : Mp / MM_ROWS;
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
    if (Cin % 8 != 0 || Mp % MM_ROWS != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
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

extern "C" const char* head_pointwise_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
