// Anchor-major head pointwise: (M, Cin) @ (Cin, A*out) + bias, stored per
// anchor plane, with the per-row max of each anchor's outputs.
//
// Replaces: efficientdet_tpu/ops/head_pallas.py, _head_pw_kernel (wrapper
// head_pointwise_anchor_major), the heads' final 1x1 conv on TPU.
//
//   z[a, m, c]  = sum_k x[m, k] * w[k, a*out + c] + bias[a*out + c]   (x dtype)
//   amax[a, m]  = max_c of the float32 sums                           (x dtype)
//
// Rows m >= M (up to Mp, a multiple of 512) read x as zero, so they hold the
// bias only, as the TPU kernel's padded rows do.
//
// What bounds it on an H100: the store of z. At D0@512, batch 128, bf16, the
// class launch (A=9, out=90) reads 89 MB of x and writes 1.13 GB of z and
// 12.6 MB of amax: about 0.37 ms at 3.35 TB/s, against 72 GFLOP of products,
// about 0.07 ms on the bf16 tensor cores but about 1 ms of float32 FMAs on
// the CUDA cores. So the bf16 path (the main path) multiplies on the tensor
// cores, and both paths spend their design on the store.
//
// Both paths: a block owns a tile of rows of one anchor's plane. Consecutive
// blocks take the anchors of the same row tile, so the blocks that read one
// x tile run together and find it in L2. The block stages x and its anchor's
// weight columns in shared memory, keeps its sums in registers, adds the
// bias, reduces each row's max with warp shuffles, and writes its outputs
// into a shared staging tile. Plane a's rows m0..m0+TM-1 are one contiguous
// run of TM*out values in z, so the staged tile leaves in 16-byte coalesced
// stores. `out` need not be a power of two: columns past it are masked.
//
// bf16 (head_pw_mma_kernel): 128 rows by 8*NT columns (NT = ceil(out/8)),
// eight warps of 16 rows, mma.sync m16n8k16 with float32 accumulation; x
// and the weights (passed transposed, k contiguous) come in with 16-byte
// loads, rows padded to 72 values in shared memory so the fragment loads
// hit 32 distinct banks. Needs Cin % 8 == 0.
// float32 (head_pw_kernel): 64 rows, float32 FMAs (TF32 would round the
// inputs), each thread an 8-row by CPT-column tile (columns tx + 16*j), K
// staged in chunks of 32.

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

constexpr int MM_ROWS = 128;  // rows per block
constexpr int MM_KC = 64;     // K chunk staged in shared memory
constexpr int MM_LDS = MM_KC + 8;  // padded row stride, in bf16 values
constexpr int MM_THREADS = 256;
constexpr int MM_WARPS = MM_THREADS / 32;
constexpr int MM_MTILES = MM_ROWS / (16 * MM_WARPS);  // 16-row tiles a warp
constexpr int MM_WROWS = 16 * MM_MTILES;              // rows a warp

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The launch bound asks for three blocks (24 warps) on an SM, so that they
// hide each other's load and store latency; chip_smoke.py's "device" line
// reports the registers ptxas gave, and PERF.md the class launch's time
// before and after the bound was set.
template <int NT>
__global__ void __launch_bounds__(MM_THREADS, 3)
head_pw_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ wt,
                   const float* __restrict__ bias, __nv_bfloat16* __restrict__ z,
                   __nv_bfloat16* __restrict__ amax, int M, int Mp, int Cin, int A, int out) {
  constexpr int NCOLS = NT * 8;
  constexpr int AS = MM_ROWS * MM_LDS;  // bf16 values
  constexpr int BS = NCOLS * MM_LDS;
  // the staging tile (MM_ROWS * out <= MM_ROWS * NCOLS values) fits in AS + BS
  static_assert(MM_ROWS * NCOLS <= AS + BS, "staging tile must fit");
  __shared__ __align__(16) __nv_bfloat16 smem[AS + BS];
  __nv_bfloat16* As = smem;       // [MM_ROWS][MM_LDS], k contiguous
  __nv_bfloat16* Bs = smem + AS;  // [NCOLS][MM_LDS], k contiguous (mma "col")

  const int a = blockIdx.x % A;
  const int m0 = (blockIdx.x / A) * MM_ROWS;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  float acc[MM_MTILES][NT][4];
#pragma unroll
  for (int i = 0; i < MM_MTILES; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int k0 = 0; k0 < Cin; k0 += MM_KC) {
    // x tile: 8 values (16 bytes) a load; Cin % 8 == 0 keeps them aligned
    for (int v = tid; v < MM_ROWS * (MM_KC / 8); v += MM_THREADS) {
      const int r = v / (MM_KC / 8), c8 = (v % (MM_KC / 8)) * 8;
      const int m = m0 + r, k = k0 + c8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (m < M && k < Cin) val = *reinterpret_cast<const uint4*>(x + (size_t)m * Cin + k);
      *reinterpret_cast<uint4*>(As + r * MM_LDS + c8) = val;
    }
    // weight columns of anchor a, k contiguous in wt: 16-byte loads too
    for (int v = tid; v < NCOLS * (MM_KC / 8); v += MM_THREADS) {
      const int n = v / (MM_KC / 8), c8 = (v % (MM_KC / 8)) * 8;
      const int k = k0 + c8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (n < out && k < Cin) val = *reinterpret_cast<const uint4*>(wt + (size_t)(a * out + n) * Cin + k);
      *reinterpret_cast<uint4*>(Bs + n * MM_LDS + c8) = val;
    }
    __syncthreads();
#pragma unroll
    for (int kb = 0; kb < MM_KC; kb += 16) {
      uint32_t af[MM_MTILES][4];
#pragma unroll
      for (int mt = 0; mt < MM_MTILES; ++mt) {
        const __nv_bfloat16* p = As + (warp * MM_WROWS + mt * 16 + g) * MM_LDS + kb + 2 * t;
        af[mt][0] = ld_u32(p);
        af[mt][1] = ld_u32(p + 8 * MM_LDS);
        af[mt][2] = ld_u32(p + 8);
        af[mt][3] = ld_u32(p + 8 * MM_LDS + 8);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* q = Bs + (nt * 8 + g) * MM_LDS + kb + 2 * t;
        const uint32_t b0 = ld_u32(q), b1 = ld_u32(q + 8);
#pragma unroll
        for (int mt = 0; mt < MM_MTILES; ++mt) mma_bf16(acc[mt][nt], af[mt], b0, b1);
      }
    }
    __syncthreads();
  }

  // Epilogue: bias, row max (the 4 threads of a group share a row), staging.
  __nv_bfloat16* stage = smem;
#pragma unroll
  for (int mt = 0; mt < MM_MTILES; ++mt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = warp * MM_WROWS + mt * 16 + g + 8 * half;
      float rmax = __int_as_float(0xff800000);  // -inf
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = nt * 8 + 2 * t + e;
          if (c < out) {
            const float v = acc[mt][nt][half * 2 + e] + bias[a * out + c];
            stage[r * out + c] = __float2bfloat16_rn(v);
            rmax = fmaxf(rmax, v);
          }
        }
      }
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 1));
      rmax = fmaxf(rmax, __shfl_xor_sync(0xffffffffu, rmax, 2));
      if (t == 0) amax[(size_t)a * Mp + m0 + r] = __float2bfloat16_rn(rmax);
    }
  }
  __syncthreads();
  // MM_ROWS*out*2 bytes is a multiple of 16, and so is the tile's offset in
  // z (Mp and m0 are multiples of 128).
  const int nvec = MM_ROWS * out * 2 / 16;
  const uint4* src = reinterpret_cast<const uint4*>(stage);
  uint4* dst = reinterpret_cast<uint4*>(z + ((size_t)a * Mp + m0) * out);
  for (int v = tid; v < nvec; v += MM_THREADS) dst[v] = src[v];
}

cudaError_t launch_mma(const void* x, const void* w, const float* bias, void* z,
                       void* amax, int M, int Mp, int Cin, int A, int out,
                       cudaStream_t stream) {
  const dim3 grid((unsigned)A * (unsigned)(Mp / MM_ROWS));
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* wp = static_cast<const __nv_bfloat16*>(w);
  __nv_bfloat16* zp = static_cast<__nv_bfloat16*>(z);
  __nv_bfloat16* ap = static_cast<__nv_bfloat16*>(amax);
#define HEAD_MMA_CASE(NT_)                                                  \
  case NT_:                                                                 \
    head_pw_mma_kernel<NT_><<<grid, MM_THREADS, 0, stream>>>(               \
        xp, wp, bias, zp, ap, M, Mp, Cin, A, out);                          \
    break;
  switch ((out + 7) / 8) {
    HEAD_MMA_CASE(1) HEAD_MMA_CASE(2) HEAD_MMA_CASE(3) HEAD_MMA_CASE(4)
    HEAD_MMA_CASE(5) HEAD_MMA_CASE(6) HEAD_MMA_CASE(7) HEAD_MMA_CASE(8)
    HEAD_MMA_CASE(9) HEAD_MMA_CASE(10) HEAD_MMA_CASE(11) HEAD_MMA_CASE(12)
    HEAD_MMA_CASE(13) HEAD_MMA_CASE(14) HEAD_MMA_CASE(15) HEAD_MMA_CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef HEAD_MMA_CASE
  return cudaGetLastError();
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

extern "C" const char* head_pointwise_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
