// Greedy per-class NMS keep mask for score-sorted candidates.
//
// Replaces: efficientdet_tpu/ops/nms_pallas.py, _suppress_kernel (wrapper
// suppression_keep_mask). For each image, with candidates sorted by
// descending score,
//
//   sup[j, i] = IoU(j, i) > t  and  class[j] == class[i]  and  j < i
//   keep      = the fixpoint of keep[i] = valid[i] and not any_j keep[j] sup[j, i]
//
// which is the unique greedy NMS keep mask. The result equals the JAX
// package's _fixpoint_suppress bit for bit.
//
// Why not the TPU design: the TPU kernel holds a K x K bf16 matrix (2 MB at
// K = 1024) in VMEM and sweeps it with matrix-vector products. That does not
// fit in an SM's 227 KB of shared memory. Here the matrix is bit-packed:
//
//   1. nms_mask_kernel: a grid of (column block, row block, image) blocks of
//      64 threads. Thread j of row block rb tests its candidate against the
//      64 candidates of column block cb (staged in shared memory) and writes
//      one 64-bit word of mask[b, j, cb]; bit c means "j suppresses
//      cb*64 + c". Blocks below the diagonal (cb < rb) hold no j < i pair
//      and write zeros. The mask is (B, K, ceil(K/64)) uint64, 128 KB per
//      image at K = 1024, in a scratch tensor the wrapper allocates.
//   2. nms_scan_kernel: one block per image copies its mask into shared
//      memory, then one warp walks the candidates in score order. Lane w
//      holds word w of the "removed" bitset; candidate i is kept if valid
//      and its bit is clear, and a kept candidate ORs its mask row into the
//      bitset. That is the greedy scan, which gives the fixpoint's mask.
//
// Bit for bit: the IoU is computed with the reference's operations in its
// order, each rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn; the file is also built with -fmad=false), so no multiply-add
// is contracted into an FMA and no IoU at the threshold moves.
//
// What bounds it on an H100: operations. B*K*(K-1)/2 candidate pairs
// (67 M at B = 128, K = 1024) get a class compare, and the pairs of one
// class an IoU test of about 14 float32 operations: at most about
// 0.014 ms at 67 TFLOP/s. The bytes (boxes in, keep out) are under 3 MB.
// In practice the scan bounds it: a chain of K dependent steps per image,
// about 1 K x a few tens of cycles, run for all images at once on
// separate SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TB = 64;  // candidates per block side = bits per mask word

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f), fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

__global__ void __launch_bounds__(TB)
nms_mask_kernel(const float4* __restrict__ boxes, const int* __restrict__ classes,
                int K, int W, float thr, unsigned long long* __restrict__ mask) {
  const int cb = blockIdx.x, rb = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x;
  const int j = rb * TB + t;
  if (cb < rb) {  // block-uniform: no pair j < i below the diagonal
    if (j < K) mask[((size_t)b * K + j) * W + cb] = 0ull;
    return;
  }
  __shared__ float4 cbox[TB];
  __shared__ float carea[TB];
  __shared__ int ccls[TB];
  const int i0 = cb * TB;
  if (i0 + t < K) {
    const float4 bx = boxes[(size_t)b * K + i0 + t];
    cbox[t] = bx;
    carea[t] = box_area(bx);
    ccls[t] = classes[(size_t)b * K + i0 + t];
  }
  __syncthreads();
  if (j >= K) return;
  const float4 bj = boxes[(size_t)b * K + j];
  const float aj = box_area(bj);
  const int cj = classes[(size_t)b * K + j];
  const int n = min(TB, K - i0);
  unsigned long long bits = 0ull;
  for (int c = 0; c < n; ++c) {
    if (i0 + c <= j || ccls[c] != cj) continue;
    const float4 bi = cbox[c];
    // iou_matrix(boxes, boxes)[j, i]: rows are j, columns i
    const float iw = fmaxf(__fsub_rn(fminf(bj.z, bi.z), fmaxf(bj.x, bi.x)), 0.f);
    const float ih = fmaxf(__fsub_rn(fminf(bj.w, bi.w), fmaxf(bj.y, bi.y)), 0.f);
    const float inter = __fmul_rn(iw, ih);
    const float uni = __fsub_rn(__fadd_rn(aj, carea[c]), inter);
    const float iou = uni > 0.f ? __fdiv_rn(inter, fmaxf(uni, 1e-9f)) : 0.f;
    if (iou > thr) bits |= 1ull << c;
  }
  mask[((size_t)b * K + j) * W + cb] = bits;
}

constexpr int SCAN_THREADS = 512;

__global__ void __launch_bounds__(SCAN_THREADS)
nms_scan_kernel(const unsigned long long* __restrict__ mask,
                const unsigned char* __restrict__ valid, int K, int W,
                unsigned char* __restrict__ keep) {
  extern __shared__ unsigned long long smask[];  // [K][W], then valid[K]
  unsigned char* sval = reinterpret_cast<unsigned char*>(smask + (size_t)K * W);
  const int b = blockIdx.x;
  const unsigned long long* src = mask + (size_t)b * K * W;
  for (int idx = threadIdx.x; idx < K * W; idx += SCAN_THREADS) smask[idx] = src[idx];
  for (int idx = threadIdx.x; idx < K; idx += SCAN_THREADS) sval[idx] = valid[(size_t)b * K + idx];
  __syncthreads();
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  unsigned long long removed = 0ull;  // word `lane` of the removed bitset
  for (int i = 0; i < K; ++i) {
    const unsigned long long word = __shfl_sync(0xffffffffu, removed, i / TB);
    const bool kept = sval[i] && !((word >> (i % TB)) & 1ull);
    if (kept && lane < W) removed |= smask[(size_t)i * W + lane];
    if (lane == 0) keep[(size_t)b * K + i] = kept ? 1 : 0;
  }
}

}  // namespace

// boxes (B, K, 4) f32, classes (B, K) i32, valid (B, K) u8 -> keep (B, K) u8.
// mask is scratch of B*K*ceil(K/64) uint64. Needs ceil(K/64) <= 32.
extern "C" int nms_suppress_launch(const void* boxes, const void* classes,
                                   const void* valid, void* mask, void* keep,
                                   int B, int K, float thr, void* stream) {
  if (B < 0 || K < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || K == 0) return 0;
  const int W = (K + TB - 1) / TB;
  if (W > 32 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(W, W, B);
  nms_mask_kernel<<<grid, TB, 0, s>>>(
      static_cast<const float4*>(boxes), static_cast<const int*>(classes), K, W,
      thr, static_cast<unsigned long long*>(mask));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int smem = K * W * 8 + K;  // mask words, then valid flags
  err = cudaFuncSetAttribute(nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  nms_scan_kernel<<<B, SCAN_THREADS, smem, s>>>(
      static_cast<const unsigned long long*>(mask),
      static_cast<const unsigned char*>(valid), K, W,
      static_cast<unsigned char*>(keep));
  return (int)cudaGetLastError();
}

extern "C" const char* nms_suppress_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
