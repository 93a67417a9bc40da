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
// fit in an SM's 227 KB of shared memory. Here the matrix is bit-packed, and
// one launch does all of it, one block of 16 warps per image, in shared
// memory, with no scratch in device memory:
//
//   1. Staging: the image's boxes, areas and classes; its valid flags as one
//      64-bit word per 64 candidates (warp ballots); and, per word, a table
//      of 128 class buckets, bucket[w][h] holding the bits of the word's
//      candidates whose class hashes to h.
//   2. Mask: mask[j][w] bit c means "j suppresses i = 64w + c". Only the
//      words at or right of j's own word (w >= j / 64) are built; the scan
//      reads no other. A word is built by one thread: its candidates of
//      j's class are bucket[w][hash(class j)] (one load instead of 64 class
//      compares; a bucket's other classes are dropped by a compare), with
//      i > j and i < K; the IoU test runs only on those, first the
//      intersection alone, then the full IoU only where it is not 0. The
//      words are dealt to the warps 32 rows by one word at a time. Rows are
//      ldw = W | 1 words apart (W = ceil(K/64)), an odd stride, so a warp's
//      32 row writes and the scan's column reads hit distinct banks. Then
//      each diagonal word block is transposed: col[i] bit c means
//      "64w + c suppresses i", for i in word w.
//   3. Scan, one warp, word by word: lane l holds word l of the "removed"
//      set. Word w's kept set is the fixpoint of kept = avail & ~{i : col[i]
//      & kept != 0}, avail its valid candidates not removed by earlier
//      words; iterated from kept = avail, two ballots a step, it is exact
//      once a step changes nothing (the fixpoint is unique), after as many
//      steps as the longest chain of suppressions inside the word, plus one.
//      The word's kept bits are then fanned in: lane l > w ORs mask[i][l] of
//      every kept i into its word, as 64 predicated loads that do not wait on
//      one another. keep is written 64 flags a word.
//
// Bit for bit: the IoU is computed with the reference's operations in its
// order, each rounded on its own (__fmul_rn, __fadd_rn, __fsub_rn,
// __fdiv_rn; the file is also built with -fmad=false), so no multiply-add
// is contracted into an FMA and no IoU at the threshold moves. A pair whose
// intersection is 0 has IoU 0 (the reference's 0 / union, or its 0 where the
// union is not positive) and so suppresses exactly when 0 > t.
//
// Shared memory per image: 16 K (boxes) + 256 W (classes, padded to whole
// words) + 8 K ldw (mask) + 512 W (diagonal columns) + 8 W (valid words) +
// 1024 W (class buckets) + 4 K (areas): 188,544 B at K = 1024; the largest K
// that fits the 232,448 B a block may have is 1152 (ops/nms_kernel.py,
// MAX_CANDIDATES; EvalConfig.pre_nms_top_k is 1024).
//
// What bounds it on an H100: operations, by the count chip_smoke.py's
// nms_kernel phase makes from its data: a class compare for each of the
// B*K*(K-1)/2 pairs (67 M at B = 128, K = 1024) and an IoU test of 14
// float32 operations for each pair of one class (4.2 M with 16 classes):
// 126 M operations, 0.0019 ms at 67 TFLOP/s. The bytes (boxes, classes and
// flags in, keep out) are under 3 MB. That bound does not count the greedy
// scan's dependency chain, word after word per image, which no amount of
// parallel hardware shortens; the design keeps each word's share of it to a
// few ballots, with all images in flight at once on separate SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int NMS_THREADS = 512;
constexpr int NMS_WARPS = NMS_THREADS / 32;
constexpr int BUCKET_BITS = 7;  // 128 class buckets a word
constexpr int BUCKETS = 1 << BUCKET_BITS;

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(fmaxf(__fsub_rn(b.z, b.x), 0.f), fmaxf(__fsub_rn(b.w, b.y), 0.f));
}

// the intersection of two boxes, in the reference's operations
__device__ __forceinline__ float intersection(float4 bj, float4 bi) {
  const float iw = fmaxf(__fsub_rn(fminf(bj.z, bi.z), fmaxf(bj.x, bi.x)), 0.f);
  const float ih = fmaxf(__fsub_rn(fminf(bj.w, bi.w), fmaxf(bj.y, bi.y)), 0.f);
  return __fmul_rn(iw, ih);
}

// iou_matrix(boxes, boxes)[j, i] > thr from the intersection and the areas
__device__ __forceinline__ bool iou_above(float inter, float aj, float ai, float thr) {
  const float uni = __fsub_rn(__fadd_rn(aj, ai), inter);
  const float iou = uni > 0.f ? __fdiv_rn(inter, fmaxf(uni, 1e-9f)) : 0.f;
  return iou > thr;
}

__device__ __forceinline__ int bucket_of(int cls) {
  return (int)(((unsigned)cls * 2654435761u) >> (32 - BUCKET_BITS));
}

struct Smem {
  float4* box;   // [K]
  int* cls;      // [W * 64], padded entries unused
  u64* mask;     // [K][ldw]
  u64* col;      // [W * 64]: the diagonal word blocks, transposed
  u64* vbits;    // [W]
  u64* bucket;   // [W][BUCKETS]
  float* area;   // [K]
};

__host__ __device__ __forceinline__ size_t smem_layout(int K, Smem* s, unsigned char* base) {
  const int W = (K + 63) / 64, ldw = W | 1;
  size_t off = 0;
  if (s) s->box = reinterpret_cast<float4*>(base + off);
  off += (size_t)K * 16;
  if (s) s->cls = reinterpret_cast<int*>(base + off);
  off += (size_t)W * 64 * 4;
  if (s) s->mask = reinterpret_cast<u64*>(base + off);
  off += (size_t)K * ldw * 8;
  if (s) s->col = reinterpret_cast<u64*>(base + off);
  off += (size_t)W * 64 * 8;
  if (s) s->vbits = reinterpret_cast<u64*>(base + off);
  off += (size_t)W * 8;
  if (s) s->bucket = reinterpret_cast<u64*>(base + off);
  off += (size_t)W * BUCKETS * 8;
  if (s) s->area = reinterpret_cast<float*>(base + off);
  off += (size_t)K * 4;
  return off;
}

__global__ void __launch_bounds__(NMS_THREADS, 1)
nms_suppress_kernel(const float4* __restrict__ boxes, const int* __restrict__ classes,
                    const unsigned char* __restrict__ valid, int K, float thr,
                    unsigned char* __restrict__ keep) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem s;
  smem_layout(K, &s, smem);
  const int W = (K + 63) / 64, ldw = W | 1;
  const int b = blockIdx.x, tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  // 1. staging
  for (int i = tid; i < K; i += NMS_THREADS) {
    const float4 bx = boxes[(size_t)b * K + i];
    s.box[i] = bx;
    s.area[i] = box_area(bx);
  }
  for (int i = tid; i < W * 64; i += NMS_THREADS) s.cls[i] = i < K ? classes[(size_t)b * K + i] : 0;
  for (int w = warp; w < W; w += NMS_WARPS) {
    const int i = w * 64 + lane;
    const unsigned lo = __ballot_sync(0xffffffffu, i < K && valid[(size_t)b * K + i]);
    const unsigned hi = __ballot_sync(0xffffffffu, i + 32 < K && valid[(size_t)b * K + i + 32]);
    if (lane == 0) s.vbits[w] = (u64)lo | ((u64)hi << 32);
  }
  for (int i = tid; i < W * BUCKETS; i += NMS_THREADS) s.bucket[i] = 0;
  __syncthreads();
  for (int i = tid; i < K; i += NMS_THREADS)
    atomicOr(&s.bucket[(i / 64) * BUCKETS + bucket_of(s.cls[i])], 1ull << (i % 64));
  __syncthreads();

  // 2. mask words at or right of the diagonal; task f = (32-row group, word)
  //    goes to warp f % NMS_WARPS
  const bool zero_above = 0.f > thr;  // what a pair that does not intersect gives
  const int groups = (K + 31) / 32;
  int f = 0;
  for (int gi = 0; gi < groups; ++gi) {
    const int rb = gi / 2;  // the group's own word
    const int j = gi * 32 + lane;
    for (int w = rb; w < W; ++w, ++f) {
      if (f % NMS_WARPS != warp || j >= K) continue;
      const int base = w * 64;
      const int cj = s.cls[j];
      u64 m = s.bucket[w * BUCKETS + bucket_of(cj)];  // bits i < K only
      if (w == rb) {  // only i > j
        const int jl = j - base;
        m &= jl == 63 ? 0ull : (~0ull << (jl + 1));
      }
      // the pairs of j's class that intersect (or, if 0 > thr, all of them)
      const float4 bj = s.box[j];
      u64 over = 0;
      while (m) {
        const int c = __ffsll((long long)m) - 1;
        m &= m - 1;
        if (s.cls[base + c] == cj && (zero_above || intersection(bj, s.box[base + c]) > 0.f))
          over |= 1ull << c;
      }
      const float aj = s.area[j];
      u64 bits = 0;
      while (over) {
        const int c = __ffsll((long long)over) - 1;
        over &= over - 1;
        if (iou_above(intersection(bj, s.box[base + c]), aj, s.area[base + c], thr))
          bits |= 1ull << c;
      }
      s.mask[(size_t)j * ldw + w] = bits;
    }
  }
  __syncthreads();
  // the diagonal word blocks, transposed: col[64w + l] bit c = mask[64w + c][w] bit l
  for (int w = warp; w < W; w += NMS_WARPS) {
    const int base = w * 64, n = min(64, K - base);
    u64 c0 = 0, c1 = 0;
    for (int c = 0; c < n; ++c) {
      const u64 row = s.mask[(size_t)(base + c) * ldw + w];
      c0 |= ((row >> lane) & 1ull) << c;
      c1 |= ((row >> (lane + 32)) & 1ull) << c;
    }
    s.col[base + lane] = c0;
    s.col[base + lane + 32] = c1;
  }
  __syncthreads();
  if (warp != 0) return;

  // 3. the scan
  u64 removed = 0;  // word `lane` of the removed set
  for (int w = 0; w < W; ++w) {
    const int base = w * 64;
    const int n = min(64, K - base);
    const u64 avail = s.vbits[w] & ~__shfl_sync(0xffffffffu, removed, w);
    const u64 col0 = s.col[base + lane], col1 = s.col[base + lane + 32];
    u64 kept = avail;
    for (;;) {
      const unsigned lo = __ballot_sync(0xffffffffu, (col0 & kept) != 0);
      const unsigned hi = __ballot_sync(0xffffffffu, (col1 & kept) != 0);
      const u64 next = avail & ~((u64)lo | ((u64)hi << 32));
      if (next == kept) break;
      kept = next;
    }
    if (lane > w && lane < W) {
      // the fan-in: 64 independent predicated loads, none waits on another
      const u64* colp = s.mask + (size_t)base * ldw + lane;
      u64 acc = 0;
#pragma unroll 16
      for (int c = 0; c < 64; ++c)
        if ((kept >> c) & 1ull) acc |= colp[(size_t)c * ldw];
      removed |= acc;
    }
    unsigned char* kp = keep + (size_t)b * K + base;
    if (lane < n) kp[lane] = (kept >> lane) & 1ull;
    if (lane + 32 < n) kp[lane + 32] = (kept >> (lane + 32)) & 1ull;
  }
}

}  // namespace

// Shared memory one image needs, in bytes (the layout above).
extern "C" long long nms_suppress_smem_bytes(int K) {
  return (long long)smem_layout(K, nullptr, nullptr);
}

// boxes (B, K, 4) f32, classes (B, K) i32, valid (B, K) u8 -> keep (B, K) u8.
// One launch, one block per image; K is limited by the shared memory a
// block may have (nms_suppress_smem_bytes; K <= 1152 on an H100). Returns
// the cudaError_t.
extern "C" int nms_suppress_launch(const void* boxes, const void* classes,
                                   const void* valid, void* keep,
                                   int B, int K, float thr, void* stream) {
  if (B < 0 || K < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || K == 0) return 0;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_layout(K, nullptr, nullptr);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(nms_suppress_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  nms_suppress_kernel<<<B, NMS_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<const int*>(classes),
      static_cast<const unsigned char*>(valid), K, thr, static_cast<unsigned char*>(keep));
  return (int)cudaGetLastError();
}

extern "C" const char* nms_suppress_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
