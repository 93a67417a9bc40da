// Host-side pairwise IoU: compute_overlap(boxes N x 4, queries K x 4) -> the
// N x K float64 IoU matrix of xyxy boxes (continuous areas, no +1), for the
// VOC evaluator. A copy of the JAX package's cc/compute_overlap.cc, built
// by efficientdet_tpu_torch/evaluation/host_overlap.py with g++ into the
// package's _build/ directory at first use and loaded with ctypes.

#include <algorithm>
#include <cstdint>

extern "C" {

// boxes: N*4 row-major float64; queries: K*4; out: N*K.
void compute_overlap_f64(const double* boxes, int64_t n,
                         const double* queries, int64_t k, double* out) {
  for (int64_t j = 0; j < k; ++j) {
    const double qx1 = queries[j * 4 + 0];
    const double qy1 = queries[j * 4 + 1];
    const double qx2 = queries[j * 4 + 2];
    const double qy2 = queries[j * 4 + 3];
    const double q_area = std::max(0.0, qx2 - qx1) * std::max(0.0, qy2 - qy1);
    for (int64_t i = 0; i < n; ++i) {
      const double bx1 = boxes[i * 4 + 0];
      const double by1 = boxes[i * 4 + 1];
      const double bx2 = boxes[i * 4 + 2];
      const double by2 = boxes[i * 4 + 3];
      const double iw = std::min(bx2, qx2) - std::max(bx1, qx1);
      double iou = 0.0;
      if (iw > 0) {
        const double ih = std::min(by2, qy2) - std::max(by1, qy1);
        if (ih > 0) {
          const double b_area =
              std::max(0.0, bx2 - bx1) * std::max(0.0, by2 - by1);
          const double ua = b_area + q_area - iw * ih;
          if (ua > 0) iou = iw * ih / ua;
        }
      }
      out[i * k + j] = iou;
    }
  }
}

}  // extern "C"
