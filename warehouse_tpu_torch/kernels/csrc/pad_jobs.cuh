// Zero-padded weight copies, for nets of any depth. A net's per-layer
// tables live on the host (std::vector, sized from the configuration), and
// the structs that the kernels take by value only point into them; so a
// prep kernel takes the layers' copies as PadJobs, at most MAXJ a launch,
// each over K policy groups, and a net deeper than one launch holds runs
// the rest through pad_jobs_kernel. Nets of up to 4 layers fit one launch:
// their prep is the one kernel it was.
#pragma once

#include <cuda_runtime.h>

#include <vector>

#include "host_ptr.cuh"

namespace {

constexpr int MAXJ = 8;  // weight copies of one launch

// dst [rows, cols] = W [out, in] (or, with tr, W^T), zeros past it.
__device__ void pad_copy(float* dst, int rows, int cols, const float* W,
                         int out, int in, bool tr, long i0, long stride) {
  for (long i = i0; i < (long)rows * cols; i += stride) {
    const int r = (int)(i / cols), c = (int)(i % cols);
    const int o = tr ? c : r, k = tr ? r : c;
    dst[i] = o < out && k < in ? W[(long)o * in + k] : 0.f;
  }
}

// One copy: group g's [rows, cols] at dst + g dst_g from its [out, in]
// matrix at W + g w_g (transposed with tr).
struct PadJob {
  float* dst;
  long dst_g;
  const float* W;
  long w_g;
  int rows, cols, out, in, tr;
};

struct PadJobs {
  int n, K;  // copies, groups
  PadJob j[MAXJ];
};

__device__ void run_pad_jobs(const PadJobs& pj, long i0, long stride) {
  for (int g = 0; g < pj.K; ++g)
    for (int x = 0; x < pj.n; ++x) {
      const PadJob& c = pj.j[x];
      pad_copy(c.dst + g * c.dst_g, c.rows, c.cols, c.W + g * c.w_g, c.out,
               c.in, c.tr != 0, i0, stride);
    }
}

__global__ void pad_jobs_kernel(PadJobs pj) {
  run_pad_jobs(pj, (long)blockIdx.x * blockDim.x + threadIdx.x,
               (long)gridDim.x * blockDim.x);
}

// A net's copies, in launches of MAXJ: batch(0) goes to the caller's prep
// kernel, launch_rest runs the others.
struct PadPlan {
  std::vector<PadJob> jobs;
  int K = 1;

  void add(float* dst, long dst_g, const float* W, long w_g, int rows,
           int cols, int out, int in, bool tr) {
    jobs.push_back(PadJob{dst, dst_g, W, w_g, rows, cols, out, in, tr});
  }
  int batches() const { return (int)((jobs.size() + MAXJ - 1) / MAXJ); }
  PadJobs batch(int b) const {
    PadJobs pj = {};
    pj.K = K;
    for (size_t i = (size_t)b * MAXJ; i < jobs.size() && pj.n < MAXJ; ++i)
      pj.j[pj.n++] = jobs[i];
    return pj;
  }
  // The batches past the first; *launched gets those launched added.
  cudaError_t launch_rest(int grid, int threads, cudaStream_t stream,
                          long* launched = nullptr) const {
    for (int b = 1; b < batches(); ++b) {
      pad_jobs_kernel<<<grid, threads, 0, stream>>>(batch(b));
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return e;
      if (launched) ++*launched;
    }
    return cudaSuccess;
  }
};

}  // namespace
