// A pointer into a table that lives on the host (a std::vector sized from
// the configuration), carried in a struct that kernels take by value. Only
// host code can index or read it: a read in device code does not compile
// (a __host__ function called from __device__ or __global__ code), where a
// raw pointer would fault on the card.
#pragma once

#include <cuda_runtime.h>

namespace {

template <class T>
class HostPtr {
 public:
  HostPtr() = default;
  __host__ HostPtr(T* p) : p_(p) {}
  __host__ T& operator[](long i) const { return p_[i]; }
  __host__ T* get() const { return p_; }

 private:
  T* p_ = nullptr;
};

}  // namespace
