// Section counters of a probe build of kernels K1 and K2 (nvcc
// -DTINYMPC_SECTIONS; ops/cuda/layout_probe.py ``sections``): how a tile
// iteration's time splits between the product's k-loop, the waits on its
// slab ring, the product's epilogue, the elementwise step, the residual
// maxima and the rho prediction.  Thread 0 of each block adds the clock64()
// cycles since its last mark to the section that just ended (a mark closes
// a section; the block's barriers make thread 0's clock the block's), and
// at the block's end its sums and its tile iterations go to g_sections.
// Without the flag every macro is empty, so the shipped instances compile
// exactly as before.
#pragma once
#include <cuda_runtime.h>

#ifdef TINYMPC_SECTIONS
namespace tinympc {

enum Section {
  kSecProduct,    // the fp32 product's k-loop: its FMAs, shared loads, issues
  kSecRing,       // its waits on the slab ring (cp.async / mbarrier + barrier)
  kSecProductLo,  // the bf16 product's k-loop (and w's rounding)
  kSecRingLo,     // its waits on the ring
  kSecEpilogue,   // the products' epilogues (stores, K1's parked passes)
  kSecStep,       // the elementwise step: projections, residual and update
                  // passes, and the barrier after them (the lanes'
                  // slowest thread)
  kSecMaxima,     // the residual maxima meeting (K1's with the wait for
                  // every thread's residual pass), the latch and done flags
  kSecMaximaWait,  // K2's: the barrier before the maxima meet, the wait
                   // for every thread's residual pass
  kSecRho,        // K2's rho prediction (the OSQP-form residuals with it)
  kSecBarrier,    // the barrier after each product (its warps' imbalance)
  kSecOther,      // set-up before the loop and the outputs after it
  kSecCount
};

constexpr int kSecBlocks = 4096;  // blocks of a launch that report
// per block: the sections' cycles, then its tile iterations
__device__ unsigned long long g_sections[kSecBlocks][kSecCount + 1];
// thread 0's sums, its last mark and its iterations
__shared__ unsigned long long sec_clock[kSecCount + 2];

__device__ __forceinline__ void sec_begin() {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kSecCount + 2; ++s) sec_clock[s] = 0;
    sec_clock[kSecCount] = clock64();
  }
}

__device__ __forceinline__ void sec_mark(int s) {
  if (threadIdx.x == 0) {
    const unsigned long long now = clock64();
    sec_clock[s] += now - sec_clock[kSecCount];
    sec_clock[kSecCount] = now;
  }
}

__device__ __forceinline__ void sec_iteration() {
  if (threadIdx.x == 0) ++sec_clock[kSecCount + 1];
}

__device__ __forceinline__ void sec_end() {
  sec_mark(kSecOther);
  const int b = blockIdx.x + gridDim.x * blockIdx.y;
  if (threadIdx.x == 0 && b < kSecBlocks) {
    for (int s = 0; s < kSecCount; ++s) g_sections[b][s] = sec_clock[s];
    g_sections[b][kSecCount] = sec_clock[kSecCount + 1];
  }
}

}  // namespace tinympc

// Copies the first ``blocks`` blocks' rows of g_sections (kSecCount + 1
// values each) to ``out`` (host memory) and zeroes them for the next
// launch; returns the section count, or a negative CUDA error.
extern "C" int tinympc_sections(unsigned long long* out, int blocks) {
  using namespace tinympc;
  if (blocks < 0 || blocks > kSecBlocks)
    return -static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = sizeof(unsigned long long) * (kSecCount + 1) * blocks;
  void* dev = nullptr;
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaGetSymbolAddress(&dev, g_sections);
  if (err == cudaSuccess && bytes)
    err = cudaMemcpy(out, dev, bytes, cudaMemcpyDeviceToHost);
  if (err == cudaSuccess) err = cudaMemset(dev, 0, sizeof(g_sections));
  return err == cudaSuccess ? kSecCount : -static_cast<int>(err);
}

#define TINYMPC_SEC(s) ::tinympc::sec_mark(::tinympc::s)
#define TINYMPC_SEC_BEGIN() ::tinympc::sec_begin()
#define TINYMPC_SEC_ITERATION() ::tinympc::sec_iteration()
#define TINYMPC_SEC_END() ::tinympc::sec_end()
#else
#define TINYMPC_SEC(s) ((void)0)
#define TINYMPC_SEC_BEGIN() ((void)0)
#define TINYMPC_SEC_ITERATION() ((void)0)
#define TINYMPC_SEC_END() ((void)0)
#endif
