// A check, not a port: csrc/mi_digest.cuh's exp and log main paths
// (fw_digest::core, which K6 and K7 run in each logsumexp step) against
// libdevice's exp() and log() on the card, bit for bit.  It replaces no
// TPU kernel; chip_smoke.py launches it in phase 1, on inputs drawn from a
// seed: exp on x below 0 down to -708.39 (a step's range) and on random
// bit patterns of either sign inside the main path, log on [1, 2] (a step's
// range) and on random normal positive numbers.  What bounds it: the
// float64 calls, some 150 operations an input; it runs once.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mi_digest.cuh"

namespace {

__device__ __forceinline__ uint64_t mix(uint64_t z) {      // splitmix64
  z += 0x9e3779b97f4a7c15ull;
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
  return z ^ (z >> 31);
}

__device__ __forceinline__ double unit(uint64_t r) {       // [0, 1)
  return (double)(r >> 11) * 0x1p-53;
}

// counts[0..3]: exp inputs, exp mismatches, log inputs, log mismatches
__global__ void __launch_bounds__(256)
fw_digest_core_check_kernel(long long n, unsigned long long seed,
                            unsigned long long* counts) {
  unsigned long long ne = 0, be = 0, nl = 0, bl = 0;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const uint64_t r = mix(seed ^ mix((uint64_t)i));
    const uint64_t r2 = mix(r);
    const uint64_t mant = r & 0xfffffffffffffull;
    // |x| below 2^10, zeros and subnormals among them
    const uint64_t xe = (r2 >> 52) % 0x409;
    double x = (i & 1) ? -unit(r) * 708.5
                       : __longlong_as_double((long long)(
                             (r2 & 0x8000000000000000ull) | (xe << 52) | mant));
    const uint64_t se = 1 + (r2 >> 53) % 2046;            // a normal exponent
    double s = (i & 2) ? 1.0 + unit(r2) * ((i & 4) ? 1.0 : 0x1p-30)
                       : __longlong_as_double((long long)((se << 52) | mant));
    if (i < 8) {                                // the ends of a step's ranges
      const double xs[8] = {0.0, -0.0, -708.39, -1e-300, -0x1p-1074, -1.0,
                            -0x1p-53, -745.0};
      const double ss[8] = {1.0, 2.0, 0x1.fffffffffffffp+0,
                            0x1.0000000000001p+0, 1.5, 0x1.6a09ep+0,
                            0x1.6a09fp+0, 1.25};
      x = xs[i];
      s = ss[i];
    }
    if (fw_digest::core::exp_main_takes(x)) {
      ++ne;
      be += __double_as_longlong(fw_digest::core::exp_main(x)) !=
            __double_as_longlong(exp(x));
    }
    ++nl;
    bl += __double_as_longlong(fw_digest::core::log_main(s)) !=
          __double_as_longlong(log(s));
  }
  atomicAdd(counts + 0, ne);
  atomicAdd(counts + 1, be);
  atomicAdd(counts + 2, nl);
  atomicAdd(counts + 3, bl);
}

}  // namespace

extern "C" {

// Launches the check over n inputs on `stream`; counts: 4 uint64, zeroed
// by the caller.  Returns the cudaError_t of the launch.
int fw_digest_core_check(long long n, unsigned long long seed, void* counts,
                         void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  fw_digest_core_check_kernel<<<1056, 256, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      n, seed, static_cast<unsigned long long*>(counts));
  return (int)cudaGetLastError();
}

}  // extern "C"
