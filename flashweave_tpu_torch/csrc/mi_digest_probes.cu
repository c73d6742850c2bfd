// One float64 call of csrc/mi_digest.cuh's log p chain and of
// csrc/mi_cond_epilogue.cuh's G-test a kernel: exp, log, log1p, erfc and
// sqrt, each on one element a thread.
// Nothing launches them.  They replace no TPU kernel: chip_smoke.py counts
// the float64 instructions of each in the built library's SASS
// (cuobjdump -sass) on the path a typical argument takes, the cost of one
// call with libdevice inlined as K5-K7 compile it, and the operation
// bounds of K6's log p chains and of K7's G-tests and chains rest on those
// counts.

#include <cuda_runtime.h>
#include <math.h>

#define FW_PROBE(name, expr)                                               \
  extern "C" __global__ void fw_probe_##name##_kernel(const double* x,    \
                                                      double* y) {        \
    const double v = x[threadIdx.x];                                       \
    y[threadIdx.x] = (expr);                                               \
  }

FW_PROBE(exp, exp(v))
FW_PROBE(log, log(v))
FW_PROBE(log1p, log1p(v))
FW_PROBE(erfc, erfc(v))
FW_PROBE(sqrt, sqrt(v))
