// The float64 pow of the step controller (dp45.cuh step_factors), compiled
// alone WITH FMA contraction (kernels/build.py CONTRACTED) and linked as
// relocatable device code into every kernel that calls it (the float64
// and mixed units, kernels/build.py RELOCATABLE).
//
// Why: PyTorch's CUDA pow on a float64 tensor (error_norm ** -0.2 in the
// plain versions) is libdevice's pow built with nvcc's default
// contraction. Built with -fmad=false, as every other unit here must be,
// libdevice's pow rounds differently on about one argument in a million
// (16 of 16,777,216 on an H100 with nvcc 12.9, pow_parity.py; none with
// contraction), and
// one such step factor moves a lane's step size by an ulp, which the
// controller amplifies. The float32 powf, sin, cos, tan, atan2 and fmod
// agree either way, so they stay inline.
#include <cuda_runtime.h>

namespace rwrt {
namespace dp45 {

__device__ __noinline__ double pow_fmad(double x, double y) {
  return pow(x, y);
}

}  // namespace dp45
}  // namespace rwrt
