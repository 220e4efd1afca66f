// The float64 entry points of the exact kernels (exact_run.cu), compiled
// apart from the float32 ones so that the build runs both at once.
#define RWRT_EXACT_F64
#include "exact_run.cu"
