// The float64 entry points of the dense kernel (dense_run.cu), compiled
// apart from the float32 ones so that the build runs both at once.
#define RWRT_DENSE_F64
#include "dense_run.cu"
