// The float64 entry points of the interval kernel (interval.cu), compiled
// apart from the float32 ones so that the build runs both at once, and as
// relocatable device code (the controller calls pow_fmad.cu's pow).
#define RWRT_INTERVAL_F64
#include "interval.cu"
