// The float64 entry points of the interval kernel (interval.cu), compiled
// apart from the float32 ones so that the build runs both at once.
#define RWRT_INTERVAL_F64
#include "interval.cu"
