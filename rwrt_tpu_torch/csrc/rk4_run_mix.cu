// The mixed-precision entry points of the RK4 kernel (rk4_run.cu): a
// double state over a float background, compiled apart from the one-type
// ones so that the build runs both at once.
#define RWRT_RK4_MIX
#include "rk4_run.cu"
