// The mixed-precision time instances of the RK4 kernel (rk4_run.cu): a
// double state over a float time-varying or ensemble background, in a unit
// of their own so that the build runs them beside the others.
#define RWRT_RK4_TIME_MIX
#include "rk4_run.cu"
