// The time instances of the RK4 kernel (rk4_run.cu) in one type: a
// time-varying or ensemble background, compiled apart from the static
// instances so that the build runs them at once and the static code stays
// as it is.
#define RWRT_RK4_TIME
#include "rk4_run.cu"
