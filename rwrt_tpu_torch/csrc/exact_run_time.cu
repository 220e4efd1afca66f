// The time instances of the exact kernels (exact_run.cu: the whole run and the
// single group) in float32: a time-varying or ensemble background, compiled
// apart from the other instances so that the build runs them at once and the
// static code stays as it is.
#define RWRT_EXACT_TIME
#include "exact_run.cu"
