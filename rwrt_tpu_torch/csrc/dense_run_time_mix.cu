// The time instances of the dense kernels (dense_run.cu: the whole run and the
// single group) in mixed precision: a time-varying or ensemble background,
// compiled apart from the other instances so that the build runs them at once
// and the static code stays as it is.
#define RWRT_DENSE_TIME_MIX
#include "dense_run.cu"
