// The time instances of the whole-run exact kernel (exact_run.cu) in float32:
// a time-varying or ensemble background, compiled apart from the other
// instances so that the build runs them at once and the static code stays as
// it is.
#define RWRT_EXACT_TIME
#include "exact_run.cu"
