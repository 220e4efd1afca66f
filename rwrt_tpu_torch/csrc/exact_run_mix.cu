// The mixed-precision entry points of the exact kernels (exact_run.cu): the
// whole run and the single group with a double state over a float
// background, compiled apart from the one-type ones so that the build runs
// them at once.
#define RWRT_EXACT_MIX
#include "exact_run.cu"
