// The mixed-precision entry points of the dense kernel (dense_run.cu): the
// whole run and the single group with a double state over a float
// background, compiled apart from the one-type ones so that the build runs
// both at once.
#define RWRT_DENSE_MIX
#include "dense_run.cu"
