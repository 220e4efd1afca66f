// The mixed-precision entry point of the dense kernel (dense_run.cu): the
// whole run with a double state over a float background, compiled apart
// from the one-type ones so that the build runs both at once.
#define RWRT_DENSE_MIX
#include "dense_run.cu"
