// The time instances of the RHS kernel (rhs.cu): a time-varying or
// ensemble background, compiled apart from the static instances so that
// the build runs both at once and their code stays the static code.
#define RWRT_RHS_TIME
#include "rhs.cu"
