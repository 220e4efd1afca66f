// The float32 time instance of the entry-stage kernel (entry.cu): a
// time-varying or ensemble background, compiled apart from the static
// instances so that the build runs them at once and their code stays the
// static code.
#define RWRT_ENTRY_TIME_F32
#include "entry.cu"
