// The float64 and mixed time instances of the entry-stage kernel
// (entry.cu): a time-varying or ensemble background, compiled apart from
// the other instances so that the build runs them at once.
#define RWRT_ENTRY_TIME_F64
#include "entry.cu"
