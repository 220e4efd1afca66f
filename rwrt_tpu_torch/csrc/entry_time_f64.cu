// The float64 and mixed time instances of the entry-stage kernel
// (entry.cu): a time-varying or ensemble background, compiled apart from
// the other instances so that the build runs them at once; relocatable
// device code (the initial step's pow is pow_fmad.cu's).
#define RWRT_ENTRY_TIME_F64
#include "entry.cu"
