// The float64 and mixed static instances of the entry-stage kernel
// (entry.cu), compiled apart from the float32 one so that the build runs
// them at once.
#define RWRT_ENTRY_F64
#include "entry.cu"
