// The float64 and mixed static instances of the entry-stage kernel
// (entry.cu), compiled apart from the float32 one so that the build runs
// them at once, and as relocatable device code (the initial step's pow is
// pow_fmad.cu's).
#define RWRT_ENTRY_F64
#include "entry.cu"
