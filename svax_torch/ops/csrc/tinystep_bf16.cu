// tinystep's bf16-product instantiations (tinystep.cu: kBf16 = true at C = 16, the
// reference's nn_precision DEFAULT), compiled apart from the f32 ones so
// that the kernel build runs them in parallel; tinystep.cu's C entry launches
// them through tinystep_launch_bf16.
#define SVAX_STEP_PART 2
#include "tinystep.cu"
