// flexstep's bf16-product instantiations (flexstep.cu: kBf16 = true at C = 16, the
// reference's nn_precision DEFAULT), compiled apart from the f32 ones so
// that the kernel build runs them in parallel; flexstep.cu's C entry launches
// them through flexstep_launch_bf16.
#define SVAX_STEP_PART 2
#include "flexstep.cu"
