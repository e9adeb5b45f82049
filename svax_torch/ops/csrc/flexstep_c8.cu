// flexstep's f32 instantiations at a cluster of 8 CTAs (flexstep.cu), compiled
// apart from the others so that the kernel build runs them in parallel;
// flexstep.cu's C entry launches them through flexstep_launch_c8.
#define SVAX_STEP_PART 1
#include "flexstep.cu"
