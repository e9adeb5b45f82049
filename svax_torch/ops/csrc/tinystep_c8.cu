// tinystep's f32 instantiations at a cluster of 8 CTAs (tinystep.cu), compiled
// apart from the others so that the kernel build runs them in parallel;
// tinystep.cu's C entry launches them through tinystep_launch_c8.
#define SVAX_STEP_PART 1
#include "tinystep.cu"
