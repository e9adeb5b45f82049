// The CUDA runtime's message for an error code that a C entry returned
// (svax_torch/ops/_build.py: check). A source of its own, so that a library
// built from a few of the sources (measure_phases.py) carries it too.

#include <cuda_runtime.h>

extern "C" const char* svax_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
