// Error text for the codes the entry points of this library return.
#include <cuda_runtime.h>

extern "C" const char* kpop_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
