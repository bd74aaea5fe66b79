// The emulation's globals: thread and block indices, the block's
// barrier, the launch error, the cp.async mode and groups, and shared
// memory (the extern __shared__ arrays of the kernels, 227 KB each).
#include <cuda_runtime.h>
#include <mma_tiles.cuh>

thread_local dim3 threadIdx;
dim3 blockIdx;
std::barrier<>* emu_barrier;
int emu_error;
extern "C" int emu_defer = 0;
thread_local std::vector<mma::Copy> mma::open_group;
thread_local std::deque<std::vector<mma::Copy>> mma::groups;
alignas(16) float smem_f32[kEmuSharedBytes / sizeof(float)];
alignas(16) unsigned char smem_raw[kEmuSharedBytes];
