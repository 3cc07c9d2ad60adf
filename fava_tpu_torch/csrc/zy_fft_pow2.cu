// B12's power-of-two build (every divisor of the plan a power of two):
// zy_fft_kernel<kPow2> of zy_fft.cuh, in a translation unit of its own
// so that nvcc compiles the three builds at once.

#include "zy_fft.cuh"

void* fava_zy::pow2_kernel() { return reinterpret_cast<void*>(&zy_fft_kernel<kPow2>); }
