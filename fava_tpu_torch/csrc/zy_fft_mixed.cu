// B12's mixed-radix build (y and z 7-smooth, not both powers of two):
// zy_fft_kernel<kMixed> of zy_fft.cuh, in a translation unit of its own
// so that nvcc compiles the three builds at once.

#include "zy_fft.cuh"

void* fava_zy::mixed_kernel() { return reinterpret_cast<void*>(&zy_fft_kernel<kMixed>); }
