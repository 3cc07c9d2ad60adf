// B12's chirp build (a y or z axis with a prime factor above 7, by
// Bluestein's algorithm; or nz = 1):
// zy_fft_kernel<kChirp> of zy_fft.cuh, in a translation unit of its own
// so that nvcc compiles the three builds at once.

#include "zy_fft.cuh"

void* fava_zy::chirp_kernel() { return reinterpret_cast<void*>(&zy_fft_kernel<kChirp>); }
