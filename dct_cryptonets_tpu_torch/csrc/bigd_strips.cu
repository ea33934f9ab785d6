// Toeplitz strip table for the external product.
//
// Replaces the TPU kernel dct_cryptonets_tpu/fhe/pallas_kernels.py
// build_bigd_strips / _bigd_kernel:
//
//   strip[g, tt, x] = dbl[g, (x - tt + N + 128) mod 2N]
//   for tt < 128, x < 2N - 128,
//
// from the doubled negacyclic BSK byte rows dbl (G, 2N) int8.  Every
// (N, N) negacyclic Toeplitz tile the external product needs is a column
// slice of one strip.  With k_major the kernel reads index (-i) mod 2N for
// i: the same function on the reversed row, whose strips hold the Toeplitz
// tiles transposed (contraction index along a row), the layout of
// fused_external.cu's B operand.
//
// Bound on the card: memory (it writes 128*(2N-128) bytes per row, reads
// 2N).  Design: one thread per 4 output bytes, the gather as index
// arithmetic with a power-of-two mask (the TPU kernel packs four byte rows
// into an i32 lane to roll them, since its rolls need 32-bit data), one
// 4-byte store per thread so a warp writes 128 contiguous bytes.
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void bigd_strips_kernel(const signed char* __restrict__ dbl,
                                   signed char* __restrict__ out, int G,
                                   int N, int k_major) {
  int W = 2 * N - 128;
  int W4 = W >> 2;
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = (long long)G * 128 * W4;
  if (idx >= total) return;
  int x = (int)(idx % W4) * 4;
  long long rest = idx / W4;
  int tt = (int)(rest & 127);
  long long g = rest >> 7;
  const unsigned char* row = (const unsigned char*)dbl + g * 2 * N;
  int base = x - tt + N + 128;
  int wrap = 2 * N - 1;
  int sign = k_major ? -1 : 1;
  uint32_t packed = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    packed |= (uint32_t)row[(sign * (base + q)) & wrap] << (8 * q);
  *(uint32_t*)(out + (g * 128 + tt) * W + x) = packed;
}

extern "C" int dctc_bigd_strips(const void* dbl, void* out, int G, int N,
                                int k_major, void* stream) {
  long long total = (long long)G * 128 * ((2 * N - 128) / 4);
  int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  bigd_strips_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const signed char*)dbl, (signed char*)out, G, N, k_major);
  return (int)cudaGetLastError();
}
