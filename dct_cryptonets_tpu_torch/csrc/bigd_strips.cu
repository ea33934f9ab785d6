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
// 2N).  Design: a block takes one input row g and a band of kBand strip
// rows, grid (G, 128 / kBand), so no thread divides.  It stages the row
// once in shared memory, rotated (and, for k_major, reversed) so that every
// strip row is a contiguous window of it:
//   s[i] = dbl[g, (i + N + 1) mod 2N]      (k_major: (-(i + N + 1)) mod 2N)
//   strip[g, tt, x] = s[x + 127 - tt].
// Each warp takes whole strip rows; each lane writes 16 output bytes with
// one 16-byte store (a warp writes 512 contiguous bytes), cut out of the
// two aligned 16-byte shared words that cover its window with
// __funnelshift_r.  The window's byte offset (127 - tt) mod 16 is the same
// for the whole warp, so the word select does not diverge.  Stores are the
// default write-back ones: fused_external.cu reads the table right after,
// and a CMUX step's table (32.5 MB at N=2048, k=1) fits in the 50 MB L2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBand = 16;   // strip rows per block, 2 per warp

// The 16 bytes at byte offset o (0..15) of the 32 bytes lo:hi.
__device__ __forceinline__ uint4 window16(uint4 lo, uint4 hi, int o) {
  uint32_t w0, w1, w2, w3, w4;
  switch (o >> 2) {
    case 0: w0 = lo.x; w1 = lo.y; w2 = lo.z; w3 = lo.w; w4 = hi.x; break;
    case 1: w0 = lo.y; w1 = lo.z; w2 = lo.w; w3 = hi.x; w4 = hi.y; break;
    case 2: w0 = lo.z; w1 = lo.w; w2 = hi.x; w3 = hi.y; w4 = hi.z; break;
    default: w0 = lo.w; w1 = hi.x; w2 = hi.y; w3 = hi.z; w4 = hi.w; break;
  }
  const int sh = (o & 3) * 8;
  return make_uint4(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh),
                    __funnelshift_r(w2, w3, sh), __funnelshift_r(w3, w4, sh));
}

__global__ void __launch_bounds__(kThreads)
    bigd_strips_kernel(const signed char* __restrict__ dbl,
                       signed char* __restrict__ out, int N, int k_major) {
  extern __shared__ __align__(16) unsigned char s[];       // 2N bytes
  const int twoN = 2 * N, W = twoN - 128;
  const long long g = blockIdx.x;
  const uint4* src = (const uint4*)(dbl + g * twoN);
  // raw byte q of the row goes to s[i] with q = (+-(i + N + 1)) mod 2N
  for (int c = threadIdx.x; c < twoN / 16; c += blockDim.x) {
    const uint4 v = src[c];
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      const int q = 16 * c + b;
      const int i = (k_major ? -q - N - 1 : q - N - 1) & (twoN - 1);
      s[i] = (unsigned char)(w[b >> 2] >> (8 * (b & 3)));
    }
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int tt = blockIdx.y * kBand + warp; tt < (blockIdx.y + 1) * kBand;
       tt += kThreads / 32) {
    const int o = (127 - tt) & 15;
    signed char* dst = out + (g * 128 + tt) * W;
    for (int x = 16 * lane; x < W; x += 16 * 32) {
      const unsigned char* win = s + x + 127 - tt - o;      // 16-aligned
      const uint4 v = window16(*(const uint4*)win, *(const uint4*)(win + 16),
                               o);
      *(uint4*)(dst + x) = v;
    }
  }
}

}  // namespace

extern "C" int dctc_bigd_strips(const void* dbl, void* out, int G, int N,
                                int k_major, void* stream) {
  const size_t smem = 2 * (size_t)N;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        bigd_strips_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  bigd_strips_kernel<<<dim3((unsigned)G, 128 / kBand), kThreads, smem,
                       (cudaStream_t)stream>>>(
      (const signed char*)dbl, (signed char*)out, N, k_major);
  return (int)cudaGetLastError();
}
