// CMUX back half: the external product and its 64-bit accumulate.
//
// Replaces the TPU kernel dct_cryptonets_tpu/fhe/pallas_kernels.py
// fused_external / _fused_ext_kernel:
//
//   out[j] = acc[j] + sum_{u, vi, r} dB_u[r] x Toeplitz(strip[j, vi*rows+r])
//                                     << 8 * (u + vi + drop)      (mod 2^64)
//
// over digit bytes u in {0, 1}, kept key limbs vi < L = 8 - drop and GGSW
// rows r, skipping byte scales u+vi+drop >= 8 (they wrap out of 2^64) and
// pairs with u+vi < cross.  The strip table is K-major (K2 with k_major):
// strip[g, xx, c] holds the Toeplitz entry of output column 128 x0 + xx at
// contraction index k = c - (N - 128(x0+1)), so the B tile of output block
// x0 at contraction offset k0 is the box strip[g, :, N - 128(x0+1) + k0 ...].
//
// Bound on the card: int8 tensor-core throughput, 2 J pairs rows M N^2
// operations (pairs = 15 at drop 0): 2.06e12 at the main lattice (J=2,
// N=2048, rows=4, M=2048), 1.04 ms at the int8 dense peak of 1,979 TOPS.
// Design (sm_90a):
//  * wgmma.mma_async m64n128k32 s8*s8->s32 with both operands K-major in
//    shared memory, the only 8-bit layout wgmma takes.  A block owns a
//    BM x 256 output tile of one output polynomial j (BM = 128, or 64 where
//    that leaves fewer SMs idle in the last wave) and walks the whole
//    contraction itself (nothing carries across blocks on the GPU, unlike
//    the TPU grid's sequential combo axis).  Consumer warpgroup h owns the
//    tile's column block X+h (128 columns) and all BM rows;
//  * the card is bound here by the bytes that reach shared memory, so the
//    Toeplitz structure is used to load fewer: block X+1's B box at stage
//    t is block X's at stage t-1.  Each stage brings the A tile and ONE
//    128 x 128 B box (box t); warpgroup 0 multiplies box t, warpgroup 1 the
//    previous stage's box t-1, and each (pair, row) segment starts with a
//    step that brings only box -1.  A stage is 32 KB at BM=128 where two
//    boxes would be 48 KB;
//  * TMA loads with 128-byte swizzle: one producer thread fills a ring of
//    stages (128 contraction bytes each: the A tile from dB_u viewed as a
//    (rows, M, N) tensor, whose out-of-range rows TMA fills with zeros, and
//    the box from the strip table viewed as (J*C*128, 2N-128)); full/empty
//    mbarriers hand the stages between the producer and the two consumer
//    warpgroups, which keep one stage of wgmma in flight and release a
//    stage only once no wgmma reads it (warpgroup 1 one stage later);
//  * the contraction is ordered by byte scale s, so one int32 accumulator
//    per output element suffices: once scale s is complete its low byte is
//    final (higher scales never touch the bits below 8s), so after
//    wgmma.wait_group 0 the byte goes straight to byte s of the output word
//    and the accumulator keeps only the carry (acc >> 8); a wgmma.fence
//    follows before the next wgmma reads the rewritten registers.  No 64-bit
//    value lives in registers; the epilogue adds the assembled 8 bytes to
//    acc mod 2^64.
// Per-scale bucket bound: |bucket| <= 2 * rows * N * 128 * 128 < 2^31 up to
// N = 8192, so the int32 accumulator cannot overflow.
#include <cuda.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace {

constexpr int BK = 128;             // contraction bytes per stage
constexpr int BOX_BYTES = 128 * BK;  // one B box: 128 output columns
constexpr int RING_BYTES = 192 * 1024;
constexpr int THREADS = 384;        // consumer warpgroups 0, 1; producer 2
constexpr int CONSUMER_WARPS = 8;
constexpr int MAX_STAGES = 8;

// MW m64 row slices per consumer warpgroup: a BM = 64 MW row tile
template <int MW>
struct Tile {
  static constexpr int BM = 64 * MW;
  static constexpr int A_BYTES = BM * BK;
  static constexpr int STAGE_BYTES = A_BYTES + BOX_BYTES;
  static constexpr int STAGES = RING_BYTES / STAGE_BYTES;  // 6 or 8
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + align
  static_assert(STAGES <= MAX_STAGES, "ring deeper than its barriers");
};

struct Params {
  const long long* acc;
  long long* out;
  int J, M, N, rows, L, drop, cross;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Wait for the phase of the given parity to complete.  A wait that lasts
// ~2^28 polls (seconds) can only be a wrong phase: trap instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t a = smem_u32(bar);
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 28)) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"((uint64_t)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma operand descriptor of a K-major tile written by TMA with 128-byte
// swizzle: rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), the
// leading offset unused for this layout, layout type 1 (128B swizzle).
// Advancing the start address by 32 bytes steps one k32 slice along K.
__device__ __forceinline__ uint64_t smem_desc(const void* tile) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin the accumulators at this point of the instruction stream, so the
// compiler moves no read or write of them across a wgmma fence or wait.
template <int NR>
__device__ __forceinline__ void fence_regs(int* d) {
#pragma unroll
  for (int i = 0; i < NR; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define D8(i)                                                          \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),          \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d += A (64 x 32, K-major) x B (32 x 128, K-major)
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29,"
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43,"
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57,"
      "%58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
      : "l"(da), "l"(db), "r"(1));
}

#undef D8

}  // namespace

template <int MW>
__global__ void __launch_bounds__(THREADS, 1)
fused_external_kernel(const __grid_constant__ CUtensorMap map_a0,
                      const __grid_constant__ CUtensorMap map_a1,
                      const __grid_constant__ CUtensorMap map_b, Params p) {
  using TL = Tile<MW>;
  constexpr int NR = 64 * MW;   // accumulators per consumer thread
  extern __shared__ unsigned char smem_raw[];
  __shared__ uint64_t full[MAX_STAGES], empty[MAX_STAGES];
  __shared__ signed char pair_u[16], pair_vi[16], pair_s[16];
  __shared__ int n_pairs;
  // TMA's 128-byte swizzle repeats every 1024 bytes: align the ring to it
  unsigned char* ring = (unsigned char*)(((uintptr_t)smem_raw + 1023) &
                                         ~(uintptr_t)1023);

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * TL::BM;
  const int X = 2 * blockIdx.y;           // column blocks X, X+1
  const int j = blockIdx.z;
  const int N = p.N, M = p.M, rows = p.rows;
  const int C = p.L * rows;
  const int col0 = N - 128 * (X + 1);     // strip column of box 0

  if (tid == 0) {
    int n = 0;
    for (int s = p.drop; s < 8; ++s)
      for (int u = 0; u < 2; ++u) {
        int vi = s - p.drop - u;
        if (vi < 0 || vi >= p.L || u + vi < p.cross) continue;
        pair_u[n] = (signed char)u;
        pair_vi[n] = (signed char)vi;
        pair_s[n] = (signed char)s;
        ++n;
      }
    n_pairs = n;
    for (int s = 0; s < TL::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // each (pair, row) segment: step -1 (box -1 only), then stages 0..sps-1
  const int sps = N / BK;

  if (warp >= CONSUMER_WARPS) {
    // ---- producer warpgroup: one thread issues every TMA load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == CONSUMER_WARPS && lane == 0) {
      int slot = 0, phase = 0;
      for (int pr = 0; pr < n_pairs; ++pr) {
        const CUtensorMap* map_a = pair_u[pr] ? &map_a1 : &map_a0;
        for (int r = 0; r < rows; ++r) {
          const int brow = (j * C + pair_vi[pr] * rows + r) * 128;
          for (int t = -1; t < sps; ++t) {
            mbar_wait(&empty[slot], phase ^ 1);
            unsigned char* st = ring + slot * TL::STAGE_BYTES;
            mbar_expect_tx(&full[slot], t < 0 ? BOX_BYTES : TL::STAGE_BYTES);
            if (t >= 0) tma_load_3d(st, map_a, &full[slot], t * BK, m0, r);
            tma_load_2d(st + TL::A_BYTES, &map_b, &full[slot], col0 + t * BK,
                        brow);
            if (++slot == TL::STAGES) {
              slot = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroup h: column block X+h, all BM rows
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int h = warp >> 2;
    int d[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) d[i] = 0;

    // accumulator i = 64 mw + c of this thread: row
    // mrow + 64 mw + 8 ((c >> 1) & 1), column xcol + 8 (c >> 2) + (c & 1)
    const int mrow = m0 + 16 * (warp & 3) + (lane >> 2);
    const int xcol = (X + h) * 128 + 2 * (lane & 3);
    unsigned char* out8 = (unsigned char*)p.out;

    // finish byte scale b: its low byte is final (byte b of the output
    // word); keep the carry
    auto flush = [&](int b) {
#pragma unroll
      for (int i = 0; i < NR; i += 2) {
        const int m = mrow + 64 * (i >> 6) + 8 * ((i >> 1) & 1);
        const long long e =
            ((long long)j * M + m) * N + xcol + 8 * ((i & 63) >> 2);
        if (m < M) {
          out8[8 * e + b] = (unsigned char)d[i];
          out8[8 * e + 8 + b] = (unsigned char)d[i + 1];
        }
        d[i] >>= 8;
        d[i + 1] >>= 8;
      }
    };

    int next_flush = n_pairs > 0 ? pair_s[0] : 8;
    for (int b = 0; b < next_flush; ++b) flush(b);

    // stage slots this warp releases once the wgmma group in flight is done
    int owed0 = -1, owed1 = -1;
    auto release = [&](int s0, int s1) {
      if (lane == 0) {
        if (s0 >= 0) mbar_arrive(&empty[s0]);
        if (s1 >= 0) mbar_arrive(&empty[s1]);
      }
    };
    int slot = 0, phase = 0, prev = 0;
    for (int pr = 0; pr < n_pairs; ++pr)
      for (int r = 0; r < rows; ++r)
        for (int t = -1; t < sps; ++t) {
          mbar_wait(&full[slot], phase);
          if (t < 0) {
            // box -1: warpgroup 0 never reads it, warpgroup 1 after stage 0
            if (h == 0) release(slot, -1);
          } else {
            // what this stage reads: A of this slot; box t (this slot) or
            // box t-1 (the previous step's slot)
            const int bslot = h == 0 ? slot : prev;
            const uint64_t da = smem_desc(ring + slot * TL::STAGE_BYTES);
            const uint64_t db =
                smem_desc(ring + bslot * TL::STAGE_BYTES + TL::A_BYTES);
            fence_regs<NR>(d);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < BK / 32; ++kk)
#pragma unroll
              for (int mw = 0; mw < MW; ++mw)
                wgmma_s8(d + 64 * mw, da + 512 * mw + 2 * kk, db + 2 * kk);
            wgmma_commit();
            // slots this stage frees: warpgroup 0 its own; warpgroup 1 the
            // previous one, and its own at the segment's end
            const int free0 = bslot;
            const int free1 = (h == 1 && t == sps - 1) ? slot : -1;
            const bool scale_end =
                t == sps - 1 && r == rows - 1 &&
                (pr + 1 == n_pairs || pair_s[pr + 1] != pair_s[pr]);
            if (scale_end) {
              wgmma_wait<0>();
              fence_regs<NR>(d);
              release(owed0, owed1);
              release(free0, free1);
              owed0 = owed1 = -1;
              const int s_next = pr + 1 < n_pairs ? pair_s[pr + 1] : 8;
              for (int b = next_flush; b < s_next; ++b) flush(b);
              next_flush = s_next;
            } else {
              wgmma_wait<1>();         // the previous stage's wgmma is done
              fence_regs<NR>(d);
              release(owed0, owed1);
              owed0 = free0;
              owed1 = free1;
            }
          }
          prev = slot;
          if (++slot == TL::STAGES) {
            slot = 0;
            phase ^= 1;
          }
        }
    wgmma_wait<0>();   // (the last stage already waited; says so to ptxas)

    // epilogue: out = acc + (the 8 assembled bytes)  (mod 2^64)
#pragma unroll
    for (int i = 0; i < NR; i += 2) {
      const int m = mrow + 64 * (i >> 6) + 8 * ((i >> 1) & 1);
      if (m >= M) continue;
      const long long e =
          ((long long)j * M + m) * N + xcol + 8 * ((i & 63) >> 2);
      longlong2 in = *(const longlong2*)(p.acc + e);
      longlong2 v = *(const longlong2*)(p.out + e);
      longlong2 o;
      o.x = (long long)((uint64_t)in.x + (uint64_t)v.x);
      o.y = (long long)((uint64_t)in.y + (uint64_t)v.y);
      *(longlong2*)(p.out + e) = o;
    }
  }
}

namespace {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver library the process already uses
// (the CUDA runtime links no driver API).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (lib) fn = (EncodeTiled)dlsym(lib, "cuTensorMapEncodeTiled");
  }
  return fn;
}

// A uint8 tensor map with 128-byte swizzle and 128-byte-wide boxes.
bool make_map(CUtensorMap* map, const void* base, int rank,
              const cuuint64_t* dims, const cuuint64_t* strides,
              const cuuint32_t* box) {
  EncodeTiled enc = encode_tiled();
  if (!enc) return false;
  const cuuint32_t ones[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, (void*)base, dims,
             strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MW>
int launch(const CUtensorMap& a0, const CUtensorMap& a1, const CUtensorMap& b,
           const Params& p, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_external_kernel<MW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Tile<MW>::SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((p.M + Tile<MW>::BM - 1) / Tile<MW>::BM, p.N / 256, p.J);
  fused_external_kernel<MW>
      <<<grid, THREADS, Tile<MW>::SMEM_BYTES, stream>>>(a0, a1, b, p);
  return (int)cudaGetLastError();
}

int sm_count() {
  static int n = 0;
  if (!n) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

}  // namespace

extern "C" int dctc_fused_external(const void* dB0, const void* dB1,
                                   const void* bigd, const void* acc,
                                   void* out, int J, int M, int N, int rows,
                                   int L, int drop, int cross, void* stream) {
  // the row tile that leaves the fewest SMs idle: waves x rows, 128 on a tie
  const int sms = sm_count();
  const long long blocks = (long long)(N / 256) * J;
  const long long w128 = ((M + 127) / 128 * blocks + sms - 1) / sms * 128;
  const long long w64 = ((M + 63) / 64 * blocks + sms - 1) / sms * 64;
  const int mw = w128 <= w64 ? 2 : 1;
  // dB_u as (rows, M, N): box 128 bytes x BM samples x 1 row
  const cuuint64_t a_dims[3] = {(cuuint64_t)N, (cuuint64_t)M,
                                (cuuint64_t)rows};
  const cuuint64_t a_strides[2] = {(cuuint64_t)N, (cuuint64_t)M * N};
  const cuuint32_t a_box[3] = {BK, (cuuint32_t)(64 * mw), 1};
  // the strip table as (J*C*128, 2N-128): box 128 bytes x 128 columns
  const cuuint64_t b_dims[2] = {(cuuint64_t)(2 * N - 128),
                                (cuuint64_t)J * L * rows * 128};
  const cuuint64_t b_strides[1] = {(cuuint64_t)(2 * N - 128)};
  const cuuint32_t b_box[2] = {BK, 128};
  CUtensorMap a0, a1, b;
  if (!make_map(&a0, dB0, 3, a_dims, a_strides, a_box) ||
      !make_map(&a1, dB1, 3, a_dims, a_strides, a_box) ||
      !make_map(&b, bigd, 2, b_dims, b_strides, b_box))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.acc = (const long long*)acc;
  p.out = (long long*)out;
  p.J = J;
  p.M = M;
  p.N = N;
  p.rows = rows;
  p.L = L;
  p.drop = drop;
  p.cross = cross;
  if (mw == 2) return launch<2>(a0, a1, b, p, (cudaStream_t)stream);
  return launch<1>(a0, a1, b, p, (cudaStream_t)stream);
}
