// SAME 3x3 convolution as one implicit GEMM on Hopper's tensor cores: bf16
// operands, fp32 sums, NHWC in, NHWC fp32 out, zero padding, no bias.
//
// Replaces the Pallas TPU kernel of scripts/bench_pallas_v2.py::conv_v2
// (body _kernel_v2): the nine tap windows concatenated along channels and
// contracted with the (9*Cin, Cout) weight in one product of depth
// K = 9*Cin, bf16 operands, fp32 accumulation.
//
// The product here: M = B*H*W output pixels, N = Cout, K = 9*Cin, walked as
// K steps of 16 input channels, each of 9 taps. y[b,h,w,o] =
// sum_{du,dv,c} x[b,h+du-1,w+dv-1,c] * w[3*du+dv, c, o].
//
// Bound on an H100 SXM: per output pixel 2*9*Cin*Cout flops against
// 2*Cin + 4*Cout bytes (bf16 in, fp32 out). At the flagship's wide shapes
// (Berk AE 96<->192, plc 3->243->243) that is 350..730 flop/byte, above the
// ~295 flop/byte ridge of the bf16 tensor cores: bound by operations, the
// least time is the flops over 989 TFLOP/s. The narrow ends (3->96, 96->3,
// 1->32, 32->1) are bound by bytes (over 3.35 TB/s).
//
// Design. wgmma (the only way to the tensor cores' full rate) fed by a ring
// of shared-memory stages that one producer thread fills with TMA,
// completion signalled on mbarriers:
//
// - A block owns TH = 2*MS output rows x 64 columns of one image and an N
//   tile of output channels: all of Cout where one tile of at most 192
//   holds it, so each halo tile is staged once per pixel tile; wider Cout
//   in tiles of 128 (ops/conv_v2.py::pick_n_tile says when). Two consumer
//   warpgroups each run MS row segments of 64 pixels (wgmma's M); a third
//   warpgroup is the producer (setmaxnreg moves its registers to the
//   consumers where the accumulators are large; those plans ask for more
//   than half the SM's shared memory, so the block has the SM to itself).
// - A stage holds one K step of 16 input channels: its weights for the 9
//   taps, then the (TH+2) x 66 halo as two planes of 8 channels,
//   [c8][halo row][halo col][8 ch], 16 bytes a pixel. In wgmma's no-swizzle
//   K-major form a core matrix is 8 rows x 16 bytes: here 8 consecutive
//   pixels x 8 channels, 128 contiguous bytes. So the A operand of tap
//   (du, dv) for tile row r is the same staged halo read from plane +
//   ((r+du)*66 + dv)*16 bytes: the tap is a descriptor offset and no data
//   moves (what the Pallas kernel's concatenation of tap windows means).
//   A's descriptors: SBO = 128 bytes (the next 8 pixels), LBO = the plane's
//   size (the next 8 channels of K).
// - The halo comes from a 4-D TMA tensor map over x (C, W, H, B) with a box
//   of (8, 66, TH+2, 1) at start (c, w0-1, h0-1, b): TMA fills what lies
//   outside the image with zeros, which is the SAME padding, and what lies
//   past Cin in the last K step.
// - The weights come as the caller holds them, tap-major (9, Cin, Cout),
//   through a 3-D tensor map (Cout, Cin, 9) in boxes of (WC, 16, 9), WC
//   = 64 outputs with the 128-byte swizzle where the N tile is a multiple
//   of 64 or above 192, else 32 with the 64-byte swizzle: B is N-major
//   (Cout contiguous), which wgmma reads with its transpose flag for
//   16-bit types, so no copy lays the weight out anew on each call. B's
//   descriptors: tap t at 16 rows of 2*WC bytes a box, SBO = 8 rows (the
//   next 8 rows of K), LBO = one box (the next WC outputs).
// - Full/empty mbarriers per stage; each warpgroup keeps one wgmma group in
//   flight and releases a stage when the group that read it completes.
// - Epilogue: the accumulators go to shared memory (the ring, no longer
//   read), then out with coalesced stores: with one N tile a row segment's
//   output is one contiguous run of 64*Cout floats, written as float4
//   where Cout (1, 3, 243) leaves it unaligned only at its ends.
//
// What this design leaves on the table: one block an SM for the wide tiles
// (no overlap of a tile's epilogue with the next tile's loads; a persistent
// grid would give it), every pixel tile restages the step's weights from
// L2 (a cluster multicast would share them), and narrow Cin (1, 3) fills
// 1-3 of 16 K lanes (packing taps x channels into K would not).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <mutex>

#include "wgmma_bf16.cuh"

namespace {

constexpr int SEG = 64;          // output pixels of a row segment (M)
constexpr int HC = SEG + 2;      // halo tile columns
constexpr int CONSUMERS = 2;     // consumer warpgroups
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int HEAD = 2048;       // 1024-byte alignment slack, the mbarriers
constexpr int SMEM_MAX = 232448;

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}
__host__ __device__ constexpr int halo_plane_bytes(int th) {
  return round_up((th + 2) * HC * 16, 128);
}
// Outputs of one weight box: its rows of wcols * 2 bytes are the swizzle
// span (64 bytes: SWIZZLE_64B, layout type 2; 128: SWIZZLE_128B, type 1).
__host__ __device__ constexpr int wcols(int n) {
  return n >= 64 && (n % 64 == 0 || n > 192) ? 64 : 32;
}
// one box: 9 taps x 16 channels x wcols outputs
__host__ __device__ constexpr int wbox_bytes(int n) {
  return 9 * 16 * wcols(n) * 2;
}
__host__ __device__ constexpr int weight_bytes(int n) {
  return (n + wcols(n) - 1) / wcols(n) * wbox_bytes(n);
}
__host__ __device__ constexpr int stage_bytes(int n, int th) {
  return round_up(weight_bytes(n) + 2 * halo_plane_bytes(th), 1024);
}
__host__ __device__ constexpr int epi_seg_bytes(int n) {
  return SEG * n * 4 + 16;
}
constexpr int smem_needed(int n, int ms, int stages) {
  return HEAD + (stages * stage_bytes(n, CONSUMERS * ms) >
                         CONSUMERS * ms * epi_seg_bytes(n)
                     ? stages * stage_bytes(n, CONSUMERS * ms)
                     : CONSUMERS * ms * epi_seg_bytes(n));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait for the completion of the barrier's phase of this parity.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, LBO and SBO in
// 16-byte units, and the layout type (0: no swizzle, 1: 128-byte swizzle,
// 2: 64-byte swizzle). K-major, no swizzle (A): LBO the next core matrix
// along K, SBO the next 8 rows of M. N-major, swizzled (B): LBO the next
// box of columns of N, SBO the next 8 rows of K.
template <int LAYOUT>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(LAYOUT) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING)
               : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products that own them.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// x map: (Cp, W, H, B) bf16, box (8, 66, TH+2, 1), no swizzle; w map: the
// tap-major weight (Cw, Cin, 9) bf16, box (wcols(N), 16, 9), swizzled;
// y: (B, H, W, Cout) fp32. Grid: (tiles_h * tiles_w, n_tiles, B).
template <int N, int MS>
__global__ void __launch_bounds__(THREADS, N <= 16 ? 2 : 1)
    conv_v2_kernel(const __grid_constant__ CUtensorMap xmap,
                   const __grid_constant__ CUtensorMap wmap,
                   float* __restrict__ y, int H, int W, int Cout, int chunks,
                   int stages, int tiles_w) {
  constexpr int TH = CONSUMERS * MS;
  constexpr int HALO = halo_plane_bytes(TH);
  constexpr int WC = wcols(N);
  constexpr int WBOX = wbox_bytes(N);
  constexpr int WB = weight_bytes(N);            // one step's weight boxes
  constexpr int STAGE = stage_bytes(N, TH);
  constexpr uint32_t TX = 2 * (TH + 2) * HC * 16 + WB;  // bytes a stage gets
  constexpr int EPI = epi_seg_bytes(N);
  constexpr bool WIDE = N > 16;                  // one block an SM

  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t bars = smem_u32(base);          // full[s], then empty[s]
  uint8_t* ring = base + 1024;                   // stages 1024-byte aligned
  const uint32_t ring_u = smem_u32(ring);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const int b = blockIdx.z;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * SEG;
  const int nt = blockIdx.y;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (stages + s), 4 * CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // producer: one thread keeps the ring full
    if constexpr (WIDE) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == CONSUMERS * 128) {
      for (int k = 0; k < chunks; ++k) {
        const int s = k % stages;
        if (k >= stages)
          mbar_wait(bars + 8 * (stages + s), ((k / stages) - 1) & 1);
        const uint32_t full = bars + 8 * s;
        const uint32_t st = ring_u + s * STAGE;
        mbar_expect_tx(full, TX);
#pragma unroll
        for (int j = 0; j < WB / WBOX; ++j)
          tma_load_3d(st + j * WBOX, &wmap, full, nt * N + j * WC, 16 * k,
                      0);
        tma_load_4d(st + WB, &xmap, full, 16 * k, w0 - 1, h0 - 1, b);
        tma_load_4d(st + WB + HALO, &xmap, full, 16 * k + 8, w0 - 1, h0 - 1,
                    b);
      }
    }
  } else {
    if constexpr (WIDE) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int r0 = wg * MS;                      // first tile row
    float acc[MS][N / 2];
#pragma unroll
    for (int m = 0; m < MS; ++m) {
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[m][i] = 0.f;
      fence_regs(acc[m]);
    }
    for (int k = 0; k < chunks; ++k) {
      const int s = k % stages;
      mbar_wait(bars + 8 * s, (k / stages) & 1);
      const uint32_t st = ring_u + s * STAGE;
      wgmma_fence();
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        // tap t's 16 x N weights: 16 rows of 2*WC bytes a box (swizzle
        // atoms of 8 rows), boxes WBOX apart
        const uint64_t bd =
            desc<WC == 64 ? 1 : 2>(st + t * 16 * WC * 2, WBOX, 8 * WC * 2);
#pragma unroll
        for (int m = 0; m < MS; ++m) {
          const uint64_t ad = desc<0>(
              st + WB + ((r0 + m + t / 3) * HC + t % 3) * 16, HALO, 128);
          wgmma_bf16<N>(acc[m], ad, bd);
        }
      }
      wgmma_commit();
      if (k > 0) {
        // the group of step k-1 is done: its stage may be refilled
        wgmma_wait<1>();
        if (tid % 32 == 0) mbar_arrive(bars + 8 * (stages + (k - 1) % stages));
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int m = 0; m < MS; ++m) fence_regs(acc[m]);

    // epilogue: both warpgroups are done with the ring; stage the tile
    asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 128) : "memory");
    const int lane = tid % 32;
    const int warp = (tid % 128) / 32;
    const int n0 = nt * N;
    const int nvalid = min(N, Cout - n0);
    const bool whole = nvalid == Cout;           // one N tile: contiguous
    float* ep = reinterpret_cast<float*>(ring + wg * MS * EPI);
    long long g0[MS];
#pragma unroll
    for (int m = 0; m < MS; ++m) {
      g0[m] = ((static_cast<long long>(b) * H + h0 + r0 + m) * W + w0) * Cout +
              n0;
      float* seg = ep + m * (EPI / 4) + (whole ? int(g0[m] & 3) : 0);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const int row = 16 * warp + lane / 4 + 8 * ((i >> 1) & 1);
        const int col = 8 * (i >> 2) + 2 * (lane % 4) + (i & 1);
        if (col < nvalid) seg[row * nvalid + col] = acc[m][i];
      }
    }
    asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
    const int t = tid % 128;
    const int npix = min(SEG, W - w0);
#pragma unroll
    for (int m = 0; m < MS; ++m) {
      if (h0 + r0 + m >= H) continue;
      const int count = npix * nvalid;
      float* dst = y + g0[m];
      if (whole) {
        const int off = int(g0[m] & 3);
        const float* seg = ep + m * (EPI / 4) + off;
        const int head = min((4 - off) & 3, count);
        const int nvec = (count - head) / 4;
        if (t < head) dst[t] = seg[t];
        const float4* s4 = reinterpret_cast<const float4*>(seg + head);
        float4* d4 = reinterpret_cast<float4*>(dst + head);
        for (int j = t; j < nvec; j += 128) d4[j] = s4[j];
        for (int i = head + 4 * nvec + t; i < count; i += 128) dst[i] = seg[i];
      } else {
        const float* seg = ep + m * (EPI / 4);
        for (int i = t; i < count; i += 128) {
          const int p = i / nvalid;
          dst[(long long)p * Cout + (i - p * nvalid)] = seg[i];
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime so that
// the library needs no link against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

template <int N, int MS>
int launch(const CUtensorMap& xmap, const CUtensorMap& wmap, float* y, int B,
           int H, int W, int Cout, int chunks, int stages, int n_tiles,
           int smem, int grid_x, cudaStream_t s) {
  constexpr int TH = CONSUMERS * MS;
  const int tiles_w = (W + SEG - 1) / SEG;
  if (grid_x != ((H + TH - 1) / TH) * tiles_w ||
      smem < smem_needed(N, MS, stages))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = conv_v2_kernel<N, MS>;
  // the shared-memory limit is raised once per device to the most a block
  // may have; each launch asks for its own
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!raised[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX);
    if (e != cudaSuccess) return static_cast<int>(e);
    raised[dev] = true;
  }
  // cudaLaunchKernel reports this launch's own refusal, where
  // cudaGetLastError could return an error another library left behind
  void* args[] = {const_cast<CUtensorMap*>(&xmap),
                  const_cast<CUtensorMap*>(&wmap), &y, &H, &W, &Cout, &chunks,
                  &stages, const_cast<int*>(&tiles_w)};
  return static_cast<int>(cudaLaunchKernel(
      reinterpret_cast<const void*>(kernel), dim3(grid_x, n_tiles, B),
      dim3(THREADS), args, smem, s));
}

// A bf16 tensor map over a dense tensor of `rank` (at most 4) dimensions,
// innermost first, zero fill out of bounds. The last few maps are kept,
// keyed by everything they encode: PyTorch's allocator hands the same
// blocks out again, so most launches find theirs without encoding.
struct MapKey {
  const void* ptr;
  int rank, swizzle;
  cuuint64_t dims[4];
  cuuint32_t box[4];
};
constexpr int MAP_CACHE = 32;
std::mutex map_mutex;
MapKey map_keys[MAP_CACHE];
CUtensorMap map_vals[MAP_CACHE];
int map_used = 0, map_next = 0;

CUresult tensor_map(CUtensorMap* map, const void* ptr, int rank,
                    const cuuint64_t* dims, const cuuint32_t* box,
                    CUtensorMapSwizzle swizzle) {
  MapKey key;
  std::memset(&key, 0, sizeof key);
  key.ptr = ptr;
  key.rank = rank;
  key.swizzle = static_cast<int>(swizzle);
  std::memcpy(key.dims, dims, rank * sizeof *dims);
  std::memcpy(key.box, box, rank * sizeof *box);
  std::lock_guard<std::mutex> lock(map_mutex);
  for (int i = 0; i < map_used; ++i)
    if (std::memcmp(&map_keys[i], &key, sizeof key) == 0) {
      *map = map_vals[i];
      return CUDA_SUCCESS;
    }
  cuuint64_t strides[4];
  cuuint64_t stride = 2;
  for (int i = 0; i + 1 < rank; ++i) strides[i] = stride *= dims[i];
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = encode_tiled()(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr),
      dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r == CUDA_SUCCESS) {
    map_keys[map_next] = key;
    map_vals[map_next] = *map;
    map_next = (map_next + 1) % MAP_CACHE;
    if (map_used < MAP_CACHE) ++map_used;
  }
  return r;
}

}  // namespace

// C interface for ctypes. The geometry comes from ops/conv_v2.py's
// launch_plan: Cp (x's channels, a multiple of 8), Cw (the weight's Cout
// stride, a multiple of 8), the N tile and its row segments a warpgroup
// (one of the pairs below), the N tiles, the K steps (ceil(Cp/16)), the
// ring's stages, the dynamic shared memory and the grid's pixel tiles; the
// kernel checks them against its own reckoning. x: (B, H, W, Cp) bf16;
// w: (9, Cin, Cw) bf16; y: (B, H, W, Cout) fp32. Returns 0, a cudaError_t,
// or 1000 + the CUresult of a refused tensor map.
extern "C" int conv_v2_fwd(const void* x, const void* w, void* y, int B,
                           int H, int W, int Cp, int Cin, int Cout, int Cw,
                           int n_tile, int segs, int n_tiles, int chunks,
                           int stages, int smem, int grid_x, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (Cp % 8 != 0 || Cw % 8 != 0 || Cp < Cin || Cw < Cout ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      chunks != (Cp + 15) / 16 || n_tile * n_tiles < Cout ||
      n_tile * (n_tiles - 1) >= Cout || stages < 1 || stages > chunks ||
      (stages < 2 && chunks > 1) || smem > SMEM_MAX || n_tiles > 65535 ||
      B > 65535)
    return bad;
  if (encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[4] = {(cuuint64_t)Cp, (cuuint64_t)W, (cuuint64_t)H,
                               (cuuint64_t)B};
  const cuuint32_t xbox[4] = {8, (cuuint32_t)HC, (cuuint32_t)(2 * segs + 2),
                              1};
  CUresult r = tensor_map(&xmap, x, 4, xdims, xbox, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
  const cuuint64_t wdims[3] = {(cuuint64_t)Cw, (cuuint64_t)Cin, 9};
  const cuuint32_t wbox[3] = {(cuuint32_t)wcols(n_tile), 16, 9};
  r = tensor_map(&wmap, w, 3, wdims, wbox,
                 wcols(n_tile) == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : CU_TENSOR_MAP_SWIZZLE_64B);
  if (r != CUDA_SUCCESS) return 1000 + static_cast<int>(r);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(y);
#define CONV_V2_CASE(n, ms)                                                   \
  if (n_tile == n && segs == ms)                                              \
    return launch<n, ms>(xmap, wmap, out, B, H, W, Cout, chunks, stages,      \
                         n_tiles, smem, grid_x, s);
  CONV_V2_CASE(8, 8)
  CONV_V2_CASE(16, 4)
  CONV_V2_CASE(32, 4)
  CONV_V2_CASE(64, 2)
  CONV_V2_CASE(96, 2)
  CONV_V2_CASE(128, 2)
  CONV_V2_CASE(192, 2)
  CONV_V2_CASE(248, 1)
#undef CONV_V2_CASE
  return bad;
}
