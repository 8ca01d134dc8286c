// SAME 3x3 convolution with zero padding and no bias: fp32 operands, exact
// fp32 products and fp32 sums on the CUDA cores, NHWC in, NHWC fp32 out.
//
// Replaces the Pallas TPU kernel of the JAX package,
// ops/pallas_conv.py::_conv3x3_halo_fwd (body _conv_kernel): nine shifted
// tap products over a (TH+2)-row halo tile, accumulated in fp32. It carries
// every fp32 3x3 conv of the port, forward and dx (the dx is this kernel on
// the flipped, in/out-swapped weight); bf16 operands go to conv_v2.cu.
//
// y[b,h,w,o] = sum_{du,dv,c} x[b,h+du-1,w+dv-1,c] * wt[3*du+dv, c, o]
// with x (B, H, W, Cin), wt (9, Cin, Cout) tap-major, y (B, H, W, Cout).
//
// Bound on an H100 SXM: per output pixel 2*9*Cin*Cout flops against
// 4*Cin + 4*Cout bytes. wgmma has no fp32 form and TF32 would change the
// numbers, so the peak is the CUDA cores' 67 TFLOP/s: at the wide shapes
// (Berk AE 96<->192, plc 243->243) the least time is the flops over
// 67 TFLOP/s; the narrow ends (Cin or Cout 1 and 3) are bound by their
// bytes over 3.35 TB/s.
//
// Design: a register-tiled implicit GEMM fed by a cp.async ring.
//
// - Each thread owns PX = 8 consecutive output columns of one row x CO
//   output channels (CO = 8, 12 or 16 by N tile: 64 to 128 fp32
//   accumulators). For each (4-channel group, du) it reads its PX + 2 halo
//   columns once and uses them for all three dv taps, and for each
//   (channel, tap) it reads its CO weights as CO/4 16-byte loads that the
//   lanes of its channel group share (broadcast). Per (du, 2 channels)
//   that is PX + 2 + 6*CO/4 shared loads for 6*PX*CO FFMAs (PX 8, CO 16:
//   34 for 768), so the FMA units, not shared memory, set the pace (at 12
//   scalar loads for 32 FFMAs a loop is bound by shared memory at 20-25
//   TFLOP/s). A thread's channels
//   are runs of 4 at a stride of 4 * (channel groups), so that the channel
//   groups of a warp read consecutive 16-byte words.
// - A block owns 8 rows x 32 columns (64 for N tiles of 8 and 32) of one
//   image and an N tile of output channels: 8, 32, 64, 96 or 128, chosen
//   per layer by ops/conv3x3_halo.py::launch_plan so that Cout 96, 192 and
//   243 split with little waste (96 = 1 x 96, 192 = 2 x 96, 243 = 2 x
//   128): each halo tile is staged once per N tile, twice at most on the
//   main path. Where those tiles would give the grid fewer blocks than the
//   card has SMs (small images at batch 1-8: the bitstream, the agent's
//   128-pixel patches, the coarse levels), the plan takes the small tiles
//   instead: PX = 4, CO = 8, N tiles of 8 or 32, blocks of 32 or 64
//   threads over 8 x 16 or 4 x 16 pixels, so that more SMs get work.
// - Cin is walked in chunks of 8 channels through a ring of 2-3 shared-
//   memory stages filled by cp.async: one wait_group and one __syncthreads
//   a chunk, so the FFMAs of chunk k overlap the loads of chunks k+1 and
//   k+2. x comes by 16-byte cp.async.cg where Cin is a multiple of 4 and
//   the pointer 16-byte aligned, by 4-byte cp.async.ca otherwise (Cin 1,
//   3, 243; a misaligned view); the SAME padding, ragged tiles and the channels past
//   Cin come from the copies' zero fill (src-size 0), not from branches in
//   the FFMA loop. The weight comes packed by the wrapper
//   (ops/conv3x3_halo.py::pack_weight: each N tile's chunk one contiguous
//   run in the stage's layout, zeros past Cin and Cout), so a stage's
//   weights are plain 16-byte copies whatever Cout is: gathering them from
//   the tap-major tensor in the kernel (4-byte copies for Cout 243) was
//   the largest cost at 243 -> 243 when tried on the card.
// - The halo is staged as [channel group of 4][row][column][4 channels]:
//   a 16-byte copy of 4 channels of a pixel lands whole. Each run of 8
//   columns is followed by one empty pixel, so that the 8-column groups of
//   one row fall on different banks.
// - Epilogue: the tile goes through shared memory (the ring, no longer
//   read) and out with a warp a pixel, its lanes on consecutive channels
//   (consecutive threads on consecutive outputs where the tile has fewer
//   than 32): whole runs of 128 bytes a store, where one channel of 32
//   pixels a store would touch 32 sectors for 128 useful bytes.
// - Deterministic: each output is summed by one thread in a fixed order
//   (chunks, du, channels, dv); no atomics, no split of K. The real
//   bitstream needs this: a decoded plane must match the encoder's bit for
//   bit, and both run this kernel.
//
// What this design leaves on the table: one block an SM for the N tiles
// 96 and 128 (255 registers a thread; a tile's epilogue and first loads
// are not overlapped with another tile's FFMAs); the register allocation
// of the FFMA loop is the compiler's (operand bank conflicts are not
// controlled); the weight tile is restaged from L2 for every pixel tile;
// Cin 1 and 3 fill only 1-3 of a 4-channel group.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int KC = 8;                 // input channels a ring stage holds
constexpr int SMEM_MAX = 232448;      // dynamic shared memory a block may use

// columns of the staged halo row: TW + 2 pixels and an empty one after
// every 8
__host__ __device__ constexpr int halo_cols(int tw) {
  return tw + 2 + (tw + 1) / 8;
}
__host__ __device__ constexpr int halo_floats(int th, int tw) {
  return (KC / 4) * (th + 2) * halo_cols(tw) * 4;
}
__host__ __device__ constexpr int stage_floats(int th, int tw, int nt) {
  return halo_floats(th, tw) + 9 * KC * nt;
}
__host__ __device__ constexpr int epilogue_floats(int th, int tw, int nt) {
  return th * tw * (nt + 4);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most `pending` (0 or 1) groups of this thread are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::);
  else
    asm volatile("cp.async.wait_group 0;\n" ::);
}

// CG channel groups of CO (N tile CO*CG) x PR rows x PC column groups of
// PX: one thread per (channel group, row, column group), CO channels x PX
// columns each.
template <int CG, int PR, int PC, int CO, int PX>
struct Tile {
  static constexpr int NT = CO * CG;
  static constexpr int TH = PR;
  static constexpr int TW = PX * PC;
  static constexpr int THREADS = CG * PR * PC;
  static constexpr int HR = TH + 2;
  static constexpr int HCS = halo_cols(TW);
  static constexpr int HALO = halo_floats(TH, TW);
  static constexpr int STAGE = stage_floats(TH, TW, NT);
  // two blocks an SM where 256 threads a block leave 128 registers each
  static constexpr int MIN_BLOCKS = THREADS == 256 && CO == 8 ? 2 : 1;
};

// Stage chunk c0.. of x's halo and the chunk's packed weights `wk` into
// one ring stage.
template <class T>
__device__ __forceinline__ void load_chunk(float* stage, const float* xb,
                                           const float* wk, int H, int W,
                                           int Cin, int h0, int w0, int c0,
                                           bool vec_x, int tid) {
  constexpr int HW = T::TW + 2;      // halo columns holding pixels
  float* xs = stage;
  float* ws = stage + T::HALO;
  if (vec_x) {
    // 16 bytes: 4 channels of one pixel (Cin % 4 == 0, so a group is all
    // in or all past Cin); consecutive threads on the chunk's groups of a
    // pixel, then the next pixel
    for (int e = tid; e < (KC / 4) * T::HR * HW; e += T::THREADS) {
      const int g = e % (KC / 4);
      const int pix = e / (KC / 4);
      const int row = pix / HW;
      const int col = pix - row * HW;
      const int gh = h0 - 1 + row, gw = w0 - 1 + col, c = c0 + 4 * g;
      const bool ok = gh >= 0 && gh < H && gw >= 0 && gw < W && c < Cin;
      const float* src = ok ? xb + ((size_t)gh * W + gw) * Cin + c : xb;
      cp_async16(xs + ((g * T::HR + row) * T::HCS + col + col / 8) * 4, src,
                 ok);
    }
  } else {
    for (int e = tid; e < KC * T::HR * HW; e += T::THREADS) {
      const int ci = e & (KC - 1);
      const int pix = e / KC;
      const int row = pix / HW;
      const int col = pix - row * HW;
      const int gh = h0 - 1 + row, gw = w0 - 1 + col, c = c0 + ci;
      const bool ok = gh >= 0 && gh < H && gw >= 0 && gw < W && c < Cin;
      const float* src = ok ? xb + ((size_t)gh * W + gw) * Cin + c : xb;
      cp_async4(xs + (((ci >> 2) * T::HR + row) * T::HCS + col + col / 8) * 4 +
                    (ci & 3),
                src, ok);
    }
  }
  // the chunk's weights: the wrapper packed them as the stage holds them
  for (int e = tid; e < 9 * KC * T::NT / 4; e += T::THREADS)
    cp_async16(ws + 4 * e, wk + 4 * e, true);
}

// x (B, H, W, Cin); w packed (n_tiles, chunks, 9, KC, NT), zero past Cin
// and Cout; y (B, H, W, Cout). Grid: (tiles_h * tiles_w, n_tiles, B);
// dynamic shared memory: max(stages * STAGE, epilogue) floats.
template <int CG, int PR, int PC, int CO, int PX>
__global__ void __launch_bounds__(Tile<CG, PR, PC, CO, PX>::THREADS,
                                  Tile<CG, PR, PC, CO, PX>::MIN_BLOCKS)
conv3x3_halo_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ y, int H, int W, int Cin, int Cout,
                    int stages, int vec_x, int tiles_w) {
  using T = Tile<CG, PR, PC, CO, PX>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int cg = tid % CG;
  const int pg = tid / CG;
  const int pr = pg / PC;
  const int pc = pg % PC;
  const int h0 = (blockIdx.x / tiles_w) * T::TH;
  const int w0 = (blockIdx.x % tiles_w) * T::TW;
  const int n0 = blockIdx.y * T::NT;
  const int b = blockIdx.z;
  const float* xb = x + (size_t)b * H * W * Cin;
  const int chunks = (Cin + KC - 1) / KC;
  constexpr int WCHUNK = 9 * KC * T::NT;   // floats of a chunk's weights
  const float* wt = w + (size_t)blockIdx.y * chunks * WCHUNK;

  // the thread's first column c0 lies at c0 + c0/8 in the staged row (an
  // empty pixel after every 8); cm: c0's place within its run of 8, 0 at
  // compile time where PX is a multiple of 8
  const int c0 = pc * PX;
  const int cbase = c0 + c0 / 8;
  const int cm = PX % 8 == 0 ? 0 : c0 % 8;

  float acc[PX][CO];
#pragma unroll
  for (int i = 0; i < PX; ++i)
#pragma unroll
    for (int j = 0; j < CO; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < stages - 1; ++s) {
    if (s < chunks)
      load_chunk<T>(smem + s * T::STAGE, xb, wt + (size_t)s * WCHUNK, H, W,
                    Cin, h0, w0, s * KC, vec_x, tid);
    cp_async_commit();
  }

  for (int k = 0; k < chunks; ++k) {
    cp_async_wait(stages - 2);       // chunk k has landed (this thread's)
    __syncthreads();                 // everyone's, and chunk k-1 is done
    const int next = k + stages - 1;
    if (next < chunks)
      load_chunk<T>(smem + (next % stages) * T::STAGE, xb,
                    wt + (size_t)next * WCHUNK, H, W, Cin, h0, w0, next * KC,
                    vec_x, tid);
    cp_async_commit();

    const float* xs = smem + (k % stages) * T::STAGE;
    const float* ws = xs + T::HALO + cg * 4;
    const int groups = (min(KC, Cin - k * KC) + 3) / 4;
#pragma unroll 1
    for (int g = 0; g < groups; ++g) {
#pragma unroll
      for (int du = 0; du < 3; ++du) {
        const float* hx = xs + ((g * T::HR + pr + du) * T::HCS + cbase) * 4;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float2 hv[PX + 2];
#pragma unroll
          for (int j = 0; j < PX + 2; ++j)
            hv[j] = *reinterpret_cast<const float2*>(
                hx + (j + (cm + j) / 8) * 4 + 2 * half);
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            const int ci = 4 * g + 2 * half + cc;
#pragma unroll
            for (int dv = 0; dv < 3; ++dv) {
              const float* wp = ws + ((du * 3 + dv) * KC + ci) * T::NT;
              float wv[CO];
#pragma unroll
              for (int r = 0; r < CO / 4; ++r) {
                const float4 q =
                    *reinterpret_cast<const float4*>(wp + r * 4 * CG);
                wv[4 * r] = q.x;
                wv[4 * r + 1] = q.y;
                wv[4 * r + 2] = q.z;
                wv[4 * r + 3] = q.w;
              }
#pragma unroll
              for (int i = 0; i < PX; ++i) {
                const float a = cc ? hv[i + dv].y : hv[i + dv].x;
#pragma unroll
                for (int j = 0; j < CO; ++j)
                  acc[i][j] = fmaf(a, wv[j], acc[i][j]);
              }
            }
          }
        }
      }
    }
  }

  // epilogue: the tile through shared memory, then coalesced runs out
  cp_async_wait(0);
  __syncthreads();
  constexpr int NTP = T::NT + 4;
#pragma unroll
  for (int i = 0; i < PX; ++i) {
    float* sp = smem + (pr * T::TW + c0 + i) * NTP + cg * 4;
#pragma unroll
    for (int r = 0; r < CO / 4; ++r)
      *reinterpret_cast<float4*>(sp + r * 4 * CG) =
          make_float4(acc[i][4 * r], acc[i][4 * r + 1], acc[i][4 * r + 2],
                      acc[i][4 * r + 3]);
  }
  __syncthreads();
  const int ncols = min(T::NT, Cout - n0);
  const int rows = min(T::TH, H - h0);
  const int cols = min(T::TW, W - w0);
  float* yb = y + (((size_t)b * H + h0) * W + w0) * Cout + n0;
  if (ncols >= 32) {
    // a warp a pixel, its lanes on consecutive channels
    constexpr int WARPS = T::THREADS / 32;
    const int lane = tid % 32;
    for (int p = tid / 32; p < T::TH * T::TW; p += WARPS) {
      const int r = p / T::TW;
      const int c = p % T::TW;
      if (r >= rows || c >= cols) continue;
      float* yp = yb + ((size_t)r * W + c) * Cout;
      for (int ch = lane; ch < ncols; ch += 32) yp[ch] = smem[p * NTP + ch];
    }
  } else {
    // few channels: consecutive threads on consecutive (pixel, channel)
    for (int e = tid; e < T::TH * T::TW * ncols; e += T::THREADS) {
      const int p = e / ncols;
      const int ch = e - p * ncols;
      const int r = p / T::TW;
      const int c = p % T::TW;
      if (r < rows && c < cols)
        yb[((size_t)r * W + c) * Cout + ch] = smem[p * NTP + ch];
    }
  }
}

size_t smem_needed(int th, int tw, int nt, int stages) {
  const int ring = stages * stage_floats(th, tw, nt);
  const int epi = epilogue_floats(th, tw, nt);
  return sizeof(float) * static_cast<size_t>(ring > epi ? ring : epi);
}

template <int CG, int PR, int PC, int CO, int PX>
int launch(const float* x, const float* w, float* y, int B, int H, int W,
           int Cin, int Cout, int n_tiles, int tile_w, int stages, int smem,
           int vec_x, int grid_x, cudaStream_t s) {
  using T = Tile<CG, PR, PC, CO, PX>;
  const int tiles_w = (W + T::TW - 1) / T::TW;
  if (tile_w != T::TW || grid_x != ((H + T::TH - 1) / T::TH) * tiles_w ||
      static_cast<size_t>(smem) < smem_needed(T::TH, T::TW, T::NT, stages))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = conv3x3_halo_kernel<CG, PR, PC, CO, PX>;
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
  int tw = tiles_w;
  void* args[] = {&x, &w, &y, &H, &W, &Cin, &Cout, &stages, &vec_x, &tw};
  return static_cast<int>(cudaLaunchKernel(
      reinterpret_cast<const void*>(kernel), dim3(grid_x, n_tiles, B),
      dim3(T::THREADS), args, smem, s));
}

}  // namespace

// C interface for ctypes: the plan's geometry comes from
// ops/conv3x3_halo.py::launch_plan and is checked here; w is the weight as
// ops/conv3x3_halo.py::pack_weight lays it out for the plan. vec_x picks
// the 16-byte copies of x. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int conv3x3_halo_fwd(const void* x, const void* w, void* y, int B,
                                int H, int W, int Cin, int Cout, int n_tile,
                                int n_tiles, int tile_w, int stages, int smem,
                                int vec_x, int grid_x, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (B < 1 || H < 1 || W < 1 || Cin < 1 || Cout < 1 || n_tile < 8 ||
      n_tile * n_tiles < Cout || n_tile * (n_tiles - 1) >= Cout ||
      stages < 2 || stages > 3 || smem > SMEM_MAX || n_tiles > 65535 ||
      B > 65535 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      (vec_x && (Cin % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)))
    return bad;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* yf = static_cast<float*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the kernel of the plan's (N tile, tile width): ops/conv3x3_halo.py's
  // TILES as <channel groups, rows, column groups, CO, PX>; a width of 16
  // is the small-grid tile
#define CONV3X3_ARGS \
  xf, wf, yf, B, H, W, Cin, Cout, n_tiles, tile_w, stages, smem, vec_x,    \
      grid_x, s
  switch (n_tile) {
    case 8:
      return tile_w == 16 ? launch<1, 8, 4, 8, 4>(CONV3X3_ARGS)
                          : launch<1, 8, 8, 8, 8>(CONV3X3_ARGS);
    case 32:
      return tile_w == 16 ? launch<4, 4, 4, 8, 4>(CONV3X3_ARGS)
                          : launch<4, 8, 8, 8, 8>(CONV3X3_ARGS);
    case 64:
      return launch<8, 8, 4, 8, 8>(CONV3X3_ARGS);
    case 96:
      return launch<8, 8, 4, 12, 8>(CONV3X3_ARGS);
    case 128:
      return launch<8, 8, 4, 16, 8>(CONV3X3_ARGS);
#undef CONV3X3_ARGS
    default:
      return bad;
  }
}
