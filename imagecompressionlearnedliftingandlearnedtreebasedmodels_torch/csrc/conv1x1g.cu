// Grouped 1x1 convolution in NCHW with a fused bias: fp32 operands, exact
// fp32 products and fp32 sums on the CUDA cores, NCHW in, NCHW fp32 out.
//
// Replaces no Pallas kernel: the JAX package leaves its fp32 grouped 1x1
// convs (ZTsep's cgp fusion stacks, the pointwise subband autoencoders) to
// XLA. It was added because the port sent them to cuDNN's grouped conv,
// which on NCHW fp32 operands wraps each one in layout transposes (NCHW to
// NHWC and back) that took most of the device time of every fp32 eval and
// train step that has such layers.
//
// For image b and group g, with P = H*W pixels:
//   y[b, g*M + m, p] = bias[g*M + m] + sum_k w(g, m, k) * x[b, g*K + k, p]
// a product (M x K) . (K x P). In NCHW the pixel axis of each channel is
// already contiguous, so no layout copy is needed: x's and y's channel rows
// are the product's rows. w(g, m, k) sits at w[g*M*K + m*wsm + k*wsk]: the
// forward passes PyTorch's (Cout, K, 1, 1) weight (wsm = K, wsk = 1), the
// input gradient the same tensor read transposed (M and K swapped, wsm = 1,
// wsk = M), so neither is copied or packed.
//
// Bound on an H100 SXM: a pixel of a group costs 2*M*K flops against
// 4*(M + K) bytes, 67 TFLOP/s of fp32 FFMA against 3.35 TB/s: 20 flops a
// byte. ZTsep's cgp layers (162 -> 162, 162 -> 54 a group) are far above
// it and bound by the FLOPs; the pointwise autoencoders' layers (1 -> 32,
// 32 -> 32, 32 -> 1 a group) and the cgp's narrow end (54 -> 18, 18 -> 2)
// are below it and bound by their bytes.
//
// Design: one register-tiled FFMA loop fed by a cp.async ring, whose tile
// ops/conv1x1g.py::launch_plan picks from the group's M.
//
// - A block computes BM output channels (the whole group's M on every
//   shape of the main path, so each input pixel is read from device memory
//   once) x BN pixels of one (image, group). A thread owns TM channels x 8
//   pixels: TM*8 fp32 accumulators.
// - K is walked in chunks of BK channels (8 on the streaming tiles, 16 on
//   the large ones) through a ring of 2-3 shared-memory stages filled by
//   cp.async: x's rows as 16-byte copies along the pixels (4-byte ones
//   where P or a stride is not a multiple of 4, or x is misaligned), the
//   chunk's BK x BM weights as 4-byte copies ordered along whichever of m
//   and k is contiguous in memory. The K tail, the channels past M and the
//   pixels past P come from the copies' zero fill (src-size 0), not from
//   branches in the FFMA loop. The FFMAs of chunk c overlap the loads of
//   chunks c+1 and c+2.
// - A warp is WM x WN threads (channels x pixels). For each k a thread
//   reads its 8 pixels as two 16-byte loads, at 4*tn and 4*(WN + tn) within
//   the warp's pixels, so the lanes of a warp read consecutive 16-byte
//   words, and its TM weights as TM/4 16-byte loads at a stride of 4*WM,
//   which the WN lanes of a channel group share (broadcast).
// - Two regimes, one code path. The FLOP-bound cgp shapes take the large
//   tiles (BM 64, 96 or 192: TM 12 or 16, warps of 4 x 8 threads, BK 16):
//   per k a warp makes 5-6 shared-memory wavefronts for 96-128 FFMAs a
//   thread, so the FMA units and not shared memory set the pace, and the
//   96- and 192-wide tiles ask for two blocks an SM (the 192-wide, of 256
//   threads, is then held to 128 registers), so that one block's loads
//   and epilogue overlap the other's FFMAs (162 -> 162 on an H100: 4.70 ms
//   against 5.72 with BK 8 and one block of 176 registers). The
//   byte-bound shapes take the streaming tiles (BM 4 or 32, BN 1024 or 256
//   pixels, 128 threads, BK 8): few registers, several blocks an SM, the
//   copies of two stages in flight, each input pixel read once and each
//   output written once.
// - Epilogue: the bias (the tensor's, or none) is added to the
//   accumulators and the tile is stored from registers as 16-byte stores
//   along the pixels (4-byte ones where P is not a multiple of 4, masked
//   at the ragged tail): the WN lanes of a channel group write WN * 16
//   consecutive bytes of one channel row.
// - Deterministic: each output is summed by one thread in a fixed order
//   (k ascending), with no atomics and no split of K.
//
// What this design leaves on the table: 162 -> 162 runs at ~26 TFLOP/s,
// about cuBLAS's fp32 batched product; the weight tile is restaged from
// L2 for every pixel tile (a persistent block holding W_g would load it
// once per SM); M = 162 is computed as 192 (the padded channels' FFMAs run
// and are not stored; an exact 168-wide tile of 7 warps spilled and ran
// 2 % slower); the register allocation of the FFMA loop is the compiler's.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int SMEM_MAX = 232448;      // dynamic shared memory a block may use
constexpr int MAX_STAGES = 4;

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

// wait until at most `pending` (0 to 2) groups of this thread are in flight
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending >= 2)
    asm volatile("cp.async.wait_group 2;\n" ::);
  else if (pending == 1)
    asm volatile("cp.async.wait_group 1;\n" ::);
  else
    asm volatile("cp.async.wait_group 0;\n" ::);
}

// TM channels x 8 pixels a thread; warps of (32 / WN) x WN threads
// (channels x pixels); WARPS_M x WARPS_N warps a block; BK_ input channels
// a ring stage.
template <int TM, int WN, int WARPS_M, int WARPS_N, int BK_>
struct Tile {
  static constexpr int BK = BK_;
  static constexpr int WM = 32 / WN;
  static constexpr int BM = TM * WM * WARPS_M;
  static constexpr int BN = 8 * WN * WARPS_N;
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int WS = BM + 4;   // a staged weight row (k), padded
  static constexpr int STAGE = BK * BN + BK * WS;   // floats
  // the large tiles: two blocks an SM (at most 128 registers a thread), so
  // that one block's loads and epilogue overlap the other's FFMAs
  static constexpr int MIN_BLOCKS = BM >= 96 ? 2 : 1;
  static_assert(TM % 4 == 0 && WM * WN == 32, "bad tile");
};

struct Args {
  const float* x;
  const float* w;
  const float* bias;   // Cout floats, or null
  float* y;
  long long xsb, xsc;  // x's batch and channel strides (its pixels dense)
  long long ysb;       // y's batch stride (its channels P apart)
  int P, G, K, M;      // pixels, groups, in and out channels of a group
  int wsm, wsk;        // w(g, m, k) = w[g*M*K + m*wsm + k*wsk]
  int vec_x, vec_y;
  int stages;
};

// Stage chunk c0.. of x's rows and of the weights into one ring stage.
template <class T>
__device__ __forceinline__ void load_chunk(float* stage, const Args& a,
                                           const float* xg, const float* wg,
                                           int p0, int m0, int c0, int tid) {
  float* xs = stage;
  constexpr int BK = T::BK;
  float* ws = stage + BK * T::BN;
  if (a.vec_x) {
    // 16 bytes: 4 pixels of one channel (P % 4 == 0, so a run is all in or
    // all past P); consecutive threads on consecutive runs of a row
    constexpr int RUNS = T::BN / 4;
    for (int e = tid; e < BK * RUNS; e += T::THREADS) {
      const int kk = e / RUNS;
      const int q = 4 * (e - kk * RUNS);
      const bool ok = c0 + kk < a.K && p0 + q < a.P;
      const float* src = ok ? xg + (c0 + kk) * a.xsc + p0 + q : xg;
      cp_async16(xs + kk * T::BN + q, src, ok);
    }
  } else {
    for (int e = tid; e < BK * T::BN; e += T::THREADS) {
      const int kk = e / T::BN;
      const int q = e - kk * T::BN;
      const bool ok = c0 + kk < a.K && p0 + q < a.P;
      const float* src = ok ? xg + (c0 + kk) * a.xsc + p0 + q : xg;
      cp_async4(xs + kk * T::BN + q, src, ok);
    }
  }
  // the chunk's weights, [k][m]: consecutive threads along the contiguous
  // axis of w (k in the forward, m in the input gradient)
  const bool k_inner = a.wsk == 1;
  for (int e = tid; e < BK * T::BM; e += T::THREADS) {
    const int kk = k_inner ? e % BK : e / T::BM;
    const int mm = k_inner ? e / BK : e % T::BM;
    const int k = c0 + kk, m = m0 + mm;
    const bool ok = k < a.K && m < a.M;
    const float* src =
        ok ? wg + static_cast<long long>(m) * a.wsm +
                 static_cast<long long>(k) * a.wsk
           : wg;
    cp_async4(ws + kk * T::WS + mm, src, ok);
  }
}

// One k of the product: the thread's 8 pixels of staged x row kk and its TM
// weights of staged weight row kk, TM*8 FFMAs.
template <class T, int TM, int WN>
__device__ __forceinline__ void fma_row(float (&acc)[TM][8], const float* xs,
                                        const float* ws, int kk) {
  const float4 x0 = *reinterpret_cast<const float4*>(xs + kk * T::BN);
  const float4 x1 = *reinterpret_cast<const float4*>(xs + kk * T::BN + 4 * WN);
  const float xv[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
  float wv[TM];
#pragma unroll
  for (int r = 0; r < TM / 4; ++r) {
    const float4 q =
        *reinterpret_cast<const float4*>(ws + kk * T::WS + 4 * T::WM * r);
    wv[4 * r] = q.x;
    wv[4 * r + 1] = q.y;
    wv[4 * r + 2] = q.z;
    wv[4 * r + 3] = q.w;
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
}

// Grid: (pixel tiles, M tiles, B * G); dynamic shared memory: stages *
// STAGE floats.
template <int TM, int WN, int WARPS_M, int WARPS_N, int BK>
__global__ void __launch_bounds__(
    Tile<TM, WN, WARPS_M, WARPS_N, BK>::THREADS,
    Tile<TM, WN, WARPS_M, WARPS_N, BK>::MIN_BLOCKS)
conv1x1g_kernel(const Args a) {
  using T = Tile<TM, WN, WARPS_M, WARPS_N, BK>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int tm = lane / WN;
  const int tn = lane % WN;
  // this thread's first channel and pixel within the block's tile
  const int mb = (warp % WARPS_M) * TM * T::WM + 4 * tm;
  const int nb = (warp / WARPS_M) * 8 * WN + 4 * tn;
  const int p0 = blockIdx.x * T::BN;
  const int m0 = blockIdx.y * T::BM;
  const int g = blockIdx.z % a.G;
  const int b = blockIdx.z / a.G;
  const float* xg = a.x + b * a.xsb + static_cast<long long>(g) * a.K * a.xsc;
  const float* wg = a.w + static_cast<long long>(g) * a.M * a.K;
  const int chunks = (a.K + BK - 1) / BK;
  const int stages = a.stages;

  float acc[TM][8];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < stages - 1; ++s) {
    if (s < chunks)
      load_chunk<T>(smem + s * T::STAGE, a, xg, wg, p0, m0, s * BK, tid);
    cp_async_commit();
  }

  for (int c = 0; c < chunks; ++c) {
    cp_async_wait(stages - 2);       // chunk c has landed (this thread's)
    __syncthreads();                 // everyone's, and chunk c-1 is done
    const int next = c + stages - 1;
    if (next < chunks)
      load_chunk<T>(smem + (next % stages) * T::STAGE, a, xg, wg, p0, m0,
                    next * BK, tid);
    cp_async_commit();

    const float* xs = smem + (c % stages) * T::STAGE + nb;
    const float* ws = smem + (c % stages) * T::STAGE + BK * T::BN + mb;
    const int kn = min(BK, a.K - c * BK);
    if (kn == BK) {
      // a whole chunk: unrolled, no branch between its rows
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) fma_row<T, TM, WN>(acc, xs, ws, kk);
    } else {
      // the last chunk's K tail
#pragma unroll 1
      for (int kk = 0; kk < kn; ++kk) fma_row<T, TM, WN>(acc, xs, ws, kk);
    }
  }
  cp_async_wait(0);

  // epilogue: bias, then straight from the registers to y's channel rows
  float* yg = a.y + b * a.ysb + static_cast<long long>(g) * a.M * a.P;
#pragma unroll
  for (int r = 0; r < TM / 4; ++r) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * r + e;
      const int m = m0 + mb + 4 * T::WM * r + e;
      if (m >= a.M) continue;
      const float bv = a.bias ? a.bias[g * a.M + m] : 0.f;
      float* yrow = yg + static_cast<long long>(m) * a.P;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int p = p0 + nb + 4 * WN * s;
        const float4 v =
            make_float4(acc[i][4 * s] + bv, acc[i][4 * s + 1] + bv,
                        acc[i][4 * s + 2] + bv, acc[i][4 * s + 3] + bv);
        if (a.vec_y) {
          if (p < a.P) *reinterpret_cast<float4*>(yrow + p) = v;
        } else {
          if (p < a.P) yrow[p] = v.x;
          if (p + 1 < a.P) yrow[p + 1] = v.y;
          if (p + 2 < a.P) yrow[p + 2] = v.z;
          if (p + 3 < a.P) yrow[p + 3] = v.w;
        }
      }
    }
  }
}

template <int TM, int WN, int WARPS_M, int WARPS_N, int BK>
int launch(const Args& a, int B, int threads, int smem, int grid_x,
           int grid_y, cudaStream_t s) {
  using T = Tile<TM, WN, WARPS_M, WARPS_N, BK>;
  if (threads != T::THREADS || grid_x != (a.P + T::BN - 1) / T::BN ||
      grid_y != (a.M + T::BM - 1) / T::BM ||
      static_cast<size_t>(smem) !=
          sizeof(float) * static_cast<size_t>(a.stages) * T::STAGE)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = conv1x1g_kernel<TM, WN, WARPS_M, WARPS_N, BK>;
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
  Args args = a;
  void* params[] = {&args};
  return static_cast<int>(cudaLaunchKernel(
      reinterpret_cast<const void*>(kernel),
      dim3(grid_x, grid_y, B * a.G), dim3(T::THREADS), params, smem, s));
}

}  // namespace

// C interface for ctypes: the plan's geometry comes from
// ops/conv1x1g.py::launch_plan and is checked here. x (B, G*K, P) with
// pixels dense and strides xsb, xsc; y (B, G*M, P) dense with batch stride
// ysb; bias G*M floats or null; w as the header says. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int conv1x1g_fwd(const void* x, const void* w, const void* bias,
                            void* y, long long xsb, long long xsc,
                            long long ysb, int B, int P, int G, int K, int M,
                            int wsm, int wsk, int m_tile, int threads,
                            int stages, int smem, int vec_x, int vec_y,
                            int grid_x, int grid_y, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (B < 1 || P < 1 || G < 1 || K < 1 || M < 1 || stages < 2 ||
      stages > MAX_STAGES || smem > SMEM_MAX || grid_y > 65535 ||
      static_cast<long long>(B) * G > 65535 ||
      !((wsm == K && wsk == 1) || (wsm == 1 && wsk == M)) ||
      (vec_x && (P % 4 != 0 || xsb % 4 != 0 || xsc % 4 != 0 ||
                 reinterpret_cast<uintptr_t>(x) % 16 != 0)) ||
      (vec_y && (P % 4 != 0 || ysb % 4 != 0 ||
                 reinterpret_cast<uintptr_t>(y) % 16 != 0)))
    return bad;
  Args a;
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const float*>(w);
  a.bias = static_cast<const float*>(bias);
  a.y = static_cast<float*>(y);
  a.xsb = xsb;
  a.xsc = xsc;
  a.ysb = ysb;
  a.P = P;
  a.G = G;
  a.K = K;
  a.M = M;
  a.wsm = wsm;
  a.wsk = wsk;
  a.vec_x = vec_x;
  a.vec_y = vec_y;
  a.stages = stages;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the kernel of the plan's M tile: ops/conv1x1g.py's TILES as <TM, WN,
  // WARPS_M, WARPS_N, BK>
#define CONV1X1G_ARGS a, B, threads, smem, grid_x, grid_y, s
  switch (m_tile) {
    case 4:
      return launch<4, 32, 1, 4, 8>(CONV1X1G_ARGS);
    case 32:
      return launch<8, 8, 1, 4, 8>(CONV1X1G_ARGS);
    case 64:
      return launch<16, 8, 1, 4, 16>(CONV1X1G_ARGS);
    case 96:
      return launch<12, 8, 2, 2, 16>(CONV1X1G_ARGS);
    case 192:
      return launch<12, 8, 4, 2, 16>(CONV1X1G_ARGS);
#undef CONV1X1G_ARGS
    default:
      return bad;
  }
}
