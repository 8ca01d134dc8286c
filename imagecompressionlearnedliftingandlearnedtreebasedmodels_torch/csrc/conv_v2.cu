// SAME 3x3 convolution as one implicit GEMM on the tensor cores: bf16
// operands, fp32 sums, NHWC in, NHWC fp32 out, zero padding.
//
// Replaces the Pallas TPU kernel of scripts/bench_pallas_v2.py::conv_v2
// (body _kernel_v2): the nine tap windows concatenated along channels and
// contracted with the (9*Cin, Cout) weight in one product of depth
// K = 9*Cin, bf16 operands, fp32 accumulation.
//
// The product here: M = B*H*W output pixels, N = Cout, K = 9*Cin, walked as
// 9 taps x Cin chunks of 16. y[b,h,w,o] = sum_{du,dv,c} x[b,h+du-1,w+dv-1,c]
// * w[3*du+dv, c, o].
//
// Bound on an H100 SXM: per output pixel 2*9*Cin*Cout flops against
// 2*Cin + 4*Cout bytes (bf16 in, fp32 out). At the flagship's wide shapes
// (Berk AE 96<->192, plc 3->243->243) that is 350..730 flop/byte, above the
// ~295 flop/byte ridge of the bf16 tensor cores: bound by operations, the
// least time is the flops over 989 TFLOP/s. The narrow ends (3->96, 96->3,
// 1->32, 32->1) are bound by bytes (over 3.35 TB/s).
//
// Design, simple and right first. The wrapper (ops/conv_v2.py) hands the
// kernel channels padded with zeros to a multiple of 16 (Cp) and the weight
// zero-padded to (9, Cp, Coutp), Coutp a multiple of the block's Cout tile,
// so every K step is whole and every staging load is one unmasked 16-byte
// vector but at the image border. One block of 8 warps owns a tile of
// TH x TW = 8 x 32 output pixels of one image and BN output channels: 64,
// or 32 where that pads Cout less (96 -> 96, not 128), or 16 where
// Cout <= 16 (the narrow 96->3 and 32->1 layers). For each chunk
// of 16 input channels it stages in shared memory the (TH+2) x (TW+2) halo
// of the chunk (zero past the image border, which gives the SAME padding)
// and the chunk's 9 x 16 x BN weights. Each warp owns two 16-pixel row
// segments of the tile (rows r and r+4) and runs, for each of the 9 taps,
// one nvcuda::wmma 16x16x16 bf16 product per segment and 16 output
// channels into fp32 accumulator fragments: the tap shifts the A operand's
// start inside the halo tile (pixels are 32 bytes apart there, so every
// start is 32-byte aligned and the leading dimension is 16 bf16 values).
// Each fragment goes out through a 16x16 staging square of its warp,
// masked at ragged H, W and Cout. Two blocks fit on an SM (at most 128
// registers a thread), so one block's staging overlaps another's products.
//
// What this design leaves on the table: loads are synchronous (no cp.async
// or TMA pipeline), every warp reloads the B fragments, mma.sync/wmma is not
// wgmma, and narrow Cin (1, 3) fills 1-3 of 16 K lanes. The fast form is a
// wgmma kernel fed by a TMA ring of halo tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int TH = 8;             // output rows per block
constexpr int TW = 32;            // output columns per block
constexpr int KC = 16;            // input channels per K step (wmma depth)
constexpr int HR = TH + 2;        // halo tile rows
constexpr int HC = TW + 2;        // halo tile columns
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MF = TH * TW / 16 / WARPS;  // 16-pixel segments per warp (2)
constexpr int LDS = 20;           // a warp's output staging square stride

// x: (B, H, W, Cp) bf16, Cp % 16 == 0; w: (9, Cp, Coutp) bf16, tap
// t = 3*du + dv, Coutp % BN == 0; y: (B, H, W, Cout) fp32.
// Grid: (tiles_h * tiles_w, Coutp / BN, B). BN = 16 * NF.
template <int NF>
__global__ void __launch_bounds__(THREADS, 2)
conv_v2_kernel(const __nv_bfloat16* __restrict__ x,
               const __nv_bfloat16* __restrict__ w, float* __restrict__ y,
               int H, int W, int Cp, int Cout, int Coutp, int tiles_w) {
  constexpr int BN = 16 * NF;      // output channels per block
  constexpr int LDB = BN + 8;      // weight row stride (bf16), multiple of 8
  __shared__ __align__(128) __nv_bfloat16 xs[HR * HC * KC];
  __shared__ __align__(128) __nv_bfloat16 ws[9 * KC * LDB];
  __shared__ __align__(128) float st[WARPS][16 * LDS];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int w0 = (blockIdx.x % tiles_w) * TW;
  const int co0 = blockIdx.y * BN;
  const __nv_bfloat16* xb = x + (size_t)blockIdx.z * H * W * Cp;
  const int wr = warp / (TW / 16);          // first tile row of this warp
  const int wc = (warp % (TW / 16)) * 16;   // and its first column

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MF][NF];
#pragma unroll
  for (int m = 0; m < MF; ++m)
#pragma unroll
    for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[m][j], 0.f);

  for (int c0 = 0; c0 < Cp; c0 += KC) {
    for (int e = tid; e < HR * HC * 2; e += THREADS) {
      const int pix = e >> 1;
      const int hh = h0 - 1 + pix / HC;
      const int ww = w0 - 1 + pix % HC;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (hh >= 0 && hh < H && ww >= 0 && ww < W)
        v = *reinterpret_cast<const uint4*>(
            xb + ((size_t)hh * W + ww) * Cp + c0 + (e & 1) * 8);
      *reinterpret_cast<uint4*>(xs + e * 8) = v;
    }
    for (int e = tid; e < 9 * KC * BN / 8; e += THREADS) {
      const int n8 = e % (BN / 8);
      const int row = e / (BN / 8);           // t * KC + k
      const int t = row / KC;
      const int k = row % KC;
      *reinterpret_cast<uint4*>(ws + row * LDB + n8 * 8) =
          *reinterpret_cast<const uint4*>(
              w + ((size_t)t * Cp + c0 + k) * Coutp + co0 + n8 * 8);
    }
    __syncthreads();

#pragma unroll 1
    for (int t = 0; t < 9; ++t) {
      const int du = t / 3;
      const int dv = t % 3;
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[MF];
#pragma unroll
      for (int m = 0; m < MF; ++m)
        // 16 consecutive pixels of halo row (tile row + du) from column
        // wc + dv: row i of A is pixel i, its 16 channels contiguous
        wmma::load_matrix_sync(
            a[m], xs + ((wr + m * (TH / MF) + du) * HC + wc + dv) * KC, KC);
#pragma unroll
      for (int j = 0; j < NF; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> bw;
        wmma::load_matrix_sync(bw, ws + t * KC * LDB + j * 16, LDB);
#pragma unroll
        for (int m = 0; m < MF; ++m) wmma::mma_sync(acc[m][j], a[m], bw,
                                                    acc[m][j]);
      }
    }
    __syncthreads();
  }

  float* sq = st[warp];
#pragma unroll
  for (int m = 0; m < MF; ++m) {
    const int hh = h0 + wr + m * (TH / MF);
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      wmma::store_matrix_sync(sq, acc[m][j], LDS, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int ww = w0 + wc + e / 16;
        const int co = co0 + j * 16 + e % 16;
        if (hh < H && ww < W && co < Cout)
          y[(((size_t)blockIdx.z * H + hh) * W + ww) * Cout + co] =
              sq[(e / 16) * LDS + e % 16];
      }
      __syncwarp();
    }
  }
}

}  // namespace

// C interface for ctypes: Cp, Coutp and the Cout tile bn (16, 32 or 64)
// as ops/conv_v2.py pads them (Cp a multiple of 16, Coutp of bn). Returns
// the cudaError_t of the launch (0 on success, cudaErrorInvalidValue for
// another tile).
extern "C" int conv_v2_fwd(const void* x, const void* w, void* y, int B,
                           int H, int W, int Cp, int Cout, int Coutp, int bn,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const __nv_bfloat16*>(w);
  float* out = static_cast<float*>(y);
  const int tiles_w = (W + TW - 1) / TW;
  const int tiles_h = (H + TH - 1) / TH;
  const dim3 grid(tiles_h * tiles_w, Coutp / bn, B);
  if (bn == 16)
    conv_v2_kernel<1><<<grid, THREADS, 0, s>>>(xp, wp, out, H, W, Cp, Cout,
                                               Coutp, tiles_w);
  else if (bn == 32)
    conv_v2_kernel<2><<<grid, THREADS, 0, s>>>(xp, wp, out, H, W, Cp, Cout,
                                               Coutp, tiles_w);
  else if (bn == 64)
    conv_v2_kernel<4><<<grid, THREADS, 0, s>>>(xp, wp, out, H, W, Cp, Cout,
                                               Coutp, tiles_w);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
