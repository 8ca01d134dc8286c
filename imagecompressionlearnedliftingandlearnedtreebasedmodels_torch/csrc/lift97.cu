// CDF 9/7 lifting ladder on fp32 planes with periodic ends: one launch
// lifts a whole 2-D level (rows, then the columns of each row band), or
// one axis.
//
// Replaces the Pallas TPU kernels of the JAX package's
// scripts/bench_pallas.py: lift97_rows_fused (body _ladder_kernel, the
// analysis ladder) and ilift97_rows_fused (body _inverse_kernel, its exact
// inverse). Two kernels, one per direction, each templated on the lifted
// axes (H, W or both) and the tile:
//
//   analysis:  per axis, split into (s, d) pairs -> 4 steps -> s *= g_lo,
//              d *= g_hi; H first, then W on each row band
//   synthesis: per axis, s = lo * g_lo, d = hi * g_hi -> 4 steps ->
//              interleave; W first on each row band, then H
//
// A step is P (d_i += c * (s_i + s_{i+1})) or U (s_i += c * (d_{i-1} +
// d_i)), indices modulo the number of pairs. The caller passes the four
// (kind, coefficient) steps and the two gains, so the analysis kernel runs
// the forward ladder F and the adjoint of the inverse, and the synthesis
// kernel the inverse I and the adjoint of the forward (see ops/lift97.py).
// Every value is the plain ladder's expression, so the results differ from
// it only by FMA contraction.
//
// Layout: x is (planes, h, w), row-major. A band (ph, pw) -- ph the parity
// of the H pass (0 low, 1 high), pw that of the W pass; an axis that is
// not lifted has parity 0 -- is (planes, oh, ow) at its own base pointer
// and plane stride, so the level's detail pack (B, 3C, h/2, w/2), channel
// 3c + s with s = (LH, HL, HH), is written and read in place as three
// bands of plane stride 3 oh ow.
//
// Bound on an H100: a level reads each fp32 sample once and writes it
// once, 8 bytes, and does ~14 flops a sample (7 an axis), under 2 flops a
// byte where fp32's ridge is 20 (67 TFLOP/s over 3.35 TB/s): bytes bound
// it.
//
// Design, against what held the one-axis kernels back:
// - One launch a level: the row bands never go through device memory.
// - A block owns TR x TC samples of one plane and stages them with the
//   ladder's reach -- 2 pairs each side of a lifted axis, read off the
//   plain ladder in ops/lift97.py and tests/test_torch_lift97_plan.py --
//   by cp.async, 16-byte chunks where the rows allow it (8-byte ones for
//   the 2-pair reach of a band), 4-byte ones otherwise. The periodic wrap
//   is a compare per chunk; only a chunk outside the plane (a reach or a
//   ragged tile) takes a 32-bit modulo.
// - A persistent grid walks the tiles; a ring of two stages loads the next
//   tile while the block computes this one.
// - The ladders run in registers: a thread takes a staged column (H) or
//   row (W) whole, runs the four steps over it in fully unrolled loops and
//   writes it back once, gains folded into the analysis's write and the
//   synthesis's read. Rows are read and written as float4: the row pitch
//   is an odd number of 16-byte units, so the 8 rows of a quarter warp
//   fall on distinct banks; columns are read one float a thread, on
//   neighbouring banks. Three __syncthreads a tile for a level (two for
//   one axis), none per ladder step.
// - Offsets inside a plane are 32-bit; a tile's plane base is computed
//   once. Stores are float4 where the band width allows.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int STEPS = 4;
constexpr int REACH = 2;           // pairs a lifted axis stages each side
constexpr int BLOCK_SMEM = 232448; // dynamic shared memory a block may use

struct Ladder {
  int kind[STEPS];    // 0 = P (update d from s), 1 = U (update s from d)
  float coef[STEPS];
  float g_lo, g_hi;
};

struct Bands {        // band (ph, pw) at index 2 * ph + pw
  float* ptr[4];
  long long plane[4];  // elements from one plane to the next
};

struct Geometry {
  int h, w;           // a plane of x
  int oh, ow;         // a plane of a band
  int tiles_w, tiles_plane, tiles;
  int vec;            // 16-byte chunks and float4 stores
};

__device__ __forceinline__ int wrap(int v, int n) {
  if (static_cast<unsigned>(v) >= static_cast<unsigned>(n)) {
    v %= n;
    if (v < 0) v += n;
  }
  return v;
}

template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(BYTES));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// band (ph, pw) of four pointers, by selects (no local-memory indexing)
template <class P>
__device__ __forceinline__ P band(const P (&b)[4], int ph, int pw) {
  return ph ? (pw ? b[3] : b[2]) : (pw ? b[1] : b[0]);
}

// a[i] = v where i (a constant after unrolling) lies in the array
template <int N>
__device__ __forceinline__ void put(float (&a)[N], int i, float v) {
  if (i >= 0 && i < N) a[i] = v;
}

// The four steps over NP pairs in registers. A P step leaves d[NP-1], a U
// step s[0] as they were: they lack a neighbour in the window, and the
// REACH pairs at each end are never written out.
template <int NP>
__device__ __forceinline__ void run_ladder(float (&s)[NP], float (&d)[NP],
                                           const Ladder& L) {
#pragma unroll
  for (int t = 0; t < STEPS; ++t) {
    const float c = L.coef[t];
    if (L.kind[t] == 0) {
#pragma unroll
      for (int i = 0; i + 1 < NP; ++i) d[i] += c * (s[i] + s[i + 1]);
    } else {
#pragma unroll
      for (int i = NP - 1; i > 0; --i) s[i] += c * (d[i - 1] + d[i]);
    }
  }
}

template <bool SYN, bool LH, bool LW, int TR, int TC>
struct Tile {
  static_assert(TC % 16 == 0 && TR % 2 == 0, "tile");
  static constexpr int RH = LH ? 2 * REACH : 0;  // samples staged above/below
  static constexpr int RW = LW ? 2 * REACH : 0;
  static constexpr int SR = TR + 2 * RH;         // staged rows
  // synthesis along W: each band's TC/2 pairs and the reach in a quadrant
  // of QW columns, pair -REACH at column 2 so that pair 0 is 16-byte aligned
  static constexpr int QW = TC / 2 + 4 * REACH;
  static constexpr int SW = (SYN && LW) ? 2 * QW : TC + 2 * RW;
  static constexpr int PITCH = (SW / 4) % 2 ? SW : SW + 4;  // odd float4s
  static constexpr int STAGE = SR * PITCH;
  static constexpr int SMEM = 2 * STAGE * 4;
};

// --- staging ----------------------------------------------------------------

// x's rows r0 - RH .. r0 + TR + RH, columns c0 - RW .. c0 + TC + RW, in
// chunks of CH floats.
template <class T, int CH>
__device__ void stage_x(float* buf, const float* __restrict__ xp, int r0,
                        int c0, const Geometry& g) {
  constexpr int N = T::SW / CH;
  for (int e = threadIdx.x; e < T::SR * N; e += THREADS) {
    const int k = e / N, q = e - k * N;
    const int r = wrap(r0 - T::RH + k, g.h);
    const int c = wrap(c0 - T::RW + CH * q, g.w);
    cp_async<4 * CH>(buf + k * T::PITCH + CH * q, xp + r * g.w + c);
  }
}

// The bands' pairs that the tile's samples reach: with H lifted, staged
// rows [0, SR/2) are the low band's pairs i0 - REACH .., [SR/2, SR) the
// high band's; with W lifted, each band's pairs j0 - REACH .. j0 + TC/2 +
// REACH sit in its quadrant from column 2.
template <class T, bool LH, bool LW, int TR, int TC, int CH>
__device__ void stage_bands(float* buf, const float* const (&src)[4], int r0,
                            int c0, const Geometry& g) {
  constexpr int SR = T::SR, QW = T::QW;
  const int i0 = LH ? r0 / 2 : r0, j0 = LW ? c0 / 2 : c0;
  auto row_of = [&](int k, int& ph) {
    ph = (LH && k >= SR / 2) ? 1 : 0;
    return wrap(i0 - (LH ? REACH : 0) + k - ph * (SR / 2), g.oh);
  };
  if constexpr (!LW) {
    constexpr int N = TC / CH;
    for (int e = threadIdx.x; e < SR * N; e += THREADS) {
      const int k = e / N, q = e - k * N;
      int ph;
      const int r = row_of(k, ph);
      cp_async<4 * CH>(buf + k * T::PITCH + q * CH,
                       band(src, ph, 0) + r * g.ow + wrap(j0 + q * CH, g.ow));
    }
  } else if constexpr (CH == 4) {
    // each band's TC/8 16-byte chunks, then its reach as two 8-byte chunks
    // a row (left, right), in separate loops so that no warp diverges
    constexpr int NB = TC / 8, N = 2 * NB;
    for (int e = threadIdx.x; e < SR * N; e += THREADS) {
      const int k = e / N, q = e - k * N;
      const int pw = q >= NB ? 1 : 0, jj = 4 * (q - pw * NB);
      int ph;
      const int r = row_of(k, ph);
      cp_async<16>(buf + k * T::PITCH + pw * QW + 2 * REACH + jj,
                   band(src, ph, pw) + r * g.ow + wrap(j0 + jj, g.ow));
    }
    for (int e = threadIdx.x; e < SR * 4; e += THREADS) {
      const int k = e >> 2, pw = (e >> 1) & 1, right = e & 1;
      const int jj = right ? TC / 2 : -REACH;
      int ph;
      const int r = row_of(k, ph);
      cp_async<8>(buf + k * T::PITCH + pw * QW + 2 * REACH + jj,
                  band(src, ph, pw) + r * g.ow + wrap(j0 + jj, g.ow));
    }
  } else {
    constexpr int NB = TC / 2 + 2 * REACH, N = 2 * NB;
    for (int e = threadIdx.x; e < SR * N; e += THREADS) {
      const int k = e / N, q = e - k * N;
      const int pw = q >= NB ? 1 : 0, jj = q - pw * NB - REACH;
      int ph;
      const int r = row_of(k, ph);
      cp_async<4>(buf + k * T::PITCH + pw * QW + 2 * REACH + jj,
                  band(src, ph, pw) + r * g.ow + wrap(j0 + jj, g.ow));
    }
  }
}

// --- the ladders in registers ---------------------------------------------

// Analysis along H: staged column c, SR samples -> the low band's TR/2
// pairs in rows [0, TR/2), the high band's in [TR/2, TR).
template <class T, int TR>
__device__ void analysis_h(float* buf, int cols, const Ladder& L) {
  constexpr int NP = T::SR / 2, P = T::PITCH;
  for (int c = threadIdx.x; c < cols; c += THREADS) {
    float s[NP], d[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      s[i] = buf[(2 * i) * P + c];
      d[i] = buf[(2 * i + 1) * P + c];
    }
    run_ladder(s, d, L);
#pragma unroll
    for (int i = 0; i < TR / 2; ++i) {
      buf[i * P + c] = s[i + REACH] * L.g_lo;
      buf[(TR / 2 + i) * P + c] = d[i + REACH] * L.g_hi;
    }
  }
}

// Analysis along W: staged row r, TC + 4 REACH samples -> the low band's
// TC/2 pairs in columns [0, TC/2), the high band's in [TC/2, TC).
template <class T, int TC>
__device__ void analysis_w(float* buf, int rows, const Ladder& L) {
  constexpr int NP = TC / 2 + 2 * REACH;
  for (int r = threadIdx.x; r < rows; r += THREADS) {
    float* row = buf + r * T::PITCH;
    float s[NP], d[NP];
#pragma unroll
    for (int q = 0; q < NP / 2; ++q) {
      const float4 v = ld4(row + 4 * q);
      s[2 * q] = v.x;
      d[2 * q] = v.y;
      s[2 * q + 1] = v.z;
      d[2 * q + 1] = v.w;
    }
    run_ladder(s, d, L);
    const float gl = L.g_lo, gh = L.g_hi;
#pragma unroll
    for (int q = 0; q < TC / 8; ++q) {
      const int j = 4 * q + REACH;
      st4(row + 4 * q, s[j] * gl, s[j + 1] * gl, s[j + 2] * gl,
          s[j + 3] * gl);
      st4(row + TC / 2 + 4 * q, d[j] * gh, d[j + 1] * gh, d[j + 2] * gh,
          d[j + 3] * gh);
    }
  }
}

// Synthesis along W: staged row r, each band's TC/2 + 2 REACH pairs from
// its quadrant -> TC interleaved samples in columns [0, TC).
template <class T, int TC>
__device__ void synthesis_w(float* buf, int rows, const Ladder& L) {
  constexpr int NP = TC / 2 + 2 * REACH, QW = T::QW;
  for (int r = threadIdx.x; r < rows; r += THREADS) {
    float* row = buf + r * T::PITCH;
    float s[NP], d[NP];
#pragma unroll
    for (int q = 0; q < QW / 4; ++q) {
      const float4 a = ld4(row + 4 * q), b = ld4(row + QW + 4 * q);
      const int i = 4 * q - REACH;   // s/d index of the float4's first
      put(s, i, a.x * L.g_lo);
      put(s, i + 1, a.y * L.g_lo);
      put(s, i + 2, a.z * L.g_lo);
      put(s, i + 3, a.w * L.g_lo);
      put(d, i, b.x * L.g_hi);
      put(d, i + 1, b.y * L.g_hi);
      put(d, i + 2, b.z * L.g_hi);
      put(d, i + 3, b.w * L.g_hi);
    }
    run_ladder(s, d, L);
#pragma unroll
    for (int j = 0; j < TC / 2; j += 2)
      st4(row + 2 * j, s[j + REACH], d[j + REACH], s[j + REACH + 1],
          d[j + REACH + 1]);
  }
}

// Synthesis along H: staged column c, the low band's SR/2 pairs in rows
// [0, SR/2) and the high band's in [SR/2, SR) -> TR interleaved samples in
// rows [0, TR).
template <class T, int TR>
__device__ void synthesis_h(float* buf, int cols, const Ladder& L) {
  constexpr int NP = T::SR / 2, P = T::PITCH;
  for (int c = threadIdx.x; c < cols; c += THREADS) {
    float s[NP], d[NP];
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      s[i] = buf[i * P + c] * L.g_lo;
      d[i] = buf[(NP + i) * P + c] * L.g_hi;
    }
    run_ladder(s, d, L);
#pragma unroll
    for (int i = 0; i < TR / 2; ++i) {
      buf[(2 * i) * P + c] = s[i + REACH];
      buf[(2 * i + 1) * P + c] = d[i + REACH];
    }
  }
}

// Coalesced stores of the tile's TR rows x TC columns from shared memory
// in chunks of CH floats: x's samples (synthesis), or each band's rows
// (analysis: band (ph, pw) in rows [ph TR/2, ..) and columns [pw TC/2, ..)
// of a lifted axis).
template <class T, bool SYN, bool LH, bool LW, int TR, int TC, int CH>
__device__ void store_tile(const float* buf, float* __restrict__ x,
                           const Bands& bands, const Geometry& g, int p,
                           int r0, int c0) {
  constexpr int N = TC / CH;
  float* dst[4];
  if constexpr (SYN) {
#pragma unroll
    for (int b = 0; b < 4; ++b) dst[b] = x + static_cast<long long>(p) * g.h * g.w;
  } else {
#pragma unroll
    for (int b = 0; b < 4; ++b) dst[b] = bands.ptr[b] + p * bands.plane[b];
  }
  const int i0 = (!SYN && LH) ? r0 / 2 : r0, j0 = (!SYN && LW) ? c0 / 2 : c0;
  const int oh = SYN ? g.h : g.oh, ow = SYN ? g.w : g.ow;
  for (int e = threadIdx.x; e < TR * N; e += THREADS) {
    const int r = e / N, col = (e - r * N) * CH;
    const int ph = (!SYN && LH && r >= TR / 2) ? 1 : 0;
    const int pw = (!SYN && LW && col >= TC / 2) ? 1 : 0;
    const int i = i0 + r - ph * (TR / 2), j = j0 + col - pw * (TC / 2);
    if (i >= oh || j >= ow) continue;
    float* to = band(dst, ph, pw) + i * ow + j;
    const float* from = buf + r * T::PITCH + col;
    if constexpr (CH == 4)
      *reinterpret_cast<float4*>(to) = ld4(from);
    else
      *to = *from;
  }
}

// --- the kernels --------------------------------------------------------------

// Analysis: x (planes, h, w) -> the bands. Synthesis: the bands -> x.
template <bool SYN, bool LH, bool LW, int TR, int TC>
__global__ void __launch_bounds__(THREADS, 4)
level_kernel(float* __restrict__ x, Bands bands, Geometry g, Ladder L) {
  using T = Tile<SYN, LH, LW, TR, TC>;
  extern __shared__ __align__(16) float smem[];

  // a tile's plane and first row and column
  auto locate = [&](int tile, int& p, int& r0, int& c0) {
    p = tile / g.tiles_plane;
    const int rem = tile - p * g.tiles_plane;
    const int tr = rem / g.tiles_w;
    r0 = tr * TR;
    c0 = (rem - tr * g.tiles_w) * TC;
  };
  auto stage = [&](int tile, float* buf) {
    int p, r0, c0;
    locate(tile, p, r0, c0);
    if constexpr (SYN) {
      const float* src[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) src[b] = bands.ptr[b] + p * bands.plane[b];
      if (g.vec)
        stage_bands<T, LH, LW, TR, TC, 4>(buf, src, r0, c0, g);
      else
        stage_bands<T, LH, LW, TR, TC, 1>(buf, src, r0, c0, g);
    } else {
      const float* xp = x + static_cast<long long>(p) * g.h * g.w;
      if (g.vec)
        stage_x<T, 4>(buf, xp, r0, c0, g);
      else
        stage_x<T, 1>(buf, xp, r0, c0, g);
    }
    cp_commit();
  };

  int tile = blockIdx.x;
  if (tile < g.tiles) stage(tile, smem);
  for (int it = 0; tile < g.tiles; ++it, tile += gridDim.x) {
    float* buf = smem + (it & 1) * T::STAGE;
    cp_wait_all();
    __syncthreads();   // the tile has landed; the other stage is free
    if (tile + static_cast<int>(gridDim.x) < g.tiles)
      stage(tile + gridDim.x, smem + ((it + 1) & 1) * T::STAGE);

    if constexpr (!SYN) {
      if constexpr (LH) analysis_h<T, TR>(buf, T::SW, L);
      if constexpr (LH && LW) __syncthreads();
      if constexpr (LW) analysis_w<T, TC>(buf, TR, L);
    } else {
      if constexpr (LW) synthesis_w<T, TC>(buf, T::SR, L);
      if constexpr (LH && LW) __syncthreads();
      if constexpr (LH) synthesis_h<T, TR>(buf, TC, L);
    }
    __syncthreads();

    int p, r0, c0;
    locate(tile, p, r0, c0);
    if (g.vec)
      store_tile<T, SYN, LH, LW, TR, TC, 4>(buf, x, bands, g, p, r0, c0);
    else
      store_tile<T, SYN, LH, LW, TR, TC, 1>(buf, x, bands, g, p, r0, c0);
  }
}

// --- dispatch ---------------------------------------------------------------

using KernelFn = void (*)(float*, Bands, Geometry, Ladder);

struct Entry {
  int synth, axes, tr, tc;   // axes: 1 = H, 2 = W, 3 = both
  KernelFn fn;
  int smem;
};

template <bool SYN, int AXES, int TR, int TC>
constexpr Entry entry() {
  constexpr bool LH = (AXES & 1) != 0, LW = (AXES & 2) != 0;
  return {SYN, AXES, TR, TC, level_kernel<SYN, LH, LW, TR, TC>,
          Tile<SYN, LH, LW, TR, TC>::SMEM};
}

// ops/lift97.py::TILES holds the same (axes, rows, columns); a test
// compares the two.
#define LIFT97_TILES(SYN)                                                   \
  entry<SYN, 3, 64, 64>(), entry<SYN, 3, 32, 32>(), entry<SYN, 3, 16, 16>(), \
      entry<SYN, 1, 32, 128>(), entry<SYN, 1, 16, 64>(),                    \
      entry<SYN, 2, 128, 64>(), entry<SYN, 2, 64, 16>()

const Entry ENTRIES[] = {LIFT97_TILES(false), LIFT97_TILES(true)};
constexpr int N_ENTRIES = sizeof(ENTRIES) / sizeof(ENTRIES[0]);
bool smem_set[N_ENTRIES];

}  // namespace

// What a launch needs besides its pointers; ops/lift97.py::LaunchArgs
// mirrors it and builds one per direction, geometry and ladder. synth 0
// runs the analysis (x -> bands), 1 the synthesis (bands -> x); axes 1
// lifts H, 2 W, 3 both; (tile_r, tile_c) one of the compiled tiles; vec 1
// for 16-byte chunks (the caller checks widths and alignment); grid the
// persistent grid; x is (planes, h, w). kinds: 0 = P, 1 = U. Band (ph, pw)
// at index 2 ph + pw lies `offset` elements past base pointer `base` (0 or
// 1; -1 for a band of an axis that is not lifted), `stride` elements from
// one plane to the next.
struct LaunchArgs {
  int synth, axes, tile_r, tile_c, vec, grid, planes, h, w;
  int kinds[STEPS];
  float coefs[STEPS];
  float g_lo, g_hi;
  int base[4];
  long long offset[4];
  long long stride[4];
};

// C interface for ctypes: one launch of the level kernel on x and the two
// base pointers of the bands (LL and the detail pack of a level, or the
// low and high halves of one axis). Returns the cudaError_t of the launch
// (0 on success).
extern "C" int lift97_level(const LaunchArgs* a, void* x, void* base0,
                            void* base1, void* stream) {
  const int axes = a->axes, h = a->h, w = a->w;
  const bool lh = axes & 1, lw = (axes & 2) != 0;
  if (axes < 1 || axes > 3 || a->planes < 1 || h < 1 || w < 1 ||
      a->grid < 1 || (lh && h % 2) || (lw && w % 2) ||
      static_cast<long long>(h) * w >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  int k = 0;
  while (k < N_ENTRIES &&
         !(ENTRIES[k].synth == (a->synth != 0) && ENTRIES[k].axes == axes &&
           ENTRIES[k].tr == a->tile_r && ENTRIES[k].tc == a->tile_c))
    ++k;
  if (k == N_ENTRIES) return static_cast<int>(cudaErrorInvalidValue);
  Ladder L;
  for (int t = 0; t < STEPS; ++t) {
    if (a->kinds[t] != 0 && a->kinds[t] != 1)
      return static_cast<int>(cudaErrorInvalidValue);
    L.kind[t] = a->kinds[t];
    L.coef[t] = a->coefs[t];
  }
  L.g_lo = a->g_lo;
  L.g_hi = a->g_hi;
  Bands b;
  float* bases[2] = {static_cast<float*>(base0), static_cast<float*>(base1)};
  for (int i = 0; i < 4; ++i) {
    b.ptr[i] = a->base[i] < 0 ? nullptr : bases[a->base[i] & 1] + a->offset[i];
    b.plane[i] = a->stride[i];
  }
  Geometry g;
  g.h = h;
  g.w = w;
  g.oh = lh ? h / 2 : h;
  g.ow = lw ? w / 2 : w;
  g.tiles_w = (w + a->tile_c - 1) / a->tile_c;
  const long long per =
      static_cast<long long>((h + a->tile_r - 1) / a->tile_r) * g.tiles_w;
  if (per * a->planes >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  g.tiles_plane = static_cast<int>(per);
  g.tiles = static_cast<int>(per * a->planes);
  g.vec = a->vec != 0;
  const Entry& e = ENTRIES[k];
  if (e.smem > BLOCK_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  if (!smem_set[k]) {
    const cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(e.fn),
        cudaFuncAttributeMaxDynamicSharedMemorySize, e.smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[k] = true;
  }
  float* xp = static_cast<float*>(x);
  void* args[] = {&xp, &b, &g, &L};
  // cudaLaunchKernel reports this launch's own refusal, where
  // cudaGetLastError could return an error another library left behind
  return static_cast<int>(cudaLaunchKernel(
      reinterpret_cast<const void*>(e.fn), dim3(a->grid), dim3(THREADS), args,
      e.smem, static_cast<cudaStream_t>(stream)));
}
