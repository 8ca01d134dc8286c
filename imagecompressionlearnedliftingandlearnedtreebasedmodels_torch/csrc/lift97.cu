// CDF 9/7 lifting ladder along one axis of an fp32 tensor, periodic ends.
//
// Replaces the Pallas TPU kernels of the JAX package's
// scripts/bench_pallas.py: lift97_rows_fused (body _ladder_kernel, the
// analysis ladder) and ilift97_rows_fused (body _inverse_kernel, its exact
// inverse). Two kernels, one step list each:
//
//   analysis:  split into (s, d) pairs -> 4 steps -> s *= g_lo, d *= g_hi
//   synthesis: s = lo * g_lo, d = hi * g_hi -> 4 steps -> interleave
//
// A step is P (d_i += c * (s_i + s_{i+1})) or U (s_i += c * (d_{i-1} +
// d_i)), indices modulo the number of pairs m. The caller passes the four
// (kind, coefficient) steps and the two gains, so the analysis kernel runs
// the forward ladder F and the adjoint of the inverse, and the synthesis
// kernel runs the inverse I and the adjoint of the forward (the ladder is
// linear; its transpose has the same structure, see ops/lift97.py).
//
// Layout: the tensor is addressed as (outer, n, inner), the lifted axis of
// even length n = 2m with stride `inner`; outputs (outer, m, inner). No
// axis is moved: on the H axis of NCHW (inner = W) neighbouring threads
// take neighbouring columns; on the W axis (inner = 1) they take
// neighbouring samples of a line. Each variant keeps its fast index
// innermost in shared memory too.
//
// Bound on an H100: a ladder pass reads each fp32 sample once and writes
// it once and does ~7 flops a sample, under 1 flop a byte where fp32's
// ridge is 20 (67 TFLOP/s over 3.35 TB/s), so bytes bound it: 8 bytes a
// sample at 3.35 TB/s.
//
// Design: simple and right first. A block owns TC lines x TP pairs and
// stages them in shared memory with HALO pairs more on each side, wrapped
// modulo m at the periodic ends (so any even n works, and a line never has
// to fit in shared memory whole). Each step reads neighbours at most one
// pair away, so after the four steps the values HALO = 4 pairs in from the
// window's ends are exact; only the TP centre pairs are written. Every
// intermediate is the plain ladder's expression, so the results differ
// from it only by FMA contraction. What it leaves on the table: the halo is
// read twice (12.5 % more reads at TP = 64), loads are synchronous, and
// the four steps of an analysis and a synthesis are not fused across the
// two axes of a level (each 2-D level is three launches).

#include <cuda_runtime.h>

namespace {

constexpr int HALO = 4;     // pairs staged beyond each side of a tile
constexpr int STEPS = 4;    // steps of a ladder
constexpr int THREADS = 256;

struct Ladder {
  int kind[STEPS];    // 0 = P (update d from s), 1 = U (update s from d)
  float coef[STEPS];
  float g_lo, g_hi;
};

// Shared-memory index of pair j of line c; the fast index is innermost.
template <bool CONTIG, int TC, int WP>
__device__ __forceinline__ int sidx(int j, int c) {
  return CONTIG ? c * WP + j : j * TC + c;
}

// Element e of a (lines TC) x (pairs P) x (parity 2) iteration, with the
// fast index first: along the line for CONTIG, across lines otherwise.
// `par_fast` puts the parity first (interleaved x) instead of last.
template <bool CONTIG, int TC, int P>
__device__ __forceinline__ void decode(int e, bool par_fast, int& c, int& j,
                                       int& par) {
  if (par_fast) {
    par = e & 1;
    e >>= 1;
  } else {
    par = e / (TC * P);
    e -= par * TC * P;
  }
  if (CONTIG) {
    j = e % P;
    c = e / P;
  } else {
    c = e % TC;
    j = e / TC;
  }
}

__device__ __forceinline__ int wrap(int q, int m) {
  q %= m;
  return q < 0 ? q + m : q;
}

template <bool CONTIG, int TC, int WP>
__device__ void run_steps(float* s, float* d, const Ladder& L) {
  for (int t = 0; t < STEPS; ++t) {
    const float cf = L.coef[t];
    // pair WP-1 of a P step and pair 0 of a U step lack a neighbour; they
    // lie in the halo and are never written out
    for (int e = threadIdx.x; e < (WP - 1) * TC; e += THREADS) {
      int c, j, par;
      decode<CONTIG, TC, WP - 1>(e, false, c, j, par);
      if (L.kind[t] == 0) {
        d[sidx<CONTIG, TC, WP>(j, c)] +=
            cf * (s[sidx<CONTIG, TC, WP>(j, c)] +
                  s[sidx<CONTIG, TC, WP>(j + 1, c)]);
      } else {
        s[sidx<CONTIG, TC, WP>(j + 1, c)] +=
            cf * (d[sidx<CONTIG, TC, WP>(j, c)] +
                  d[sidx<CONTIG, TC, WP>(j + 1, c)]);
      }
    }
    __syncthreads();
  }
}

// x: (outer, 2m, inner) -> lo, hi: (outer, m, inner). Grid: (ceil(lines /
// TC), ceil(m / TP)), lines = outer * inner.
template <bool CONTIG, int TC, int TP>
__global__ void __launch_bounds__(THREADS)
analysis_kernel(const float* __restrict__ x, float* __restrict__ lo,
                float* __restrict__ hi, long long lines, int m,
                long long inner, Ladder L) {
  constexpr int WP = TP + 2 * HALO;
  __shared__ float s[WP * TC];
  __shared__ float d[WP * TC];
  const long long line0 = (long long)blockIdx.x * TC;
  const int p0 = blockIdx.y * TP;

  for (int e = threadIdx.x; e < 2 * WP * TC; e += THREADS) {
    int c, j, par;
    decode<CONTIG, TC, WP>(e, CONTIG, c, j, par);
    const long long line = line0 + c;
    float v = 0.f;
    if (line < lines) {
      const long long o = line / inner, ci = line % inner;
      const int q = wrap(p0 - HALO + j, m);
      v = x[(o * 2 * m + 2 * q + par) * inner + ci];
    }
    (par ? d : s)[sidx<CONTIG, TC, WP>(j, c)] = v;
  }
  __syncthreads();

  run_steps<CONTIG, TC, WP>(s, d, L);

  for (int e = threadIdx.x; e < 2 * TP * TC; e += THREADS) {
    int c, j, par;
    decode<CONTIG, TC, TP>(e, false, c, j, par);
    const long long line = line0 + c;
    const int p = p0 + j;
    if (line < lines && p < m) {
      const long long o = line / inner, ci = line % inner;
      const int k = sidx<CONTIG, TC, WP>(j + HALO, c);
      const long long at = (o * m + p) * inner + ci;
      if (par)
        hi[at] = d[k] * L.g_hi;
      else
        lo[at] = s[k] * L.g_lo;
    }
  }
}

// lo, hi: (outer, m, inner) -> x: (outer, 2m, inner).
template <bool CONTIG, int TC, int TP>
__global__ void __launch_bounds__(THREADS)
synthesis_kernel(const float* __restrict__ lo, const float* __restrict__ hi,
                 float* __restrict__ x, long long lines, int m,
                 long long inner, Ladder L) {
  constexpr int WP = TP + 2 * HALO;
  __shared__ float s[WP * TC];
  __shared__ float d[WP * TC];
  const long long line0 = (long long)blockIdx.x * TC;
  const int p0 = blockIdx.y * TP;

  for (int e = threadIdx.x; e < 2 * WP * TC; e += THREADS) {
    int c, j, par;
    decode<CONTIG, TC, WP>(e, false, c, j, par);
    const long long line = line0 + c;
    float v = 0.f;
    if (line < lines) {
      const long long o = line / inner, ci = line % inner;
      const int q = wrap(p0 - HALO + j, m);
      const long long at = (o * m + q) * inner + ci;
      v = par ? hi[at] * L.g_hi : lo[at] * L.g_lo;
    }
    (par ? d : s)[sidx<CONTIG, TC, WP>(j, c)] = v;
  }
  __syncthreads();

  run_steps<CONTIG, TC, WP>(s, d, L);

  for (int e = threadIdx.x; e < 2 * TP * TC; e += THREADS) {
    int c, j, par;
    decode<CONTIG, TC, TP>(e, CONTIG, c, j, par);
    const long long line = line0 + c;
    const int p = p0 + j;
    if (line < lines && p < m) {
      const long long o = line / inner, ci = line % inner;
      const int k = sidx<CONTIG, TC, WP>(j + HALO, c);
      x[(o * 2 * m + 2 * p + par) * inner + ci] = par ? d[k] : s[k];
    }
  }
}

// Tiles: along a contiguous axis 8 lines x 64 pairs, along a strided one
// 32 columns x 64 pairs (18 KB of shared memory with the halo).
constexpr int TP = 64;
constexpr int TC_CONTIG = 8;
constexpr int TC_STRIDED = 32;

bool make_ladder(const int* kinds, const float* coefs, float g_lo, float g_hi,
                 Ladder* L) {
  for (int t = 0; t < STEPS; ++t) {
    if (kinds[t] != 0 && kinds[t] != 1) return false;
    L->kind[t] = kinds[t];
    L->coef[t] = coefs[t];
  }
  L->g_lo = g_lo;
  L->g_hi = g_hi;
  return true;
}

template <bool SYNTH>
int launch(const void* a, const void* b, void* out, void* out2,
           long long outer, int n, long long inner, const int* kinds,
           const float* coefs, float g_lo, float g_hi, void* stream) {
  Ladder L;
  if (outer < 1 || inner < 1 || n < 2 || n % 2 != 0 ||
      !make_ladder(kinds, coefs, g_lo, g_hi, &L))
    return static_cast<int>(cudaErrorInvalidValue);
  const int m = n / 2;
  const long long lines = outer * inner;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned gy = (m + TP - 1) / TP;
  if (inner == 1) {
    dim3 grid((lines + TC_CONTIG - 1) / TC_CONTIG, gy);
    if (SYNTH)
      synthesis_kernel<true, TC_CONTIG, TP><<<grid, THREADS, 0, s>>>(
          static_cast<const float*>(a), static_cast<const float*>(b),
          static_cast<float*>(out), lines, m, inner, L);
    else
      analysis_kernel<true, TC_CONTIG, TP><<<grid, THREADS, 0, s>>>(
          static_cast<const float*>(a), static_cast<float*>(out),
          static_cast<float*>(out2), lines, m, inner, L);
  } else {
    dim3 grid((lines + TC_STRIDED - 1) / TC_STRIDED, gy);
    if (SYNTH)
      synthesis_kernel<false, TC_STRIDED, TP><<<grid, THREADS, 0, s>>>(
          static_cast<const float*>(a), static_cast<const float*>(b),
          static_cast<float*>(out), lines, m, inner, L);
    else
      analysis_kernel<false, TC_STRIDED, TP><<<grid, THREADS, 0, s>>>(
          static_cast<const float*>(a), static_cast<float*>(out),
          static_cast<float*>(out2), lines, m, inner, L);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface for ctypes. kinds: 4 ints (0 = P, 1 = U); coefs: 4 floats.
// Return the cudaError_t of the launch (0 on success).
extern "C" int lift97_analysis(const void* x, void* lo, void* hi,
                               long long outer, int n, long long inner,
                               const int* kinds, const float* coefs,
                               float g_lo, float g_hi, void* stream) {
  return launch<false>(x, nullptr, lo, hi, outer, n, inner, kinds, coefs,
                       g_lo, g_hi, stream);
}

extern "C" int lift97_synthesis(const void* lo, const void* hi, void* x,
                                long long outer, int n, long long inner,
                                const int* kinds, const float* coefs,
                                float g_lo, float g_hi, void* stream) {
  return launch<true>(lo, hi, x, nullptr, outer, n, inner, kinds, coefs,
                      g_lo, g_hi, stream);
}
