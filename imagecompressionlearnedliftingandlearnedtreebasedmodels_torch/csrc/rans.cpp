// Host-side rANS entropy coder for the TPU wavelet codec.
//
// Native replacement for the reference's pip-native coding surface
// (compressai.ans BufferedRansEncoder/RansDecoder and the range_coder C
// extension used at reference LiftingBasedDWT_net.py:466,516 and
// utils/ae.py:13). Independent implementation of the public rANS scheme
// (Duda 2013; byte-renormalizing variant):
//
//   state x in [2^23, 2^31); 16-bit quantized CDF rows; encode runs over
//   symbols in reverse and the byte buffer is reversed on flush so the
//   decoder streams forward.
//
// Out-of-range symbols use an escape interval (the last CDF bin, which
// carries the tail mass) followed by a zigzag varint coded in 3-bit
// bypass nibbles through the same rANS state.
//
// Exposed as extern "C" for ctypes binding (no pybind11 in this image).

#include <cstring>
#include <vector>

#include "rans_core.h"

using namespace ranscore;

extern "C" {

// Encode n symbols against per-symbol CDF rows. cdfs is row-major with
// stride cdf_stride (uint32 entries). Returns bytes written, or -1 if
// out_capacity is insufficient.
int64_t rans_encode_with_indexes(
    const int32_t* symbols, const int32_t* indexes, int64_t n,
    const uint32_t* cdfs, int32_t cdf_stride, const int32_t* cdf_lengths,
    const int32_t* offsets, uint8_t* out, int64_t out_capacity) {
  // precompute ops forward, encode in reverse (rANS is LIFO)
  std::vector<SymOp> ops(static_cast<size_t>(n));
  for (int64_t i = 0; i < n; ++i) {
    const int32_t idx = indexes[i];
    make_op(symbols[i], cdfs + static_cast<int64_t>(idx) * cdf_stride,
            cdf_lengths[idx], offsets[idx], &ops[static_cast<size_t>(i)]);
  }
  RansEncState enc;
  for (int64_t i = n - 1; i >= 0; --i) {
    const SymOp& op = ops[static_cast<size_t>(i)];
    // bypass nibbles decode after the main symbol, so encode them first
    // (reverse order within the op, too)
    for (auto it = op.nibbles.rbegin(); it != op.nibbles.rend(); ++it) {
      enc.put_bits(*it, kBypassBits + 1);
    }
    enc.put(op.start, op.freq);
  }
  std::vector<uint8_t> bytes;
  enc.flush(&bytes);
  if (static_cast<int64_t>(bytes.size()) > out_capacity) return -1;
  std::memcpy(out, bytes.data(), bytes.size());
  return static_cast<int64_t>(bytes.size());
}

// One-shot decode of n symbols.
int64_t rans_decode_with_indexes(
    const uint8_t* bytes, int64_t nbytes, const int32_t* indexes, int64_t n,
    const uint32_t* cdfs, int32_t cdf_stride, const int32_t* cdf_lengths,
    const int32_t* offsets, int32_t* out_symbols) {
  RansDecState dec;
  dec.init(bytes, nbytes);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t idx = indexes[i];
    out_symbols[i] = decode_symbol(
        &dec, cdfs + static_cast<int64_t>(idx) * cdf_stride,
        cdf_lengths[idx], offsets[idx]);
  }
  return n;
}

// Streaming decoder (for wavefront AR decode: repeated decode calls
// against one stream, mirroring compressai's RansDecoder.decode_stream).
struct StreamDecoder {
  std::vector<uint8_t> data;
  RansDecState st;
};

void* rans_decoder_new(const uint8_t* bytes, int64_t nbytes) {
  auto* d = new StreamDecoder();
  d->data.assign(bytes, bytes + nbytes);
  d->st.init(d->data.data(), static_cast<int64_t>(d->data.size()));
  return d;
}

void rans_decoder_free(void* dec) {
  delete static_cast<StreamDecoder*>(dec);
}

int64_t rans_decoder_decode(
    void* dec, const int32_t* indexes, int64_t n, const uint32_t* cdfs,
    int32_t cdf_stride, const int32_t* cdf_lengths, const int32_t* offsets,
    int32_t* out_symbols) {
  auto* d = static_cast<StreamDecoder*>(dec);
  for (int64_t i = 0; i < n; ++i) {
    const int32_t idx = indexes[i];
    out_symbols[i] = decode_symbol(
        &d->st, cdfs + static_cast<int64_t>(idx) * cdf_stride,
        cdf_lengths[idx], offsets[idx]);
  }
  return n;
}

// Quantize a pmf row (tail mass as final element) to a 16-bit CDF with no
// zero-width intervals: largest-interval stealing, deterministic.
// cdf_out must hold n+1 entries; returns 0 on success.
int32_t pmf_to_quantized_cdf(const double* pmf, int32_t n, int32_t precision,
                             uint32_t* cdf_out) {
  if (n < 1 || precision < 8 || precision > 16) return -1;
  const uint32_t scale = 1u << precision;
  double total = 0.0;
  for (int32_t i = 0; i < n; ++i) total += (pmf[i] > 0 ? pmf[i] : 0.0);
  if (total <= 0.0) total = 1.0;
  std::vector<uint32_t> freqs(static_cast<size_t>(n));
  uint64_t sum = 0;
  for (int32_t i = 0; i < n; ++i) {
    const double p = pmf[i] > 0 ? pmf[i] : 0.0;
    uint32_t f = static_cast<uint32_t>(p / total * scale + 0.5);
    if (f == 0) f = 1;  // every symbol must be codable
    freqs[static_cast<size_t>(i)] = f;
    sum += f;
  }
  // rebalance to exactly `scale` by adjusting the largest interval(s)
  while (sum != scale) {
    int32_t best = 0;
    for (int32_t i = 1; i < n; ++i) {
      if (freqs[static_cast<size_t>(i)] > freqs[static_cast<size_t>(best)]) {
        best = i;
      }
    }
    if (sum > scale) {
      const uint64_t excess = sum - scale;
      const uint32_t take = freqs[static_cast<size_t>(best)] > excess + 1
                                ? static_cast<uint32_t>(excess)
                                : freqs[static_cast<size_t>(best)] - 1;
      if (take == 0) return -2;  // cannot normalize (n > scale)
      freqs[static_cast<size_t>(best)] -= take;
      sum -= take;
    } else {
      const uint32_t add = static_cast<uint32_t>(scale - sum);
      freqs[static_cast<size_t>(best)] += add;
      sum += add;
    }
  }
  cdf_out[0] = 0;
  for (int32_t i = 0; i < n; ++i) {
    cdf_out[i + 1] = cdf_out[i] + freqs[static_cast<size_t>(i)];
  }
  return 0;
}

}  // extern "C"
