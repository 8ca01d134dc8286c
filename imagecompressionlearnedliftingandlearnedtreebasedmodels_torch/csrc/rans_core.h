// Core rANS state machine + symbol/escape mapping, shared between the
// standalone coder library (rans.cpp) and the fully-native wavefront walk
// (wavefront_ctx.cpp). Header-only so each .so compiles an identical copy —
// all arithmetic is exact integer math, so the two binaries are
// bit-compatible by construction.
//
// Independent implementation of the public rANS scheme (Duda 2013;
// byte-renormalizing variant) with compressai.ans-style table semantics
// (reference LiftingBasedDWT_net.py:502-505,540-546): 16-bit quantized CDF
// rows; out-of-range symbols escape into the tail bin followed by a zigzag
// varint in 3-bit bypass nibbles through the same rANS state.

#ifndef RANS_CORE_H_
#define RANS_CORE_H_

#include <cstdint>
#include <vector>

namespace ranscore {

constexpr uint32_t kProbBits = 16;
constexpr uint32_t kProbScale = 1u << kProbBits;
constexpr uint32_t kRansL = 1u << 23;  // lower bound of the state interval

// ---------------------------------------------------------------------
// core rANS state ops (byte renormalization)

struct RansEncState {
  uint32_t x = kRansL;
  std::vector<uint8_t> bytes;  // emitted in reverse; reversed on flush

  inline void put(uint32_t start, uint32_t freq) {
    // renormalize: keep x < ((L >> kProbBits) << 8) * freq after encoding
    const uint32_t x_max = ((kRansL >> kProbBits) << 8) * freq;
    while (x >= x_max) {
      bytes.push_back(static_cast<uint8_t>(x & 0xff));
      x >>= 8;
    }
    x = ((x / freq) << kProbBits) + (x % freq) + start;
  }

  // raw-bit bypass: value in [0, 2^nbits) with uniform probability
  inline void put_bits(uint32_t val, uint32_t nbits) {
    put(val << (kProbBits - nbits), 1u << (kProbBits - nbits));
  }

  void flush(std::vector<uint8_t>* out) {
    uint32_t xx = x;
    for (int i = 0; i < 4; ++i) {
      bytes.push_back(static_cast<uint8_t>(xx & 0xff));
      xx >>= 8;
    }
    out->assign(bytes.rbegin(), bytes.rend());
  }
};

struct RansDecState {
  uint32_t x = 0;
  const uint8_t* ptr = nullptr;
  const uint8_t* end = nullptr;

  void init(const uint8_t* data, int64_t n) {
    ptr = data;
    end = data + n;
    x = 0;
    for (int i = 0; i < 4; ++i) {
      x = (x << 8) | (ptr < end ? *ptr++ : 0);
    }
  }

  inline uint32_t peek() const { return x & (kProbScale - 1); }

  inline void advance(uint32_t start, uint32_t freq) {
    x = freq * (x >> kProbBits) + peek() - start;
    while (x < kRansL) {
      x = (x << 8) | (ptr < end ? *ptr++ : 0);
    }
  }

  inline uint32_t get_bits(uint32_t nbits) {
    const uint32_t val = peek() >> (kProbBits - nbits);
    advance(val << (kProbBits - nbits), 1u << (kProbBits - nbits));
    return val;
  }
};

// ---------------------------------------------------------------------
// symbol <-> escape mapping
//
// A CDF row of length Lr covers symbols 0..Lr-2 (the last interval,
// index Lr-2, is the escape/tail bin). A raw value r = symbol - offset
// outside [0, Lr-3] is coded as escape + zigzag varint of the overflow.

constexpr uint32_t kBypassBits = 3;         // payload bits per nibble
constexpr uint32_t kBypassCont = 1u << 3;   // continuation flag bit

struct SymOp {
  uint32_t start, freq;   // main interval
  std::vector<uint8_t> nibbles;  // bypass payload (empty if in range)
};

inline void make_op(int32_t symbol, const uint32_t* cdf_row, int32_t cdf_len,
                    int32_t offset, SymOp* op) {
  const int32_t max_sym = cdf_len - 2;   // escape index
  int64_t r = static_cast<int64_t>(symbol) - offset;
  op->nibbles.clear();
  if (r >= 0 && r < max_sym) {
    op->start = cdf_row[r];
    op->freq = cdf_row[r + 1] - cdf_row[r];
    return;
  }
  // escape + zigzag varint
  op->start = cdf_row[max_sym];
  op->freq = cdf_row[max_sym + 1] - cdf_row[max_sym];
  uint64_t ov;
  uint32_t sign;
  if (r >= max_sym) {
    ov = static_cast<uint64_t>(r - max_sym);
    sign = 0;
  } else {
    ov = static_cast<uint64_t>(-(r + 1));
    sign = 1;
  }
  uint64_t zig = (ov << 1) | sign;
  while (zig >= kBypassCont) {
    op->nibbles.push_back(
        static_cast<uint8_t>((zig & (kBypassCont - 1)) | kBypassCont));
    zig >>= kBypassBits;
  }
  op->nibbles.push_back(static_cast<uint8_t>(zig));
}

inline int32_t decode_symbol(RansDecState* dec, const uint32_t* cdf_row,
                             int32_t cdf_len, int32_t offset) {
  const int32_t max_sym = cdf_len - 2;
  const uint32_t cum = dec->peek();
  // binary search the interval containing cum
  int32_t lo = 0, hi = cdf_len - 1;
  while (hi - lo > 1) {
    const int32_t mid = (lo + hi) >> 1;
    if (cdf_row[mid] <= cum) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  dec->advance(cdf_row[lo], cdf_row[lo + 1] - cdf_row[lo]);
  if (lo < max_sym) {
    return lo + offset;
  }
  // escape: read zigzag varint nibbles
  uint64_t zig = 0;
  uint32_t shift = 0;
  while (true) {
    const uint32_t nib = dec->get_bits(kBypassBits + 1);
    zig |= static_cast<uint64_t>(nib & (kBypassCont - 1)) << shift;
    shift += kBypassBits;
    if (!(nib & kBypassCont)) break;
  }
  const uint32_t sign = zig & 1;
  const int64_t ov = static_cast<int64_t>(zig >> 1);
  const int64_t r = sign ? -(ov + 1) : ov + max_sym;
  return static_cast<int32_t>(r + offset);
}

}  // namespace ranscore

#endif  // RANS_CORE_H_
