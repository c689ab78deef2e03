// Native entropy codec for RBV coefficient planes.
//
// The framework's C++ runtime component (the reference's performance-critical
// paths are native C++; here the host-side hot loop is entropy coding, so it
// is native too).  Algorithm: RLE0 tokenisation of an int16 stream into three
// byte streams (zero-run varints, literal low bytes, literal high bytes),
// each compressed with a static order-0 rANS coder (32-bit state, byte
// renormalisation, 12-bit frequency precision).
//
// C ABI for ctypes:
//   int64_t rbv_compress_i16(const int16_t* data, int64_t n,
//                            uint8_t* out, int64_t out_cap);
//   int64_t rbv_decompress_i16(const uint8_t* in, int64_t in_len,
//                              int16_t* out, int64_t n);
// Both return the number of bytes written / consumed, or -1 on error.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC rans.cpp -o librbv_native.so

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kProbBits = 12;
constexpr uint32_t kProbScale = 1u << kProbBits;
constexpr uint32_t kRansL = 1u << 23;  // renormalisation threshold

struct SymStats {
  uint32_t freq[256];
  uint32_t cum[257];
};

// Normalise raw counts to kProbScale, guaranteeing nonzero freq for any
// symbol that occurs.
void normalize(const uint64_t counts[256], SymStats& s) {
  uint64_t total = 0;
  for (int i = 0; i < 256; i++) total += counts[i];
  if (total == 0) {
    // degenerate: uniform
    for (int i = 0; i < 256; i++) s.freq[i] = kProbScale / 256;
  } else {
    uint32_t assigned = 0;
    int last_nz = -1;
    for (int i = 0; i < 256; i++) {
      if (counts[i] == 0) {
        s.freq[i] = 0;
        continue;
      }
      uint32_t f = (uint32_t)((counts[i] * kProbScale) / total);
      if (f == 0) f = 1;
      s.freq[i] = f;
      assigned += f;
      last_nz = i;
    }
    // fix total to kProbScale by adjusting the most frequent symbol
    int maxi = 0;
    for (int i = 1; i < 256; i++)
      if (s.freq[i] > s.freq[maxi]) maxi = i;
    int64_t diff = (int64_t)kProbScale - (int64_t)assigned;
    if ((int64_t)s.freq[maxi] + diff < 1) return;  // cannot happen in practice
    s.freq[maxi] = (uint32_t)((int64_t)s.freq[maxi] + diff);
    (void)last_nz;
  }
  s.cum[0] = 0;
  for (int i = 0; i < 256; i++) s.cum[i + 1] = s.cum[i] + s.freq[i];
}

// Per-symbol encoder tables: the naive transition does a division per
// symbol (state / freq); replacing it with an exact reciprocal multiply
// (the standard alias-free rANS encoder construction) measured ~2x encode
// throughput on this host with a byte-identical bitstream.
struct EncSym {
  uint32_t x_max;      // renormalisation threshold for this symbol
  uint32_t rcp_freq;   // reciprocal of freq, fixed point
  uint32_t bias;       // cum (adjusted for the freq==1 special case)
  uint16_t cmpl_freq;  // kProbScale - freq
  uint16_t rcp_shift;
};

void init_enc(const SymStats& s, EncSym enc[256]) {
  for (int i = 0; i < 256; i++) {
    uint32_t f = s.freq[i];
    uint32_t c = s.cum[i];
    EncSym& e = enc[i];
    if (f == 0) {
      e = EncSym{};
      continue;
    }
    e.x_max = ((kRansL >> kProbBits) << 8) * f;
    e.cmpl_freq = (uint16_t)(kProbScale - f);
    if (f < 2) {
      // q = mul_hi(x, 2^32-1) = x-1 for x>=1; bias absorbs the off-by-one
      e.rcp_freq = ~0u;
      e.rcp_shift = 0;
      e.bias = c + kProbScale - 1;
    } else {
      uint32_t shift = 0;
      while (f > (1u << shift)) shift++;
      e.rcp_freq = (uint32_t)(((1ull << (shift + 31)) + f - 1) / f);
      e.rcp_shift = (uint16_t)(shift - 1);
      e.bias = c;
    }
  }
}

// rANS encode a byte stream (reverse iteration; output grows backwards).
void rans_encode(const std::vector<uint8_t>& in, const SymStats& s,
                 std::vector<uint8_t>& out) {
  EncSym enc[256];
  init_enc(s, enc);
  std::vector<uint8_t> tmp;
  tmp.reserve(in.size() + 16);
  uint32_t state = kRansL;
  for (size_t i = in.size(); i-- > 0;) {
    const EncSym& e = enc[in[i]];
    while (state >= e.x_max) {
      tmp.push_back((uint8_t)(state & 0xFF));
      state >>= 8;
    }
    // exact q = state / freq via reciprocal multiply;
    // state' = (q << 12) + (state % freq) + cum  ==  state + bias + q*cmpl
    uint32_t q =
        (uint32_t)(((uint64_t)state * e.rcp_freq) >> 32) >> e.rcp_shift;
    state = state + e.bias + q * e.cmpl_freq;
  }
  // emit final state (4 bytes, little endian)
  for (int i = 0; i < 4; i++) {
    tmp.push_back((uint8_t)(state & 0xFF));
    state >>= 8;
  }
  // reverse into out
  out.insert(out.end(), tmp.rbegin(), tmp.rend());
}

// rANS decode `n` bytes.
bool rans_decode(const uint8_t* in, size_t in_len, const SymStats& s, size_t n,
                 std::vector<uint8_t>& out) {
  // combined per-slot lookup: symbol | (freq-1)<<8 | cum<<20 in one load
  // (freq-1 because a single-symbol stream has freq == 4096, 13 bits)
  std::vector<uint32_t> lut(kProbScale);
  for (uint32_t sym = 0; sym < 256; sym++)
    for (uint32_t j = s.cum[sym]; j < s.cum[sym + 1]; j++)
      lut[j] = sym | ((s.freq[sym] - 1) << 8) | (s.cum[sym] << 20);
  size_t pos = 0;
  if (in_len < 4) return false;
  uint32_t state = 0;
  for (int i = 0; i < 4; i++) state = (state << 8) | in[pos++];
  out.resize(n);
  for (size_t i = 0; i < n; i++) {
    uint32_t slot = state & (kProbScale - 1);
    uint32_t e = lut[slot];
    out[i] = (uint8_t)(e & 0xFF);
    state =
        (((e >> 8) & 0xFFF) + 1) * (state >> kProbBits) + slot - (e >> 20);
    while (state < kRansL) {
      if (pos >= in_len) {
        if (i + 1 == n && state >= 1) break;  // final symbol may not renorm
        return false;
      }
      state = (state << 8) | in[pos++];
    }
  }
  return true;
}

void put_u32(std::vector<uint8_t>& v, uint32_t x) {
  v.push_back(x & 0xFF);
  v.push_back((x >> 8) & 0xFF);
  v.push_back((x >> 16) & 0xFF);
  v.push_back((x >> 24) & 0xFF);
}

uint32_t get_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

// serialize a frequency table: 256 x u16 (freq < 4096 fits)
void put_table(std::vector<uint8_t>& v, const SymStats& s) {
  for (int i = 0; i < 256; i++) {
    v.push_back(s.freq[i] & 0xFF);
    v.push_back((s.freq[i] >> 8) & 0xFF);
  }
}

bool get_table(const uint8_t* p, SymStats& s) {
  uint32_t total = 0;
  for (int i = 0; i < 256; i++) {
    s.freq[i] = (uint32_t)p[2 * i] | ((uint32_t)p[2 * i + 1] << 8);
    total += s.freq[i];
  }
  if (total != kProbScale) return false;
  s.cum[0] = 0;
  for (int i = 0; i < 256; i++) s.cum[i + 1] = s.cum[i] + s.freq[i];
  return true;
}

void encode_stream(const std::vector<uint8_t>& in, std::vector<uint8_t>& out) {
  uint64_t counts[256] = {0};
  for (uint8_t b : in) counts[b]++;
  SymStats s;
  normalize(counts, s);
  put_u32(out, (uint32_t)in.size());
  put_table(out, s);
  std::vector<uint8_t> body;
  rans_encode(in, s, body);
  put_u32(out, (uint32_t)body.size());
  out.insert(out.end(), body.begin(), body.end());
}

// returns bytes consumed or -1
int64_t decode_stream(const uint8_t* p, int64_t avail,
                      std::vector<uint8_t>& out) {
  if (avail < 4 + 512 + 4) return -1;
  uint32_t n = get_u32(p);
  SymStats s;
  if (!get_table(p + 4, s)) return -1;
  uint32_t body_len = get_u32(p + 4 + 512);
  int64_t consumed = 4 + 512 + 4 + (int64_t)body_len;
  if (consumed > avail) return -1;
  if (!rans_decode(p + 4 + 512 + 4, body_len, s, n, out)) return -1;
  return consumed;
}

// --- banded tokenisation ----------------------------------------------------
// Coefficient slabs are frequency-major: the DC rows, low-AC and high-AC
// regions have very different zero-run and magnitude statistics, so giving
// each frequency band its own rANS tables buys rate at zero speed cost
// (same total token work, a few extra 516-byte tables).  The caller
// describes the array as an ordered list of (offset, length, band)
// segments; runs continue across segment boundaries WITHIN a band.
struct BandTokens {
  std::vector<uint8_t> runs, lo, hi;
  uint64_t run = 0;
  void flush_run() {
    uint64_t r = run;
    while (r >= 0x80) {
      runs.push_back((uint8_t)(r & 0x7F) | 0x80);
      r >>= 7;
    }
    runs.push_back((uint8_t)r);
    run = 0;
  }
  void push(int16_t v) {
    if (v == 0) {
      run++;
      return;
    }
    flush_run();
    uint16_t z = (uint16_t)((v << 1) ^ (v >> 15));
    lo.push_back((uint8_t)(z & 0xFF));
    hi.push_back((uint8_t)(z >> 8));
  }
};

}  // namespace

extern "C" {

int64_t rbv_compress_i16_bands(const int16_t* data, int64_t n,
                               const int64_t* seg_off, const int64_t* seg_len,
                               const int32_t* seg_band, int64_t n_segs,
                               int32_t n_bands, uint8_t* out,
                               int64_t out_cap) {
  if (n_bands < 1 || n_bands > 255) return -1;
  std::vector<BandTokens> bands(n_bands);
  for (int64_t s = 0; s < n_segs; s++) {
    int32_t b = seg_band[s];
    if (b < 0 || b >= n_bands) return -1;
    BandTokens& bt = bands[b];
    const int16_t* p = data + seg_off[s];
    int64_t len = seg_len[s];
    if (seg_off[s] < 0 || seg_off[s] + len > n) return -1;
    int64_t i = 0;
    const int64_t len4 = len & ~int64_t(3);
    while (i < len4) {
      uint64_t w;
      std::memcpy(&w, p + i, 8);
      if (w == 0) {
        bt.run += 4;
        i += 4;
        continue;
      }
      for (int64_t e = i + 4; i < e; i++) bt.push(p[i]);
    }
    for (; i < len; i++) bt.push(p[i]);
  }
  std::vector<uint8_t> out_v;
  out_v.reserve(n / 4 + 2048);
  out_v.push_back('R');
  out_v.push_back('B');
  for (int i = 0; i < 8; i++)
    out_v.push_back((uint8_t)((uint64_t)n >> (8 * i)));
  out_v.push_back((uint8_t)n_bands);
  for (auto& bt : bands) {
    bt.flush_run();
    encode_stream(bt.runs, out_v);
    encode_stream(bt.lo, out_v);
    encode_stream(bt.hi, out_v);
  }
  if ((int64_t)out_v.size() > out_cap) return -1;
  std::memcpy(out, out_v.data(), out_v.size());
  return (int64_t)out_v.size();
}

int64_t rbv_decompress_i16_bands(const uint8_t* in, int64_t in_len,
                                 int16_t* out, int64_t n,
                                 const int64_t* seg_off,
                                 const int64_t* seg_len,
                                 const int32_t* seg_band, int64_t n_segs,
                                 int32_t n_bands) {
  if (in_len < 11 || in[0] != 'R' || in[1] != 'B') return -1;
  uint64_t n_hdr = 0;
  for (int i = 0; i < 8; i++) n_hdr |= ((uint64_t)in[2 + i]) << (8 * i);
  if ((int64_t)n_hdr != n) return -1;
  if ((int32_t)in[10] != n_bands) return -1;
  int64_t pos = 11;
  struct BandState {
    std::vector<uint8_t> runs, lo, hi;
    size_t ri = 0, li = 0;
    uint64_t pending = 0;  // zeros left of the loaded run
    bool has_run = false;  // a run token is loaded (pending may be 0 ->
                           // the next element is the literal)
  };
  std::vector<BandState> bands(n_bands);
  for (auto& bs : bands) {
    int64_t c = decode_stream(in + pos, in_len - pos, bs.runs);
    if (c < 0) return -1;
    pos += c;
    c = decode_stream(in + pos, in_len - pos, bs.lo);
    if (c < 0) return -1;
    pos += c;
    c = decode_stream(in + pos, in_len - pos, bs.hi);
    if (c < 0) return -1;
    pos += c;
    if (bs.lo.size() != bs.hi.size()) return -1;
  }
  for (int64_t s = 0; s < n_segs; s++) {
    int32_t b = seg_band[s];
    if (b < 0 || b >= n_bands) return -1;
    BandState& bs = bands[b];
    int16_t* o = out + seg_off[s];
    int64_t len = seg_len[s];
    if (seg_off[s] < 0 || seg_off[s] + len > n) return -1;
    int64_t oi = 0;
    while (oi < len) {
      if (!bs.has_run) {
        uint64_t run = 0;
        int shift = 0;
        while (true) {
          if (bs.ri >= bs.runs.size()) return -1;
          uint8_t byte = bs.runs[bs.ri++];
          run |= (uint64_t)(byte & 0x7F) << shift;
          if (!(byte & 0x80)) break;
          shift += 7;
        }
        bs.pending = run;
        bs.has_run = true;
      }
      if (bs.pending > 0) {
        uint64_t take = bs.pending;
        if ((int64_t)take > len - oi) take = (uint64_t)(len - oi);
        std::memset(o + oi, 0, take * sizeof(int16_t));
        oi += (int64_t)take;
        bs.pending -= take;
      } else {
        // the loaded run is exhausted: the next element is its literal
        bs.has_run = false;
        if (bs.li >= bs.lo.size()) return -1;
        uint16_t z = (uint16_t)bs.lo[bs.li] | ((uint16_t)bs.hi[bs.li] << 8);
        bs.li++;
        o[oi++] = (int16_t)((z >> 1) ^ (uint16_t)(-(int16_t)(z & 1)));
      }
    }
  }
  return pos;
}

int64_t rbv_compress_i16(const int16_t* data, int64_t n, uint8_t* out,
                         int64_t out_cap) {
  // RLE0 tokenise.  Pass 1 counts literals (vectorisable), so the token
  // buffers allocate exactly once and the fill pass writes through raw
  // pointers — push_back realloc/branch overhead dominated the profile.
  int64_t n_lit = 0;
  for (int64_t i = 0; i < n; i++) n_lit += (data[i] != 0);
  std::vector<uint8_t> runs, lo(n_lit), hi(n_lit);
  runs.reserve(n_lit + 16);
  uint8_t* lo_p = lo.data();
  uint8_t* hi_p = hi.data();
  int64_t li = 0;
  uint64_t run = 0;
  auto flush_run = [&]() {
    uint64_t r = run;
    while (r >= 0x80) {
      runs.push_back((uint8_t)(r & 0x7F) | 0x80);
      r >>= 7;
    }
    runs.push_back((uint8_t)r);
    run = 0;
  };
  // coefficient planes are >90% zeros: skip 4 elements at a time through
  // zero 64-bit words (the common case), falling back to the scalar loop
  // only inside words that carry a literal
  int64_t i = 0;
  const int64_t n4 = n & ~int64_t(3);
  while (i < n4) {
    uint64_t w;
    std::memcpy(&w, data + i, 8);
    if (w == 0) {
      run += 4;
      i += 4;
      continue;
    }
    for (int64_t e = i + 4; i < e; i++) {
      int16_t v = data[i];
      if (v == 0) {
        run++;
      } else {
        flush_run();
        uint16_t z = (uint16_t)((v << 1) ^ (v >> 15));  // zigzag map
        lo_p[li] = (uint8_t)(z & 0xFF);
        hi_p[li] = (uint8_t)(z >> 8);
        li++;
      }
    }
  }
  for (; i < n; i++) {
    int16_t v = data[i];
    if (v == 0) {
      run++;
    } else {
      flush_run();
      uint16_t z = (uint16_t)((v << 1) ^ (v >> 15));
      lo_p[li] = (uint8_t)(z & 0xFF);
      hi_p[li] = (uint8_t)(z >> 8);
      li++;
    }
  }
  flush_run();

  std::vector<uint8_t> out_v;
  out_v.reserve(n / 4 + 2048);
  // header: magic 'R0', n_elements u64
  out_v.push_back('R');
  out_v.push_back('0');
  for (int i = 0; i < 8; i++) out_v.push_back((uint8_t)((uint64_t)n >> (8 * i)));
  encode_stream(runs, out_v);
  encode_stream(lo, out_v);
  encode_stream(hi, out_v);
  if ((int64_t)out_v.size() > out_cap) return -1;
  std::memcpy(out, out_v.data(), out_v.size());
  return (int64_t)out_v.size();
}

int64_t rbv_decompress_i16(const uint8_t* in, int64_t in_len, int16_t* out,
                           int64_t n) {
  if (in_len < 10 || in[0] != 'R' || in[1] != '0') return -1;
  uint64_t n_hdr = 0;
  for (int i = 0; i < 8; i++) n_hdr |= ((uint64_t)in[2 + i]) << (8 * i);
  if ((int64_t)n_hdr != n) return -1;
  int64_t pos = 10;
  std::vector<uint8_t> runs, lo, hi;
  int64_t c = decode_stream(in + pos, in_len - pos, runs);
  if (c < 0) return -1;
  pos += c;
  c = decode_stream(in + pos, in_len - pos, lo);
  if (c < 0) return -1;
  pos += c;
  c = decode_stream(in + pos, in_len - pos, hi);
  if (c < 0) return -1;
  pos += c;
  if (lo.size() != hi.size()) return -1;

  // detokenise
  int64_t oi = 0;
  size_t li = 0;
  size_t ri = 0;
  size_t n_lit = lo.size();
  while (oi < n) {
    // read varint run
    uint64_t run = 0;
    int shift = 0;
    while (true) {
      if (ri >= runs.size()) return -1;
      uint8_t b = runs[ri++];
      run |= (uint64_t)(b & 0x7F) << shift;
      if (!(b & 0x80)) break;
      shift += 7;
    }
    if (oi + (int64_t)run > n) return -1;
    std::memset(out + oi, 0, run * sizeof(int16_t));
    oi += (int64_t)run;
    if (oi >= n) break;
    if (li >= n_lit) return -1;
    uint16_t z = (uint16_t)lo[li] | ((uint16_t)hi[li] << 8);
    li++;
    out[oi++] = (int16_t)((z >> 1) ^ (uint16_t)(-(int16_t)(z & 1)));
  }
  return pos;
}

}  // extern "C"
