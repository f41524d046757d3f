// Native sequential codec for redux_tpu.
//
// A fresh C++ implementation of the reference's sequential arithmetic coder
// (Rust, src/{bitio/mod.rs,codec.rs,model/adaptive_tree.rs} of the reference)
// with identical observable semantics, used for:
//   * the reference-format compatibility path (fast host encode/decode of
//     bare single streams, byte-identical to the reference CLI);
//   * the independent twin the device coders are checked against;
//   * a host-side fallback/cross-check for the block container.
//
// Semantics parity notes (file:line refer to the reference):
//   * MSB-first bit I/O with zero-padded flush      bitio/mod.rs:78-198
//   * Parameters derivation + validation            model/mod.rs:63-81
//   * Fenwick (BIT) adaptive model, +1 updates,
//     freeze at freq_max                            adaptive_tree.rs:43-136
//   * WNC interval coder, E1/E2/E3 renorm, pending
//     bits, EOF symbol + extra-bit drain            codec.rs:28-176
//
// All interval products fit in uint64 for every legal parameter set
// (range <= 2^code <= 2^33, bound < 2^freq, code+freq <= 64 enforced by
// Parameters validation; the production config (8,30,32) peaks below 2^62).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Params {
  int symbol_bits;
  uint64_t symbol_eof;
  uint64_t symbol_count;
  uint64_t freq_max;
  int code_bits;
  uint64_t code_one_fourth, code_half, code_three_fourths, code_max;

  static bool make(int s, int f, int c, Params* out) {
    if (s < 1 || f < s + 2 || c < f + 2 || 64 < c + f) return false;  // model/mod.rs:64
    out->symbol_bits = s;
    out->symbol_eof = 1ull << s;
    out->symbol_count = (1ull << s) + 1;
    out->freq_max = (1ull << f) - 1;
    out->code_bits = c;
    out->code_one_fourth = 1ull << (c - 2);
    out->code_half = 2ull << (c - 2);
    out->code_three_fourths = 3ull << (c - 2);
    out->code_max = (1ull << c) - 1;
    return true;
  }
};

// MSB-first bit writer over a growable byte vector (bitio/mod.rs:124-198).
struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t bits = 0;  // pending bits, right-aligned
  int nbits = 0;

  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}

  inline void put(uint32_t symbol, int n) {
    bits = (bits << n) | symbol;
    nbits += n;
    while (nbits >= 8) {
      nbits -= 8;
      out.push_back(static_cast<uint8_t>(bits >> nbits));
      bits &= (1u << nbits) - 1;
    }
  }
  inline void flush() {  // zero-pad the final partial byte (bitio/mod.rs:185)
    if (nbits > 0) {
      out.push_back(static_cast<uint8_t>(bits << (8 - nbits)));
      bits = 0;
      nbits = 0;
    }
  }
};

// MSB-first bit reader (bitio/mod.rs:54-120); eof() reports exhaustion.
struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  uint32_t bits = 0;
  int nbits = 0;
  bool hit_eof = false;

  BitReader(const uint8_t* d, size_t n) : data(d), size(n) {}

  inline int get1() {  // single-bit read; -1 on EOF
    if (nbits == 0) {
      if (pos >= size) {
        hit_eof = true;
        return -1;
      }
      bits = data[pos++];
      nbits = 8;
    }
    nbits--;
    int b = (bits >> nbits) & 1;
    bits &= (1u << nbits) - 1;
    return b;
  }
  inline int64_t get(int n) {  // n <= 32; -1 on EOF
    int64_t v = 0;
    for (int i = 0; i < n; i++) {
      int b = get1();
      if (b < 0) return -1;
      v = (v << 1) | b;
    }
    return v;
  }
};

// Fenwick/BIT adaptive cumulative-frequency model (adaptive_tree.rs:11-146).
// `delta` generalizes the reference's +1 adaptation increment (the RXT v2
// container extension; semantics identical to redux_tpu.models.dense).
struct FenwickModel {
  Params p;
  std::vector<uint64_t> tree;
  uint64_t count;
  uint64_t delta = 1;

  explicit FenwickModel(const Params& params) : p(params) {
    size_t n = static_cast<size_t>(p.symbol_count);
    tree.resize(n + 1);
    for (size_t i = 0; i <= n; i++) tree[i] = i & (~i + 1);  // last_one(i)
    count = p.symbol_count;
  }

  // Optional warm-start prior: initial frequency of symbol i is
  // 1 + extra[i] (redux_tpu container extension; uniform when extra=null).
  void init_prior(const uint16_t* extra) {
    size_t n = static_cast<size_t>(p.symbol_count);
    std::vector<uint64_t> freq(n + 1, 0);
    uint64_t total = 0;
    for (size_t i = 0; i < n; i++) {
      uint64_t f = 1 + (extra && i < 256 ? extra[i] : 0);
      freq[i + 1] = f;
      total += f;
    }
    // Build the Fenwick tree from per-symbol frequencies.
    for (size_t i = 1; i <= n; i++) {
      uint64_t s = 0;
      for (size_t j = i - (i & (~i + 1)) + 1; j <= i; j++) s += freq[j];
      tree[i] = s;
    }
    tree[0] = 0;
    count = total;
  }

  inline uint64_t total() const { return count; }

  inline uint64_t cum_single(uint64_t symbol) const {  // adaptive_tree.rs:52-61
    uint64_t sum = tree[0];
    for (uint64_t i = symbol; i > 0; i -= i & (~i + 1)) sum += tree[i];
    return sum;
  }

  inline void range(uint64_t symbol, uint64_t* lo, uint64_t* hi) const {
    // Shared-path walk (adaptive_tree.rs:63-80).
    uint64_t sumh = 0, suml = 0, h = symbol + 1, l = symbol;
    while (h != l) {
      if (h > l) {
        sumh += tree[h];
        h -= h & (~h + 1);
      } else {
        suml += tree[l];
        l -= l & (~l + 1);
      }
    }
    uint64_t sumr = cum_single(h);
    *lo = suml + sumr;
    *hi = sumh + sumr;
  }

  inline void update(uint64_t symbol) {  // 1-based +delta walk (adaptive_tree.rs:83-92)
    if (count < p.freq_max) {
      for (uint64_t i = symbol; i <= p.symbol_count; i += i & (~i + 1)) tree[i] += delta;
      count += delta;
    }
  }

  // get_frequency + adapt (adaptive_tree.rs:105-112).
  inline void get_frequency(uint64_t symbol, uint64_t* lo, uint64_t* hi) {
    range(symbol, lo, hi);
    update(symbol + 1);
  }

  // get_symbol + adapt: top-down binary descent (adaptive_tree.rs:115-136).
  inline bool get_symbol(uint64_t value, uint64_t* sym, uint64_t* lo, uint64_t* hi) {
    uint64_t m = p.symbol_eof, i = 0, v = value;
    while (m > 0 && i < p.symbol_eof) {
      uint64_t ti = i + m;
      uint64_t tv = tree[ti];
      if (v >= tv) {
        i = ti;
        v -= tv;
      }
      m >>= 1;
    }
    range(i, lo, hi);
    if (value >= *hi) return false;
    update(i + 1);
    *sym = i;
    return true;
  }
};

// WNC coder state (codec.rs:11-36).
struct Codec {
  Params p;
  uint64_t low, high, pending;
  int extra;

  explicit Codec(const Params& params)
      : p(params), low(0), high(params.code_max), pending(0), extra(params.code_bits) {}

  inline void put_bit(bool bit, BitWriter& w) {  // codec.rs:39-46
    w.put(bit ? 1 : 0, 1);
    while (pending > 0) {
      w.put(bit ? 0 : 1, 1);
      pending--;
    }
  }

  // codec.rs:55-101
  void compress_symbol(FenwickModel& m, uint64_t symbol, BitWriter& w) {
    uint64_t count = m.total(), flo, fhi;
    m.get_frequency(symbol, &flo, &fhi);
    uint64_t range = high - low + 1;
    high = low + (range * fhi) / count - 1;
    low = low + (range * flo) / count;

    bool is_eof = (symbol == p.symbol_eof);
    for (;;) {
      if (high < p.code_half) {
        put_bit(false, w);
        if (is_eof) extra--;
      } else if (low >= p.code_half) {
        put_bit(true, w);
        if (is_eof) extra--;
      } else if (low >= p.code_one_fourth && high < p.code_three_fourths) {
        pending++;
        low -= p.code_one_fourth;
        high -= p.code_one_fourth;
        if (is_eof) extra--;
      } else {
        break;
      }
      high = ((high << 1) + 1) & p.code_max;
      low = (low << 1) & p.code_max;
    }

    if (is_eof) {  // drain disambiguation bits (codec.rs:91-99)
      while (extra > 0) {
        put_bit((low & p.code_half) != 0, w);
        low = (low << 1) & p.code_max;
        extra--;
      }
      w.flush();
    }
  }

  // codec.rs:123-158; returns symbol or -1 on EOF-of-input error.
  int64_t decompress_symbol(FenwickModel& m, BitReader& r) {
    while (extra > 0) {  // prime code_bits bits (codec.rs:124-127)
      int b = r.get1();
      if (b < 0) return -1;
      pending = (pending << 1) | static_cast<uint64_t>(b);
      extra--;
    }
    uint64_t range = high - low + 1;
    uint64_t count = m.total();
    uint64_t value = ((pending - low + 1) * count - 1) / range;
    uint64_t sym, flo, fhi;
    if (!m.get_symbol(value, &sym, &flo, &fhi)) return -1;
    high = low + (range * fhi) / count - 1;
    low = low + (range * flo) / count;

    if (sym == p.symbol_eof) return static_cast<int64_t>(sym);

    for (;;) {
      if (high < p.code_half) {
        // nothing
      } else if (low >= p.code_half) {
        pending -= p.code_half;
        low -= p.code_half;
        high -= p.code_half;
      } else if (low >= p.code_one_fourth && high < p.code_three_fourths) {
        pending -= p.code_one_fourth;
        low -= p.code_one_fourth;
        high -= p.code_one_fourth;
      } else {
        break;
      }
      low <<= 1;
      high = (high << 1) + 1;
      int b = r.get1();
      if (b < 0) return -1;
      pending = (pending << 1) | static_cast<uint64_t>(b);
    }
    return static_cast<int64_t>(sym);
  }
};

}  // namespace

extern "C" {

// ---- RXT v2 block payloads -------------------------------------------------
//
// The v2 payload (redux_tpu.oracle.compress_block) differs from the
// reference stream format: no EOF symbol / extra-bit drain; instead a
// minimal 2-bit terminator tq = ceil(low / quarter), and the decoder reads
// ZERO bits past the physical end of the payload (stored-length
// termination).  Same WNC coder and (+delta, freeze) model otherwise.

int64_t rdx_compress_v2(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap,
                        int sb, int fb, int cb, const uint16_t* extra,
                        int64_t delta) {
  Params p;
  if (!Params::make(sb, fb, cb, &p) || sb != 8 || delta < 1) return -1;
  std::vector<uint8_t> buf;
  buf.reserve(static_cast<size_t>(n) + 64);
  BitWriter w(buf);
  FenwickModel m(p);
  m.init_prior(extra);  // uniform when extra == NULL (freq 1 per symbol)
  m.delta = static_cast<uint64_t>(delta);
  if (m.count >= p.freq_max) return -1;  // prior leaves no adaptation headroom
  Codec c(p);
  for (int64_t i = 0; i < n; i++) c.compress_symbol(m, in[i], w);
  // 2-bit terminator (oracle.compress_block): tq = ceil(low / quarter).
  uint64_t tq = (c.low + p.code_one_fourth - 1) / p.code_one_fourth;
  c.put_bit((tq >> 1) != 0, w);
  c.put_bit((tq & 1) != 0, w);
  w.flush();
  if (static_cast<int64_t>(buf.size()) > cap) return -2;
  std::memcpy(out, buf.data(), buf.size());
  return static_cast<int64_t>(buf.size());
}

int64_t rdx_decompress_v2(const uint8_t* in, int64_t n, uint8_t* out,
                          int64_t cap, int sb, int fb, int cb,
                          const uint16_t* extra, int64_t delta, int64_t nsyms) {
  Params p;
  if (!Params::make(sb, fb, cb, &p) || sb != 8 || delta < 1 || nsyms < 0)
    return -1;
  if (nsyms > cap) return -2;
  BitReader r(in, static_cast<size_t>(n));
  FenwickModel m(p);
  m.init_prior(extra);
  m.delta = static_cast<uint64_t>(delta);
  if (m.count >= p.freq_max) return -1;
  // Zero-padded single-bit read (the v2 termination contract).
  auto get1z = [&r]() -> uint64_t {
    int b = r.get1();
    return b < 0 ? 0u : static_cast<uint64_t>(b);
  };
  uint64_t low = 0, high = p.code_max, z = 0;
  for (int i = 0; i < p.code_bits; i++) z = (z << 1) | get1z();
  for (int64_t t = 0; t < nsyms; t++) {
    uint64_t range = high - low + 1;
    uint64_t count = m.total();
    uint64_t value = ((z - low + 1) * count - 1) / range;
    uint64_t sym, flo, fhi;
    if (!m.get_symbol(value, &sym, &flo, &fhi)) return -1;
    if (sym >= p.symbol_eof) return -1;  // EOF symbol is not coded in v2
    high = low + (range * fhi) / count - 1;
    low = low + (range * flo) / count;
    for (;;) {
      if (high < p.code_half) {
        // nothing
      } else if (low >= p.code_half) {
        z -= p.code_half;
        low -= p.code_half;
        high -= p.code_half;
      } else if (low >= p.code_one_fourth && high < p.code_three_fourths) {
        z -= p.code_one_fourth;
        low -= p.code_one_fourth;
        high -= p.code_one_fourth;
      } else {
        break;
      }
      low <<= 1;
      high = (high << 1) + 1;
      z = (z << 1) | get1z();
    }
    out[t] = static_cast<uint8_t>(sym);
  }
  return nsyms;
}

// Compress `n` bytes into a malloc-free caller interface: output written to
// a std::vector internally and copied into `out` (capacity `cap`).
// Returns bytes written, -1 on invalid params, -2 if cap is too small.
// Reference-format single stream (compress_stream, codec.rs:104-120) with
// optional warm-start prior (extra = NULL for reference-exact uniform init).
int64_t rdx_compress(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap,
                     int sb, int fb, int cb, const uint16_t* extra) {
  Params p;
  if (!Params::make(sb, fb, cb, &p) || sb > 16) return -1;
  std::vector<uint8_t> buf;
  buf.reserve(static_cast<size_t>(n) + 64);
  BitWriter w(buf);
  FenwickModel m(p);
  if (extra) m.init_prior(extra);
  Codec c(p);

  // Symbol loop (compress_stream, codec.rs:104-120). For symbol widths
  // other than 8 the input is consumed sb bits at a time like the
  // reference's read_bits(symbol_bits).
  if (sb == 8) {
    for (int64_t i = 0; i < n; i++) c.compress_symbol(m, in[i], w);
  } else {
    BitReader r(in, static_cast<size_t>(n));
    for (;;) {
      int64_t s = r.get(sb);
      if (s < 0) break;
      c.compress_symbol(m, static_cast<uint64_t>(s), w);
    }
  }
  c.compress_symbol(m, p.symbol_eof, w);

  if (static_cast<int64_t>(buf.size()) > cap) return -2;
  std::memcpy(out, buf.data(), buf.size());
  return static_cast<int64_t>(buf.size());
}

// Decompress a reference-format stream. Returns bytes written, -1 on codec
// error (truncated/corrupt), -2 if cap too small. If `nsyms` >= 0, decodes
// exactly nsyms data symbols (stored-length container termination) instead
// of running to the EOF symbol.
int64_t rdx_decompress(const uint8_t* in, int64_t n, uint8_t* out, int64_t cap,
                       int sb, int fb, int cb, const uint16_t* extra,
                       int64_t nsyms) {
  Params p;
  if (!Params::make(sb, fb, cb, &p) || sb > 16) return -1;
  BitReader r(in, static_cast<size_t>(n));
  FenwickModel m(p);
  if (extra) m.init_prior(extra);
  Codec c(p);

  // For symbol widths other than 8 the output is written sb bits per
  // symbol MSB-first, dropping a partial trailing byte — exactly the
  // reference's write_bits(symbol, symbol_bits) with no final flush
  // (codec.rs:164-176, lib.rs:113-120).
  uint32_t acc = 0;
  int nbits = 0;
  int64_t written = 0, symbols = 0;
  for (;;) {
    if (nsyms >= 0 && symbols >= nsyms) break;
    int64_t s = c.decompress_symbol(m, r);
    if (s < 0) return -1;
    if (s == static_cast<int64_t>(p.symbol_eof)) {
      if (nsyms >= 0) return -1;  // hit EOF before the promised length
      break;
    }
    symbols++;
    if (sb == 8) {
      if (written >= cap) return -2;
      out[written++] = static_cast<uint8_t>(s);
      continue;
    }
    acc = (acc << sb) | static_cast<uint32_t>(s);
    nbits += sb;
    while (nbits >= 8) {
      if (written >= cap) return -2;
      out[written++] = static_cast<uint8_t>((acc >> (nbits - 8)) & 0xFF);
      nbits -= 8;
    }
  }
  return written;
}

}  // extern "C"
