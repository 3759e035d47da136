// Native Rice bitstream pack/unpack — host-side hot loop.
//
// Copy of the JAX package's native/bitio.cpp, built for the PyTorch port.
// Analog of upstream:src/rice/rice_encoder.cpp and
// rice_decoder.cpp (sahaRatul/sela, path-level cite -- reference mount was
// empty; SURVEY.md SS2). The device does all codec math and
// chooses k; this library does the one genuinely bit-serial stage -- variable
// -length bit packing -- at memory speed on the host, threaded over
// independent blocks. Bit conventions are normative per FORMAT.md:
//   zigzag u = (v << 1) ^ (v >> 31)
//   k <= 30: (u >> k) one-bits, one zero bit, low k bits of u MSB-first
//   k == 31: all 32 bits of u MSB-first (verbatim escape)
//   bit i of stream = bit 31 - (i % 32) of word i / 32
//
// Exactness is asserted against the numpy oracle in tests/test_native.py.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline uint32_t zigzag(int32_t v) {
  return (static_cast<uint32_t>(v) << 1) ^ static_cast<uint32_t>(v >> 31);
}

inline int32_t unzigzag(uint32_t u) {
  return static_cast<int32_t>((u >> 1) ^ (~(u & 1) + 1));
}

struct BitWriter {
  uint32_t* out;
  size_t w = 0;
  uint64_t acc = 0;  // low `n` bits are pending, MSB-first order
  int n = 0;

  inline void put(uint32_t bits, int len) {
    if (len == 0) return;
    acc = (acc << len) | (static_cast<uint64_t>(bits) & ((1ull << len) - 1));
    n += len;
    while (n >= 32) {
      out[w++] = static_cast<uint32_t>(acc >> (n - 32));
      n -= 32;
    }
  }
  inline void put32(uint32_t bits) {
    acc = (acc << 32) | bits;
    n += 32;
    while (n >= 32) {
      out[w++] = static_cast<uint32_t>(acc >> (n - 32));
      n -= 32;
    }
  }
  inline void flush() {
    if (n > 0) {
      out[w++] = static_cast<uint32_t>(acc << (32 - n));
      n = 0;
      acc = 0;
    }
  }
};

struct BitReader {
  const uint32_t* in;
  size_t words;
  size_t r = 0;
  uint64_t acc = 0;  // low `n` bits are the next bits, MSB-first order
  int n = 0;

  inline void refill() {
    while (n <= 32 && r < words) {
      acc = (acc << 32) | in[r++];
      n += 32;
    }
  }
  inline uint32_t get(int len) {  // len <= 32
    if (len == 0) return 0;
    refill();
    if (n < len) {  // past-the-end: pad with zeros (caller validated sizes)
      acc <<= (len - n);
      n = len;
    }
    uint32_t v = static_cast<uint32_t>((acc >> (n - len)) & ((1ull << len) - 1));
    n -= len;
    return v;
  }
  inline uint32_t read_unary() {  // count 1-bits up to the terminating 0
    uint32_t q = 0;
    for (;;) {
      refill();
      if (n == 0) return q;  // truncated stream: treat as terminated
      // examine the top n pending bits
      uint64_t window = acc & ((n == 64) ? ~0ull : ((1ull << n) - 1));
      // leading ones of the n-bit window
      int lead = 0;
      while (lead < n &&
             ((window >> (n - 1 - lead)) & 1ull) != 0)
        ++lead;
      q += static_cast<uint32_t>(lead);
      if (lead < n) {       // found the zero bit
        n -= lead + 1;      // consume the ones and the stop bit
        return q;
      }
      n = 0;                // consumed everything; keep counting
      acc = 0;
    }
  }
};

inline uint64_t rice_bits(uint32_t u, int k) {
  if (k == 31) return 32;
  return static_cast<uint64_t>(u >> k) + 1 + k;
}

// Partitioned residues (FORMAT.md §Partitioned residues): k byte 32 marks a
// block split into 4 sub-blocks with independent ks (packed bit-contiguous).
constexpr int kPartitionMarker = 32;
constexpr int kResidueParts = 4;

// Per-value k for value j of an n-value block: sub-block q spans
// [q*n/4, (q+1)*n/4). ks4 holds the packed sub-ks (k0 | k1<<8 | ...).
inline int part_k(int32_t j, int32_t n, int32_t ks4) {
  // branchless sub-block index: q such that j in [q*n/4, (q+1)*n/4)
  int q = static_cast<int>((static_cast<int64_t>(j) * kResidueParts) / n);
  // guard the exact boundary: j*4/n can land one past due to flooring rules
  while (q > 0 && j < (static_cast<int64_t>(q) * n) / kResidueParts) --q;
  while (q < kResidueParts - 1 &&
         j >= (static_cast<int64_t>(q + 1) * n) / kResidueParts)
    ++q;
  return (ks4 >> (8 * q)) & 0xFF;
}

void parallel_for(int64_t count, void (*fn)(int64_t, void*), void* ctx) {
  unsigned hw = std::thread::hardware_concurrency();
  if (hw == 0) hw = 2;
  unsigned nthreads = hw;
  if (count < static_cast<int64_t>(nthreads) * 4) {
    for (int64_t i = 0; i < count; ++i) fn(i, ctx);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> pool;
  for (unsigned t = 0; t < nthreads; ++t) {
    pool.emplace_back([&]() {
      for (;;) {
        int64_t i = next.fetch_add(1);
        if (i >= count) return;
        fn(i, ctx);
      }
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Pass 1: exact word count per block (so Python can allocate output).
// values: concatenated int32; offs[i]..offs[i]+counts[i] is block i;
// ks[i] in [0, 31], or 32 (partition marker) with the 4 sub-block ks packed
// byte-wise into ks4[i] (pass ks4 = nullptr when no block is partitioned).
void rice_block_words(const int32_t* values, const int64_t* offs,
                      const int32_t* counts, const int32_t* ks,
                      const int32_t* ks4, int64_t n_blocks,
                      int64_t* out_words) {
  struct Ctx {
    const int32_t* values;
    const int64_t* offs;
    const int32_t* counts;
    const int32_t* ks;
    const int32_t* ks4;
    int64_t* out_words;
  } ctx{values, offs, counts, ks, ks4, out_words};
  parallel_for(
      n_blocks,
      [](int64_t i, void* p) {
        auto& c = *static_cast<Ctx*>(p);
        const int32_t* v = c.values + c.offs[i];
        int k = c.ks[i];
        int32_t n = c.counts[i];
        uint64_t bits = 0;
        if (k == kPartitionMarker) {
          int32_t kk = c.ks4[i];
          for (int32_t j = 0; j < n; ++j)
            bits += rice_bits(zigzag(v[j]), part_k(j, n, kk));
        } else {
          for (int32_t j = 0; j < n; ++j) bits += rice_bits(zigzag(v[j]), k);
        }
        c.out_words[i] = static_cast<int64_t>((bits + 31) / 32);
      },
      &ctx);
}

// Pass 2: pack. word_offs are exclusive prefix sums of rice_block_words
// output; out must hold sum(words). Partitioned blocks (ks[i] == 32) pack
// their sub-blocks bit-contiguously with per-sub ks from ks4[i].
void rice_pack_blocks(const int32_t* values, const int64_t* offs,
                      const int32_t* counts, const int32_t* ks,
                      const int32_t* ks4, const int64_t* word_offs,
                      int64_t n_blocks, uint32_t* out) {
  struct Ctx {
    const int32_t* values;
    const int64_t* offs;
    const int32_t* counts;
    const int32_t* ks;
    const int32_t* ks4;
    const int64_t* word_offs;
    uint32_t* out;
  } ctx{values, offs, counts, ks, ks4, word_offs, out};
  parallel_for(
      n_blocks,
      [](int64_t i, void* p) {
        auto& c = *static_cast<Ctx*>(p);
        const int32_t* v = c.values + c.offs[i];
        int kb = c.ks[i];
        int32_t n = c.counts[i];
        BitWriter bw{c.out + c.word_offs[i]};
        for (int32_t j = 0; j < n; ++j) {
          int k = (kb == kPartitionMarker) ? part_k(j, n, c.ks4[i]) : kb;
          uint32_t u = zigzag(v[j]);
          if (k == 31) {
            bw.put32(u);
          } else {
            uint32_t q = u >> k;
            while (q >= 32) {
              bw.put32(0xFFFFFFFFu);
              q -= 32;
            }
            bw.put((1u << q) - 1, static_cast<int>(q));  // q one-bits
            bw.put(0, 1);                                // stop bit
            bw.put(u, k);                                // low k bits
          }
        }
        bw.flush();
      },
      &ctx);
}

// Unpack: words concatenated; per block word_offs/word_counts,
// value offs/counts, ks (+ks4 sub-ks for partitioned blocks).
// out holds concatenated int32 values.
void rice_unpack_blocks(const uint32_t* words, const int64_t* word_offs,
                        const int32_t* word_counts, const int64_t* offs,
                        const int32_t* counts, const int32_t* ks,
                        const int32_t* ks4, int64_t n_blocks, int32_t* out) {
  struct Ctx {
    const uint32_t* words;
    const int64_t* word_offs;
    const int32_t* word_counts;
    const int64_t* offs;
    const int32_t* counts;
    const int32_t* ks;
    const int32_t* ks4;
    int32_t* out;
  } ctx{words, word_offs, word_counts, offs, counts, ks, ks4, out};
  parallel_for(
      n_blocks,
      [](int64_t i, void* p) {
        auto& c = *static_cast<Ctx*>(p);
        BitReader br{c.words + c.word_offs[i],
                     static_cast<size_t>(c.word_counts[i])};
        int kb = c.ks[i];
        int32_t n = c.counts[i];
        int32_t* o = c.out + c.offs[i];
        for (int32_t j = 0; j < n; ++j) {
          int k = (kb == kPartitionMarker) ? part_k(j, n, c.ks4[i]) : kb;
          uint32_t u;
          if (k == 31) {
            u = br.get(32);
          } else {
            uint32_t q = br.read_unary();
            uint32_t rem = (k > 0) ? br.get(k) : 0;
            u = (q << k) | rem;
          }
          o[j] = unzigzag(u);
        }
      },
      &ctx);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Container scan/emit — host-side frame (de)serialization at memory speed.
//
// Analog of upstream:src/file/sela_file.cpp
// (readFrames/writeToFile; sahaRatul/sela, path-level cite -- reference mount
// empty, SURVEY.md SS2 "SELA container"). Python's per-frame struct loops are
// the decode-side host bottleneck for hour-long files; these single-pass
// scanners replace them. Layout per FORMAT.md:
//   Frame    := u32 SYNC  u16 numSamples  SubFrame*channels
//   SubFrame := u8 ch u8 type u8 order  u8 kC u16 nWC u32*nWC  u8 kR u32 nWR
//               u32*nWR
// All little-endian; word payloads may be byte-misaligned relative to the
// buffer, so the scanner memcpy-copies them into aligned output arrays
// (coeff words and residue words separately, each concatenated in subframe
// order) ready for rice_unpack_blocks.

namespace {
inline uint16_t ld_u16(const uint8_t* p) {
  uint16_t v;
  std::memcpy(&v, p, 2);
  return v;
}
inline uint32_t ld_u32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}
}  // namespace

extern "C" {

// Returns the final byte offset (>= 0) on success, or -(offset+1) of the
// first structural error. Output arrays are caller-allocated:
//   n_samples[num_frames]; per subframe s (file order, num_frames*channels):
//   sf_channel/sf_type/sf_order/sf_kc/sf_nwc/sf_kr/sf_nwr [F*C] int32;
//   coeff_words / res_words sized >= (len - pos) / 4 words each.
// coeff_total/res_total receive the written word counts.
int64_t sela_scan_frames(const uint8_t* buf, int64_t len, int64_t pos,
                         int32_t num_frames, int32_t channels, uint32_t sync,
                         int32_t max_samples, int32_t* n_samples,
                         int32_t* sf_channel, int32_t* sf_type,
                         int32_t* sf_order, int32_t* sf_kc, int32_t* sf_nwc,
                         int32_t* sf_kr, int32_t* sf_kr4, int32_t* sf_nwr,
                         uint32_t* coeff_words, int64_t* coeff_total,
                         uint32_t* res_words, int64_t* res_total) {
  int64_t cw = 0, rw = 0;
  int64_t s = 0;
  bool seen[256];  // per-frame channel-byte dedup (channels is a u8 field)
  for (int32_t f = 0; f < num_frames; ++f) {
    if (pos + 6 > len) return -(pos + 1);
    if (ld_u32(buf + pos) != sync) return -(pos + 1);
    int32_t ns = ld_u16(buf + pos + 4);
    if (ns <= 0 || ns > max_samples) return -(pos + 1);
    n_samples[f] = ns;
    pos += 6;
    std::memset(seen, 0, sizeof(seen));
    for (int32_t c = 0; c < channels; ++c, ++s) {
      if (pos + 6 > len) return -(pos + 1);
      // channel byte must be in range and unique within the frame
      // (duplicates would last-write-win in the decoder's dense scatter)
      if (buf[pos] >= channels || seen[buf[pos]]) return -(pos + 1);
      seen[buf[pos]] = true;
      sf_channel[s] = buf[pos];
      sf_type[s] = buf[pos + 1];
      sf_order[s] = buf[pos + 2];
      sf_kc[s] = buf[pos + 3];
      int64_t nwc = ld_u16(buf + pos + 4);
      sf_nwc[s] = static_cast<int32_t>(nwc);
      pos += 6;
      if (pos + 4 * nwc > len) return -(pos + 1);
      std::memcpy(coeff_words + cw, buf + pos, 4 * nwc);
      cw += nwc;
      pos += 4 * nwc;
      if (pos + 5 > len) return -(pos + 1);
      int kr = buf[pos];
      sf_kr[s] = kr;
      sf_kr4[s] = 0;
      if (kr == kPartitionMarker) {
        // FORMAT.md §Partitioned residues: 4 sub-block ks follow the marker
        if (pos + 1 + kResidueParts + 4 > len) return -(pos + 1);
        int32_t kk = 0;
        for (int q = 0; q < kResidueParts; ++q) {
          uint8_t sk = buf[pos + 1 + q];
          if (sk > 31) return -(pos + 1);
          kk |= static_cast<int32_t>(sk) << (8 * q);
        }
        sf_kr4[s] = kk;
        pos += kResidueParts;
      } else if (kr > 31) {
        return -(pos + 1);
      }
      int64_t nwr = ld_u32(buf + pos + 1);
      pos += 5;
      if (nwr < 0 || pos + 4 * nwr > len) return -(pos + 1);
      sf_nwr[s] = static_cast<int32_t>(nwr);
      std::memcpy(res_words + rw, buf + pos, 4 * nwr);
      rw += nwr;
      pos += 4 * nwr;
    }
  }
  *coeff_total = cw;
  *res_total = rw;
  return pos;
}

// Emit num_frames frames into out (caller-sized exactly; see Python side).
// Subframe arrays are in emit order (frame-major, channel idx within frame).
// Returns bytes written.
int64_t sela_emit_frames(int32_t num_frames, int32_t channels, uint32_t sync,
                         const int32_t* n_samples, const int32_t* sf_channel,
                         const int32_t* sf_type, const int32_t* sf_order,
                         const int32_t* sf_kc, const int32_t* sf_nwc,
                         const int32_t* sf_kr, const int32_t* sf_kr4,
                         const int32_t* sf_nwr, const uint32_t* coeff_words,
                         const uint32_t* res_words, uint8_t* out) {
  int64_t pos = 0, cw = 0, rw = 0, s = 0;
  for (int32_t f = 0; f < num_frames; ++f) {
    std::memcpy(out + pos, &sync, 4);
    uint16_t ns = static_cast<uint16_t>(n_samples[f]);
    std::memcpy(out + pos + 4, &ns, 2);
    pos += 6;
    for (int32_t c = 0; c < channels; ++c, ++s) {
      out[pos] = static_cast<uint8_t>(sf_channel[s]);
      out[pos + 1] = static_cast<uint8_t>(sf_type[s]);
      out[pos + 2] = static_cast<uint8_t>(sf_order[s]);
      out[pos + 3] = static_cast<uint8_t>(sf_kc[s]);
      uint16_t nwc = static_cast<uint16_t>(sf_nwc[s]);
      std::memcpy(out + pos + 4, &nwc, 2);
      pos += 6;
      std::memcpy(out + pos, coeff_words + cw, 4ll * sf_nwc[s]);
      cw += sf_nwc[s];
      pos += 4ll * sf_nwc[s];
      out[pos] = static_cast<uint8_t>(sf_kr[s]);
      if (sf_kr[s] == kPartitionMarker) {
        for (int q = 0; q < kResidueParts; ++q)
          out[pos + 1 + q] = static_cast<uint8_t>((sf_kr4[s] >> (8 * q)) & 0xFF);
        pos += kResidueParts;
      }
      uint32_t nwr = static_cast<uint32_t>(sf_nwr[s]);
      std::memcpy(out + pos + 1, &nwr, 4);
      pos += 5;
      std::memcpy(out + pos, res_words + rw, 4ll * sf_nwr[s]);
      rw += sf_nwr[s];
      pos += 4ll * sf_nwr[s];
    }
  }
  return pos;
}

}  // extern "C"
