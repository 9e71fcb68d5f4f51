// minimizers.cpp — minimizer digestion of a batch of reads, one pass per read
// (the -m and -a schemes of src/spumoni.cpp:294-342; the semantics are set
// out in io/minimizers.py). Built by native.py into the same shared library
// as native/spumoni_native.cpp, and called through ctypes, which releases
// the interpreter lock for the call.
//
// For each read of length len, with nk = len - k + 1 k-mers:
//   1. every k-mer's value, rolling: the promotion scheme's 8-bit CyclicHash
//      h(i + 1) = rotl(h(i), 1) ^ rotl(t[s[i]], k) ^ t[s[i + k]], or the
//      DNA scheme's 2k-bit code (the last 32 bases where k > 32); a k-mer
//      holding a non-ACGT byte takes the sentinel, the largest value;
//   2. each window's minimum over its width = min(max(w - k + 1, 1), nk)
//      k-mers (a read with k <= len < w is one truncated window), by
//      doubling: min over 1, 2, 4, ... k-mers, then two overlapping spans;
//   3. windows whose minimum is the sentinel dropped, consecutive equal raw
//      values compressed, then the +3 remap (promotion) or the k-mer's ACGT
//      text (DNA).
//
// The file calls nothing outside itself (the caller passes the scratch
// buffer), so linking it after native/spumoni_native.cpp leaves that
// source's code at the addresses it has in a library built from it alone:
// its hot loops keep their alignment.

#include <cstdint>

namespace {

using u8 = uint8_t;
using i64 = int64_t;

inline u8 rotl8(u8 x, int r) {
  r &= 7;
  return r ? u8((x << r) | (x >> (8 - r))) : x;
}

struct Tables {
  u8 hash[256];     // CyclicHash entries of A, C, G, T; 0 for other bytes
  u8 hash_out[256]; // rotl(hash, k): a byte's term as it leaves the k-mer
  u8 code[256];     // 2-bit codes A=0 < C=1 < G=2 < T=3
  u8 bad[256];      // 1 for every byte but A, C, G, T
};

// vals[i] for i in [0, len - k + 1): the value of the k-mer at i (len >= k)
template <bool kDna, typename V>
void kmer_values(const u8* s, i64 len, int k, const Tables& t, V* vals) {
  constexpr V kSentinel = V(~V(0));
  i64 last_bad = -1;
  if constexpr (kDna) {
    const uint64_t mask = k >= 32 ? ~uint64_t(0)
                                  : (uint64_t(1) << (2 * k)) - 1;
    uint64_t code = 0;
    for (i64 p = 0; p < k - 1; ++p) {
      if (t.bad[s[p]]) last_bad = p;
      code = (code << 2) | t.code[s[p]];
    }
    for (i64 p = k - 1, i = 0; p < len; ++p, ++i) {
      const u8 b = s[p];
      if (t.bad[b]) last_bad = p;
      code = (code << 2) | t.code[b];
      vals[i] = last_bad >= i ? kSentinel : V(code & mask);
    }
  } else {
    u8 h = 0;
    for (i64 p = 0; p < k - 1; ++p) {
      if (t.bad[s[p]]) last_bad = p;
      h = rotl8(h, 1) ^ t.hash[s[p]];
    }
    // the byte leaving the k-mer enters at p - k: none before p = k
    u8 out_k = 0;
    for (i64 p = k - 1, i = 0; p < len; ++p, ++i) {
      const u8 b = s[p];
      if (t.bad[b]) last_bad = p;
      h = rotl8(h, 1) ^ t.hash[b] ^ out_k;
      vals[i] = last_bad >= i ? kSentinel : V(h);
      out_k = t.hash_out[s[i]];
    }
  }
}

// vals[i] <- min(vals[i .. i + width - 1]) for i in [0, n - width + 1)
template <typename V>
void window_mins(V* vals, i64 n, i64 width) {
  i64 span = 1;
  for (; 2 * span <= width; span *= 2)
    for (i64 i = 0; i + span < n; ++i)
      vals[i] = vals[i + span] < vals[i] ? vals[i + span] : vals[i];
  const i64 rest = width - span;
  if (rest > 0)
    for (i64 i = 0; i + rest < n; ++i)
      vals[i] = vals[i + rest] < vals[i] ? vals[i + rest] : vals[i];
}

// one read's digest into out, with v scratch for its nk values; returns
// the bytes written, -1 past cap
template <bool kDna, typename V>
i64 digest_read(const u8* s, i64 len, int k, i64 per, const Tables& t, V* v,
                u8* out, i64 cap) {
  constexpr V kSentinel = V(~V(0));
  const i64 nk = len - k + 1;
  if (nk <= 0) return 0;
  const i64 out_w = kDna ? k : 1;
  if (nk * out_w > cap) return -1;
  kmer_values<kDna>(s, len, k, t, v);
  const i64 width = per < nk ? per : nk;
  window_mins(v, nk, width);
  // keep each window's minimum that is valid and differs from the last
  // kept one, compacted in place without a branch (n <= i)
  i64 n = 0;
  V last = kSentinel;
  for (i64 i = 0, nwin = nk - width + 1; i < nwin; ++i) {
    const V m = v[i];
    v[n] = m;
    n += (m != kSentinel) & (m != last);
    last = m == kSentinel ? last : m;
  }
  if constexpr (kDna) {
    for (i64 j = 0; j < n; ++j)
      for (int c = 0; c < k; ++c) {
        const int sh = 2 * (k - 1 - c);
        out[j * k + c] = "ACGT"[sh < 64 ? (v[j] >> sh) & 3 : 0];
      }
  } else {
    for (i64 j = 0; j < n; ++j)
      out[j] = u8(v[j] > 2 ? v[j] : v[j] + 3);
  }
  return n * out_w;
}

template <bool kDna, typename V>
i64 digest_reads(const u8* buf, const i64* offs, i64 nreads, int k, i64 per,
                 const Tables& t, V* scratch, u8* out, i64 cap,
                 i64* out_offs) {
  out_offs[0] = 0;
  for (i64 r = 0; r < nreads; ++r) {
    const i64 o = out_offs[r];
    const i64 m = digest_read<kDna, V>(buf + offs[r], offs[r + 1] - offs[r],
                                       k, per, t, scratch, out + o, cap - o);
    if (m < 0) return -1;
    out_offs[r + 1] = o + m;
  }
  return out_offs[nreads];
}

}  // namespace

extern "C" {

// Digests reads buf[offs[r]:offs[r+1]], r < nreads: the DNA-letter scheme if
// dna, else the promotion scheme with hash4 the CyclicHash entries of A, C,
// G, T. scratch holds 8 bytes for each k-mer of the longest read. Writes
// the digests back to back into out (cap bytes) and their bounds into
// out_offs[0..nreads]. Returns the bytes written, -1 if they pass cap, -2
// if k < 1.
i64 spn_digest_reads(const u8* buf, const i64* offs, i64 nreads, int dna,
                     int k, int w, const u8* hash4, uint64_t* scratch, u8* out,
                     i64 cap, i64* out_offs) {
  if (k < 1) return -2;
  Tables t;
  for (int b = 0; b < 256; ++b) {
    t.hash[b] = 0;
    t.hash_out[b] = 0;
    t.code[b] = 0;
    t.bad[b] = 1;
  }
  const u8 acgt[4] = {'A', 'C', 'G', 'T'};
  for (int c = 0; c < 4; ++c) {
    t.hash[acgt[c]] = hash4[c];
    t.hash_out[acgt[c]] = rotl8(hash4[c], k);
    t.code[acgt[c]] = u8(c);
    t.bad[acgt[c]] = 0;
  }
  const i64 per = i64(w) - k + 1 > 1 ? i64(w) - k + 1 : 1;
  return dna ? digest_reads<true>(buf, offs, nreads, k, per, t, scratch, out,
                                  cap, out_offs)
             : digest_reads<false>(buf, offs, nreads, k, per, t,
                                   reinterpret_cast<uint16_t*>(scratch), out,
                                   cap, out_offs);
}

}  // extern "C"
