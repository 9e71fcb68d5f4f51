// values_writer.cpp — the value files of a batch (.pseudo_lengths, .lengths,
// .pointers, .doc_numbers), one pass per file over the batch's rows, with the
// bin-max classification of each read (classify/binmax.py) in the same pass
// over the lengths. Built by native.py into the same shared library as
// native/spumoni_native.cpp, and called through ctypes, which releases the
// interpreter lock for the call.
//
// A record is ">id\n", then each value followed by one space, then "\n"
// (report.write_values_record). A value prints as unsigned 64-bit after
// sign extension, so a negative one prints as the reference's size_t
// underflow (native.format_values). The caller owns the output buffer and
// calls again, from the state the last call left, until every record is
// out: a record may straddle two calls.
//
// The file calls nothing outside itself, so linking it after
// native/spumoni_native.cpp leaves that source's code at the addresses it
// has in a library built from it alone: its hot loops keep their alignment.

#include <cstdint>

namespace {

using u8 = uint8_t;
using i64 = int64_t;
using u32 = uint32_t;
using u64 = uint64_t;

// the most bytes a value takes: 20 digits of a 64-bit value and its space
constexpr i64 kMaxValue = 21;

struct Pairs {
  char d[200];  // "00" "01" ... "99"
  constexpr Pairs() : d() {
    for (int i = 0; i < 100; ++i) {
      d[2 * i] = char('0' + i / 10);
      d[2 * i + 1] = char('0' + i % 10);
    }
  }
};
constexpr Pairs kPairs;

inline int digits(u64 x) {
  if (x < 10) return 1;
  if (x < 100) return 2;
  if (x < 1000) return 3;
  if (x < 10000) return 4;
  if (x < 100000) return 5;
  int n = 6;
  for (x /= 1000000; x; x /= 10) ++n;
  return n;
}

// the n decimal digits of x at p, two at a time from the last
template <class U>
inline char* put_digits(char* p, U x, int n) {
  char* q = p + n;
  while (x >= 100) {
    const unsigned r = unsigned(x % 100);
    x /= 100;
    q -= 2;
    q[0] = kPairs.d[2 * r];
    q[1] = kPairs.d[2 * r + 1];
  }
  if (x >= 10) {
    q[-2] = kPairs.d[2 * x];
    q[-1] = kPairs.d[2 * x + 1];
  } else {
    q[-1] = char('0' + x);
  }
  return p + n;
}

inline char* put_value(char* p, i64 v) {
  const u64 x = u64(v);
  if (x < 10) {  // most matching statistics and document ids
    p[0] = char('0' + x);
    p[1] = ' ';
    return p + 2;
  }
  if (x < 100) {
    p[0] = kPairs.d[2 * x];
    p[1] = kPairs.d[2 * x + 1];
    p[2] = ' ';
    return p + 3;
  }
  p = x <= 0xFFFFFFFFu ? put_digits<u32>(p, u32(x), digits(x))
                       : put_digits<u64>(p, x, digits(x));
  *p++ = ' ';
  return p;
}

// values k.. of the n at v, while they surely fit before end; returns the
// next value's index
template <class T>
i64 put_values(const T* v, i64 k, i64 n, char*& p, char* end) {
  while (k < n) {
    const i64 fit = (end - p) / kMaxValue;
    if (fit == 0) break;
    const i64 stop = n - k < fit ? n : k + fit;
    char* q = p;
    for (; k < stop; ++k) q = put_value(q, i64(v[k]));
    p = q;
  }
  return k;
}

// binmax.classify's windows: width values each, a tail shorter than width
// merged into the window before it; a window is above where its max is at
// least thr
template <class T>
void bin_max(const T* v, i64 n, i64 width, i64 thr, i64* above, i64* below,
             i64* sum_maxes) {
  i64 a = 0, b = 0, s = 0;
  for (i64 start = 0; start < n;) {
    i64 end = start + width < n ? start + width : n;
    if (n - end < width) end = n;
    i64 mv = i64(v[start]);
    for (i64 j = start + 1; j < end; ++j)
      if (i64(v[j]) > mv) mv = i64(v[j]);
    if (mv >= thr) ++a; else ++b;
    s += mv;
    start = end;
  }
  *above = a;
  *below = b;
  *sum_maxes = s;
}

template <class T>
i64 format_records(const i64* rows, const i64* counts, i64 nreads,
                   const u8* ids, const i64* id_offs, char* out, i64 cap,
                   i64* state, i64 bin_width, i64 thr, i64* above,
                   i64* below, i64* sum_maxes) {
  char* p = out;
  char* const end = out + cap;
  i64 r = state[0], k = state[1];
  while (r < nreads) {
    const T* v = reinterpret_cast<const T*>(rows[r]);
    const i64 n = counts[r];
    if (k < 0) {
      const i64 a = id_offs[r], len = id_offs[r + 1] - a;
      if (end - p < len + 2) break;
      *p++ = '>';
      for (i64 j = 0; j < len; ++j) p[j] = char(ids[a + j]);
      p += len;
      *p++ = '\n';
      if (above)
        bin_max(v, n, bin_width, thr, above + r, below + r, sum_maxes + r);
      k = 0;
    }
    k = put_values(v, k, n, p, end);
    if (k < n || p == end) break;
    *p++ = '\n';
    ++r;
    k = -1;
  }
  state[0] = r;
  state[1] = k;
  if (p == out && r < nreads) return -1;  // not even one value fits
  return i64(p - out);
}

}  // namespace

extern "C" {

// Formats the records of reads state[0].. into out (cap bytes): read r has
// the counts[r] values of itemsize bytes (4: int32, 8: int64) at address
// rows[r] and the id ids[id_offs[r]:id_offs[r + 1]]. state is {read, next
// value}, value -1 before the read's header: {0, -1} at the start, left
// where this call stopped. With above non-null, each read's bin-max over
// bin_width values against thr goes to above[r], below[r] and
// sum_maxes[r] as its header is written. Returns the bytes written, -1 if
// out cannot hold the next header or value, -2 on a bad itemsize or width.
i64 spn_format_records(const i64* rows, const i64* counts, i64 nreads,
                       int itemsize, const u8* ids, const i64* id_offs,
                       char* out, i64 cap, i64* state, i64 bin_width,
                       i64 thr, i64* above, i64* below, i64* sum_maxes) {
  if (above && bin_width < 1) return -2;
  if (itemsize == 4)
    return format_records<int32_t>(rows, counts, nreads, ids, id_offs, out,
                                   cap, state, bin_width, thr, above, below,
                                   sum_maxes);
  if (itemsize == 8)
    return format_records<int64_t>(rows, counts, nreads, ids, id_offs, out,
                                   cap, state, bin_width, thr, above, below,
                                   sum_maxes);
  return -2;
}

}  // extern "C"
