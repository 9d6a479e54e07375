// Native .miso sample-block parser.
//
// Parses the sample lines of a .miso file ("p1,p2,...\tscore\n") into a
// float64 matrix at memory speed.  Two properties matter:
//  - ctypes calls release the GIL, so catalog-scale summarize/compare
//    loads parallelize across real cores (the numpy token parse holds
//    the GIL and serializes the thread pool);
//  - psi fields written by this framework are always fixed-width
//    "d.dddd", which parses with integer digit math (~10x strtod);
//    anything else (reference-written files, scores, exponents) falls
//    back to strtod per token, so any valid float still parses.
//
// Returns the number of values written, or -1 if the block is ragged
// (differing column counts per row) or malformed -- callers fall back
// to the Python parser, which reproduces the legacy per-line behavior.
#include <cstdint>
#include <cstdlib>

namespace {

// fast path: "d.dddd" (exactly 4 decimals).  Returns true and advances
// *pp past the token iff it matches; the value equals strtod's result
// for these tokens (dddd / 1e4 with one correctly-rounded division).
inline bool parse_fixed_psi(const char** pp, const char* end, double* out) {
  const char* p = *pp;
  if (end - p < 6) return false;
  if (p[0] < '0' || p[0] > '9' || p[1] != '.') return false;
  for (int i = 2; i < 6; ++i)
    if (p[i] < '0' || p[i] > '9') return false;
  if (end - p > 6) {
    char c = p[6];
    if (c != ',' && c != '\t' && c != '\n' && c != '\r') return false;
  }
  int64_t v = (int64_t)(p[0] - '0') * 10000
      + (p[2] - '0') * 1000 + (p[3] - '0') * 100
      + (p[4] - '0') * 10 + (p[5] - '0');
  *out = (double)v / 10000.0;
  *pp = p + 6;
  return true;
}

}  // namespace

extern "C" int64_t miso_parse_samples(
    const char* buf, int64_t len, double* out, int64_t max_vals,
    int64_t* ncols_out) {
  const char* p = buf;
  const char* end = buf + len;
  int64_t n = 0;
  int64_t ncols = -1;
  while (p < end) {
    // skip blank lines
    if (*p == '\n' || *p == '\r') { ++p; continue; }
    int64_t row_cols = 0;
    for (;;) {
      double v;
      if (!parse_fixed_psi(&p, end, &v)) {
        char* q;
        v = strtod(p, &q);
        if (q == p) return -1;  // not a number
        p = q;
      }
      if (n >= max_vals) return -1;
      out[n++] = v;
      ++row_cols;
      if (p >= end) break;
      char c = *p;
      if (c == ',' || c == '\t') { ++p; continue; }
      if (c == '\n') { ++p; break; }
      if (c == '\r') { ++p; if (p < end && *p == '\n') ++p; break; }
      return -1;  // junk between tokens
    }
    if (ncols < 0) ncols = row_cols;
    else if (row_cols != ncols) return -1;  // ragged
  }
  if (ncols < 2) return -1;  // need >= 1 psi column + score
  *ncols_out = ncols;
  return n;
}
