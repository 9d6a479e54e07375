// Native .miso sample-block formatter.
//
// Formats quantized posterior samples (psi ticks at 1e-4, log-score
// centipoints) into the exact `.miso` text body
// ("p1,p2,...\tscore\n" with "%.4f" psi and "%.2f" scores;
// reference format: misopy/miso_sampler.py:458-464).  The vectorized
// numpy formatter (io/miso_file.py::_format_quantized) runs at
// ~0.6 ms/event; this loop runs at memory speed and is the write-phase
// hot path for catalog-scale runs.
//
// Contract matches the numpy formatter exactly:
//  - q[s*I + i] in [0, 10000] -> "0.xxxx" / "1.0000"
//  - cents[s] signed centipoints; neg[s] forces the '-' sign (covers
//    "-0.00", whose sign is lost in the rounded integer)
//  - out: caller-allocated, >= S * (7*I + 30) bytes
//  - off[s]: byte offset of line s (off[S] = total length)
// Returns total bytes written.
#include <cstdint>

extern "C" int64_t miso_format_quantized(
    const int64_t* q, int64_t S, int64_t I,
    const int64_t* cents, const uint8_t* neg,
    uint8_t* out, int64_t* off) {
  uint8_t* p = out;
  off[0] = 0;
  for (int64_t s = 0; s < S; ++s) {
    const int64_t* row = q + s * I;
    for (int64_t i = 0; i < I; ++i) {
      if (i) *p++ = ',';
      int64_t t = row[i];
      *p++ = (uint8_t)('0' + t / 10000);
      *p++ = '.';
      int64_t r = t % 10000;
      p[0] = (uint8_t)('0' + r / 1000);
      p[1] = (uint8_t)('0' + (r / 100) % 10);
      p[2] = (uint8_t)('0' + (r / 10) % 10);
      p[3] = (uint8_t)('0' + r % 10);
      p += 4;
    }
    *p++ = '\t';
    int64_t c = cents[s];
    uint64_t a = c < 0 ? (uint64_t)(-(c + 1)) + 1 : (uint64_t)c;
    uint64_t ip = a / 100, fr = a % 100;
    if (neg[s]) *p++ = '-';
    uint8_t buf[24];
    int nd = 0;
    do {
      buf[nd++] = (uint8_t)('0' + ip % 10);
      ip /= 10;
    } while (ip);
    while (nd) *p++ = buf[--nd];
    *p++ = '.';
    *p++ = (uint8_t)('0' + fr / 10);
    *p++ = (uint8_t)('0' + fr % 10);
    *p++ = '\n';
    off[s + 1] = p - out;
  }
  return p - out;
}
