// Host ETL for the RNA-seq data path: a multithreaded CSV -> float32
// matrix parser and column z-scores, behind a plain C interface that
// ctypes loads (hyperbolic_vae_tpu_torch/data/native.py).
//
// The heaviest host work of the Jerby-Arnon path is parsing the
// ~23k-gene x ~7k-cell GSE115978 TPM CSV. The parse is parallel over row
// ranges and writes straight into a caller-provided float32 buffer.
//
// Built at first use with g++ (-O3 -std=c++17 -fPIC -pthread -shared)
// into the package's git-ignored _build/ directory, keyed by a hash of
// this file. The same code as the JAX package's parser, so both give the
// same bits.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <string>
#include <thread>
#include <vector>

namespace {

// Hand-rolled decimal float parser: strtof is locale-aware and dominates
// the parse profile. Handles [+-]?digits[.digits]?([eE][+-]?digits)? with
// double accumulation (exact for the <= 9 significant digits these TPM
// files carry); anything unusual falls back to strtof.
static const double kPow10[] = {
    1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,  1e8,  1e9,  1e10,
    1e11, 1e12, 1e13, 1e14, 1e15, 1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};

inline const char* parse_float(const char* p, const char* end, float* out) {
  const char* start = p;
  bool neg = false;
  if (p < end && (*p == '-' || *p == '+')) {
    neg = (*p == '-');
    ++p;
  }
  uint64_t mant = 0;
  int digits = 0;
  int frac_digits = 0;
  bool any = false;
  while (p < end && *p >= '0' && *p <= '9') {
    if (digits < 18) {
      mant = mant * 10 + static_cast<uint64_t>(*p - '0');
      ++digits;
    } else {
      ++frac_digits;  // reuse as "dropped integer digits" (negated below)
    }
    any = true;
    ++p;
  }
  int dropped_int = frac_digits;
  frac_digits = 0;
  if (p < end && *p == '.') {
    ++p;
    while (p < end && *p >= '0' && *p <= '9') {
      if (digits < 18) {
        mant = mant * 10 + static_cast<uint64_t>(*p - '0');
        ++digits;
        ++frac_digits;
      }
      any = true;
      ++p;
    }
  }
  if (!any) {  // not a plain number (nan/inf/empty/NA) -> strtof fallback
    char* next = nullptr;
    *out = std::strtof(start, &next);
    if (next && next <= end && next > start) return next;
    // unparseable field (empty, "NA", ...): emit NaN and leave the cursor
    // at the field start so the caller's comma scan still advances — one
    // missing value must not fail the whole file
    *out = std::nanf("");
    return start;
  }
  int exp10 = dropped_int - frac_digits;
  if (p < end && (*p == 'e' || *p == 'E')) {
    ++p;
    bool eneg = false;
    if (p < end && (*p == '-' || *p == '+')) {
      eneg = (*p == '-');
      ++p;
    }
    int e = 0;
    while (p < end && *p >= '0' && *p <= '9') {
      e = e * 10 + (*p - '0');
      ++p;
    }
    exp10 += eneg ? -e : e;
  }
  double v = static_cast<double>(mant);
  if (exp10 > 0) {
    v = (exp10 <= 22) ? v * kPow10[exp10] : v * std::pow(10.0, exp10);
  } else if (exp10 < 0) {
    int e = -exp10;
    v = (e <= 22) ? v / kPow10[e] : v / std::pow(10.0, e);
  }
  *out = static_cast<float>(neg ? -v : v);
  return p;
}

// RFC-4180 quote-aware comma scan: a comma inside a quoted field is not
// a delimiter (pandas and pyarrow honor quoting; a quote-blind memchr
// would silently SHIFT every later column of the row). Doubled quotes ("") inside a quoted field are the escaped-quote
// form and stay inside the field.
inline const char* find_comma(const char* p, const char* end) {
  bool in_quotes = false;
  for (; p < end; ++p) {
    if (*p == '"') {
      in_quotes = !in_quotes;
    } else if (*p == ',' && !in_quotes) {
      return p;
    }
  }
  return nullptr;
}

// Fast path for rows verified to contain no '"' at all (the overwhelming
// case for numeric TPM matrices): plain SIMD memchr. Callers check for a
// quote ONCE per row (one vectorized scan) and only fall back to the
// byte-at-a-time quote-aware walk when the row actually carries one —
// keeping the multithreaded scan memchr-bound, not branch-bound.
inline const char* find_comma_in(const char* p, const char* end,
                                 bool has_quote) {
  if (!has_quote) {
    return static_cast<const char*>(
        memchr(p, ',', static_cast<size_t>(end - p)));
  }
  return find_comma(p, end);
}

// Parse one field as float32, honoring surrounding whitespace, an
// optional CR (CRLF files), and RFC-4180 quoting ("1234.5"). Unparseable
// fields yield NaN (one missing value must not fail the file). `end` is
// the exclusive end of the FIELD (next unquoted comma or line end).
inline void parse_field(const char* p, const char* end, float* out) {
  while (p < end && (*p == ' ' || *p == '\t')) ++p;
  while (end > p && (end[-1] == ' ' || end[-1] == '\t' || end[-1] == '\r')) --end;
  if (p < end && *p == '"' && end[-1] == '"' && end - p >= 2) {
    ++p;
    --end;
  }
  if (p >= end) {
    *out = std::nanf("");
    return;
  }
  const char* next = parse_float(p, end, out);
  // loud-NaN any field with trailing junk the parser did not consume
  // ("1.5x", "1.5 2.5"): a silently truncated parse would poison the
  // downstream matrix with plausible-looking numbers
  while (next < end && (*next == ' ' || *next == '\t')) ++next;
  if (next != end) *out = std::nanf("");
}

struct FileMap {
  std::string data;
  bool ok = false;
};

FileMap read_file(const char* path) {
  FileMap fm;
  std::ifstream f(path, std::ios::binary | std::ios::ate);
  if (!f) return fm;
  std::streamsize size = f.tellg();
  f.seekg(0);
  fm.data.resize(static_cast<size_t>(size));
  if (!f.read(fm.data.data(), size)) return fm;
  fm.ok = true;
  return fm;
}

// Index of line-start offsets (excluding a final empty line).
std::vector<size_t> line_starts(const std::string& s) {
  std::vector<size_t> starts;
  starts.push_back(0);
  for (size_t i = 0; i < s.size(); ++i) {
    if (s[i] == '\n' && i + 1 < s.size()) starts.push_back(i + 1);
  }
  return starts;
}

}  // namespace

extern "C" {

// Count data rows and columns of a CSV. Returns 0 on success.
// rows excludes the header; cols counts value columns after skipping
// `skip_cols` leading columns (e.g. the gene-symbol index column).
int hvae_csv_shape(const char* path, int skip_header, int skip_cols,
                   int64_t* rows, int64_t* cols) {
  FileMap fm = read_file(path);
  if (!fm.ok) return 1;
  std::vector<size_t> starts = line_starts(fm.data);
  int64_t n_lines = static_cast<int64_t>(starts.size());
  if (n_lines <= skip_header) return 2;
  *rows = n_lines - skip_header;
  // count columns on the first data line (quote-aware: a comma inside a
  // quoted gene symbol is not a delimiter)
  size_t begin = starts[skip_header];
  size_t end = fm.data.find('\n', begin);
  if (end == std::string::npos) end = fm.data.size();
  const char* p = fm.data.data() + begin;
  const char* line_end = fm.data.data() + end;
  const bool has_quote =
      memchr(p, '"', static_cast<size_t>(line_end - p)) != nullptr;
  if (has_quote) {
    int64_t nq = 0;
    for (const char* q = p; (q = static_cast<const char*>(memchr(
             q, '"', static_cast<size_t>(line_end - q)))) != nullptr;
         ++q) {
      ++nq;
    }
    if (nq & 1) return 6;  // unterminated quote on the first data line
  }
  int64_t commas = 0;
  while ((p = find_comma_in(p, line_end, has_quote)) != nullptr) {
    ++commas;
    ++p;
  }
  *cols = commas + 1 - skip_cols;
  return 0;
}

// Parse the CSV into a row-major float32 matrix `out` of shape
// (rows, cols), skipping `skip_header` lines and `skip_cols` leading
// columns per line. Parallel over row ranges. Returns 0 on success.
int hvae_csv_read_f32(const char* path, int skip_header, int skip_cols,
                      float* out, int64_t rows, int64_t cols, int n_threads) {
  FileMap fm = read_file(path);
  if (!fm.ok) return 1;
  std::vector<size_t> starts = line_starts(fm.data);
  if (static_cast<int64_t>(starts.size()) < skip_header + rows) return 2;
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 4;
  }
  const char* base = fm.data.data();
  const char* file_end = base + fm.data.size();
  std::atomic<int> error{0};

  auto worker = [&](int64_t r0, int64_t r1) {
    for (int64_t r = r0; r < r1; ++r) {
      const char* p = base + starts[skip_header + r];
      const char* line_end = static_cast<const char*>(
          memchr(p, '\n', static_cast<size_t>(file_end - p)));
      if (!line_end) line_end = file_end;
      // one vectorized quote probe per row picks the scan: memchr for
      // quote-free rows (the normal numeric-matrix case), the RFC-4180
      // quote-aware walk otherwise
      const bool has_quote =
          memchr(p, '"', static_cast<size_t>(line_end - p)) != nullptr;
      if (has_quote) {
        // RFC-4180 rows always carry an EVEN number of quotes (field
        // wrappers + doubled escapes). An odd count means an
        // unterminated quote — most often a quoted field with an
        // embedded newline, which the physical-line scanner splits into
        // fragments whose field counts can ACCIDENTALLY line up and
        // mis-parse silently. Reject loudly instead (code 6).
        int64_t nq = 0;
        for (const char* q = p; (q = static_cast<const char*>(memchr(
                 q, '"', static_cast<size_t>(line_end - q)))) != nullptr;
             ++q) {
          ++nq;
        }
        if (nq & 1) { error.store(6); return; }
      }
      // skip leading (index) columns — quote-aware: a comma inside a
      // quoted gene symbol must not shift the whole row
      for (int s = 0; s < skip_cols; ++s) {
        const char* comma = find_comma_in(p, line_end, has_quote);
        if (!comma) { error.store(3); return; }  // ragged: too few fields
        p = comma + 1;
      }
      float* dst = out + r * cols;
      for (int64_t cidx = 0; cidx < cols; ++cidx) {
        const char* comma = find_comma_in(p, line_end, has_quote);
        const char* field_end = comma ? comma : line_end;
        if (!comma && cidx + 1 < cols) { error.store(4); return; }  // ragged: too few fields
        if (comma && cidx + 1 == cols) { error.store(5); return; }  // ragged: EXTRA fields
        parse_field(p, field_end, &dst[cidx]);
        p = field_end + 1;
      }
    }
  };

  std::vector<std::thread> threads;
  int64_t chunk = (rows + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t r0 = t * chunk;
    int64_t r1 = std::min(rows, r0 + chunk);
    if (r0 >= r1) break;
    threads.emplace_back(worker, r0, r1);
  }
  for (auto& th : threads) th.join();
  return error.load();
}

// In-place column z-score with ddof=1 (the reference's scipy.stats.zscore
// path uses ddof=0; the python wrapper chooses by flag). Parallel over
// column ranges. data is row-major (rows, cols).
int hvae_zscore_columns(float* data, int64_t rows, int64_t cols, int ddof,
                        int n_threads) {
  if (rows <= ddof) return 1;
  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 4;
  }
  auto worker = [&](int64_t c0, int64_t c1) {
    for (int64_t c = c0; c < c1; ++c) {
      double sum = 0.0, sq = 0.0;
      for (int64_t r = 0; r < rows; ++r) {
        double v = data[r * cols + c];
        sum += v;
        sq += v * v;
      }
      double mean = sum / rows;
      double var = (sq - sum * mean) / (rows - ddof);
      double inv = var > 1e-24 ? 1.0 / std::sqrt(var) : 0.0;
      for (int64_t r = 0; r < rows; ++r) {
        data[r * cols + c] = static_cast<float>((data[r * cols + c] - mean) * inv);
      }
    }
  };
  std::vector<std::thread> threads;
  int64_t chunk = (cols + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t c0 = t * chunk;
    int64_t c1 = std::min(cols, c0 + chunk);
    if (c0 >= c1) break;
    threads.emplace_back(worker, c0, c1);
  }
  for (auto& th : threads) th.join();
  return 0;
}

}  // extern "C"
