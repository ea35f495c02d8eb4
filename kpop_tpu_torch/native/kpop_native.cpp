// kpop-tpu native host runtime: sequence IO + encoding + counting hot loops.
//
// The reference's native components are OCaml executables whose hot loops are
// per-read k-mer hashing and text parsing (reference bin/KPopCount.ml:20-64,
// BiOCamLib Files.ReadsIterate / Sequences.Lint).  Here the equivalents are
// C++ kernels exposed through a C ABI (consumed via ctypes,
// kpop_tpu/native/__init__.py): they feed int8 base-code batches to the TPU
// pipeline and provide the dense host counting path.
//
// Encoding contract (must match kpop_tpu/core/kmers.py exactly):
//   A=0 C=1 G=2 T=3 (case-insensitive), U->T, '-' removed (gap joins
//   flanks), everything else -> -1 (window break).  Canonical double-
//   stranded code = min(forward, reverse-complement), first base most
//   significant (2 bits/base).

#include <algorithm>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

namespace {

struct DnaTables {
  int8_t code[256];
  DnaTables() {
    std::memset(code, -1, sizeof(code));
    code[(unsigned)'A'] = 0; code[(unsigned)'a'] = 0;
    code[(unsigned)'C'] = 1; code[(unsigned)'c'] = 1;
    code[(unsigned)'G'] = 2; code[(unsigned)'g'] = 2;
    code[(unsigned)'T'] = 3; code[(unsigned)'t'] = 3;
    code[(unsigned)'U'] = 3; code[(unsigned)'u'] = 3;
    code[(unsigned)'-'] = -2;  // dash: removed entirely
  }
};
const DnaTables kDna;

// Protein: base-20 over "ACDEFGHIKLMNPQRSTVWY" (core/kmers.py
// PROTEIN_ALPHABET; reference protein mode bin/KPopCount.ml:66-82),
// lowercase accepted, dashes removed, anything else -> -1 (window break).
struct ProtTables {
  int8_t code[256];
  ProtTables() {
    std::memset(code, -1, sizeof(code));
    const char* a = "ACDEFGHIKLMNPQRSTVWY";
    for (int i = 0; a[i]; ++i) {
      code[(unsigned)a[i]] = (int8_t)i;
      code[(unsigned)(a[i] + 32)] = (int8_t)i;
    }
    code[(unsigned)'-'] = -2;
  }
};
const ProtTables kProt;

// Emit one double as %.{precision}g into p (capacity guaranteed by caller).
// Integral values whose digit count fits the precision take a fast itoa
// path (identical bytes to %g, which prints such values without exponent
// or trailing '.'); everything else goes through std::to_chars, whose
// general-format-with-precision output is byte-identical to printf %g
// (verified over randomized magnitudes 1e-320..1e320, specials, and
// precisions 1..40 at build time of this design) but ~2.7x faster than
// glibc snprintf, locale-free.
inline char* format_g(char* p, double v, int precision) {
  // range guards BEFORE the float->int cast: for inf/NaN/|v|>=2^63 the
  // conversion is UB (inf/NaN table cells are legal and round-tripped by
  // the fuzz parity test, so this path is exercised routinely)
  if (std::isfinite(v) && std::fabs(v) < 1e15 && v == (double)(int64_t)v) {
    int64_t iv = (int64_t)v;
    uint64_t a = iv < 0 ? (uint64_t)(-iv) : (uint64_t)iv;
    char tmp[24];
    int nd = 0;
    do {
      tmp[nd++] = (char)('0' + a % 10);
      a /= 10;
    } while (a);
    if (nd <= precision) {
      if (iv < 0 || (iv == 0 && std::signbit(v))) *p++ = '-';
      while (nd) *p++ = tmp[--nd];
      return p;
    }
  }
  auto r = std::to_chars(p, p + precision + 24, v,
                         std::chars_format::general, precision);
  return r.ec == std::errc() ? r.ptr
                             : p + snprintf(p, (size_t)precision + 24, "%.*g",
                                            precision, v);
}

// Format rows [r0, r1) of a TSV block into dst (capacity dcap); returns
// bytes written or -1 on insufficient capacity.
int64_t format_tsv_rows(const double* vals, int64_t r0, int64_t r1,
                        int64_t cols, int32_t precision,
                        const uint8_t* names_buf, const int64_t* name_off,
                        const int64_t* name_len, int32_t with_prefix,
                        int32_t lead_sep, int64_t pv, char* dst,
                        int64_t dcap) {
  char* p = dst;
  char* end = dst + dcap;
  for (int64_t i = r0; i < r1; ++i) {
    int64_t pre = with_prefix ? name_len[i] : 0;
    if (end - p < pre + cols * pv + 2) return -1;
    if (with_prefix) {
      std::memcpy(p, names_buf + name_off[i], pre);
      p += pre;
    }
    const double* row = vals + i * cols;
    for (int64_t j = 0; j < cols; ++j) {
      if (j > 0 || with_prefix || lead_sep) *p++ = '\t';
      p = format_g(p, row[j], precision);
    }
    *p++ = '\n';
  }
  return p - dst;
}

// Parse one TSV matrix body line: <name> ('\t' <float>)*cols.
// Numeric fields may be wrapped in double quotes and padded with spaces
// (Python's float() tolerates both; so does the reference's OCaml reader).
// Returns 0 on success, -1 on malformed float / wrong column count.
int parse_tsv_line(const uint8_t* buf, int64_t pos, int64_t end, int64_t cols,
                   double* out, int64_t* nm_off, int64_t* nm_len) {
  int64_t ne = pos;
  while (ne < end && buf[ne] != '\t') ++ne;
  *nm_off = pos;
  *nm_len = ne - pos;
  int64_t p = ne;
  for (int64_t j = 0; j < cols; ++j) {
    if (p >= end || buf[p] != '\t') return -1;
    ++p;
    // Accept exactly a subset of what the Python fallback
    // float(field.strip('"')) accepts, so no field parses natively that
    // Python would reject: quotes only at the field's extreme ends (at
    // most one here; more fall back), space padding only inside them, an
    // explicit '+' not followed by another sign (from_chars would accept
    // "+-5" as -5), and no "nan(n-char-seq)" forms.
    if (p < end && buf[p] == '"') ++p;
    while (p < end && buf[p] == ' ') ++p;
    if (p < end && buf[p] == '+') {
      ++p;
      if (p < end && (buf[p] == '+' || buf[p] == '-')) return -1;
    }
    auto r = std::from_chars((const char*)buf + p, (const char*)buf + end,
                             out[j]);
    if (r.ec != std::errc()) return -1;
    // from_chars accepts "nan(n-char-seq)"; Python float() does not
    if (std::isnan(out[j]))
      for (const char* q = (const char*)buf + p; q < r.ptr; ++q)
        if (*q == '(') return -1;
    p = r.ptr - (const char*)buf;
    while (p < end && buf[p] == ' ') ++p;
    if (p < end && buf[p] == '"') ++p;
  }
  return p == end ? 0 : -1;
}

}  // namespace

extern "C" {

// Parse the body of a TSV named matrix (all lines after the header) into a
// dense row-major [rows, cols] float64 block plus per-row name spans.
// line_start/line_end index the (non-empty) body lines within buf.
// Multithreaded over line ranges (each line writes its own row).
// Returns the number of rows parsed, or -(line_index+1) for the first
// malformed line (caller falls back to the tolerant Python reader).
int64_t kpop_parse_tsv(const uint8_t* buf, const int64_t* line_start,
                       const int64_t* line_end, int64_t n_lines, int64_t cols,
                       double* vals, int64_t* name_off, int64_t* name_len,
                       int32_t n_threads) {
  int64_t T = n_threads > 1 ? std::min<int64_t>(n_threads, n_lines / 4096) : 1;
  if (T <= 1) {
    for (int64_t i = 0; i < n_lines; ++i)
      if (parse_tsv_line(buf, line_start[i], line_end[i], cols,
                         vals + i * cols, name_off + i, name_len + i))
        return -(i + 1);
    return n_lines;
  }
  std::vector<int64_t> errs(T, 0);
  std::vector<std::thread> ts;
  const int64_t step = (n_lines + T - 1) / T;
  for (int64_t t = 0; t < T; ++t) {
    ts.emplace_back([&, t] {
      int64_t l0 = t * step, l1 = std::min(n_lines, l0 + step);
      for (int64_t i = l0; i < l1; ++i)
        if (parse_tsv_line(buf, line_start[i], line_end[i], cols,
                           vals + i * cols, name_off + i, name_len + i)) {
          errs[t] = -(i + 1);
          return;
        }
    });
  }
  for (auto& th : ts) th.join();
  for (int64_t t = 0; t < T; ++t)
    if (errs[t]) return errs[t];
  return n_lines;
}

// Format a [rows, cols] float64 block as TSV text.  Per row:
//   [prefix bytes] (sep '\t' before each value; suppressed before the first
//   value when with_prefix==0 and lead_sep==0) values as %.{precision}g,
//   then '\n'.  Prefixes (row name, or name+metadata fields pre-joined) are
//   concatenated in names_buf at name_off/name_len.
// Returns bytes written, or -1 if cap could be exceeded (caller sizes cap
// as rows*(max_prefix + cols*40 + 2), so -1 never happens in practice).
int64_t kpop_format_tsv(const double* vals, int64_t rows, int64_t cols,
                        int32_t precision, const uint8_t* names_buf,
                        const int64_t* name_off, const int64_t* name_len,
                        int32_t with_prefix, int32_t lead_sep, char* out,
                        int64_t cap, int32_t n_threads) {
  const int64_t pv = (int64_t)precision + 12;
  int64_t max_pre = 0;
  if (with_prefix)
    for (int64_t i = 0; i < rows; ++i) max_pre = std::max(max_pre, name_len[i]);
  const int64_t rowcap = max_pre + cols * pv + 2;
  int64_t T = n_threads > 1 ? std::min<int64_t>(n_threads, rows / 4096) : 1;
  if (T > 1 && rows * rowcap <= cap) {
    // Partition rows into T chunks; chunk i formats into its own region of
    // out (worst-case spaced at rowcap/row, which the caller's cap covers),
    // then regions are compacted left.  This is the multithreaded analogue
    // of the reference's fork-parallel chunk writer (lib/KMerDB.ml:1004+).
    std::vector<int64_t> lens(T);
    std::vector<std::thread> ts;
    const int64_t step = (rows + T - 1) / T;
    for (int64_t t = 0; t < T; ++t) {
      ts.emplace_back([&, t] {
        int64_t r0 = t * step, r1 = std::min(rows, r0 + step);
        lens[t] = r0 >= r1 ? 0
                           : format_tsv_rows(vals, r0, r1, cols, precision,
                                             names_buf, name_off, name_len,
                                             with_prefix, lead_sep, pv,
                                             out + r0 * rowcap,
                                             (r1 - r0) * rowcap);
      });
    }
    for (auto& th : ts) th.join();
    for (int64_t t = 0; t < T; ++t)
      if (lens[t] < 0) return -1;
    int64_t total = lens[0];
    for (int64_t t = 1; t < T; ++t) {
      std::memmove(out + total, out + t * step * rowcap, lens[t]);
      total += lens[t];
    }
    return total;
  }
  return format_tsv_rows(vals, 0, rows, cols, precision, names_buf, name_off,
                         name_len, with_prefix, lead_sep, pv, out, cap);
}

// Format the positive entries of a spectrum column as
//   <name>\t<%.{precision}g>\n
// lines (the .KPopSpectra.txt body, reference lib/KMerDB.ml:1222-1223).
// Returns bytes written, or -1 if cap could be exceeded.
int64_t kpop_format_spectra_col(const double* vals, int64_t n,
                                int32_t precision, const uint8_t* names_buf,
                                const int64_t* name_off,
                                const int64_t* name_len, char* out,
                                int64_t cap) {
  char* p = out;
  char* end = out + cap;
  const int64_t pv = (int64_t)precision + 12;
  for (int64_t i = 0; i < n; ++i) {
    if (!(vals[i] > 0.0)) continue;
    if (end - p < name_len[i] + pv) return -1;
    std::memcpy(p, names_buf + name_off[i], name_len[i]);
    p += name_len[i];
    *p++ = '\t';
    p = format_g(p, vals[i], precision);
    *p++ = '\n';
  }
  return p - out;
}

// Format k-mer spectrum entry lines "<hex>\t<count>\n" (the KPopCount
// output stream, reference bin/KPopCount.ml:46): hex zero-padded to
// hex_width, integral counts as plain integers, anything else as %.15g —
// matching io/spectra.write_spectrum_entries byte for byte.
// Returns bytes written; -1 on insufficient cap or a code wider than
// hex_width (caller falls back to the Python writer).
int64_t kpop_format_spectra_entries(const uint64_t* codes,
                                    const double* counts, int64_t n,
                                    int32_t hex_width, char* out,
                                    int64_t cap) {
  static const char hexd[] = "0123456789abcdef";
  char* p = out;
  char* end = out + cap;
  for (int64_t i = 0; i < n; ++i) {
    if (end - p < hex_width + 32) return -1;
    uint64_t c = codes[i];
    for (int32_t j = hex_width - 1; j >= 0; --j) {
      p[j] = hexd[c & 15];
      c >>= 4;
    }
    if (c) return -1;  // code wider than hex_width: Python would not pad
    p += hex_width;
    *p++ = '\t';
    double v = counts[i];
    if (std::isfinite(v) && std::fabs(v) < 9.2e18 && v == (double)(int64_t)v) {
      int64_t iv = (int64_t)v;
      uint64_t a = iv < 0 ? (uint64_t)(-iv) : (uint64_t)iv;
      char tmp[24];
      int nd = 0;
      do {
        tmp[nd++] = (char)('0' + a % 10);
        a /= 10;
      } while (a);
      if (iv < 0) *p++ = '-';
      while (nd) *p++ = tmp[--nd];
    } else {
      p = format_g(p, v, 15);
    }
    *p++ = '\n';
  }
  return p - out;
}

// Lint + encode DNA bytes into int8 codes; returns codes written (<= n).
int64_t kpop_encode_dna(const uint8_t* in, int64_t n, int8_t* out) {
  int64_t m = 0;
  for (int64_t i = 0; i < n; ++i) {
    int8_t c = kDna.code[in[i]];
    if (c == -2) continue;  // dash removed, flanks join
    out[m++] = c;
  }
  return m;
}

// Lint + encode protein bytes into int8 base-20 codes; returns codes written.
int64_t kpop_encode_protein(const uint8_t* in, int64_t n, int8_t* out) {
  int64_t m = 0;
  for (int64_t i = 0; i < n; ++i) {
    int8_t c = kProt.code[in[i]];
    if (c == -2) continue;
    out[m++] = c;
  }
  return m;
}

// Batch encode n_seqs sequences (concatenated in buf at offs/lens) into a
// padded [n_seqs, max_len] int8 matrix (-1 pad, dashes removed); protein
// selects the base-20 table.  enc_len[s] records each encoded length
// (pre-truncation) so the caller can trim the pad width.
void kpop_encode_batch(const uint8_t* buf, const int64_t* offs,
                       const int64_t* lens, int64_t n_seqs, int64_t max_len,
                       int32_t protein, int8_t* out, int64_t* enc_len) {
  const int8_t* tab = protein ? kProt.code : kDna.code;
  for (int64_t s = 0; s < n_seqs; ++s) {
    const uint8_t* src = buf + offs[s];
    int8_t* dst = out + s * max_len;
    int64_t m = 0, total = 0;
    for (int64_t i = 0; i < lens[s]; ++i) {
      int8_t c = tab[src[i]];
      if (c == -2) continue;
      ++total;
      if (m < max_len) dst[m++] = c;
    }
    for (; m < max_len; ++m) dst[m] = -1;
    enc_len[s] = total;
  }
}

// Parse FASTA text from a buffer; encode up to max_seqs sequences into
// out[max_seqs * max_len] (int8, -1 padded/truncated).  Also records, per
// sequence: byte offset + length of the name (first word of the header) in
// the input buffer, and the encoded length (pre-truncation).
// Returns the number of sequences encoded; *consumed is the byte position
// after the last complete record processed (for streaming refills).
int64_t kpop_fasta_encode_batch(const uint8_t* buf, int64_t buflen,
                                int8_t* out, int64_t max_seqs,
                                int64_t max_len, int64_t* name_off,
                                int64_t* name_len, int64_t* seq_len,
                                int64_t* consumed) {
  int64_t pos = 0, nseq = 0;
  *consumed = 0;
  while (pos < buflen && nseq < max_seqs) {
    // find header
    while (pos < buflen && buf[pos] != '>') ++pos;
    if (pos >= buflen) break;
    int64_t hdr = pos + 1;
    // name = first word of header
    int64_t ne = hdr;
    while (ne < buflen && buf[ne] != '\n' && buf[ne] != ' ' &&
           buf[ne] != '\t' && buf[ne] != '\r')
      ++ne;
    // end of header line
    int64_t le = ne;
    while (le < buflen && buf[le] != '\n') ++le;
    if (le >= buflen) break;  // incomplete header line
    // sequence lines until next '>' or EOF
    int64_t sp = le + 1, written = 0, total = 0;
    int8_t* dst = out + nseq * max_len;
    int64_t p = sp;
    while (p < buflen && buf[p] != '>') {
      uint8_t ch = buf[p++];
      if (ch == '\n' || ch == '\r') continue;
      int8_t c = kDna.code[ch];
      if (c == -2) continue;
      ++total;
      if (written < max_len) dst[written++] = c;
    }
    // pad
    for (int64_t i = written; i < max_len; ++i) dst[i] = -1;
    name_off[nseq] = hdr;
    name_len[nseq] = ne - hdr;
    seq_len[nseq] = total;
    ++nseq;
    pos = p;
    *consumed = p;
  }
  return nseq;
}

// Parse FASTQ (4-line records); encode reads like the FASTA variant.
int64_t kpop_fastq_encode_batch(const uint8_t* buf, int64_t buflen,
                                int8_t* out, int64_t max_seqs,
                                int64_t max_len, int64_t* name_off,
                                int64_t* name_len, int64_t* seq_len,
                                int64_t* consumed) {
  int64_t pos = 0, nseq = 0;
  *consumed = 0;
  while (pos < buflen && nseq < max_seqs) {
    while (pos < buflen && (buf[pos] == '\n' || buf[pos] == '\r')) ++pos;
    if (pos >= buflen || buf[pos] != '@') break;
    int64_t hdr = pos + 1;
    int64_t ne = hdr;
    while (ne < buflen && buf[ne] != '\n' && buf[ne] != ' ' &&
           buf[ne] != '\t' && buf[ne] != '\r')
      ++ne;
    int64_t le = ne;
    while (le < buflen && buf[le] != '\n') ++le;
    if (le >= buflen) break;
    int64_t sp = le + 1, written = 0, total = 0;
    int8_t* dst = out + nseq * max_len;
    int64_t p = sp;
    while (p < buflen && buf[p] != '\n') {
      int8_t c = kDna.code[buf[p++]];
      if (c == -2) continue;
      ++total;
      if (written < max_len) dst[written++] = c;
    }
    if (p >= buflen) break;
    ++p;  // newline
    // '+' line
    int64_t plus = p;
    while (p < buflen && buf[p] != '\n') ++p;
    if (p >= buflen || buf[plus] != '+') break;
    ++p;
    // quality line (same length as sequence bytes incl. dashes; skip a line)
    while (p < buflen && buf[p] != '\n') ++p;
    if (p >= buflen) break;
    ++p;
    for (int64_t i = written; i < max_len; ++i) dst[i] = -1;
    name_off[nseq] = hdr;
    name_len[nseq] = ne - hdr;
    seq_len[nseq] = total;
    ++nseq;
    *consumed = p;
    pos = p;
  }
  return nseq;
}

// Accumulate canonical k-mer window counts of an encoded sequence into a
// dense spectrum (int64[4^k]).  Rolling-code version of the vectorized
// window extraction (core/kmers.py window_codes): forward code rolls left,
// reverse-complement rolls right; a break resets the window.
void kpop_count_dense(const int8_t* codes, int64_t n, int32_t k,
                      int32_t canonical, int64_t* spectrum) {
  if (k <= 0 || k > 31 || n < k) return;
  const uint64_t mask = (k == 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
  const int shift = 2 * (k - 1);
  uint64_t fwd = 0, rc = 0;
  int64_t run = 0;  // valid bases in current window
  for (int64_t i = 0; i < n; ++i) {
    int8_t c = codes[i];
    if (c < 0) {
      run = 0;
      fwd = rc = 0;
      continue;
    }
    fwd = ((fwd << 2) | (uint64_t)c) & mask;
    rc = (rc >> 2) | ((uint64_t)(3 - c) << shift);
    if (++run >= k) {
      uint64_t code = canonical && rc < fwd ? rc : fwd;
      ++spectrum[code];
    }
  }
}

// Batch variant over a padded [n_seqs, length] int8 matrix; one combined
// spectrum (the -l accumulation mode of KPopCount).
void kpop_count_dense_batch(const int8_t* codes, int64_t n_seqs,
                            int64_t length, int32_t k, int32_t canonical,
                            int64_t* spectrum) {
  for (int64_t s = 0; s < n_seqs; ++s)
    kpop_count_dense(codes + s * length, length, k, canonical, spectrum);
}

// Parse a .KPopSpectra.txt buffer (header lines "\t<label>", entry lines
// "<hex>\t<count>") into flat arrays.  For each line i < max_entries:
//   kind 0: entry -> codes[i] = hex value, counts[i] = count
//   kind 1: header -> label at [label_off[i], label_off[i]+label_len[i])
// Returns the number of lines parsed; *consumed = bytes of complete lines.
// Malformed lines return -1 - line_index (caller reports the error).
int64_t kpop_spectra_parse(const uint8_t* buf, int64_t buflen,
                           uint64_t* codes, double* counts, int8_t* kinds,
                           int64_t* label_off, int64_t* label_len,
                           int64_t max_entries, int64_t* consumed) {
  int64_t pos = 0, n = 0;
  *consumed = 0;
  while (pos < buflen && n < max_entries) {
    int64_t eol = pos;
    while (eol < buflen && buf[eol] != '\n') ++eol;
    if (eol >= buflen) break;  // incomplete line: stop for refill
    if (eol == pos) {  // empty line: skip
      pos = eol + 1;
      *consumed = pos;
      continue;
    }
    if (buf[pos] == '\t') {
      kinds[n] = 1;
      label_off[n] = pos + 1;
      label_len[n] = eol - pos - 1;
      codes[n] = 0;
      counts[n] = 0.0;
    } else {
      // hex field
      uint64_t code = 0;
      int64_t p = pos;
      while (p < eol && buf[p] != '\t') {
        uint8_t c = buf[p];
        uint64_t d;
        if (c >= '0' && c <= '9') d = c - '0';
        else if (c >= 'a' && c <= 'f') d = c - 'a' + 10;
        else if (c >= 'A' && c <= 'F') d = c - 'A' + 10;
        else return -1 - n;
        code = (code << 4) | d;
        ++p;
      }
      if (p >= eol) return -1 - n;  // no tab
      ++p;
      // numeric count (integer fast path, strtod fallback)
      int64_t q = p;
      uint64_t ival = 0;
      bool is_int = true;
      while (q < eol) {
        uint8_t c = buf[q];
        if (c >= '0' && c <= '9') {
          ival = ival * 10 + (c - '0');
        } else {
          is_int = false;
          break;
        }
        ++q;
      }
      double val;
      if (is_int && q > p) {
        val = (double)ival;
      } else {
        char tmp[64];
        int64_t len = eol - p;
        if (len <= 0 || len >= 63) return -1 - n;
        std::memcpy(tmp, buf + p, len);
        tmp[len] = 0;
        char* end = nullptr;
        val = strtod(tmp, &end);
        if (end == tmp) return -1 - n;
      }
      kinds[n] = 0;
      codes[n] = code;
      counts[n] = val;
      label_off[n] = 0;
      label_len[n] = 0;
    }
    ++n;
    pos = eol + 1;
    *consumed = pos;
  }
  return n;
}

// Pack int8 base codes (-1 = break) into the 2-bit wire format:
// packed: 4 bases/byte (base i in bits 2*(i%4)), valid: 1 bit/base.
// Rows of a [n_seqs, length] batch are packed independently;
// packed stride = (length+3)/4, valid stride = (length+7)/8.
void kpop_pack_2bit_batch(const int8_t* codes, int64_t n_seqs, int64_t length,
                          uint8_t* packed, uint8_t* valid) {
  const int64_t ps = (length + 3) / 4, vs = (length + 7) / 8;
  for (int64_t s = 0; s < n_seqs; ++s) {
    const int8_t* row = codes + s * length;
    uint8_t* p = packed + s * ps;
    uint8_t* v = valid + s * vs;
    std::memset(p, 0, ps);
    std::memset(v, 0, vs);
    for (int64_t i = 0; i < length; ++i) {
      int8_t c = row[i];
      if (c >= 0) {
        p[i >> 2] |= (uint8_t)c << ((i & 3) * 2);
        v[i >> 3] |= (uint8_t)1 << (i & 7);
      }
    }
  }
}

// Format per-query distance-summary lines (the reference layout,
// lib/Matrix.ml:632-690, as written by ops/summaries.py):
//   <name>\t<mean>\t<stddev>\t<median>\t<mad>(\t<target>\t<dist>\t<z>)*eff
// dists/tgt come pre-ordered per row (distance, then target index);
// z = (d - mean) / stddev is computed here with the same IEEE double ops
// as the numpy path.  NaN is forced to "nan" (std::to_chars renders the
// sign bit as "-nan"; Python's %g never does).  Rows with eff[i] < 0 are
// skipped entirely — the caller interleaves exact host-fallback lines.
// Returns bytes written, or -1 if cap could be exceeded.
int64_t kpop_format_summary(const uint8_t* qblob, const int64_t* qoff,
                            const int64_t* qlen, const double* stats,
                            const double* dists, const int32_t* tgt,
                            const int64_t* eff, int64_t rows, int64_t kcap,
                            const uint8_t* cblob, const int64_t* coff,
                            const int64_t* clen, int32_t precision, char* out,
                            int64_t cap) {
  const int64_t pv = (int64_t)precision + 14;
  char* p = out;
  char* end = out + cap;
  for (int64_t i = 0; i < rows; ++i) {
    const int64_t e = eff[i];
    if (e < 0) continue;
    const double* drow = dists + i * kcap;
    const int32_t* trow = tgt + i * kcap;
    int64_t need = qlen[i] + 4 * (pv + 1) + 2;
    for (int64_t j = 0; j < e; ++j) need += clen[trow[j]] + 2 * (pv + 1) + 3;
    if (end - p < need) return -1;
    std::memcpy(p, qblob + qoff[i], (size_t)qlen[i]);
    p += qlen[i];
    const double* st = stats + i * 4;
    for (int m = 0; m < 4; ++m) {
      *p++ = '\t';
      p = std::isnan(st[m]) ? (std::memcpy(p, "nan", 3), p + 3)
                            : format_g(p, st[m], precision);
    }
    const double mean = st[0], sd = st[1];
    for (int64_t j = 0; j < e; ++j) {
      *p++ = '\t';
      std::memcpy(p, cblob + coff[trow[j]], (size_t)clen[trow[j]]);
      p += clen[trow[j]];
      *p++ = '\t';
      p = std::isnan(drow[j]) ? (std::memcpy(p, "nan", 3), p + 3)
                              : format_g(p, drow[j], precision);
      const double z = (drow[j] - mean) / sd;
      *p++ = '\t';
      p = std::isnan(z) ? (std::memcpy(p, "nan", 3), p + 3)
                        : format_g(p, z, precision);
    }
    *p++ = '\n';
  }
  return p - out;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Open-addressing k-mer count hash: the large-k sparse counting path.
//
// For DNA k > 13 (and protein k > ~6) the dense 4^k spectrum no longer fits,
// and the numpy fallback degrades to a full sorted merge per read.  The
// reference counts any k at hash speed (BiOCamLib KMers.IntHashFrequencies,
// bin/KPopCount.ml:111-123); this is the equivalent: linear-probing table,
// splitmix64-mixed keys, power-of-two capacity, dump-and-clear reuse for the
// -M eviction semantics (bin/KPopCount.ml:116-123).

namespace {

constexpr uint64_t kSparseEmpty = ~0ULL;  // > any k-mer code (4^30, 20^12)

inline uint64_t kpop_mix64(uint64_t x) {  // splitmix64 finalizer
  x += 0x9e3779b97f4a7c15ULL;
  x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
  x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
  return x ^ (x >> 31);
}

struct SparseHash {
  std::vector<uint64_t> keys;
  std::vector<int64_t> vals;
  int64_t n = 0;
  uint64_t mask = 0;

  explicit SparseHash(int64_t cap_hint) {
    uint64_t cap = 64;
    while ((int64_t)(cap * 7 / 10) < cap_hint && cap < (1ULL << 62)) cap <<= 1;
    keys.assign(cap, kSparseEmpty);
    vals.assign(cap, 0);
    mask = cap - 1;
  }

  void grow() {
    std::vector<uint64_t> ok;
    std::vector<int64_t> ov;
    ok.swap(keys);
    ov.swap(vals);
    uint64_t cap = (mask + 1) << 1;
    keys.assign(cap, kSparseEmpty);
    vals.assign(cap, 0);
    mask = cap - 1;
    for (uint64_t i = 0; i < ok.size(); ++i) {
      if (ok[i] == kSparseEmpty) continue;
      uint64_t j = kpop_mix64(ok[i]) & mask;
      while (keys[j] != kSparseEmpty) j = (j + 1) & mask;
      keys[j] = ok[i];
      vals[j] = ov[i];
    }
  }

  inline void add(uint64_t key, int64_t cnt) {
    if ((uint64_t)(n + 1) * 10 > (mask + 1) * 7) grow();
    uint64_t i = kpop_mix64(key) & mask;
    for (;;) {
      if (keys[i] == key) {
        vals[i] += cnt;
        return;
      }
      if (keys[i] == kSparseEmpty) {
        keys[i] = key;
        vals[i] = cnt;
        ++n;
        return;
      }
      i = (i + 1) & mask;
    }
  }

  // Batched insert with software prefetch: inserts are memory-latency
  // bound at multi-million-entry tables (each probe is a cold cache
  // line); prefetching a window of upcoming buckets overlaps the misses.
  void add_batch(const uint64_t* ks, int64_t m, int64_t cnt_each) {
    constexpr int64_t W = 16;
    for (int64_t i = 0; i < m; ++i) {
      if (i + W < m)
        __builtin_prefetch(&keys[kpop_mix64(ks[i + W]) & mask]);
      add(ks[i], cnt_each);
    }
  }
};

}  // namespace

extern "C" {

void* kpop_sparse_create(int64_t cap_hint) {
  return new SparseHash(cap_hint > 0 ? cap_hint : 1 << 16);
}

void kpop_sparse_free(void* h) { delete (SparseHash*)h; }

void kpop_sparse_clear(void* h) {
  auto* s = (SparseHash*)h;
  std::fill(s->keys.begin(), s->keys.end(), kSparseEmpty);
  s->n = 0;
}

int64_t kpop_sparse_size(void* h) { return ((SparseHash*)h)->n; }

// Bulk-insert precomputed (canonical) window codes, one count each.
void kpop_sparse_add_codes(void* h, const uint64_t* codes, int64_t n) {
  ((SparseHash*)h)->add_batch(codes, n, 1);
}

// Count every valid k-window of an encoded sequence straight into the hash:
// the rolling-code twin of kpop_count_dense for DNA (base 4, optional
// canonical min(fwd, revcomp)) plus the base-20 protein rolling code
// (fwd' = (fwd*20 + c) mod 20^k; no reverse strand).
static void sparse_count_into(SparseHash* s, const int8_t* codes, int64_t n,
                              int32_t k, int32_t canonical, int32_t base) {
  if (k <= 0 || n < k) return;
  // stage rolled codes in a small buffer so add_batch can prefetch buckets
  uint64_t buf[256];
  int64_t nb = 0;
  auto flush = [&] {
    s->add_batch(buf, nb, 1);
    nb = 0;
  };
  if (base == 4) {
    if (k > 31) return;
    const uint64_t mask = (k == 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
    const int shift = 2 * (k - 1);
    uint64_t fwd = 0, rc = 0;
    int64_t run = 0;
    for (int64_t i = 0; i < n; ++i) {
      int8_t c = codes[i];
      if (c < 0) {
        run = 0;
        fwd = rc = 0;
        continue;
      }
      fwd = ((fwd << 2) | (uint64_t)c) & mask;
      rc = (rc >> 2) | ((uint64_t)(3 - c) << shift);
      if (++run >= k) {
        buf[nb++] = canonical && rc < fwd ? rc : fwd;
        if (nb == 256) flush();
      }
    }
  } else {
    uint64_t mod = 1;
    for (int32_t j = 0; j < k; ++j) mod *= (uint64_t)base;
    uint64_t fwd = 0;
    int64_t run = 0;
    for (int64_t i = 0; i < n; ++i) {
      int8_t c = codes[i];
      if (c < 0) {
        run = 0;
        fwd = 0;
        continue;
      }
      fwd = (fwd * (uint64_t)base + (uint64_t)c) % mod;
      if (++run >= k) {
        buf[nb++] = fwd;
        if (nb == 256) flush();
      }
    }
  }
  flush();
}

void kpop_sparse_count_seq(void* h, const int8_t* codes, int64_t n, int32_t k,
                           int32_t canonical, int32_t base) {
  sparse_count_into((SparseHash*)h, codes, n, k, canonical, base);
}

// Threaded batch counting over a padded [n_seqs, stride] int8 matrix
// (-1 pad, so rows count independently): each thread accumulates a
// contiguous sequence range into its own hash, then the per-thread hashes
// merge into the main one.  This is the Processes.Parallel equivalent for
// the count stage (the reference forks workers per chunk,
// bin/KPopCountDB.ml:65); merged content is independent of the partition,
// so output is byte-identical to the sequential path.
void kpop_sparse_count_batch(void* h, const int8_t* codes, int64_t n_seqs,
                             int64_t stride, int32_t k, int32_t canonical,
                             int32_t base, int32_t n_threads) {
  auto* main_h = (SparseHash*)h;
  int64_t T = std::min<int64_t>(n_threads > 1 ? n_threads : 1, n_seqs);
  if (T <= 1) {
    for (int64_t i = 0; i < n_seqs; ++i)
      sparse_count_into(main_h, codes + i * stride, stride, k, canonical,
                        base);
    return;
  }
  std::vector<std::unique_ptr<SparseHash>> parts;
  parts.reserve(T);
  const int64_t windows_hint = n_seqs * stride / T + 64;
  for (int64_t t = 0; t < T; ++t)
    parts.emplace_back(new SparseHash(std::min<int64_t>(windows_hint,
                                                        1 << 22)));
  std::vector<std::thread> ts;
  const int64_t step = (n_seqs + T - 1) / T;
  for (int64_t t = 0; t < T; ++t) {
    ts.emplace_back([&, t] {
      SparseHash* part = parts[t].get();
      const int64_t lo = t * step, hi = std::min(n_seqs, lo + step);
      for (int64_t i = lo; i < hi; ++i)
        sparse_count_into(part, codes + i * stride, stride, k, canonical,
                          base);
    });
  }
  for (auto& th : ts) th.join();
  for (auto& part : parts)
    for (uint64_t i = 0; i <= part->mask; ++i)
      if (part->keys[i] != kSparseEmpty)
        main_h->add(part->keys[i], part->vals[i]);
}

// Threaded dense batch counting: threads roll over disjoint sequence
// ranges and accumulate with relaxed atomic adds (collisions on the same
// k-mer cell are rare at 4^k cells, and int64 relaxed adds commute).
void kpop_count_dense_batch_mt(const int8_t* codes, int64_t n_seqs,
                               int64_t length, int32_t k, int32_t canonical,
                               int64_t* spectrum, int32_t n_threads) {
  int64_t T = std::min<int64_t>(n_threads > 1 ? n_threads : 1, n_seqs);
  if (T <= 1 || k > 31) {
    for (int64_t i = 0; i < n_seqs; ++i)
      kpop_count_dense(codes + i * length, length, k, canonical, spectrum);
    return;
  }
  std::vector<std::thread> ts;
  const int64_t step = (n_seqs + T - 1) / T;
  const uint64_t mask = (k == 32) ? ~0ULL : ((1ULL << (2 * k)) - 1);
  const int shift = 2 * (k - 1);
  for (int64_t t = 0; t < T; ++t) {
    ts.emplace_back([&, t] {
      const int64_t lo = t * step, hi = std::min(n_seqs, lo + step);
      for (int64_t i = lo; i < hi; ++i) {
        const int8_t* row = codes + i * length;
        uint64_t fwd = 0, rc = 0;
        int64_t run = 0;
        for (int64_t j = 0; j < length; ++j) {
          int8_t c = row[j];
          if (c < 0) {
            run = 0;
            fwd = rc = 0;
            continue;
          }
          fwd = ((fwd << 2) | (uint64_t)c) & mask;
          rc = (rc >> 2) | ((uint64_t)(3 - c) << shift);
          if (++run >= k) {
            uint64_t code = canonical && rc < fwd ? rc : fwd;
            __atomic_fetch_add(&spectrum[code], 1, __ATOMIC_RELAXED);
          }
        }
      }
    });
  }
  for (auto& th : ts) th.join();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Centroids splits: simulated-annealing bipartition tree (the reference's
// SplitsAlgorithm.centroids, lib/Matrix.ml:364-522).  The acceptance
// schedule, objective (|centroid_one - centroid_two| scaled by
// 1/sqrt(1+|n1-n2|), sums instead of means for sides of cardinality <= 1)
// and the max(n, 40)-consecutive-rejections terminator match the Python
// reference implementation in core/splits.py; the RNG is xoshiro-style
// (deterministic under the seed, but a different stream than CPython's
// Mersenne Twister, so trajectories differ from the Python backend).
// Compiled speed makes the reference's 10^4-10^5-leaf relatedness trees
// feasible: ~100 ns/move vs ~10 us/move in Python.

namespace {

struct SplitsResult {
  std::vector<int64_t> offsets;  // n_splits + 1
  std::vector<int64_t> members;
  std::vector<double> weights;
};

struct XRng {  // splitmix64-seeded xoshiro256++
  uint64_t s[4];
  explicit XRng(uint64_t seed) {
    for (int i = 0; i < 4; ++i) {
      seed += 0x9e3779b97f4a7c15ULL;
      uint64_t z = seed;
      z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
      z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
      s[i] = z ^ (z >> 31);
    }
  }
  static inline uint64_t rotl(uint64_t x, int k) {
    return (x << k) | (x >> (64 - k));
  }
  inline uint64_t next() {
    uint64_t r = rotl(s[0] + s[3], 23) + s[0];
    uint64_t t = s[1] << 17;
    s[2] ^= s[0];
    s[3] ^= s[1];
    s[1] ^= s[2];
    s[0] ^= s[3];
    s[2] ^= t;
    s[3] = rotl(s[3], 45);
    return r;
  }
  inline double uniform() {  // [0, 1)
    return (double)(next() >> 11) * 0x1.0p-53;
  }
  inline int64_t below(int64_t n) {  // unbiased [0, n)
    uint64_t threshold = (~(uint64_t)0 - (uint64_t)n + 1) % (uint64_t)n;
    for (;;) {
      uint64_t r = next();
      if (r >= threshold) return (int64_t)(r % (uint64_t)n);
    }
  }
};

// One annealed bipartition of ids[0..n): writes sides (0/1) per position,
// returns the best objective.
double anneal_bipartition(const double* data, int32_t d, const int64_t* ids,
                          int64_t n, XRng& rng, int8_t* side,
                          double p0 = 0.2, double magnif = 10.0) {
  const double inv_acc = (1.0 - p0) / p0;
  std::vector<double> sums0(d, 0.0), sums1(d, 0.0);
  int64_t cards[2] = {0, 0};
  for (int64_t i = 0; i < n; ++i) {
    int s = rng.uniform() < 0.5 ? 1 : 0;
    side[i] = (int8_t)s;
    const double* row = data + ids[i] * d;
    double* dst = s ? sums1.data() : sums0.data();
    for (int32_t j = 0; j < d; ++j) dst[j] += row[j];
    ++cards[s];
  }
  auto objective = [&]() -> double {
    if (cards[0] == 0 || cards[1] == 0) return 0.0;
    const double inv0 = cards[0] > 1 ? 1.0 / (double)cards[0] : 1.0;
    const double inv1 = cards[1] > 1 ? 1.0 / (double)cards[1] : 1.0;
    double acc = 0.0;
    for (int32_t j = 0; j < d; ++j)
      acc += std::fabs(sums0[j] * inv0 - sums1[j] * inv1);
    int64_t dc = cards[0] - cards[1];
    return acc / std::sqrt(1.0 + (double)(dc < 0 ? -dc : dc));
  };
  double obj = objective();
  double best_obj = obj;
  std::vector<int8_t> best(side, side + n);
  std::vector<int64_t> changed;  // positions flipped since last best
  const int64_t terminator = n > 40 ? n : 40;
  // step cap: the reference's rejection-run terminator has vanishing
  // stopping probability at large n (deltas shrink as 1/n, acceptance
  // floors at p0) — see core/splits.py::_bipartition for the analysis
  const int64_t step_cap = 200 * n > 20000 ? 200 * n : 20000;
  int64_t rejected = 0, steps = 0;
  while (rejected < terminator && steps < step_cap) {
    ++steps;
    int64_t pos = rng.below(n);
    int s = side[pos];
    const double* row = data + ids[pos] * d;
    double* from = s ? sums1.data() : sums0.data();
    double* to = s ? sums0.data() : sums1.data();
    for (int32_t j = 0; j < d; ++j) {
      from[j] -= row[j];
      to[j] += row[j];
    }
    --cards[s];
    ++cards[1 - s];
    side[pos] = (int8_t)(1 - s);
    double new_obj = objective();
    double score = 1.0 / (1.0 + inv_acc * std::exp(-magnif * (new_obj - obj)));
    if (rng.uniform() <= score) {
      rejected = 0;
      obj = new_obj;
      if (obj > best_obj) {
        best_obj = obj;
        for (int64_t c : changed) best[c] = side[c];
        best[pos] = side[pos];
        changed.clear();
      } else {
        changed.push_back(pos);
      }
    } else {
      ++rejected;
      side[pos] = (int8_t)s;
      for (int32_t j = 0; j < d; ++j) {
        from[j] += row[j];
        to[j] -= row[j];
      }
      ++cards[s];
      --cards[1 - s];
    }
  }
  std::copy(best.begin(), best.end(), side);
  return best_obj;
}

}  // namespace

extern "C" {

// Full centroids splits tree over [n, d] row-major embeddings.  Returns a
// heap handle; query sizes with kpop_splits_sizes, copy out with
// kpop_splits_fill, release with kpop_splits_free.  Emission order matches
// core/splits.py::splits_centroids (preorder, 'one' side first).
void* kpop_splits_centroids(const double* data, int64_t n, int32_t d,
                            uint64_t seed) {
  auto* res = new SplitsResult();
  res->offsets.push_back(0);
  XRng rng(seed);
  std::vector<std::vector<int64_t>> stack;
  {
    std::vector<int64_t> all(n);
    for (int64_t i = 0; i < n; ++i) all[i] = i;
    stack.push_back(std::move(all));
  }
  std::vector<int8_t> side;
  while (!stack.empty()) {
    std::vector<int64_t> ids = std::move(stack.back());
    stack.pop_back();
    const int64_t m = (int64_t)ids.size();
    if (m > 1) {
      side.resize(m);
      double obj = anneal_bipartition(data, d, ids.data(), m, rng,
                                      side.data());
      std::vector<int64_t> one, two;
      for (int64_t i = 0; i < m; ++i)
        (side[i] == 0 ? one : two).push_back(ids[i]);
      if (one.empty() || two.empty()) {  // degenerate: trivial cut
        one.assign(ids.begin(), ids.begin() + m / 2);
        two.assign(ids.begin() + m / 2, ids.end());
        obj = 0.0;
      }
      res->members.insert(res->members.end(), one.begin(), one.end());
      res->offsets.push_back((int64_t)res->members.size());
      res->weights.push_back(obj);
      stack.push_back(std::move(two));
      stack.push_back(std::move(one));
    } else {
      res->members.insert(res->members.end(), ids.begin(), ids.end());
      res->offsets.push_back((int64_t)res->members.size());
      res->weights.push_back(0.0);
    }
  }
  return res;
}

void kpop_splits_sizes(void* h, int64_t* n_splits, int64_t* n_members) {
  auto* res = (SplitsResult*)h;
  *n_splits = (int64_t)res->weights.size();
  *n_members = (int64_t)res->members.size();
}

void kpop_splits_fill(void* h, int64_t* offsets, int64_t* members,
                      double* weights) {
  auto* res = (SplitsResult*)h;
  std::copy(res->offsets.begin(), res->offsets.end(), offsets);
  std::copy(res->members.begin(), res->members.end(), members);
  std::copy(res->weights.begin(), res->weights.end(), weights);
}

void kpop_splits_free(void* h) { delete (SplitsResult*)h; }

}  // extern "C"

extern "C" {

// Extract all (code, count) pairs sorted by code; returns the pair count.
// Caller sizes the output arrays with kpop_sparse_size.
int64_t kpop_sparse_extract(void* h, uint64_t* out_codes, int64_t* out_counts) {
  auto* s = (SparseHash*)h;
  int64_t m = 0;
  std::vector<std::pair<uint64_t, int64_t>> pairs;
  pairs.reserve(s->n);
  for (uint64_t i = 0; i <= s->mask; ++i)
    if (s->keys[i] != kSparseEmpty) pairs.emplace_back(s->keys[i], s->vals[i]);
  std::sort(pairs.begin(), pairs.end());
  for (auto& p : pairs) {
    out_codes[m] = p.first;
    out_counts[m] = p.second;
    ++m;
  }
  return m;
}

}  // extern "C"
