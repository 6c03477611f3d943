// Native 2048 batch engine + CSV codec (C ABI, consumed via ctypes).
//
// The reference framework is pure Python (SURVEY.md §2); this native layer
// exists for the runtime *around* the TPU compute path:
//   * a lookup-table batch move engine — the high-throughput host oracle
//     used for differential testing against the JAX kernels and as a fast
//     CPU fallback (one 2^20-entry LUT over 4x5-bit exponent rows, so the
//     65536 tile (exponent 16) is representable, matching the JAX engine's
//     range);
//   * a fast reader/writer for the 35/36-column training-data CSV schema
//     (training_data.py:188-248 in the reference) — replaces np.loadtxt,
//     which parses the file five times.
//
// Semantics mirror gym2048_tpu.core.rules exactly: single-pass compact +
// merge, leftmost first, merged tiles cannot re-merge; score is the sum of
// created tile values.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

constexpr int kBits = 5;                   // bits per cell exponent
constexpr uint32_t kMask = (1u << kBits) - 1;
constexpr uint32_t kCodes = 1u << (4 * kBits);  // 2^20 row codes

struct RowEntry {
  uint32_t new_code;
  uint32_t score;
};

RowEntry* g_lut = nullptr;

inline uint32_t pack(const int e[4]) {
  return (uint32_t)e[0] | ((uint32_t)e[1] << kBits) |
         ((uint32_t)e[2] << (2 * kBits)) | ((uint32_t)e[3] << (3 * kBits));
}

inline void unpack(uint32_t code, int e[4]) {
  e[0] = code & kMask;
  e[1] = (code >> kBits) & kMask;
  e[2] = (code >> (2 * kBits)) & kMask;
  e[3] = (code >> (3 * kBits)) & kMask;
}

// Single-pass compact+merge of one exponent row, leftward.
void shift_row(const int in[4], int out[4], uint32_t* score) {
  int buf[4] = {0, 0, 0, 0};
  int idx = 0;
  bool can_merge = false;
  *score = 0;
  for (int i = 0; i < 4; ++i) {
    int v = in[i];
    if (v == 0) continue;
    if (can_merge && buf[idx - 1] == v) {
      buf[idx - 1] = v + 1;
      *score += 1u << (v + 1);
      can_merge = false;
    } else {
      buf[idx++] = v;
      can_merge = true;
    }
  }
  memcpy(out, buf, sizeof(buf));
}

}  // namespace

extern "C" {

// Build (or rebuild) the row LUT. Returns number of entries.
int64_t engine_init() {
  if (g_lut) return kCodes;
  g_lut = (RowEntry*)malloc(sizeof(RowEntry) * kCodes);
  if (!g_lut) return -1;
  for (uint32_t code = 0; code < kCodes; ++code) {
    int e[4], out[4];
    uint32_t score;
    unpack(code, e);
    shift_row(e, out, &score);
    g_lut[code] = {pack(out), score};
  }
  return kCodes;
}

// Shift one row of exponents leftward (for tests). Returns the score.
int64_t engine_shift_row(const int8_t* row, int8_t* out) {
  int in[4] = {row[0], row[1], row[2], row[3]};
  int o[4];
  uint32_t score;
  shift_row(in, o, &score);
  for (int i = 0; i < 4; ++i) out[i] = (int8_t)o[i];
  return (int64_t)score;
}

// Apply `actions[b]` (0=up 1=right 2=down 3=left) to each of n exponent
// boards (int8[n,16], row-major). Writes moved boards (unchanged when the
// move is illegal), per-board scores, and legality flags.
void engine_move_batch(const int8_t* boards, const int32_t* actions,
                       int64_t n, int8_t* out_boards, int32_t* out_scores,
                       uint8_t* out_legal) {
  engine_init();
  for (int64_t b = 0; b < n; ++b) {
    const int8_t* board = boards + b * 16;
    int8_t* out = out_boards + b * 16;
    int action = actions[b];
    uint32_t total = 0;
    bool changed = false;
    int8_t result[16];
    memcpy(result, board, 16);

    for (int line = 0; line < 4; ++line) {
      int idx[4];
      // Cell indices of this line, ordered so the move shifts "leftward".
      switch (action) {
        case 0:  // up: columns top->bottom
          for (int i = 0; i < 4; ++i) idx[i] = i * 4 + line;
          break;
        case 1:  // right: rows reversed
          for (int i = 0; i < 4; ++i) idx[i] = line * 4 + (3 - i);
          break;
        case 2:  // down: columns bottom->top
          for (int i = 0; i < 4; ++i) idx[i] = (3 - i) * 4 + line;
          break;
        default:  // left: rows
          for (int i = 0; i < 4; ++i) idx[i] = line * 4 + i;
      }
      int e[4];
      for (int i = 0; i < 4; ++i) e[i] = board[idx[i]];
      RowEntry entry = g_lut[pack(e)];
      total += entry.score;
      int o[4];
      unpack(entry.new_code, o);
      for (int i = 0; i < 4; ++i) {
        if (o[i] != e[i]) changed = true;
        result[idx[i]] = (int8_t)o[i];
      }
    }
    out_scores[b] = (int32_t)total;
    out_legal[b] = changed ? 1 : 0;
    memcpy(out, changed ? result : board, 16);
  }
}

// All four moves per board: out_boards int8[n,4,16], scores int32[n,4],
// legal uint8[n,4].
void engine_move_all_batch(const int8_t* boards, int64_t n,
                           int8_t* out_boards, int32_t* out_scores,
                           uint8_t* out_legal) {
  engine_init();
  int32_t actions[4] = {0, 1, 2, 3};
  for (int64_t b = 0; b < n; ++b) {
    for (int a = 0; a < 4; ++a) {
      engine_move_batch(boards + b * 16, &actions[a], 1,
                        out_boards + (b * 4 + a) * 16,
                        out_scores + b * 4 + a, out_legal + b * 4 + a);
    }
  }
}

// ---------------------------------------------------------------- CSV I/O

// Count data rows (lines after the header). Block reads, not fgetc.
int64_t csv_count_rows(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  int64_t newlines = 0;
  bool last_was_newline = true;
  bool any = false;
  char buf[1 << 16];
  size_t got;
  while ((got = fread(buf, 1, sizeof(buf), f)) > 0) {
    any = true;
    for (size_t i = 0; i < got; ++i) {
      if (buf[i] == '\n') ++newlines;
    }
    last_was_newline = buf[got - 1] == '\n';
  }
  fclose(f);
  if (!any) return 0;
  int64_t lines = newlines + (last_was_newline ? 0 : 1);
  return lines > 0 ? lines - 1 : 0;  // minus header
}

namespace {

// Fast field parsers over an in-memory buffer. Each consumes the field and
// the trailing comma (if present) and advances *p.
inline int32_t parse_int(const char** p) {
  const char* s = *p;
  bool neg = false;
  if (*s == '-') {
    neg = true;
    ++s;
  }
  int64_t v = 0;
  while (*s >= '0' && *s <= '9') v = v * 10 + (*s++ - '0');
  if (*s == ',') ++s;
  *p = s;
  return (int32_t)(neg ? -v : v);
}

inline double parse_double(const char** p) {
  const char* s = *p;
  char* end;
  double v = strtod(s, &end);
  s = end;
  if (*s == ',') ++s;
  *p = s;
  return v;
}

}  // namespace

// Parse the 35/36-column schema. Arrays must be preallocated to n rows:
// boards int32[n,16], actions int32[n], rewards double[n],
// next_boards int32[n,16], dones uint8[n]. Extra trailing columns
// (returns) are skipped. Returns rows parsed, or -1 on error.
int64_t csv_read(const char* path, int64_t n, int32_t* boards,
                 int32_t* actions, double* rewards, int32_t* next_boards,
                 uint8_t* dones) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  // Read the whole file into memory (training CSVs are tens of MB at most)
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  char* data = (char*)malloc(size + 1);
  if (!data) {
    fclose(f);
    return -1;
  }
  size_t got = fread(data, 1, size, f);
  fclose(f);
  data[got] = '\0';

  const char* p = data;
  while (*p && *p != '\n') ++p;  // skip header
  if (*p == '\n') ++p;

  int64_t row = 0;
  while (row < n && *p) {
    if (*p == '\n' || *p == '\r') {
      ++p;
      continue;
    }
    for (int i = 0; i < 16; ++i) boards[row * 16 + i] = parse_int(&p);
    actions[row] = parse_int(&p);
    rewards[row] = parse_double(&p);
    for (int i = 0; i < 16; ++i) next_boards[row * 16 + i] = parse_int(&p);
    dones[row] = (uint8_t)parse_int(&p);
    // skip any remaining columns (e.g. returns) to end of line
    while (*p && *p != '\n') ++p;
    if (*p == '\n') ++p;
    ++row;
  }
  free(data);
  return row;
}

// Write rows in the reference's exact format ('%d,'*17 + '%f,' + '%d,'*16
// + '%i' [+ ',%f'], training_data.py:245-248). header: NUL-terminated.
// returns: optional (may be null). Returns rows written or -1.
int64_t csv_write(const char* path, const char* header, int64_t n,
                  const int32_t* boards, const int32_t* actions,
                  const double* rewards, const int32_t* next_boards,
                  const uint8_t* dones, const double* returns) {
  FILE* f = fopen(path, "wb");
  if (!f) return -1;
  fprintf(f, "%s\n", header);
  char line[2048];
  for (int64_t r = 0; r < n; ++r) {
    char* p = line;
    auto put_int = [&p](int64_t v) {
      if (v < 0) {
        *p++ = '-';
        v = -v;
      }
      char tmp[20];
      int k = 0;
      do {
        tmp[k++] = (char)('0' + v % 10);
        v /= 10;
      } while (v);
      while (k) *p++ = tmp[--k];
    };
    for (int i = 0; i < 16; ++i) {
      put_int(boards[r * 16 + i]);
      *p++ = ',';
    }
    put_int(actions[r]);
    *p++ = ',';
    p += snprintf(p, 32, "%f", rewards[r]);
    *p++ = ',';
    for (int i = 0; i < 16; ++i) {
      put_int(next_boards[r * 16 + i]);
      *p++ = ',';
    }
    put_int((int64_t)dones[r]);
    if (returns) {
      *p++ = ',';
      p += snprintf(p, 32, "%f", returns[r]);
    }
    *p++ = '\n';
    fwrite(line, 1, p - line, f);
  }
  fclose(f);
  return n;
}

}  // extern "C"
