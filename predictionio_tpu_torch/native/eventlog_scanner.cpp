// Native event-log scanner: JSON-lines segments -> columnar arrays.
//
// Copy of predictionio_tpu/native/eventlog_scanner.cpp for the PyTorch port
// (host code; the port imports nothing of the JAX package), with the
// chunk-grouped COO layout of CCO training at its end.
// The training read of a localfs store (the reference's HBase scan into a
// Spark RDD) becomes a parallel parse of the immutable segment files
// straight into dictionary-encoded columns.
//
// Contract: segments are written by Event.to_json_line() — compact JSON, one
// object per line.  The parser is a minimal but correct JSON tokenizer: it
// extracts event/entityId/entityType/targetEntityId/eventTime and the FULL
// properties map into sparse per-key columns (discovered schema):
//   kind 0 = number (f64), 1 = bool (0/1 in the num facet),
//   kind 2 = string, 3 = list of strings (string facet, per-key dict;
//   numeric/bool list elements are stringified, nested containers inside
//   lists are dropped), 4 = null, 5 = nested object kept as its raw JSON
//   span — dates stay ISO strings for the Python side.
// A legacy dense `rating` column (NaN-missing) is kept as the ALS fast path.
//
// Threading: one worker per segment file (they are immutable once rotated),
// then a single-threaded merge that dictionary-encodes strings.
//
// C ABI (used from Python via ctypes):
//   scan_new() -> handle
//   scan_add_file(h, path)
//   scan_run(h, n_threads) -> row count or -1
//   scan_rows/scan_col_*/scan_dict_* accessors
//   scan_prop_* accessors (sparse property columns)
//   scan_error(h) -> last error message
//   scan_free(h)

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <ctime>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// One parsed property value.  kind: 0 num, 1 bool, 2 str, 3 str-list,
// 4 null (kept: $unset lists keys with null values), 5 raw JSON (nested
// object — the raw text span, decoded lazily Python-side).
struct PropValue {
  int8_t kind = -1;
  double num = NAN;
  std::vector<std::string> strs;
};

struct RawEvent {
  std::string event;
  std::string entity_type;
  std::string entity_id;
  std::string target_id;  // empty = none
  int64_t time_us = 0;
  float rating = NAN;
  bool valid = false;
  std::vector<std::pair<std::string, PropValue>> props;
};

// ---------------------------------------------------------------------- JSON

struct Parser {
  const char* p;
  const char* end;
  bool ok = true;

  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n')) p++;
  }

  bool expect(char c) {
    skip_ws();
    if (p < end && *p == c) { p++; return true; }
    ok = false;
    return false;
  }

  // Parse a JSON string (assumes *p == '"'), appending the decoded value.
  bool parse_string(std::string* out) {
    skip_ws();
    if (p >= end || *p != '"') { ok = false; return false; }
    p++;
    while (p < end) {
      char c = *p++;
      if (c == '"') return true;
      if (c == '\\') {
        if (p >= end) break;
        char e = *p++;
        switch (e) {
          case '"': if (out) out->push_back('"'); break;
          case '\\': if (out) out->push_back('\\'); break;
          case '/': if (out) out->push_back('/'); break;
          case 'b': if (out) out->push_back('\b'); break;
          case 'f': if (out) out->push_back('\f'); break;
          case 'n': if (out) out->push_back('\n'); break;
          case 'r': if (out) out->push_back('\r'); break;
          case 't': if (out) out->push_back('\t'); break;
          case 'u': {
            if (end - p < 4) { ok = false; return false; }
            unsigned code = 0;
            for (int i = 0; i < 4; i++) {
              char h = *p++;
              code <<= 4;
              if (h >= '0' && h <= '9') code |= h - '0';
              else if (h >= 'a' && h <= 'f') code |= h - 'a' + 10;
              else if (h >= 'A' && h <= 'F') code |= h - 'A' + 10;
              else { ok = false; return false; }
            }
            // surrogate pair
            if (code >= 0xD800 && code <= 0xDBFF && end - p >= 6 &&
                p[0] == '\\' && p[1] == 'u') {
              unsigned lo = 0;
              const char* q = p + 2;
              for (int i = 0; i < 4; i++) {
                char h = *q++;
                lo <<= 4;
                if (h >= '0' && h <= '9') lo |= h - '0';
                else if (h >= 'a' && h <= 'f') lo |= h - 'a' + 10;
                else if (h >= 'A' && h <= 'F') lo |= h - 'A' + 10;
                else { lo = 0xFFFFFFFF; break; }
              }
              if (lo >= 0xDC00 && lo <= 0xDFFF) {
                code = 0x10000 + ((code - 0xD800) << 10) + (lo - 0xDC00);
                p += 6;
              }
            }
            if (out) {  // encode UTF-8
              if (code < 0x80) out->push_back((char)code);
              else if (code < 0x800) {
                out->push_back((char)(0xC0 | (code >> 6)));
                out->push_back((char)(0x80 | (code & 0x3F)));
              } else if (code < 0x10000) {
                out->push_back((char)(0xE0 | (code >> 12)));
                out->push_back((char)(0x80 | ((code >> 6) & 0x3F)));
                out->push_back((char)(0x80 | (code & 0x3F)));
              } else {
                out->push_back((char)(0xF0 | (code >> 18)));
                out->push_back((char)(0x80 | ((code >> 12) & 0x3F)));
                out->push_back((char)(0x80 | ((code >> 6) & 0x3F)));
                out->push_back((char)(0x80 | (code & 0x3F)));
              }
            }
            break;
          }
          default: ok = false; return false;
        }
      } else if (out) {
        out->push_back(c);
      }
    }
    ok = false;
    return false;
  }

  bool skip_value();  // forward decl

  bool skip_object() {
    if (!expect('{')) return false;
    skip_ws();
    if (p < end && *p == '}') { p++; return true; }
    while (p < end) {
      if (!parse_string(nullptr)) return false;
      if (!expect(':')) return false;
      if (!skip_value()) return false;
      skip_ws();
      if (p < end && *p == ',') { p++; continue; }
      return expect('}');
    }
    ok = false;
    return false;
  }

  bool skip_array() {
    if (!expect('[')) return false;
    skip_ws();
    if (p < end && *p == ']') { p++; return true; }
    while (p < end) {
      if (!skip_value()) return false;
      skip_ws();
      if (p < end && *p == ',') { p++; continue; }
      return expect(']');
    }
    ok = false;
    return false;
  }

  bool parse_number(double* out) {
    skip_ws();
    char* numend = nullptr;
    double v = strtod(p, &numend);
    if (numend == p) { ok = false; return false; }
    if (out) *out = v;
    p = numend;
    return true;
  }

  bool skip_literal(const char* lit) {
    size_t n = strlen(lit);
    if ((size_t)(end - p) >= n && strncmp(p, lit, n) == 0) { p += n; return true; }
    ok = false;
    return false;
  }
};

bool Parser::skip_value() {
  skip_ws();
  if (p >= end) { ok = false; return false; }
  switch (*p) {
    case '"': return parse_string(nullptr);
    case '{': return skip_object();
    case '[': return skip_array();
    case 't': return skip_literal("true");
    case 'f': return skip_literal("false");
    case 'n': return skip_literal("null");
    default: return parse_number(nullptr);
  }
}

// days since epoch for a civil date (Howard Hinnant's algorithm)
int64_t days_from_civil(int y, unsigned m, unsigned d) {
  y -= m <= 2;
  const int era = (y >= 0 ? y : y - 399) / 400;
  const unsigned yoe = (unsigned)(y - era * 400);
  const unsigned doy = (153 * (m + (m > 2 ? -3 : 9)) + 2) / 5 + d - 1;
  const unsigned doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
  return (int64_t)era * 146097 + (int64_t)doe - 719468;
}

// ISO-8601 -> epoch microseconds. Handles "YYYY-MM-DDTHH:MM:SS[.ffffff]"
// with "Z" or "+HH:MM"/"-HH:MM" offset.
bool parse_iso8601_us(const std::string& s, int64_t* out) {
  int y, mo, d, h, mi;
  double sec = 0;
  if (s.size() < 19) return false;
  if (sscanf(s.c_str(), "%d-%d-%dT%d:%d:%lf", &y, &mo, &d, &h, &mi, &sec) != 6)
    return false;
  // find timezone offset after the seconds field
  int64_t offset_s = 0;
  size_t tzpos = s.find_first_of("Z+-", 19);
  // (a '-' inside fractional seconds can't occur; offsets start at/after pos 19)
  if (tzpos != std::string::npos) {
    char c = s[tzpos];
    if (c == '+' || c == '-') {
      int oh = 0, om = 0;
      if (sscanf(s.c_str() + tzpos + 1, "%d:%d", &oh, &om) >= 1) {
        offset_s = (int64_t)oh * 3600 + (int64_t)om * 60;
        if (c == '-') offset_s = -offset_s;
      }
    }
  }
  int64_t days = days_from_civil(y, (unsigned)mo, (unsigned)d);
  double total = (double)days * 86400.0 + h * 3600.0 + mi * 60.0 + sec - (double)offset_s;
  *out = (int64_t)(total * 1e6);
  return true;
}

// Parse one property VALUE into pv (see PropValue kinds): nulls keep
// kind 4, nested objects keep their raw JSON span as kind 5; only nested
// containers INSIDE lists are skipped structurally — the line still parses.
bool parse_prop_value(Parser& ps, PropValue* pv) {
  ps.skip_ws();
  if (ps.p >= ps.end) { ps.ok = false; return false; }
  char c = *ps.p;
  if (c == '"') {
    pv->strs.emplace_back();
    if (!ps.parse_string(&pv->strs.back())) return false;
    pv->kind = 2;
    return true;
  }
  if (c == 't') { pv->kind = 1; pv->num = 1.0; return ps.skip_literal("true"); }
  if (c == 'f') { pv->kind = 1; pv->num = 0.0; return ps.skip_literal("false"); }
  if (c == 'n') { pv->kind = 4; return ps.skip_literal("null"); }
  if (c == '{') {
    const char* start = ps.p;
    if (!ps.skip_object()) return false;
    pv->kind = 5;
    pv->strs.emplace_back(start, (size_t)(ps.p - start));
    return true;
  }
  if (c == '[') {
    ps.p++;
    pv->kind = 3;
    ps.skip_ws();
    if (ps.p < ps.end && *ps.p == ']') { ps.p++; return true; }
    while (ps.p < ps.end) {
      ps.skip_ws();
      if (ps.p >= ps.end) break;
      char e = *ps.p;
      if (e == '"') {
        pv->strs.emplace_back();
        if (!ps.parse_string(&pv->strs.back())) return false;
      } else if (e == 't') {
        if (!ps.skip_literal("true")) return false;
        pv->strs.emplace_back("true");
      } else if (e == 'f') {
        if (!ps.skip_literal("false")) return false;
        pv->strs.emplace_back("false");
      } else if (e == 'n') {
        if (!ps.skip_literal("null")) return false;  // dropped
      } else if (e == '{' ) {
        if (!ps.skip_object()) return false;         // dropped
      } else if (e == '[') {
        if (!ps.skip_array()) return false;          // dropped
      } else {
        double v;
        if (!ps.parse_number(&v)) return false;
        char buf[32];
        snprintf(buf, sizeof buf, "%.17g", v);
        pv->strs.emplace_back(buf);
      }
      ps.skip_ws();
      if (ps.p < ps.end && *ps.p == ',') { ps.p++; continue; }
      return ps.expect(']');
    }
    ps.ok = false;
    return false;
  }
  if (!ps.parse_number(&pv->num)) return false;
  pv->kind = 0;
  return true;
}

bool parse_line(const char* line, const char* line_end, RawEvent* ev) {
  Parser ps{line, line_end};
  if (!ps.expect('{')) return false;
  ps.skip_ws();
  if (ps.p < ps.end && *ps.p == '}') { return false; }
  std::string key, sval;
  std::string event_time;
  while (ps.p < ps.end) {
    key.clear();
    if (!ps.parse_string(&key)) return false;
    if (!ps.expect(':')) return false;
    if (key == "event") {
      if (!ps.parse_string(&ev->event)) return false;
    } else if (key == "entityType") {
      if (!ps.parse_string(&ev->entity_type)) return false;
    } else if (key == "entityId") {
      if (!ps.parse_string(&ev->entity_id)) return false;
    } else if (key == "targetEntityId") {
      if (!ps.parse_string(&ev->target_id)) return false;
    } else if (key == "eventTime") {
      if (!ps.parse_string(&event_time)) return false;
    } else if (key == "properties") {
      ps.skip_ws();
      if (ps.p < ps.end && *ps.p == '{') {
        ps.p++;
        ps.skip_ws();
        if (ps.p < ps.end && *ps.p == '}') { ps.p++; }
        else {
          std::string pk;
          while (ps.p < ps.end) {
            pk.clear();
            if (!ps.parse_string(&pk)) return false;
            if (!ps.expect(':')) return false;
            PropValue pv;
            if (!parse_prop_value(ps, &pv)) return false;
            if (pv.kind == 0 && pk == "rating") ev->rating = (float)pv.num;
            if (pv.kind >= 0) ev->props.emplace_back(std::move(pk), std::move(pv));
            ps.skip_ws();
            if (ps.p < ps.end && *ps.p == ',') { ps.p++; continue; }
            if (!ps.expect('}')) return false;
            break;
          }
        }
      } else if (!ps.skip_value()) {
        return false;
      }
    } else {
      if (!ps.skip_value()) return false;
    }
    ps.skip_ws();
    if (ps.p < ps.end && *ps.p == ',') { ps.p++; continue; }
    if (!ps.expect('}')) return false;
    break;
  }
  if (ev->event.empty() || ev->entity_id.empty()) return false;
  if (!event_time.empty() && !parse_iso8601_us(event_time, &ev->time_us)) return false;
  ev->valid = ps.ok;
  return ps.ok;
}

// ------------------------------------------------------------------- scanner

struct Dict {
  std::unordered_map<std::string, int32_t> map;
  std::vector<std::string> strings;

  int32_t add(const std::string& s) {
    auto it = map.find(s);
    if (it != map.end()) return it->second;
    int32_t id = (int32_t)strings.size();
    map.emplace(s, id);
    strings.push_back(s);
    return id;
  }
};

// Sparse per-key property column: entry j is (rows[j], kind[j], num[j],
// strings codes[str_offs[j] .. str_offs[j+1])).  rows are ascending by
// construction (merge walks rows in order).
struct PropColumn {
  std::vector<int64_t> rows;
  std::vector<int8_t> kind;
  std::vector<double> num;
  std::vector<int64_t> str_offs;  // finalized to size n+1 after merge
  std::vector<int32_t> codes;
  Dict dict;
};

struct Scanner {
  std::vector<std::string> paths;
  std::string error;

  std::vector<int32_t> event_code, entity_type_code, entity_code, target_code;
  std::vector<int64_t> time_us;
  std::vector<float> rating;
  Dict events, entity_types, entities, targets;

  std::unordered_map<std::string, int> prop_index;
  std::vector<std::string> prop_keys;
  std::vector<PropColumn> prop_cols;

  // dict string export buffers
  std::vector<char> blob;
  std::vector<int64_t> offsets;

  PropColumn* prop_col(const std::string& key) {
    auto it = prop_index.find(key);
    if (it != prop_index.end()) return &prop_cols[it->second];
    int idx = (int)prop_cols.size();
    prop_index.emplace(key, idx);
    prop_keys.push_back(key);
    prop_cols.emplace_back();
    return &prop_cols[idx];
  }
};

bool read_file(const std::string& path, std::string* out, std::string* err) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) { *err = "cannot open " + path; return false; }
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  out->resize((size_t)n);
  size_t got = n ? fread(&(*out)[0], 1, (size_t)n, f) : 0;
  fclose(f);
  if ((long)got != n) { *err = "short read on " + path; return false; }
  return true;
}

}  // namespace

extern "C" {

void* scan_new() { return new Scanner(); }

void scan_free(void* h) { delete (Scanner*)h; }

void scan_add_file(void* h, const char* path) {
  ((Scanner*)h)->paths.emplace_back(path);
}

const char* scan_error(void* h) { return ((Scanner*)h)->error.c_str(); }

// Returns row count, or -1 on error.
int64_t scan_run(void* h, int n_threads) {
  Scanner* s = (Scanner*)h;
  size_t n_files = s->paths.size();
  std::vector<std::vector<RawEvent>> per_file(n_files);
  std::vector<std::string> errors(n_files);
  std::atomic<size_t> next{0};
  if (n_threads < 1) n_threads = 1;

  auto worker = [&]() {
    for (;;) {
      size_t i = next.fetch_add(1);
      if (i >= n_files) return;
      std::string content;
      if (!read_file(s->paths[i], &content, &errors[i])) continue;
      const char* p = content.data();
      const char* end = p + content.size();
      auto& out = per_file[i];
      while (p < end) {
        const char* nl = (const char*)memchr(p, '\n', (size_t)(end - p));
        if (!nl) break;  // unterminated torn tail (writer killed
                         // mid-append): never acknowledged; the Python
                         // scan skips it and the owning writer truncates
                         // it on reopen — surfacing it here would make
                         // native and Python scans disagree
        if (nl > p) {
          RawEvent ev;
          if (parse_line(p, nl, &ev)) out.push_back(std::move(ev));
        }
        p = nl + 1;
      }
    }
  };

  std::vector<std::thread> threads;
  int nt = std::min<int>(n_threads, (int)std::max<size_t>(n_files, 1));
  for (int t = 0; t < nt; t++) threads.emplace_back(worker);
  for (auto& t : threads) t.join();

  for (auto& e : errors) {
    if (!e.empty()) { s->error = e; return -1; }
  }

  size_t total = 0;
  for (auto& v : per_file) total += v.size();
  s->event_code.reserve(total);
  s->entity_type_code.reserve(total);
  s->entity_code.reserve(total);
  s->target_code.reserve(total);
  s->time_us.reserve(total);
  s->rating.reserve(total);
  for (auto& v : per_file) {
    for (auto& ev : v) {
      int64_t row = (int64_t)s->event_code.size();
      s->event_code.push_back(s->events.add(ev.event));
      s->entity_type_code.push_back(s->entity_types.add(ev.entity_type));
      s->entity_code.push_back(s->entities.add(ev.entity_id));
      s->target_code.push_back(
          ev.target_id.empty() ? -1 : s->targets.add(ev.target_id));
      s->time_us.push_back(ev.time_us);
      s->rating.push_back(ev.rating);
      for (auto& kv : ev.props) {
        PropColumn* col = s->prop_col(kv.first);
        col->rows.push_back(row);
        col->kind.push_back(kv.second.kind);
        col->num.push_back(kv.second.num);
        col->str_offs.push_back((int64_t)kv.second.strs.size());  // lengths now
        for (auto& str : kv.second.strs) col->codes.push_back(col->dict.add(str));
      }
    }
    v.clear();
    v.shrink_to_fit();
  }
  // finalize lengths -> exclusive-scan offsets [n+1]
  for (auto& col : s->prop_cols) {
    int64_t acc = 0;
    col.str_offs.push_back(0);
    for (size_t j = 0; j + 1 < col.str_offs.size(); j++) {
      int64_t len = col.str_offs[j];
      col.str_offs[j] = acc;
      acc += len;
    }
    col.str_offs.back() = acc;
  }
  return (int64_t)s->event_code.size();
}

int64_t scan_rows(void* h) { return (int64_t)((Scanner*)h)->event_code.size(); }

const int32_t* scan_col_event(void* h) { return ((Scanner*)h)->event_code.data(); }
const int32_t* scan_col_entity_type(void* h) { return ((Scanner*)h)->entity_type_code.data(); }
const int32_t* scan_col_entity(void* h) { return ((Scanner*)h)->entity_code.data(); }
const int32_t* scan_col_target(void* h) { return ((Scanner*)h)->target_code.data(); }
const int64_t* scan_col_time(void* h) { return ((Scanner*)h)->time_us.data(); }
const float* scan_col_rating(void* h) { return ((Scanner*)h)->rating.data(); }

static Dict* dict_by_id(Scanner* s, int which) {
  switch (which) {
    case 0: return &s->events;
    case 1: return &s->entity_types;
    case 2: return &s->entities;
    case 3: return &s->targets;
  }
  return nullptr;
}

int64_t scan_dict_size(void* h, int which) {
  Dict* d = dict_by_id((Scanner*)h, which);
  return d ? (int64_t)d->strings.size() : -1;
}

// Export a dict as (blob, offsets[n+1]); returns blob size.
int64_t scan_dict_export(void* h, int which) {
  Scanner* s = (Scanner*)h;
  Dict* d = dict_by_id(s, which);
  if (!d) return -1;
  s->blob.clear();
  s->offsets.clear();
  s->offsets.push_back(0);
  for (auto& str : d->strings) {
    s->blob.insert(s->blob.end(), str.begin(), str.end());
    s->offsets.push_back((int64_t)s->blob.size());
  }
  return (int64_t)s->blob.size();
}

const char* scan_dict_blob(void* h) { return ((Scanner*)h)->blob.data(); }
const int64_t* scan_dict_offsets(void* h) { return ((Scanner*)h)->offsets.data(); }

// ------------------------------ sparse property columns (discovered schema)

int64_t scan_prop_count(void* h) { return (int64_t)((Scanner*)h)->prop_cols.size(); }

// Key export is length-delimited (NOT c_str): JSON keys may contain
// embedded NULs via the \u0000 escape, and truncation could silently collide two
// distinct columns on the Python side.
const char* scan_prop_key(void* h, int k) {
  Scanner* s = (Scanner*)h;
  if (k < 0 || (size_t)k >= s->prop_keys.size()) return nullptr;
  return s->prop_keys[k].data();
}

int64_t scan_prop_key_len(void* h, int k) {
  Scanner* s = (Scanner*)h;
  if (k < 0 || (size_t)k >= s->prop_keys.size()) return -1;
  return (int64_t)s->prop_keys[k].size();
}

static PropColumn* prop_by_id(void* h, int k) {
  Scanner* s = (Scanner*)h;
  if (k < 0 || (size_t)k >= s->prop_cols.size()) return nullptr;
  return &s->prop_cols[k];
}

int64_t scan_prop_len(void* h, int k) {
  PropColumn* c = prop_by_id(h, k);
  return c ? (int64_t)c->rows.size() : -1;
}

const int64_t* scan_prop_rows(void* h, int k) {
  PropColumn* c = prop_by_id(h, k);
  return c ? c->rows.data() : nullptr;
}

const int8_t* scan_prop_kind(void* h, int k) {
  PropColumn* c = prop_by_id(h, k);
  return c ? c->kind.data() : nullptr;
}

const double* scan_prop_num(void* h, int k) {
  PropColumn* c = prop_by_id(h, k);
  return c ? c->num.data() : nullptr;
}

const int64_t* scan_prop_stroffs(void* h, int k) {
  PropColumn* c = prop_by_id(h, k);
  return c ? c->str_offs.data() : nullptr;
}

const int32_t* scan_prop_codes(void* h, int k) {
  PropColumn* c = prop_by_id(h, k);
  return c ? c->codes.data() : nullptr;
}

int64_t scan_prop_codes_len(void* h, int k) {
  PropColumn* c = prop_by_id(h, k);
  return c ? (int64_t)c->codes.size() : -1;
}

int64_t scan_prop_dict_size(void* h, int k) {
  PropColumn* c = prop_by_id(h, k);
  return c ? (int64_t)c->dict.strings.size() : -1;
}

// Export a property column's dict via the shared blob/offsets buffers.
int64_t scan_prop_dict_export(void* h, int k) {
  Scanner* s = (Scanner*)h;
  PropColumn* c = prop_by_id(h, k);
  if (!c) return -1;
  s->blob.clear();
  s->offsets.clear();
  s->offsets.push_back(0);
  for (auto& str : c->dict.strings) {
    s->blob.insert(s->blob.end(), str.begin(), str.end());
    s->offsets.push_back((int64_t)s->blob.size());
  }
  return (int64_t)s->blob.size();
}

// --------------------------------------------- chunked COO layout (training)
//
// The device CCO path wants (user, item) pairs grouped into fixed-size user
// chunks, padded to a common width (ops/cco.block_interactions).  numpy does
// argsort + fancy-indexing + a Python fill loop; this is the O(n) two-pass
// counting layout, beside the scanner because it too is host staging.
//
//   layout_width(user, n, chunk, n_chunks, pad_multiple) -> padded width
//   layout_fill(user, item, n, chunk, n_chunks, width,
//               out_lu, out_it, out_cnt) -> 0 on success
//
// out_lu/out_it are [n_chunks * width] int32 (caller-zeroed), out_cnt is
// [n_chunks] int32.

int64_t layout_width(const int32_t* user, int64_t n, int32_t chunk,
                     int32_t n_chunks, int32_t pad_multiple) {
  if (chunk <= 0 || n_chunks <= 0) return -1;
  std::vector<int64_t> counts(n_chunks, 0);
  for (int64_t i = 0; i < n; i++) {
    int32_t u = user[i];
    int32_t b = u / chunk;
    // explicit u < 0: truncating division maps [-(chunk-1), -1] to b == 0
    if (u < 0 || b >= n_chunks) return -1;  // user id out of range
    counts[b]++;
  }
  int64_t width = 1;
  for (int64_t c : counts) width = c > width ? c : width;
  if (pad_multiple > 1) width = (width + pad_multiple - 1) / pad_multiple * pad_multiple;
  return width;
}

int32_t layout_fill(const int32_t* user, const int32_t* item, int64_t n,
                    int32_t chunk, int32_t n_chunks, int64_t width,
                    int32_t* out_lu, int32_t* out_it, int32_t* out_cnt) {
  if (chunk <= 0 || n_chunks <= 0 || width <= 0) return -1;
  std::vector<int64_t> cursor(n_chunks, 0);
  for (int64_t i = 0; i < n; i++) {
    int32_t u = user[i];
    int32_t b = u / chunk;
    if (u < 0 || b >= n_chunks) return -1;
    int64_t pos = (int64_t)b * width + cursor[b];
    if (cursor[b] >= width) return -2;  // width too small for this chunk
    out_lu[pos] = u % chunk;
    out_it[pos] = item[i];
    cursor[b]++;
  }
  for (int32_t b = 0; b < n_chunks; b++) out_cnt[b] = (int32_t)cursor[b];
  return 0;
}

}  // extern "C"
