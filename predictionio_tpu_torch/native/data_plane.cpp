// The scan core's columnar header parse and merge handles, the serve core
// and the HTTP core, for the port's native/core.py (ctypes C ABI, no
// Python.h).
//
// Counterpart of predictionio_tpu/native/data_plane.cpp, three parts of
// it: the PIOCOL01 snapshot header (JSON) -> column specs, the string
// dictionaries as UTF-8 blobs with int64 offsets, the property columns and
// the raw span of "meta"; the dictionary-union handles and the code gather
// of store/columnar.BatchMerger (dp_dict_*, dp_take_i32); the UR host serve tail's CSR gather, unique,
// score accumulation and top-k (models/common.py, the UR engine's
// _score_history_host), each bit for bit its numpy oracle; and the HTTP
// request-head parse and response assembly of the event-loop front end
// (api/http_util.py).  Every entry point is called through ctypes.CDLL,
// so the GIL is released for the call.
//
// Contract against the Python parse (json.loads): the same specs, the same
// strings byte for byte (surrogate pairs combine; lone surrogates pass
// through as their 3-byte encoding, as Python's "surrogatepass" codec
// round-trips them); a header this parser declines returns NULL and
// json.loads answers.  tests/test_torch_native.py holds it.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <functional>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

#if defined(_WIN32)
#define EXPORT extern "C" __declspec(dllexport)
#else
#define EXPORT extern "C" __attribute__((visibility("default")))
#endif

namespace {

// UTF-8 encode one code point (surrogate code points use the normal
// 3-byte formula — exactly the bytes Python's "surrogatepass" codec
// round-trips, which is how json.loads-compatible lone surrogates
// survive the native path).
inline void utf8_put(std::string &out, uint32_t cp) {
    if (cp < 0x80) {
        out.push_back((char)cp);
    } else if (cp < 0x800) {
        out.push_back((char)(0xC0 | (cp >> 6)));
        out.push_back((char)(0x80 | (cp & 0x3F)));
    } else if (cp < 0x10000) {
        out.push_back((char)(0xE0 | (cp >> 12)));
        out.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
        out.push_back((char)(0x80 | (cp & 0x3F)));
    } else {
        out.push_back((char)(0xF0 | (cp >> 18)));
        out.push_back((char)(0x80 | ((cp >> 12) & 0x3F)));
        out.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
        out.push_back((char)(0x80 | (cp & 0x3F)));
    }
}

// -- minimal JSON parser (schema-directed, for the PIOCOL01 header) ---------

struct Json {
    const char *p, *end;
    bool ok = true;

    explicit Json(const char *buf, int64_t len) : p(buf), end(buf + len) {}

    void ws() { while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r')) ++p; }
    bool lit(char c) { ws(); if (p < end && *p == c) { ++p; return true; } ok = false; return false; }
    bool peek(char c) { ws(); return p < end && *p == c; }

    static int hex(char c) {
        if (c >= '0' && c <= '9') return c - '0';
        if (c >= 'a' && c <= 'f') return c - 'a' + 10;
        if (c >= 'A' && c <= 'F') return c - 'A' + 10;
        return -1;
    }

    bool u16(uint32_t &v) {
        if (end - p < 4) return false;
        v = 0;
        for (int i = 0; i < 4; ++i) {
            int h = hex(p[i]);
            if (h < 0) return false;
            v = (v << 4) | (uint32_t)h;
        }
        p += 4;
        return true;
    }

    // JSON string → UTF-8 bytes appended to out (escape handling matches
    // Python json.loads: surrogate pairs combine, lone surrogates pass
    // through as their 3-byte encoding)
    bool str(std::string &out) {
        if (!lit('"')) return false;
        while (p < end) {
            unsigned char c = (unsigned char)*p;
            if (c == '"') { ++p; return true; }
            if (c == '\\') {
                ++p;
                if (p >= end) break;
                char e = *p++;
                switch (e) {
                case '"': out.push_back('"'); break;
                case '\\': out.push_back('\\'); break;
                case '/': out.push_back('/'); break;
                case 'b': out.push_back('\b'); break;
                case 'f': out.push_back('\f'); break;
                case 'n': out.push_back('\n'); break;
                case 'r': out.push_back('\r'); break;
                case 't': out.push_back('\t'); break;
                case 'u': {
                    uint32_t hi;
                    if (!u16(hi)) { ok = false; return false; }
                    if (hi >= 0xD800 && hi < 0xDC00 && end - p >= 6 &&
                        p[0] == '\\' && p[1] == 'u') {
                        const char *save = p;
                        p += 2;
                        uint32_t lo;
                        if (u16(lo) && lo >= 0xDC00 && lo < 0xE000) {
                            utf8_put(out, 0x10000 + ((hi - 0xD800) << 10) + (lo - 0xDC00));
                            break;
                        }
                        p = save;  // not a low surrogate: leave for next loop
                    }
                    utf8_put(out, hi);
                    break;
                }
                default: ok = false; return false;
                }
            } else {
                out.push_back((char)c);
                ++p;
            }
        }
        ok = false;
        return false;
    }

    bool num(double &d, int64_t &i, bool &is_int) {
        ws();
        const char *s = p;
        if (p < end && (*p == '-' || *p == '+')) ++p;
        is_int = true;
        while (p < end && ((*p >= '0' && *p <= '9') || *p == '.' || *p == 'e' ||
                           *p == 'E' || *p == '-' || *p == '+')) {
            if (*p == '.' || *p == 'e' || *p == 'E') is_int = false;
            ++p;
        }
        if (p == s) { ok = false; return false; }
        char buf[64];
        size_t n = (size_t)(p - s);
        if (n >= sizeof(buf)) { ok = false; return false; }
        memcpy(buf, s, n);
        buf[n] = 0;
        if (is_int) i = strtoll(buf, nullptr, 10);
        d = strtod(buf, nullptr);
        return true;
    }

    bool integer(int64_t &v) {
        double d; bool ii;
        if (!num(d, v, ii)) return false;
        if (!ii) v = (int64_t)d;
        return true;
    }

    bool skip() {  // skip any value
        ws();
        if (p >= end) { ok = false; return false; }
        char c = *p;
        if (c == '"') { std::string tmp; return str(tmp); }
        if (c == '{') {
            ++p;
            if (peek('}')) { ++p; return true; }
            while (ok) {
                std::string k;
                if (!str(k) || !lit(':') || !skip()) return false;
                if (peek(',')) { ++p; continue; }
                return lit('}');
            }
            return false;
        }
        if (c == '[') {
            ++p;
            if (peek(']')) { ++p; return true; }
            while (ok) {
                if (!skip()) return false;
                if (peek(',')) { ++p; continue; }
                return lit(']');
            }
            return false;
        }
        if (c == 't') { if (end - p >= 4 && !memcmp(p, "true", 4)) { p += 4; return true; } }
        else if (c == 'f') { if (end - p >= 5 && !memcmp(p, "false", 5)) { p += 5; return true; } }
        else if (c == 'n') { if (end - p >= 4 && !memcmp(p, "null", 4)) { p += 4; return true; } }
        else { double d; int64_t i; bool ii; return num(d, i, ii); }
        ok = false;
        return false;
    }
};

// -- columnar snapshot header ------------------------------------------------

struct Spec {
    int64_t n = -1, off = -1;
    std::string dtype;
    bool present = false;
};

struct StrTable {           // decoded JSON string array → blob + offsets
    std::string blob;
    std::vector<int64_t> offs{0};
    int64_t n() const { return (int64_t)offs.size() - 1; }
};

struct PropEntry {
    std::string key;
    StrTable dict;
    Spec rows, kind, num, str_offs, codes;
};

struct ColHeader {
    int64_t rows = -1;
    Spec cols[6];            // event,entity_type,entity,target,times,ratings
    bool has_ids = false;
    Spec ids_blob, ids_offs;
    StrTable dicts[4];       // event, entity_type, entity, target
    bool has_dict[4] = {false, false, false, false};
    std::vector<PropEntry> props;
    int64_t meta_off = -1, meta_len = 0;
};

const char *kColNames[6] = {"event_codes", "entity_type_codes", "entity_ids",
                            "target_ids", "times_us", "ratings"};
const char *kColDtypes[6] = {"<i4", "<i4", "<i4", "<i4", "<i8", "<f4"};
const char *kDictNames[4] = {"event", "entity_type", "entity", "target"};

bool parse_spec(Json &j, Spec &s, const char *want_dtype) {
    if (!j.lit('{')) return false;
    while (j.ok) {
        std::string k;
        if (!j.str(k) || !j.lit(':')) return false;
        if (k == "dtype") {
            s.dtype.clear();
            if (!j.str(s.dtype)) return false;
        } else if (k == "n") {
            if (!j.integer(s.n)) return false;
        } else if (k == "off") {
            if (!j.integer(s.off)) return false;
        } else if (!j.skip()) {
            return false;
        }
        if (j.peek(',')) { ++j.p; continue; }
        if (!j.lit('}')) return false;
        break;
    }
    if (s.n < 0 || s.off < 0 || s.dtype != want_dtype) return false;
    s.present = true;
    return true;
}

bool parse_str_array(Json &j, StrTable &t) {
    if (!j.lit('[')) return false;
    if (j.peek(']')) { ++j.p; return true; }
    while (j.ok) {
        if (!j.str(t.blob)) return false;
        t.offs.push_back((int64_t)t.blob.size());
        if (j.peek(',')) { ++j.p; continue; }
        return j.lit(']');
    }
    return false;
}

bool parse_prop_entry(Json &j, PropEntry &e) {
    if (!j.lit('{')) return false;
    bool have[5] = {false, false, false, false, false};
    bool have_dict = false;
    while (j.ok) {
        std::string k;
        if (!j.str(k) || !j.lit(':')) return false;
        if (k == "dict") { if (!parse_str_array(j, e.dict)) return false; have_dict = true; }
        else if (k == "rows") { if (!parse_spec(j, e.rows, "<i8")) return false; have[0] = true; }
        else if (k == "kind") { if (!parse_spec(j, e.kind, "|i1")) return false; have[1] = true; }
        else if (k == "num") { if (!parse_spec(j, e.num, "<f8")) return false; have[2] = true; }
        else if (k == "str_offs") { if (!parse_spec(j, e.str_offs, "<i8")) return false; have[3] = true; }
        else if (k == "codes") { if (!parse_spec(j, e.codes, "<i4")) return false; have[4] = true; }
        else if (!j.skip()) return false;
        if (j.peek(',')) { ++j.p; continue; }
        if (!j.lit('}')) return false;
        break;
    }
    return have_dict && have[0] && have[1] && have[2] && have[3] && have[4];
}

bool parse_header(Json &j, const char *base, ColHeader &h) {
    if (!j.lit('{')) return false;
    while (j.ok) {
        std::string k;
        if (!j.str(k) || !j.lit(':')) return false;
        if (k == "rows") {
            if (!j.integer(h.rows)) return false;
        } else if (k == "cols") {
            if (!j.lit('{')) return false;
            while (j.ok) {
                std::string name;
                if (!j.str(name) || !j.lit(':')) return false;
                int slot = -1;
                for (int i = 0; i < 6; ++i)
                    if (name == kColNames[i]) { slot = i; break; }
                if (slot >= 0) {
                    if (!parse_spec(j, h.cols[slot], kColDtypes[slot])) return false;
                } else if (!j.skip()) return false;
                if (j.peek(',')) { ++j.p; continue; }
                if (!j.lit('}')) return false;
                break;
            }
        } else if (k == "ids") {
            j.ws();
            if (j.peek('n')) { if (!j.skip()) return false; }
            else {
                if (!j.lit('{')) return false;
                while (j.ok) {
                    std::string name;
                    if (!j.str(name) || !j.lit(':')) return false;
                    if (name == "blob") { if (!parse_spec(j, h.ids_blob, "|u1")) return false; }
                    else if (name == "offs") { if (!parse_spec(j, h.ids_offs, "<i8")) return false; }
                    else if (!j.skip()) return false;
                    if (j.peek(',')) { ++j.p; continue; }
                    if (!j.lit('}')) return false;
                    break;
                }
                h.has_ids = h.ids_blob.present && h.ids_offs.present;
                if (!h.has_ids) return false;
            }
        } else if (k == "dicts") {
            if (!j.lit('{')) return false;
            while (j.ok) {
                std::string name;
                if (!j.str(name) || !j.lit(':')) return false;
                int slot = -1;
                for (int i = 0; i < 4; ++i)
                    if (name == kDictNames[i]) { slot = i; break; }
                if (slot >= 0) {
                    if (!parse_str_array(j, h.dicts[slot])) return false;
                    h.has_dict[slot] = true;
                } else if (!j.skip()) return false;
                if (j.peek(',')) { ++j.p; continue; }
                if (!j.lit('}')) return false;
                break;
            }
        } else if (k == "props") {
            if (!j.lit('[')) return false;
            if (j.peek(']')) { ++j.p; }
            else while (j.ok) {
                // each entry is [key, {...}]
                if (!j.lit('[')) return false;
                PropEntry e;
                if (!j.str(e.key) || !j.lit(',') || !parse_prop_entry(j, e)) return false;
                if (!j.lit(']')) return false;
                h.props.push_back(std::move(e));
                if (j.peek(',')) { ++j.p; continue; }
                if (!j.lit(']')) return false;
                break;
            }
        } else if (k == "meta") {
            j.ws();
            const char *s = j.p;
            if (!j.skip()) return false;
            h.meta_off = (int64_t)(s - base);
            h.meta_len = (int64_t)(j.p - s);
        } else if (!j.skip()) {
            return false;
        }
        if (j.peek(',')) { ++j.p; continue; }
        if (!j.lit('}')) return false;
        break;
    }
    if (h.rows < 0) return false;
    for (int i = 0; i < 6; ++i)
        if (!h.cols[i].present) return false;
    for (int i = 0; i < 4; ++i)
        if (!h.has_dict[i]) return false;
    return j.ok;
}

// A string dictionary of the merge handles: codes in first-appearance
// order; the deque keeps the keys' bytes at stable addresses.
struct Dict {
    std::unordered_map<std::string_view, int32_t> map;
    std::deque<std::string> store;
    std::string exp_blob;
    std::vector<int64_t> exp_offs;
};

}  // namespace


// ===========================================================================
// C ABI
// ===========================================================================

// 2: the HTTP core (dp_http_parse, dp_http_assemble) joined the ABI
// 3: the serve core (dp_csr_gather[_size], dp_unique_i32, dp_score_accum,
//    dp_topk_f32) joined the ABI
// 4: the merge handles (dp_dict_*, dp_take_i32) joined the ABI
EXPORT int64_t dp_abi_version() { return 4; }

// -- scan core: snapshot header ---------------------------------------------

EXPORT void *dp_col_parse(const char *buf, int64_t len) {
    auto *h = new ColHeader();
    Json j(buf, len);
    if (!parse_header(j, buf, *h)) {
        delete h;
        return nullptr;
    }
    return h;
}

EXPORT void dp_col_free(void *p) { delete (ColHeader *)p; }

EXPORT int64_t dp_col_rows(void *p) { return ((ColHeader *)p)->rows; }

// which: 0..5 fixed columns, 6 ids blob, 7 ids offs.  out = [n, off].
// returns 0, or -1 when absent (ids on an id-less snapshot).
EXPORT int dp_col_spec(void *p, int which, int64_t *out) {
    auto *h = (ColHeader *)p;
    const Spec *s = nullptr;
    if (which >= 0 && which < 6) s = &h->cols[which];
    else if (which == 6) s = h->has_ids ? &h->ids_blob : nullptr;
    else if (which == 7) s = h->has_ids ? &h->ids_offs : nullptr;
    if (s == nullptr || !s->present) return -1;
    out[0] = s->n;
    out[1] = s->off;
    return 0;
}

EXPORT int64_t dp_col_dict_n(void *p, int which) {
    return ((ColHeader *)p)->dicts[which].n();
}

EXPORT int64_t dp_col_dict_bytes(void *p, int which) {
    return (int64_t)((ColHeader *)p)->dicts[which].blob.size();
}

EXPORT void dp_col_dict_copy(void *p, int which, char *out_blob, int64_t *out_offs) {
    auto &t = ((ColHeader *)p)->dicts[which];
    if (!t.blob.empty()) memcpy(out_blob, t.blob.data(), t.blob.size());
    memcpy(out_offs, t.offs.data(), t.offs.size() * sizeof(int64_t));
}

EXPORT int64_t dp_col_nprops(void *p) { return (int64_t)((ColHeader *)p)->props.size(); }

EXPORT int64_t dp_col_prop_key_bytes(void *p, int64_t i) {
    return (int64_t)((ColHeader *)p)->props[i].key.size();
}

EXPORT void dp_col_prop_key_copy(void *p, int64_t i, char *out) {
    auto &k = ((ColHeader *)p)->props[i].key;
    if (!k.empty()) memcpy(out, k.data(), k.size());
}

// which: 0 rows, 1 kind, 2 num, 3 str_offs, 4 codes.  out = [n, off].
EXPORT int dp_col_prop_spec(void *p, int64_t i, int which, int64_t *out) {
    auto &e = ((ColHeader *)p)->props[i];
    const Spec *s = which == 0 ? &e.rows : which == 1 ? &e.kind
                  : which == 2 ? &e.num : which == 3 ? &e.str_offs
                  : which == 4 ? &e.codes : nullptr;
    if (s == nullptr || !s->present) return -1;
    out[0] = s->n;
    out[1] = s->off;
    return 0;
}

EXPORT int64_t dp_col_prop_dict_n(void *p, int64_t i) {
    return ((ColHeader *)p)->props[i].dict.n();
}

EXPORT int64_t dp_col_prop_dict_bytes(void *p, int64_t i) {
    return (int64_t)((ColHeader *)p)->props[i].dict.blob.size();
}

EXPORT void dp_col_prop_dict_copy(void *p, int64_t i, char *out_blob, int64_t *out_offs) {
    auto &t = ((ColHeader *)p)->props[i].dict;
    if (!t.blob.empty()) memcpy(out_blob, t.blob.data(), t.blob.size());
    memcpy(out_offs, t.offs.data(), t.offs.size() * sizeof(int64_t));
}

// out = [off, len] of the raw "meta" JSON value inside the header bytes
// (-1 length 0 when absent)
EXPORT void dp_col_meta_span(void *p, int64_t *out) {
    auto *h = (ColHeader *)p;
    out[0] = h->meta_off;
    out[1] = h->meta_len;
}

// -- scan core: dictionary union handles ------------------------------------

EXPORT void *dp_dict_new() { return new Dict(); }
EXPORT void dp_dict_free(void *p) { delete (Dict *)p; }
EXPORT int64_t dp_dict_len(void *p) { return (int64_t)((Dict *)p)->map.size(); }

// Union n strings (a UTF-8 blob + n+1 offsets) into the dictionary, codes
// in first-appearance order (BatchMerger's contract).  out_map[i] = the
// code of string i.  Returns how many strings were new: they got codes
// [old_len, old_len + new).
EXPORT int64_t dp_dict_union(void *p, const char *blob, const int64_t *offs,
                             int64_t n, int32_t *out_map) {
    auto *d = (Dict *)p;
    int64_t nnew = 0;
    for (int64_t i = 0; i < n; ++i) {
        std::string_view s(blob + offs[i], (size_t)(offs[i + 1] - offs[i]));
        auto it = d->map.find(s);
        if (it != d->map.end()) {
            out_map[i] = it->second;
        } else {
            d->store.emplace_back(s);
            const std::string &owned = d->store.back();
            int32_t id = (int32_t)d->map.size();
            d->map.emplace(std::string_view(owned.data(), owned.size()), id);
            out_map[i] = id;
            ++nnew;
        }
    }
    return nnew;
}

// Pack strings [from, len) as blob + offsets (what the unions added since
// `from`); returns the blob's size, or -1 for a bad range.  Read the
// pointers with dp_dict_export_blob / _offs.
EXPORT int64_t dp_dict_export(void *p, int64_t from) {
    auto *d = (Dict *)p;
    int64_t n = (int64_t)d->map.size();
    if (from < 0 || from > n) return -1;
    d->exp_blob.clear();
    d->exp_offs.assign(1, 0);
    for (int64_t i = from; i < n; ++i) {
        const std::string &s = d->store[(size_t)i];
        d->exp_blob.append(s);
        d->exp_offs.push_back((int64_t)d->exp_blob.size());
    }
    return (int64_t)d->exp_blob.size();
}

EXPORT const char *dp_dict_export_blob(void *p) { return ((Dict *)p)->exp_blob.data(); }
EXPORT const int64_t *dp_dict_export_offs(void *p) { return ((Dict *)p)->exp_offs.data(); }

// -- scan core: merge gather --------------------------------------------------

// out[i] = cmap[codes[i]].  With sentinel != 0 it is numpy's take over
// cmap with -1 appended (the target_ids merge): code -1 gives -1, other
// negative codes index from the end of the extended map, as numpy wraps.
// Returns 0, or -1 at a code numpy would raise IndexError for (the caller
// then runs the numpy oracle, which raises it).
EXPORT int dp_take_i32(const int32_t *cmap, int64_t n_map, const int32_t *codes,
                       int64_t n, int32_t *out, int sentinel) {
    for (int64_t i = 0; i < n; ++i) {
        int64_t c = codes[i];
        if (sentinel && c < 0) c += n_map + 1;   // an index into cmap + [-1]
        if (c < 0 || c > n_map || (c == n_map && !sentinel)) return -1;
        out[i] = (c == n_map) ? -1 : cmap[c];
    }
    return 0;
}

// -- serve core: CSR gather / score / top-k ---------------------------------

// Total gathered element count for the in-range segments of ids: pass 1 of
// the two-pass gather.
EXPORT int64_t dp_csr_gather_size(const int64_t *indptr, int64_t n_rows,
                                  const int64_t *ids, int64_t m) {
    int64_t total = 0;
    for (int64_t i = 0; i < m; ++i) {
        int64_t id = ids[i];
        if (id < 0 || id >= n_rows) continue;
        total += indptr[id + 1] - indptr[id];
    }
    return total;
}

// Pass 2: the segments concatenated in id order, elements in storage order
// (models.common.gather_csr_rows' order, so float accumulation downstream
// sees the same addition order).  c1/o1 may be null (unweighted).
// Returns the elements written.
EXPORT int64_t dp_csr_gather(const int64_t *indptr, int64_t n_rows,
                             const int64_t *ids, int64_t m,
                             const int32_t *c0, const float *c1,
                             int32_t *o0, float *o1) {
    int64_t at = 0;
    for (int64_t i = 0; i < m; ++i) {
        int64_t id = ids[i];
        if (id < 0 || id >= n_rows) continue;
        int64_t a = indptr[id], b = indptr[id + 1];
        if (b <= a) continue;
        int64_t len = b - a;
        memcpy(o0 + at, c0 + a, (size_t)len * sizeof(int32_t));
        if (c1 != nullptr) memcpy(o1 + at, c1 + a, (size_t)len * sizeof(float));
        at += len;
    }
    return at;
}

// Ascending unique of int32 values (np.unique's set); out holds n.
// Returns the unique count.
EXPORT int64_t dp_unique_i32(const int32_t *in, int64_t n, int32_t *out) {
    if (n == 0) return 0;
    memcpy(out, in, (size_t)n * sizeof(int32_t));
    std::sort(out, out + n);
    return std::unique(out, out + n) - out;
}

// One event type's score accumulation over the compacted candidate space,
// bit for bit the numpy oracle:
//   rel = np.searchsorted(cand, rows)            (lower_bound)
//   score = np.bincount(rel, weights=w)          (float64, input order)
//           or np.bincount(rel)                  (counts)
//   score = score.astype(np.float32)
//   score *= weight                              (float32) when weight != 1
//   out = score (first) or out += score          (float32 adds)
// scratch is a caller-provided float64[nc] workspace.  -std=c++17 keeps
// -ffp-contract off, so no multiply-add is fused.
EXPORT void dp_score_accum(const int32_t *cand, int64_t nc, const int32_t *rows,
                           int64_t n, const float *w, float weight,
                           double *scratch, float *out, int first) {
    memset(scratch, 0, (size_t)nc * sizeof(double));
    if (w != nullptr) {
        for (int64_t i = 0; i < n; ++i) {
            int64_t rel = std::lower_bound(cand, cand + nc, rows[i]) - cand;
            scratch[rel] += (double)w[i];
        }
    } else {
        for (int64_t i = 0; i < n; ++i) {
            int64_t rel = std::lower_bound(cand, cand + nc, rows[i]) - cand;
            scratch[rel] += 1.0;
        }
    }
    for (int64_t jj = 0; jj < nc; ++jj) {
        float s = (float)scratch[jj];
        if (weight != 1.0f) s = s * weight;
        out[jj] = first ? s : out[jj] + s;
    }
}

// Top-k of a float32 vector in host_topk_desc's total order: the composite
// int64 key (the float's monotone int32 image in the high word, the
// descending index in the low word) makes every key distinct, so (value
// desc, index asc) is exact, -0.0 < +0.0 and ties at the k-th place too.
EXPORT void dp_topk_f32(const float *s, int64_t n, int64_t k, float *out_vals,
                        int32_t *out_idx) {
    if (k > n) k = n;
    if (k <= 0) return;
    std::vector<int64_t> keys((size_t)n);
    for (int64_t i = 0; i < n; ++i) {
        int32_t bits;
        memcpy(&bits, &s[i], 4);
        int32_t m = bits >> 31;
        m &= 0x7FFFFFFF;
        bits ^= m;
        keys[(size_t)i] = ((int64_t)bits << 32) + (0xFFFFFFFFLL - i);
    }
    auto desc = std::greater<int64_t>();
    if (k < n) std::nth_element(keys.begin(), keys.begin() + k, keys.end(), desc);
    std::sort(keys.begin(), keys.begin() + k, desc);
    for (int64_t j = 0; j < k; ++j) {
        int64_t idx = 0xFFFFFFFFLL - (keys[(size_t)j] & 0xFFFFFFFFLL);
        out_idx[j] = (int32_t)idx;
        out_vals[j] = s[idx];
    }
}

// -- HTTP core: request-head parse / response assembly -----------------

namespace {

// Python str.strip()'s whitespace set restricted to latin-1: the exact
// byte values `.decode("latin-1").strip()` removes — parity with the
// oracle parser requires this set, not isspace().
inline bool py_space(unsigned char c) {
    return (c >= 0x09 && c <= 0x0D) || (c >= 0x1C && c <= 0x1F) || c == 0x20 ||
           c == 0x85 || c == 0xA0;
}

inline unsigned char ascii_lower(unsigned char c) {
    return (c >= 'A' && c <= 'Z') ? (unsigned char)(c + 32) : c;
}

// ascii-case-insensitive equality vs a lowercase ascii literal.  A name
// equals "content-length" after Python's latin-1 .lower() iff it equals
// it after ascii-lower (non-ascii letters can never map into ascii).
inline bool name_is(const unsigned char *s, int64_t n, const char *lit) {
    for (int64_t i = 0; i < n; ++i) {
        if (lit[i] == 0 || ascii_lower(s[i]) != (unsigned char)lit[i]) return false;
    }
    return lit[n] == 0;
}

}  // namespace

// Parse one HTTP/1.1 request head (the bytes BEFORE the \r\n\r\n
// terminator, stray leading CRLFs already stripped by the caller).
//
// Returns 0 ok, or the refusal case — numbered to match the Python
// parser's refusals exactly, first-error-wins in the same order:
//   1 malformed request line          (400)
//   2 too many headers                (400)
//   3 obsolete header line folding    (400)
//   4 conflicting Content-Length      (400)
//   5 Transfer-Encoding present       (501)
//   6 bad Content-Length              (400)
//
// out[0] = n_headers
// out[1..6] = cmd_off, cmd_len, path_off, path_len, ver_off, ver_len
// out[7] = content-length state: 0 absent, 1 valid (value in out[8])
// out[8] = content-length value (saturated ~4.6e18)
// spans: 4 int32 per header — name_off, name_len, value_off, value_len
//        (strip bounds applied; name NOT lowercased — the wrapper's
//        latin-1 .lower() matches the oracle exactly)
EXPORT int dp_http_parse(const unsigned char *buf, int64_t len,
                         int64_t max_headers, int64_t *out, int32_t *spans) {
    // split on exact CRLF pairs (bytes.split(b"\r\n") parity)
    // request line: first CRLF (or end)
    int64_t l0_end = len;
    for (int64_t i = 0; i + 1 < len; ++i) {
        if (buf[i] == '\r' && buf[i + 1] == '\n') { l0_end = i; break; }
    }
    // command/path/version: need >= 2 spaces (split(" ", 2) into 3)
    int64_t sp1 = -1, sp2 = -1;
    for (int64_t i = 0; i < l0_end; ++i) {
        if (buf[i] == ' ') {
            if (sp1 < 0) sp1 = i;
            else { sp2 = i; break; }
        }
    }
    if (sp1 < 0 || sp2 < 0) return 1;
    out[1] = 0; out[2] = sp1;
    out[3] = sp1 + 1; out[4] = sp2 - sp1 - 1;
    out[5] = sp2 + 1; out[6] = l0_end - sp2 - 1;

    // count header lines first (the Python parser checks the cap before
    // walking the headers)
    int64_t count = 0;
    for (int64_t i = l0_end; i + 1 < len; ++i) {
        if (buf[i] == '\r' && buf[i + 1] == '\n') { ++count; ++i; }
    }
    if (count > max_headers) return 2;

    int64_t n_headers = 0;
    int64_t cl_off = -1, cl_len = -1;   // last content-length value span
    bool te_seen = false;
    int64_t pos = l0_end + 2;
    if (pos == len) {
        // the request line alone, ended on a CRLF: split() yields a
        // trailing "" line, an empty-name header to the oracle (the JAX
        // copy of this parser returns no header here)
        spans[0] = (int32_t)len;
        spans[1] = 0;
        spans[2] = (int32_t)len;
        spans[3] = 0;
        n_headers = 1;
    }
    while (pos < len) {
        int64_t lend = len;
        for (int64_t i = pos; i + 1 < len; ++i) {
            if (buf[i] == '\r' && buf[i + 1] == '\n') { lend = i; break; }
        }
        int64_t llen = lend - pos;
        if (llen > 0 && (buf[pos] == ' ' || buf[pos] == '\t')) return 3;
        // partition at first ':'
        int64_t colon = lend;
        for (int64_t i = pos; i < lend; ++i) {
            if (buf[i] == ':') { colon = i; break; }
        }
        int64_t ns = pos, ne = colon;
        while (ns < ne && py_space(buf[ns])) ++ns;
        while (ne > ns && py_space(buf[ne - 1])) --ne;
        int64_t vs = colon < lend ? colon + 1 : lend, ve = lend;
        while (vs < ve && py_space(buf[vs])) ++vs;
        while (ve > vs && py_space(buf[ve - 1])) --ve;
        if (name_is(buf + ns, ne - ns, "content-length")) {
            if (cl_off >= 0) {
                // repeated differing Content-Length (bytewise compare of
                // the stripped latin-1 values == the oracle's str compare)
                if (cl_len != ve - vs ||
                    memcmp(buf + cl_off, buf + vs, (size_t)cl_len) != 0)
                    return 4;
            }
            cl_off = vs;
            cl_len = ve - vs;
        } else if (name_is(buf + ns, ne - ns, "transfer-encoding")) {
            te_seen = true;
        }
        spans[n_headers * 4 + 0] = (int32_t)ns;
        spans[n_headers * 4 + 1] = (int32_t)(ne - ns);
        spans[n_headers * 4 + 2] = (int32_t)vs;
        spans[n_headers * 4 + 3] = (int32_t)(ve - vs);
        ++n_headers;
        if (lend >= len) break;
        pos = lend + 2;
        if (pos == len) {
            // head ended exactly on a CRLF: split() yields a trailing ""
            // line, which the oracle records as an empty-name header
            spans[n_headers * 4 + 0] = (int32_t)len;
            spans[n_headers * 4 + 1] = 0;
            spans[n_headers * 4 + 2] = (int32_t)len;
            spans[n_headers * 4 + 3] = 0;
            ++n_headers;
            break;
        }
    }
    out[0] = n_headers;
    if (te_seen) return 5;
    if (cl_off < 0) {
        out[7] = 0;
        out[8] = 0;
    } else {
        if (cl_len <= 0) return 6;
        int64_t v = 0;
        for (int64_t i = 0; i < cl_len; ++i) {
            unsigned char c = buf[cl_off + i];
            if (c < '0' || c > '9') return 6;
            if (v < (int64_t)460000000000000000LL) v = v * 10 + (c - '0');
        }
        out[7] = 1;
        out[8] = v;
    }
    return 0;
}

// Assemble one response into a caller-sized buffer:
//   prefix | "X-Request-ID: " rid "\r\n" (when ridlen) |
//   "Content-Length: <blen>\r\n" | tail | body
// Returns bytes written, or -1 when cap is too small.
EXPORT int64_t dp_http_assemble(const unsigned char *prefix, int64_t plen,
                                const unsigned char *rid, int64_t ridlen,
                                const unsigned char *tail, int64_t tlen,
                                const unsigned char *body, int64_t blen,
                                unsigned char *outbuf, int64_t cap) {
    char clbuf[40];
    int cln = snprintf(clbuf, sizeof(clbuf), "Content-Length: %lld\r\n",
                       (long long)blen);
    int64_t total = plen + (ridlen > 0 ? 14 + ridlen + 2 : 0) + cln + tlen + blen;
    if (total > cap) return -1;
    unsigned char *o = outbuf;
    memcpy(o, prefix, (size_t)plen); o += plen;
    if (ridlen > 0) {
        memcpy(o, "X-Request-ID: ", 14); o += 14;
        memcpy(o, rid, (size_t)ridlen); o += ridlen;
        memcpy(o, "\r\n", 2); o += 2;
    }
    memcpy(o, clbuf, (size_t)cln); o += cln;
    memcpy(o, tail, (size_t)tlen); o += tlen;
    if (blen > 0) memcpy(o, body, (size_t)blen);
    return total;
}
