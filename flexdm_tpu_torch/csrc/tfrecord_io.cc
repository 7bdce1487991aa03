// Native TFRecord scanner + SequenceExample feature extractor (host C++).
//
// The port's own copy of the JAX package's record decoder: the same C
// interface, return codes and CRC-32C check, so it yields the same arrays.
// The port's data layer (flexdm_tpu_torch/data/tfrecord.py + spec.py) has a
// pure-Python fallback; this library is the fast path of its input
// pipeline: it scans TFRecord framing (with optional CRC-32C verification)
// in one pass and decodes the protobuf wire format of SequenceExample
// feature lists directly into caller-provided buffers, avoiding Python
// object churn on the hot decode loop.
//
// Exposed C ABI (consumed via ctypes):
//   flexdm_scan_records(path, offsets, lengths, capacity, verify) -> count
//   flexdm_crc32c(data, len) -> masked crc
//   flexdm_decode_float_feature(payload, len, name, out, max_rows,
//       row_size) -> n_rows/neg — single float feature list
//   flexdm_decode_seq_features(payload, len, names, kinds, num_names, outs,
//       max_rows, row_sizes, rows_out) -> 0/neg — ALL numeric sequence
//       columns in one pass (see make_seq_feature_decoder)
//   flexdm_decode_strings_and_context(...) -> 0/neg — string sequence
//       columns and every context feature in one pass (see
//       make_string_context_decoder)
//
// Build: flexdm_tpu_torch/ops/_build.py (build_host_library) compiles it
// with g++ -O3 -fPIC -std=c++17 -shared at first use.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// CRC-32C (Castagnoli), table-driven, with TFRecord's mask rotation.
// ---------------------------------------------------------------------------

uint32_t g_crc_table[256];
bool g_crc_init = false;

void init_crc_table() {
  if (g_crc_init) return;
  const uint32_t poly = 0x82F63B78u;
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t crc = i;
    for (int j = 0; j < 8; ++j) {
      crc = (crc & 1) ? (crc >> 1) ^ poly : crc >> 1;
    }
    g_crc_table[i] = crc;
  }
  g_crc_init = true;
}

uint32_t crc32c(const uint8_t* data, size_t n) {
  init_crc_table();
  uint32_t crc = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; ++i) {
    crc = (crc >> 8) ^ g_crc_table[(crc ^ data[i]) & 0xFF];
  }
  return crc ^ 0xFFFFFFFFu;
}

uint32_t masked_crc32c(const uint8_t* data, size_t n) {
  uint32_t crc = crc32c(data, n);
  return ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
}

uint32_t read_u32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

uint64_t read_u64(const uint8_t* p) {
  uint64_t v;
  std::memcpy(&v, p, 8);
  return v;
}

// ---------------------------------------------------------------------------
// Protobuf wire-format helpers.
// ---------------------------------------------------------------------------

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
};

bool read_varint(Cursor* c, uint64_t* out) {
  uint64_t result = 0;
  int shift = 0;
  while (c->p < c->end) {
    uint8_t b = *c->p++;
    result |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = result;
      return true;
    }
    shift += 7;
    if (shift > 70) return false;
  }
  return false;
}

bool skip_field(Cursor* c, uint32_t wire) {
  uint64_t tmp;
  switch (wire) {
    case 0:
      return read_varint(c, &tmp);
    case 1:
      if (c->end - c->p < 8) return false;
      c->p += 8;
      return true;
    case 2:
      if (!read_varint(c, &tmp) || c->end - c->p < (int64_t)tmp) return false;
      c->p += tmp;
      return true;
    case 5:
      if (c->end - c->p < 4) return false;
      c->p += 4;
      return true;
    default:
      return false;
  }
}

// Find a length-delimited subfield; returns its body span.
bool find_len_field(Cursor c, uint32_t field, Cursor* out, Cursor* rest) {
  while (c.p < c.end) {
    uint64_t key;
    if (!read_varint(&c, &key)) return false;
    uint32_t f = key >> 3, wire = key & 7;
    if (f == field && wire == 2) {
      uint64_t n;
      if (!read_varint(&c, &n) || c.end - c.p < (int64_t)n) return false;
      out->p = c.p;
      out->end = c.p + n;
      if (rest) {
        rest->p = c.p + n;
        rest->end = c.end;
      }
      return true;
    }
    if (!skip_field(&c, wire)) return false;
  }
  return false;
}

// Accumulate the values of a FloatList body into dst[0..cap).
// FloatList.value = field 1 — packed chunks (possibly several, valid
// proto) and/or unpacked wire-5 entries.  Returns the value count, or -1
// on malformed wire data / overflow.  Shared by the sequence-row and
// context decoders so the subtle varint/bounds logic exists once.
long long parse_float_values(Cursor ic, float* dst, long long cap) {
  long long k = 0;
  while (ic.p < ic.end) {
    uint64_t key;
    if (!read_varint(&ic, &key)) return -1;
    uint32_t f = key >> 3, wire = key & 7;
    if (f == 1 && wire == 2) {  // packed chunk
      uint64_t n;
      if (!read_varint(&ic, &n) || ic.end - ic.p < (int64_t)n) return -1;
      long long vals = (long long)(n / 4);
      if (k + vals > cap) return -1;
      std::memcpy(dst + k, ic.p, vals * 4);
      k += vals;
      ic.p += n;
    } else if (f == 1 && wire == 5) {  // unpacked
      if (ic.end - ic.p < 4 || k >= cap) return -1;
      std::memcpy(dst + k, ic.p, 4);
      ++k;
      ic.p += 4;
    } else if (!skip_field(&ic, wire)) {
      return -1;
    }
  }
  return k;
}

// Same for an Int64List body (packed varints, two's-complement int64).
long long parse_int64_values(Cursor ic, int64_t* dst, long long cap) {
  long long k = 0;
  while (ic.p < ic.end) {
    uint64_t key;
    if (!read_varint(&ic, &key)) return -1;
    uint32_t f = key >> 3, wire = key & 7;
    uint64_t v;
    if (f == 1 && wire == 2) {  // packed
      uint64_t n;
      if (!read_varint(&ic, &n) || ic.end - ic.p < (int64_t)n) return -1;
      Cursor pc{ic.p, ic.p + n};
      ic.p += n;
      while (pc.p < pc.end) {
        if (!read_varint(&pc, &v) || k >= cap) return -1;
        dst[k++] = (int64_t)v;
      }
    } else if (f == 1 && wire == 0) {  // unpacked
      if (!read_varint(&ic, &v) || k >= cap) return -1;
      dst[k++] = (int64_t)v;
    } else if (!skip_field(&ic, wire)) {
      return -1;
    }
  }
  return k;
}

// (offset, length) spans of each BytesList value, relative to `base`
// (zero-copy: callers slice the payload).  Returns count or -1 on
// overflow.
long long parse_bytes_spans(Cursor bl, const uint8_t* base, long long* offs,
                            long long* lens, long long cap) {
  long long k = 0;
  Cursor bc = bl, val, brest;
  while (find_len_field(bc, 1, &val, &brest)) {
    bc = brest;
    if (k >= cap) return -1;
    offs[k] = (long long)(val.p - base);
    lens[k] = (long long)(val.end - val.p);
    ++k;
  }
  return k;
}

// True when the Feature carries a NON-EMPTY typed value list other than
// `want` (BytesList/FloatList/Int64List = fields 1-3).  Empty encodings —
// `tf.train.Feature()` with no list, `value {}`, or an empty list of ANY
// kind (the repo's own encode_feature([]) writes an empty Int64List
// regardless of the column type, example_proto.py:287) — all mean
// "missing optional value" and must decode as zero values to match the
// type-agnostic Python parser; only a non-empty wrong-kind list stays an
// error (corrupt data must not zero-fill silently).
bool has_wrong_nonempty_list(Cursor feature, uint32_t want) {
  Cursor probe;
  for (uint32_t f = 1; f <= 3; ++f) {
    if (f == want) continue;
    if (!find_len_field(feature, f, &probe, nullptr)) continue;
    // Count VALUES, not body bytes: encode_feature([]) emits an Int64List
    // whose body is a present-but-empty packed chunk (`value` field set,
    // zero values).  cap=0 parses return 0 for no values, nonzero (-1)
    // when any value — or malformed wire data — is present.
    long long n;
    if (f == 1) {
      long long off, len;
      n = parse_bytes_spans(probe, probe.p, &off, &len, 0);
    } else if (f == 2) {
      float fbuf[1];
      n = parse_float_values(probe, fbuf, 0);
    } else {
      int64_t ibuf[1];
      n = parse_int64_values(probe, ibuf, 0);
    }
    if (n != 0) return true;
  }
  return false;
}

// Decode the Feature rows of a FeatureList into a fixed-width float buffer.
// Every row must carry exactly row_size values (TF's
// FixedLenSequenceFeature raises on ragged rows; silent zero-fill or
// truncation would feed corrupt data into training) — a malformed row r
// returns -(r+1).
long long decode_float_rows(Cursor flist, float* out, long long max_rows,
                            long long row_size) {
  long long row = 0;
  Cursor fc = flist;
  while (fc.p < fc.end && row < max_rows) {
    Cursor feature, frest;
    if (!find_len_field(fc, 1, &feature, &frest)) break;
    fc = frest;
    // Feature.float_list = field 2.
    Cursor float_list;
    if (!find_len_field(feature, 2, &float_list, nullptr)) {
      return -(row + 1);  // wrong-typed or empty row
    }
    if (parse_float_values(float_list, out + row * row_size, row_size) !=
        row_size) {
      return -(row + 1);  // ragged or malformed row
    }
    ++row;
  }
  return row;
}

// Same for Int64List rows.
long long decode_int64_rows(Cursor flist, int64_t* out, long long max_rows,
                            long long row_size) {
  long long row = 0;
  Cursor fc = flist;
  while (fc.p < fc.end && row < max_rows) {
    Cursor feature, frest;
    if (!find_len_field(fc, 1, &feature, &frest)) break;
    fc = frest;
    // Feature.int64_list = field 3.
    Cursor int_list;
    if (!find_len_field(feature, 3, &int_list, nullptr)) {
      return -(row + 1);  // wrong-typed or empty row
    }
    if (parse_int64_values(int_list, out + row * row_size, row_size) !=
        row_size) {
      return -(row + 1);  // ragged or malformed row
    }
    ++row;
  }
  return row;
}

}  // namespace

extern "C" {

// Scan a TFRecord file; fill offsets/lengths of each payload.
// Returns record count, or a negative error code.
long long flexdm_scan_records(const char* path, long long* offsets,
                              long long* lengths, long long capacity,
                              int verify_crc) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  std::fseek(f, 0, SEEK_END);
  long long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> blob(size);
  if (std::fread(blob.data(), 1, size, f) != (size_t)size) {
    std::fclose(f);
    return -2;
  }
  std::fclose(f);

  long long pos = 0;
  long long count = 0;
  while (pos < size) {
    if (size - pos < 12) return -3;
    uint64_t length = read_u64(blob.data() + pos);
    if (verify_crc) {
      uint32_t expect = read_u32(blob.data() + pos + 8);
      if (masked_crc32c(blob.data() + pos, 8) != expect) return -4;
    }
    pos += 12;
    if (size - pos < (long long)length + 4) return -5;
    if (verify_crc) {
      uint32_t expect = read_u32(blob.data() + pos + length);
      if (masked_crc32c(blob.data() + pos, length) != expect) return -6;
    }
    if (count >= capacity) return -7;
    offsets[count] = pos;
    lengths[count] = (long long)length;
    ++count;
    pos += (long long)length + 4;
  }
  return count;
}

unsigned int flexdm_crc32c(const unsigned char* data, long long n) {
  return masked_crc32c(data, (size_t)n);
}

// Decode the float rows of one named feature list from a serialized
// SequenceExample.  Writes up to `max_rows * row_size` floats into `out`
// (row-major, rows of exactly `row_size`).  Returns the number of rows
// written, or a negative error code.
long long flexdm_decode_float_feature(const unsigned char* payload,
                                      long long payload_len, const char* name,
                                      float* out, long long max_rows,
                                      long long row_size) {
  Cursor se{payload, payload + payload_len};
  Cursor feature_lists;
  if (!find_len_field(se, 2, &feature_lists, nullptr)) return 0;

  size_t name_len = std::strlen(name);
  // Iterate map entries: FeatureLists.feature_list (field 1).
  Cursor c = feature_lists;
  while (c.p < c.end) {
    Cursor entry, rest;
    if (!find_len_field(c, 1, &entry, &rest)) break;
    c = rest;
    Cursor key;
    if (!find_len_field(entry, 1, &key, nullptr)) continue;
    if ((size_t)(key.end - key.p) != name_len ||
        std::memcmp(key.p, name, name_len) != 0)
      continue;
    Cursor flist;
    if (!find_len_field(entry, 2, &flist, nullptr)) return 0;

    return decode_float_rows(flist, out, max_rows, row_size);
  }
  return 0;
}

// Decode EVERY requested numeric sequence feature-list from one serialized
// SequenceExample in a single pass (extends the float-only fast path to
// int64 and narrow columns — the whole schema short of demo-only strings).
// kinds[i]: 1 = float32 buffer, 2 = int64 buffer.  rows_out[i] receives the
// row count written (0 when the key is absent), or -(row+1) when row `row`
// is ragged or wrong-typed.  Returns 0 on success.
long long flexdm_decode_seq_features(
    const unsigned char* payload, long long payload_len,
    const char* const* names, const unsigned char* kinds, long long num_names,
    void* const* outs, const long long* max_rows, const long long* row_sizes,
    long long* rows_out) {
  for (long long i = 0; i < num_names; ++i) rows_out[i] = 0;
  Cursor se{payload, payload + payload_len};
  Cursor feature_lists;
  if (!find_len_field(se, 2, &feature_lists, nullptr)) return 0;

  std::vector<size_t> name_lens(num_names);
  for (long long i = 0; i < num_names; ++i)
    name_lens[i] = std::strlen(names[i]);

  Cursor c = feature_lists;
  while (c.p < c.end) {
    Cursor entry, rest;
    if (!find_len_field(c, 1, &entry, &rest)) break;
    c = rest;
    Cursor key;
    if (!find_len_field(entry, 1, &key, nullptr)) continue;
    size_t klen = (size_t)(key.end - key.p);
    for (long long i = 0; i < num_names; ++i) {
      if (klen != name_lens[i] ||
          std::memcmp(key.p, names[i], klen) != 0)
        continue;
      Cursor flist;
      if (!find_len_field(entry, 2, &flist, nullptr)) break;
      if (kinds[i] == 1) {
        rows_out[i] = decode_float_rows(
            flist, (float*)outs[i], max_rows[i], row_sizes[i]);
      } else if (kinds[i] == 2) {
        rows_out[i] = decode_int64_rows(
            flist, (int64_t*)outs[i], max_rows[i], row_sizes[i]);
      }
      break;
    }
  }
  return 0;
}

// Decode every requested STRING sequence feature-list and ALL context
// features in one pass — the rest of the record once
// flexdm_decode_seq_features has taken the numeric columns, so a full
// decode never touches the Python proto parser.
//
// Sequence names: each row must hold exactly ONE bytes value; outputs are
// (offset, length) pairs into the payload, (num_seq, max_rows) flattened;
// seq_rows[i] receives the row count (0 when absent).
//
// Context names: kinds[j] 1 = float (ctx_floats), 2 = int64 (ctx_ints),
// 3 = bytes (ctx_offs/ctx_lens as payload spans); each feature may carry
// up to ctx_cap values, buffers are (num_ctx, ctx_cap) flattened and
// ctx_counts[j] receives the value count (0 when absent).
//
// Returns 0 on success, -(i+1) for a malformed sequence item i, or
// -(num_seq+j+1) for a malformed/overflowing context item j.
long long flexdm_decode_strings_and_context(
    const unsigned char* payload, long long payload_len,
    const char* const* seq_names, long long num_seq, long long max_rows,
    long long* seq_rows, long long* seq_offs, long long* seq_lens,
    const char* const* ctx_names, const unsigned char* ctx_kinds,
    long long num_ctx, long long ctx_cap, long long* ctx_counts,
    long long* ctx_ints, float* ctx_floats, long long* ctx_offs,
    long long* ctx_lens) {
  for (long long i = 0; i < num_seq; ++i) seq_rows[i] = 0;
  for (long long j = 0; j < num_ctx; ++j) ctx_counts[j] = 0;
  const uint8_t* base = payload;
  Cursor se{payload, payload + payload_len};

  std::vector<size_t> seq_name_lens(num_seq), ctx_name_lens(num_ctx);
  for (long long i = 0; i < num_seq; ++i)
    seq_name_lens[i] = std::strlen(seq_names[i]);
  for (long long j = 0; j < num_ctx; ++j)
    ctx_name_lens[j] = std::strlen(ctx_names[j]);

  // --- context: SequenceExample.context = field 1 (Features map) ---------
  Cursor context;
  if (num_ctx > 0 && find_len_field(se, 1, &context, nullptr)) {
    Cursor c = context;
    while (c.p < c.end) {
      Cursor entry, rest;
      if (!find_len_field(c, 1, &entry, &rest)) break;
      c = rest;
      Cursor key;
      if (!find_len_field(entry, 1, &key, nullptr)) continue;
      size_t klen = (size_t)(key.end - key.p);
      for (long long j = 0; j < num_ctx; ++j) {
        if (klen != ctx_name_lens[j] ||
            std::memcmp(key.p, ctx_names[j], klen) != 0)
          continue;
        // An omitted map-entry value field (the canonical wire form of an
        // empty Feature) = missing optional value -> zero values, like the
        // Python parser (_parse_map_entry defaults the value to b"").
        Cursor feature;
        if (!find_len_field(entry, 2, &feature, nullptr)) break;
        // Field numbers: Feature.bytes_list=1, float_list=2, int64_list=3.
        uint32_t want = ctx_kinds[j] == 1 ? 2u : ctx_kinds[j] == 2 ? 3u : 1u;
        Cursor list;
        long long k;
        if (!find_len_field(feature, want, &list, nullptr)) {
          if (has_wrong_nonempty_list(feature, want))
            return -(num_seq + j + 1);
          // Empty Feature (no list, or an empty wrong-kind list): missing
          // optional value — the Python parser yields [] here, so decode
          // as zero values.
          break;
        }
        if (ctx_kinds[j] == 1) {
          k = parse_float_values(list, ctx_floats + j * ctx_cap, ctx_cap);
        } else if (ctx_kinds[j] == 2) {
          k = parse_int64_values(
              list, reinterpret_cast<int64_t*>(ctx_ints) + j * ctx_cap,
              ctx_cap);
        } else {
          k = parse_bytes_spans(list, base, ctx_offs + j * ctx_cap,
                                ctx_lens + j * ctx_cap, ctx_cap);
        }
        if (k < 0) return -(num_seq + j + 1);
        ctx_counts[j] = k;
        break;
      }
    }
  }

  // --- sequence strings: feature_lists = field 2 --------------------------
  Cursor feature_lists;
  if (num_seq > 0 && find_len_field(se, 2, &feature_lists, nullptr)) {
    Cursor c = feature_lists;
    while (c.p < c.end) {
      Cursor entry, rest;
      if (!find_len_field(c, 1, &entry, &rest)) break;
      c = rest;
      Cursor key;
      if (!find_len_field(entry, 1, &key, nullptr)) continue;
      size_t klen = (size_t)(key.end - key.p);
      for (long long i = 0; i < num_seq; ++i) {
        if (klen != seq_name_lens[i] ||
            std::memcmp(key.p, seq_names[i], klen) != 0)
          continue;
        // Omitted value field = empty FeatureList -> 0 rows, matching
        // both the Python parser and flexdm_decode_seq_features.
        Cursor flist;
        if (!find_len_field(entry, 2, &flist, nullptr)) break;
        long long row = 0;
        Cursor fc = flist;
        while (fc.p < fc.end && row < max_rows) {
          Cursor feature, frest;
          if (!find_len_field(fc, 1, &feature, &frest)) break;
          fc = frest;
          Cursor bl;
          if (!find_len_field(feature, 1, &bl, nullptr)) return -(i + 1);
          Cursor val, brest;
          if (!find_len_field(bl, 1, &val, &brest)) return -(i + 1);
          // exactly one value per row
          Cursor extra;
          if (find_len_field(brest, 1, &extra, nullptr)) return -(i + 1);
          seq_offs[i * max_rows + row] = (long long)(val.p - base);
          seq_lens[i * max_rows + row] = (long long)(val.end - val.p);
          ++row;
        }
        seq_rows[i] = row;
        break;
      }
    }
  }
  return 0;
}

}  // extern "C"
