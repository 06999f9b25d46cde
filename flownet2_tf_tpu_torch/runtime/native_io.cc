// Native IO runtime of flownet2_tf_tpu_torch: the host side of the input
// pipeline in C++.
//
// A copy of flownet2_tf_tpu/runtime/native_io.cc (the port builds its own
// library from this file and loads nothing of the JAX package). It owns
// the host-side hot loop of the input pipeline: TFRecord framing + CRC32C
// verification, tf.train.Example wire-format parsing (fixed
// image_a/image_b/flow BytesList schema), Middlebury .flo and binary PPM
// decoding, and multithreaded batch assembly into caller-provided buffers.
// Python binds it with ctypes (runtime/native.py); every entry point has a
// pure-Python counterpart with the same results (data/tfrecord.py,
// utils/flowlib.py, data/loader.py), held bitwise by the tests. One change
// from the original: the uint8 -> [0,1] float conversion divides by 255
// (the pure path's `astype(float32) / 255.0`) where the original
// multiplied by 1/255, which differs in the last bit for 126 of the 256
// values.
//
// Build: runtime/native.py runs
//   g++ -O3 -std=c++17 -fPIC -shared -pthread native_io.cc -o libflownet_io.so

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// CRC32C (Castagnoli, software table)
// ---------------------------------------------------------------------------

static uint32_t g_crc_table[256];
static std::atomic<bool> g_crc_ready{false};

static void crc_init() {
  bool expected = false;
  static std::atomic<bool> building{false};
  if (g_crc_ready.load(std::memory_order_acquire)) return;
  if (building.compare_exchange_strong(expected, true)) {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t crc = i;
      for (int k = 0; k < 8; ++k)
        crc = (crc & 1) ? (crc >> 1) ^ 0x82F63B78u : crc >> 1;
      g_crc_table[i] = crc;
    }
    g_crc_ready.store(true, std::memory_order_release);
  } else {
    while (!g_crc_ready.load(std::memory_order_acquire)) {}
  }
}

// Hardware path: x86 SSE4.2 crc32 computes exactly the Castagnoli
// polynomial TFRecords use, ~8 B/cycle against ~1 B per 3 cycles for the
// byte table (the table loop remains for hosts without SSE4.2).
#if defined(__x86_64__) || defined(__i386__)
#include <nmmintrin.h>
__attribute__((target("sse4.2")))
static uint32_t crc32c_hw(uint32_t crc, const uint8_t* data, int64_t len) {
  const uint8_t* p = data;
  while (len >= 8) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    crc = (uint32_t)_mm_crc32_u64(crc, v);
    p += 8;
    len -= 8;
  }
  while (len-- > 0) crc = _mm_crc32_u8(crc, *p++);
  return crc;
}
static bool have_sse42() {
  static const bool ok = __builtin_cpu_supports("sse4.2");
  return ok;
}
#else
static uint32_t crc32c_hw(uint32_t, const uint8_t*, int64_t) { return 0; }
static bool have_sse42() { return false; }
#endif

uint32_t fnio_crc32c(const uint8_t* data, int64_t len) {
  uint32_t crc = 0xFFFFFFFFu;
  if (have_sse42()) return crc32c_hw(crc, data, len) ^ 0xFFFFFFFFu;
  crc_init();
  for (int64_t i = 0; i < len; ++i)
    crc = g_crc_table[(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
  return crc ^ 0xFFFFFFFFu;
}

static uint32_t masked_crc(const uint8_t* data, int64_t len) {
  uint32_t crc = fnio_crc32c(data, len);
  return ((crc >> 15) | (crc << 17)) + 0xA282EAD8u;
}

// ---------------------------------------------------------------------------
// TFRecord index
// ---------------------------------------------------------------------------

struct TfRecordIndex {
  std::string path;
  std::vector<int64_t> offsets;  // payload offsets
  std::vector<int64_t> sizes;    // payload sizes
};

void* fnio_tfrecord_open(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  auto* idx = new TfRecordIndex();
  idx->path = path;
  int64_t pos = 0;
  uint8_t header[12];
  while (std::fread(header, 1, 12, f) == 12) {
    uint64_t length;
    std::memcpy(&length, header, 8);
    uint32_t len_crc;
    std::memcpy(&len_crc, header + 8, 4);
    if (masked_crc(header, 8) != len_crc) {
      std::fclose(f);
      delete idx;
      return nullptr;  // corrupt framing
    }
    idx->offsets.push_back(pos + 12);
    idx->sizes.push_back((int64_t)length);
    pos += 12 + (int64_t)length + 4;
    if (std::fseek(f, pos, SEEK_SET) != 0) break;
  }
  std::fclose(f);
  return idx;
}

int64_t fnio_tfrecord_count(void* handle) {
  return handle ? (int64_t)((TfRecordIndex*)handle)->offsets.size() : -1;
}

int64_t fnio_tfrecord_size(void* handle, int64_t i) {
  auto* idx = (TfRecordIndex*)handle;
  if (!idx || i < 0 || i >= (int64_t)idx->sizes.size()) return -1;
  return idx->sizes[i];
}

// Read raw payload i from an already-open stream and verify the
// record's masked payload CRC32C (guards against torn/corrupt files
// that passed the length-CRC check at open time).
static int tfrecord_read_f(TfRecordIndex* idx, FILE* f, int64_t i,
                           uint8_t* buf) {
  if (!idx || i < 0 || i >= (int64_t)idx->offsets.size()) return -1;
  uint32_t stored_crc = 0;
  if (std::fseek(f, idx->offsets[i], SEEK_SET) != 0 ||
      std::fread(buf, 1, (size_t)idx->sizes[i], f) != (size_t)idx->sizes[i] ||
      std::fread(&stored_crc, 4, 1, f) != 1)
    return -3;
  if (masked_crc(buf, idx->sizes[i]) != stored_crc)
    return -4;  // payload corruption
  return 0;
}

int fnio_tfrecord_read(void* handle, int64_t i, uint8_t* buf) {
  auto* idx = (TfRecordIndex*)handle;
  if (!idx || i < 0 || i >= (int64_t)idx->offsets.size()) return -1;
  FILE* f = std::fopen(idx->path.c_str(), "rb");
  if (!f) return -2;
  int rc = tfrecord_read_f(idx, f, i, buf);
  std::fclose(f);
  return rc;
}

void fnio_tfrecord_close(void* handle) {
  delete (TfRecordIndex*)handle;
}

// ---------------------------------------------------------------------------
// Protobuf wire parsing (tf.train.Example, BytesList features only)
// ---------------------------------------------------------------------------

struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
};

static bool read_varint(Cursor* c, uint64_t* out) {
  uint64_t result = 0;
  int shift = 0;
  while (c->p < c->end && shift < 64) {
    uint8_t b = *c->p++;
    result |= (uint64_t)(b & 0x7F) << shift;
    if (!(b & 0x80)) {
      *out = result;
      return true;
    }
    shift += 7;
  }
  return false;
}

// Find a length-delimited subfield; returns span in *out/*out_len.
static bool find_field(const uint8_t* buf, int64_t len, uint32_t want_field,
                       const uint8_t** out, int64_t* out_len,
                       const uint8_t* resume_from = nullptr) {
  Cursor c{resume_from ? resume_from : buf, buf + len};
  while (c.p < c.end) {
    uint64_t tag;
    if (!read_varint(&c, &tag)) return false;
    uint32_t field = (uint32_t)(tag >> 3);
    uint32_t wire = (uint32_t)(tag & 7);
    if (wire == 2) {
      uint64_t flen;
      // compare against the remaining span, not c.p + flen (a huge flen
      // would overflow the pointer arithmetic — UB — before the check)
      if (!read_varint(&c, &flen) || flen > (uint64_t)(c.end - c.p))
        return false;
      if (field == want_field) {
        *out = c.p;
        *out_len = (int64_t)flen;
        return true;
      }
      c.p += flen;
    } else if (wire == 0) {
      uint64_t v;
      if (!read_varint(&c, &v)) return false;
    } else if (wire == 5) {
      if (c.end - c.p < 4) return false;
      c.p += 4;
    } else if (wire == 1) {
      if (c.end - c.p < 8) return false;
      c.p += 8;
    } else {
      return false;
    }
  }
  return false;
}

// Extract the raw bytes of named BytesList features from a serialized
// Example. names: concatenated NUL-separated feature names. For each,
// returns the offset (into payload) and size, or -1 if missing.
int fnio_parse_example(const uint8_t* payload, int64_t len,
                       const char* names_blob, int n_names,
                       int64_t* out_offsets, int64_t* out_sizes) {
  const uint8_t* features;
  int64_t features_len;
  if (!find_field(payload, len, 1, &features, &features_len)) return -1;

  std::vector<std::string> names;
  const char* np = names_blob;
  for (int i = 0; i < n_names; ++i) {
    names.emplace_back(np);
    np += names[i].size() + 1;
    out_offsets[i] = -1;
    out_sizes[i] = -1;
  }

  // iterate map entries: Features.feature = 1 (repeated)
  Cursor c{features, features + features_len};
  while (c.p < c.end) {
    uint64_t tag;
    if (!read_varint(&c, &tag)) break;
    if ((tag & 7) != 2) return -2;
    uint64_t flen;
    if (!read_varint(&c, &flen) || flen > (uint64_t)(c.end - c.p)) return -2;
    const uint8_t* entry = c.p;
    int64_t entry_len = (int64_t)flen;
    c.p += flen;
    if ((tag >> 3) != 1) continue;

    const uint8_t *key, *feat;
    int64_t key_len, feat_len;
    if (!find_field(entry, entry_len, 1, &key, &key_len)) continue;
    if (!find_field(entry, entry_len, 2, &feat, &feat_len)) continue;
    // Feature.bytes_list = 1; BytesList.value = 1
    const uint8_t *blist, *value;
    int64_t blist_len, value_len;
    if (!find_field(feat, feat_len, 1, &blist, &blist_len)) continue;
    if (!find_field(blist, blist_len, 1, &value, &value_len)) continue;

    for (int i = 0; i < n_names; ++i) {
      if ((int64_t)names[i].size() == key_len &&
          std::memcmp(names[i].data(), key, key_len) == 0) {
        out_offsets[i] = value - payload;
        out_sizes[i] = value_len;
      }
    }
  }
  for (int i = 0; i < n_names; ++i)
    if (out_offsets[i] < 0) return 1;  // some feature missing
  return 0;
}

// ---------------------------------------------------------------------------
// .flo and PPM decoding
// ---------------------------------------------------------------------------

// Returns 0 on success; fills *w, *h. data==nullptr -> dims only.
int fnio_read_flo(const char* path, float* data, int32_t* w, int32_t* h,
                  int64_t capacity_floats) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  float magic;
  int32_t width, height;
  if (std::fread(&magic, 4, 1, f) != 1 || magic != 202021.25f ||
      std::fread(&width, 4, 1, f) != 1 ||
      std::fread(&height, 4, 1, f) != 1 || width <= 0 || height <= 0 ||
      width > 100000 || height > 100000) {
    std::fclose(f);
    return -2;
  }
  *w = width;
  *h = height;
  int rc = 0;
  if (data) {
    int64_t count = (int64_t)width * height * 2;
    if (count > capacity_floats) {
      rc = -3;
    } else if (std::fread(data, 4, (size_t)count, f) != (size_t)count) {
      rc = -4;
    }
  }
  std::fclose(f);
  return rc;
}

int fnio_write_flo(const char* path, const float* data, int32_t w,
                   int32_t h) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  float magic = 202021.25f;
  int rc = 0;
  if (std::fwrite(&magic, 4, 1, f) != 1 || std::fwrite(&w, 4, 1, f) != 1 ||
      std::fwrite(&h, 4, 1, f) != 1 ||
      std::fwrite(data, 4, (size_t)w * h * 2, f) != (size_t)w * h * 2)
    rc = -2;
  std::fclose(f);
  return rc;
}

// Binary P6 PPM (maxval <= 255). data==nullptr -> dims only.
int fnio_read_ppm(const char* path, uint8_t* data, int32_t* w, int32_t* h,
                  int64_t capacity_bytes) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  char magic[3] = {0};
  if (std::fread(magic, 1, 2, f) != 2 || magic[0] != 'P' || magic[1] != '6') {
    std::fclose(f);
    return -2;
  }
  int fields[3];
  int nf = 0;
  while (nf < 3) {
    int ch = std::fgetc(f);
    if (ch == EOF) { std::fclose(f); return -3; }
    if (std::isspace(ch)) continue;
    if (ch == '#') {  // comment to end of line
      while (ch != '\n' && ch != EOF) ch = std::fgetc(f);
      continue;
    }
    int value = 0;
    while (ch != EOF && !std::isspace(ch)) {
      if (ch < '0' || ch > '9') { std::fclose(f); return -3; }
      value = value * 10 + (ch - '0');
      // bound like fnio_read_flo: rejects overflow-length digit runs
      if (value > 100000) { std::fclose(f); return -3; }
      ch = std::fgetc(f);
    }
    fields[nf++] = value;
  }
  if (fields[0] <= 0 || fields[1] <= 0) { std::fclose(f); return -3; }
  if (fields[2] > 255) { std::fclose(f); return -5; }
  *w = fields[0];
  *h = fields[1];
  int rc = 0;
  if (data) {
    int64_t count = (int64_t)fields[0] * fields[1] * 3;
    if (count > capacity_bytes) rc = -6;
    else if (std::fread(data, 1, (size_t)count, f) != (size_t)count) rc = -7;
  }
  std::fclose(f);
  return rc;
}

// ---------------------------------------------------------------------------
// Multithreaded batch assembly
// ---------------------------------------------------------------------------

// Shared engine for the two batch decoders (fixed schema: uint8
// image_a/image_b HxWx3 and float flow HxWx2). The TFRecord read,
// Example parse, size validation, and worker pool are identical; only
// the image emit differs (u8 -> [0,1] float convert vs straight
// memcpy). Returns 0, or the FIRST nonzero item status (recorded via
// compare-exchange — concurrent failures don't overwrite each other).
static int decode_batch_impl(void* handle, const int64_t* indices, int n,
                             int32_t height, int32_t width, void* image_a,
                             void* image_b, float* flow, int n_threads,
                             bool to_float) {
  auto* idx = (TfRecordIndex*)handle;
  if (!idx) return -1;
  const int64_t img_px = (int64_t)height * width * 3;
  const int64_t flo_px = (int64_t)height * width * 2;
  std::atomic<int> next{0};
  std::atomic<int> status{0};
  auto set_status = [&](int s) {
    int expected = 0;
    status.compare_exchange_strong(expected, s);
  };

  auto worker = [&]() {
    std::vector<uint8_t> payload;
    const char names[] = "image_a\0image_b\0flow";  // NUL-separated
    FILE* f = std::fopen(idx->path.c_str(), "rb");  // one open per worker
    if (!f) { set_status(-3); return; }
    while (true) {
      int i = next.fetch_add(1);
      if (i >= n) break;
      int64_t rec = indices[i];
      int64_t size = fnio_tfrecord_size(idx, rec);
      if (size < 0) { set_status(-2); break; }
      payload.resize((size_t)size);
      if (tfrecord_read_f(idx, f, rec, payload.data()) != 0) {
        set_status(-3);
        break;
      }
      int64_t offs[3], sizes[3];
      if (fnio_parse_example(payload.data(), size, names, 3, offs, sizes) !=
          0) {
        set_status(-4);
        break;
      }
      if (sizes[0] != img_px || sizes[1] != img_px ||
          sizes[2] != flo_px * 4) {
        set_status(-5);
        break;
      }
      const uint8_t* a8 = payload.data() + offs[0];
      const uint8_t* b8 = payload.data() + offs[1];
      if (to_float) {
        float* a_out = (float*)image_a + (int64_t)i * img_px;
        float* b_out = (float*)image_b + (int64_t)i * img_px;
        for (int64_t k = 0; k < img_px; ++k) a_out[k] = a8[k] / 255.0f;
        for (int64_t k = 0; k < img_px; ++k) b_out[k] = b8[k] / 255.0f;
      } else {
        std::memcpy((uint8_t*)image_a + (int64_t)i * img_px, a8,
                    (size_t)img_px);
        std::memcpy((uint8_t*)image_b + (int64_t)i * img_px, b8,
                    (size_t)img_px);
      }
      std::memcpy(flow + (int64_t)i * flo_px, payload.data() + offs[2],
                  (size_t)flo_px * 4);
    }
    std::fclose(f);
  };

  int workers = n_threads > 0 ? n_threads : 1;
  if (workers > n) workers = n;
  std::vector<std::thread> threads;
  threads.reserve(workers);
  for (int t = 0; t < workers; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return status.load();
}

// Decode a batch into [0,1] float image buffers.
int fnio_decode_batch(void* handle, const int64_t* indices, int n,
                      int32_t height, int32_t width, float* image_a,
                      float* image_b, float* flow, int n_threads) {
  return decode_batch_impl(handle, indices, n, height, width, image_a,
                           image_b, flow, n_threads, /*to_float=*/true);
}

// Raw-uint8 variant: images stay uint8 (straight memcpy out of the
// parsed Example), flow stays float. The trainer converts the images to
// [0,1] floats on the device (training/loop.py::_images_to_float), and a
// uint8 batch is a quarter of the image bytes over the host->device link.
int fnio_decode_batch_u8(void* handle, const int64_t* indices, int n,
                         int32_t height, int32_t width, uint8_t* image_a,
                         uint8_t* image_b, float* flow, int n_threads) {
  return decode_batch_impl(handle, indices, n, height, width, image_a,
                           image_b, flow, n_threads, /*to_float=*/false);
}

}  // extern "C"
