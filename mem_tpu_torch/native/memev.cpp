// libmemev: native event-camera IO runtime.
//
// The framework's host-side hot path is (1) decoding raw AER recordings and
// (2) assembling padded event batches from .npy files for device transfer.
// Both are implemented here in C++ with a thread pool, exposed through a
// plain C ABI consumed via ctypes (mem_tpu_torch/native/__init__.py; the
// port's own copy of mem_tpu/native/memev.cpp). The numpy
// implementations remain as the semantic reference; tests assert bit
// equality.
//
// Formats (reference: process_data/process_dataset.py:24-105):
//   ATIS (N-Caltech101): 5 bytes/event — y, x, [p:1|t:7], t, t (t big-endian
//     23-bit); output rows [y, x, t, 2p-1] float64.
//   N-Cars .dat: '%'-prefixed ASCII header lines + 2 bytes, then 8-byte
//     records: u32le t, u32le packed (y:0-13, x:14-27, p:28); output rows
//     [y, x, t, p] float64 with p in {0,1}.
//   .npy: little-endian '<f8'/'<f4' C-order (N, 4) arrays (the files this
//     framework's own decoder writes).

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
// decoders
// ---------------------------------------------------------------------------

// Returns number of events decoded; out must hold (len/5)*4 doubles.
int64_t memev_decode_atis(const uint8_t* buf, int64_t len, double* out) {
  const int64_t n = len / 5;
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* e = buf + i * 5;
    const uint32_t t = (uint32_t(e[2] & 0x7F) << 16) | (uint32_t(e[3]) << 8) |
                       uint32_t(e[4]);
    const int p = (e[2] >> 7) & 1;
    out[i * 4 + 0] = double(e[0]);            // y
    out[i * 4 + 1] = double(e[1]);            // x
    out[i * 4 + 2] = double(t);
    out[i * 4 + 3] = 2.0 * p - 1.0;
  }
  return n;
}

// Returns number of events (or -1 on malformed header); out sized (len/8)*4.
int64_t memev_decode_ncars(const uint8_t* buf, int64_t len, double* out) {
  int64_t off = 0;
  while (off < len && buf[off] == '%') {       // header lines (readline <=256)
    int64_t j = off;
    const int64_t cap = off + 256 < len ? off + 256 : len;
    while (j < cap && buf[j] != '\n') ++j;
    off = (j < cap) ? j + 1 : cap;
  }
  off += 2;                                    // 2 skip bytes
  if (off > len) return -1;
  const int64_t n = (len - off) / 8;
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* e = buf + off + i * 8;
    uint32_t t, d;
    std::memcpy(&t, e, 4);
    std::memcpy(&d, e + 4, 4);
    out[i * 4 + 0] = double(d & 0x3FFF);             // y
    out[i * 4 + 1] = double((d >> 14) & 0x3FFF);     // x
    out[i * 4 + 2] = double(t);
    out[i * 4 + 3] = double((d >> 28) & 1);          // p in {0,1}
  }
  return n;
}

// ---------------------------------------------------------------------------
// minimal .npy reader for little-endian C-order (N, 4) float32/float64
// ---------------------------------------------------------------------------

namespace {

struct NpyInfo {
  int64_t rows = -1;
  int itemsize = 0;     // 4 or 8
  int64_t data_off = 0;
};

// Saturating casts for values sourced from UNTRUSTED file bytes: a corrupt
// payload may carry arbitrary floats, and C++ float->int conversion of an
// out-of-range value is undefined behavior (the python paths go through
// numpy casts instead and never feed these back into indexing).
inline int32_t sat_i32(float v) {
  if (!(v >= -2147483648.0f)) return INT32_MIN;      // also catches NaN
  if (v >= 2147483647.0f) return INT32_MAX;
  return int32_t(v);
}
inline int16_t sat_i16(float v) {
  if (!(v >= -32768.0f)) return INT16_MIN;           // also catches NaN
  if (v >= 32767.0f) return INT16_MAX;
  return int16_t(v);
}

bool parse_npy_header(const uint8_t* buf, int64_t len, NpyInfo* info) {
  if (len < 10 || std::memcmp(buf, "\x93NUMPY", 6) != 0) return false;
  const int major = buf[6];
  int64_t hlen, hoff;
  if (major == 1) {
    uint16_t h;
    std::memcpy(&h, buf + 8, 2);
    hlen = h;
    hoff = 10;
  } else {
    if (len < 12) return false;  // v2+ header length is 4 bytes
    uint32_t h;
    std::memcpy(&h, buf + 8, 4);
    hlen = h;
    hoff = 12;
  }
  if (hoff + hlen > len) return false;
  std::string hdr(reinterpret_cast<const char*>(buf + hoff), size_t(hlen));
  if (hdr.find("'fortran_order': True") != std::string::npos) return false;
  if (hdr.find("<f8") != std::string::npos) info->itemsize = 8;
  else if (hdr.find("<f4") != std::string::npos) info->itemsize = 4;
  else return false;
  auto sp = hdr.find("'shape':");
  if (sp == std::string::npos) return false;
  auto lp = hdr.find('(', sp);
  if (lp == std::string::npos) return false;
  long long rows = -1, cols = -1;
  if (std::sscanf(hdr.c_str() + lp, "(%lld, %lld)", &rows, &cols) != 2)
    return false;
  if (cols != 4) return false;
  // The header's claimed row count must fit in the actual payload bytes —
  // a truncated or corrupt file must fail the parse, not read past the
  // buffer (division form avoids rows*itemsize overflow for absurd claims).
  if (rows < 0 || rows > (len - hoff - hlen) / (4 * info->itemsize))
    return false;
  info->rows = rows;
  info->data_off = hoff + hlen;
  return true;
}

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  const long sz = std::ftell(f);
  if (sz < 0) {
    std::fclose(f);
    return false;
  }
  std::fseek(f, 0, SEEK_SET);
  out->resize(size_t(sz));
  const bool ok = std::fread(out->data(), 1, size_t(sz), f) == size_t(sz);
  std::fclose(f);
  return ok;
}

}  // namespace

// ---------------------------------------------------------------------------
// minimal ZIP_STORED .npz column reader (N-ImageNet x/y/t/p samples)
// ---------------------------------------------------------------------------

namespace {

// dtype codes for 1-D npy columns
enum ColCode {
  kU1 = 1, kI1, kU2, kI2, kU4, kI4, kU8, kI8, kF4, kF8
};

struct NpzCol {
  int64_t off = -1;   // payload offset in the file
  int code = 0;
  int64_t n = 0;
};

int col_itemsize(int code);

int dtype_code_from_header(const std::string& hdr) {
  struct { const char* pat; int code; } table[] = {
      {"'|u1'", kU1}, {"'|i1'", kI1}, {"'<u2'", kU2}, {"'<i2'", kI2},
      {"'<u4'", kU4}, {"'<i4'", kI4}, {"'<u8'", kU8}, {"'<i8'", kI8},
      {"'<f4'", kF4}, {"'<f8'", kF8}, {"'|b1'", kU1},
  };
  for (auto& t : table)
    if (hdr.find(t.pat) != std::string::npos) return t.code;
  return 0;
}

// parse a 1-D npy member at `base`; returns payload offset or -1
int64_t parse_npy_1d(const uint8_t* buf, int64_t len, int64_t base,
                     int* code, int64_t* n) {
  if (base + 10 > len || std::memcmp(buf + base, "\x93NUMPY", 6) != 0)
    return -1;
  const int major = buf[base + 6];
  int64_t hlen, hoff;
  if (major == 1) {
    uint16_t h;
    std::memcpy(&h, buf + base + 8, 2);
    hlen = h;
    hoff = base + 10;
  } else {
    if (base + 12 > len) return -1;  // v2+ header length is 4 bytes
    uint32_t h;
    std::memcpy(&h, buf + base + 8, 4);
    hlen = h;
    hoff = base + 12;
  }
  if (hoff + hlen > len) return -1;
  std::string hdr(reinterpret_cast<const char*>(buf + hoff), size_t(hlen));
  if (hdr.find("'fortran_order': True") != std::string::npos) return -1;
  *code = dtype_code_from_header(hdr);
  if (*code == 0) return -1;
  auto sp = hdr.find("'shape':");
  if (sp == std::string::npos) return -1;
  auto lp = hdr.find('(', sp);
  if (lp == std::string::npos) return -1;
  long long rows = -1;
  if (std::sscanf(hdr.c_str() + lp, "(%lld", &rows) != 1) return -1;
  // must be 1-D: "(N,)" — reject "(N, M"
  auto comma = hdr.find(',', lp);
  auto rp = hdr.find(')', lp);
  if (comma != std::string::npos && comma < rp) {
    // 1-D tuples are "(N,)": the char after the comma is ')'
    auto q = hdr.find_first_not_of(" ", comma + 1);
    if (q == std::string::npos || hdr[q] != ')') return -1;
  }
  // claimed length must fit in the remaining file bytes (untrusted input;
  // division form avoids overflow for absurd claims)
  if (rows < 0 || rows > (len - hoff - hlen) / col_itemsize(*code)) return -1;
  *n = rows;
  return hoff + hlen;
}

int col_itemsize(int code) {
  switch (code) {
    case kU1: case kI1: return 1;
    case kU2: case kI2: return 2;
    case kU4: case kI4: case kF4: return 4;
    default: return 8;
  }
}

inline double col_get(const uint8_t* p, int code, int64_t i) {
  switch (code) {
    case kU1: return double(p[i]);
    case kI1: return double(reinterpret_cast<const int8_t*>(p)[i]);
    case kU2: { uint16_t v; std::memcpy(&v, p + 2 * i, 2); return double(v); }
    case kI2: { int16_t v; std::memcpy(&v, p + 2 * i, 2); return double(v); }
    case kU4: { uint32_t v; std::memcpy(&v, p + 4 * i, 4); return double(v); }
    case kI4: { int32_t v; std::memcpy(&v, p + 4 * i, 4); return double(v); }
    case kU8: { uint64_t v; std::memcpy(&v, p + 8 * i, 8); return double(v); }
    case kI8: { int64_t v; std::memcpy(&v, p + 8 * i, 8); return double(v); }
    case kF4: { float v; std::memcpy(&v, p + 4 * i, 4); return double(v); }
    default:  { double v; std::memcpy(&v, p + 8 * i, 8); return v; }
  }
}

// locate the x/y/t/p members of a ZIP_STORED npz; cols indexed x=0 y=1 t=2 p=3
bool parse_npz_columns(const uint8_t* buf, int64_t len, NpzCol cols[4]) {
  // EOCD: search the last 64KB + 22 for the signature
  const uint32_t kEOCD = 0x06054b50, kCDE = 0x02014b50, kLFH = 0x04034b50;
  int64_t eocd = -1;
  const int64_t lo = len - 22 - 65535 > 0 ? len - 22 - 65535 : 0;
  for (int64_t i = len - 22; i >= lo; --i) {
    uint32_t sig;
    std::memcpy(&sig, buf + i, 4);
    if (sig == kEOCD) { eocd = i; break; }
  }
  if (eocd < 0) return false;
  uint16_t nent;
  uint32_t cdoff;
  std::memcpy(&nent, buf + eocd + 10, 2);
  std::memcpy(&cdoff, buf + eocd + 16, 4);
  int64_t p = cdoff;
  for (int e = 0; e < nent; ++e) {
    if (p + 46 > len) return false;
    uint32_t sig;
    std::memcpy(&sig, buf + p, 4);
    if (sig != kCDE) return false;
    uint16_t method, nlen, elen, clen;
    uint32_t lho;
    std::memcpy(&method, buf + p + 10, 2);
    std::memcpy(&nlen, buf + p + 28, 2);
    std::memcpy(&elen, buf + p + 30, 2);
    std::memcpy(&clen, buf + p + 32, 2);
    std::memcpy(&lho, buf + p + 42, 4);
    if (p + 46 + int64_t(nlen) + elen + clen > len) return false;
    std::string name(reinterpret_cast<const char*>(buf + p + 46), nlen);
    p += 46 + nlen + elen + clen;
    int idx = -1;
    if (name == "x.npy") idx = 0;
    else if (name == "y.npy") idx = 1;
    else if (name == "t.npy") idx = 2;
    else if (name == "p.npy") idx = 3;
    if (idx < 0) continue;
    if (method != 0) return false;   // compressed: python fallback
    // local header: its name/extra lengths may differ from the central ones
    if (lho + 30 > uint32_t(len)) return false;
    uint32_t lsig;
    std::memcpy(&lsig, buf + lho, 4);
    if (lsig != kLFH) return false;
    uint16_t lnlen, lelen;
    std::memcpy(&lnlen, buf + lho + 26, 2);
    std::memcpy(&lelen, buf + lho + 28, 2);
    const int64_t base = int64_t(lho) + 30 + lnlen + lelen;
    int code;
    int64_t n;
    const int64_t doff = parse_npy_1d(buf, len, base, &code, &n);
    if (doff < 0) return false;
    cols[idx].off = doff;
    cols[idx].code = code;
    cols[idx].n = n;
  }
  for (int i = 0; i < 4; ++i)
    if (cols[i].off < 0) return false;
  return cols[0].n == cols[1].n && cols[0].n == cols[2].n &&
         cols[0].n == cols[3].n;
}

}  // namespace

// Load one N-ImageNet .npz (structured x/y/t/p columns, ZIP_STORED) into
// float32 (cap, 4) rows [x*sx, y*sy, t, 2p-1], slicing the
// SliceRandomMaxEvs window on the COLUMNS first. The x/y rescale multiplies
// in double before the single float round — bit-identical to the python
// path (data/pipeline.py columns fast path). Returns rows written or -1.
int64_t memev_load_npz_imgnet(const char* path, double slice_frac,
                              int64_t cap, double sx, double sy, float* out,
                              int32_t* out_maxxy) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) return -1;
  NpzCol cols[4];
  if (!parse_npz_columns(buf.data(), int64_t(buf.size()), cols)) return -1;
  const int64_t rows = cols[0].n;
  int64_t start = 0, take = rows;
  if (rows > cap) {
    start = int64_t(slice_frac * double(rows - cap + 1));
    if (start < 0) start = 0;
    if (start > rows - cap) start = rows - cap;
    take = cap;
  }
  const uint8_t* xd = buf.data() + cols[0].off;
  const uint8_t* yd = buf.data() + cols[1].off;
  const uint8_t* td = buf.data() + cols[2].off;
  const uint8_t* pd = buf.data() + cols[3].off;
  float mx = -1.0f, my = -1.0f;
  for (int64_t i = 0; i < take; ++i) {
    const float x = float(col_get(xd, cols[0].code, start + i) * sx);
    const float y = float(col_get(yd, cols[1].code, start + i) * sy);
    out[i * 4 + 0] = x;
    out[i * 4 + 1] = y;
    out[i * 4 + 2] = float(col_get(td, cols[2].code, start + i));
    out[i * 4 + 3] = float(2.0 * col_get(pd, cols[3].code, start + i) - 1.0);
    if (x > mx) mx = x;
    if (y > my) my = y;
  }
  for (int64_t i = take * 4; i < cap * 4; ++i) out[i] = 0.0f;
  // floor(mx)+1 == floor(mx+1) for every mx >= 0 (and mx == -1 when empty)
  out_maxxy[0] = sat_i32(mx + 1.0f);
  out_maxxy[1] = sat_i32(my + 1.0f);
  return take;
}

int64_t memev_load_batch_imgnet(const char** paths, const double* slice_fracs,
                                int64_t batch, int64_t cap, double sx,
                                double sy, int64_t num_threads,
                                float* out_events, int32_t* out_nvalid,
                                int32_t* out_maxxy) {
  std::atomic<int64_t> next(0), failed(0);
  auto worker = [&]() {
    for (;;) {
      const int64_t i = next.fetch_add(1);
      if (i >= batch) return;
      const int64_t n = memev_load_npz_imgnet(
          paths[i], slice_fracs[i], cap, sx, sy, out_events + i * cap * 4,
          out_maxxy + i * 2);
      if (n < 0) {
        int64_t expect = 0;
        failed.compare_exchange_strong(expect, i + 1);
        out_nvalid[i] = 0;
      } else {
        out_nvalid[i] = int32_t(n);
      }
    }
  };
  if (num_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int64_t t = 0; t < num_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return failed.load();
}

// Load one .npy event file into float32 (cap, 4) at out, applying
// SliceRandomMaxEvs with the pre-sampled uniform fraction `slice_frac`
// (start = floor(frac * (rows - cap + 1)) when rows > cap — identical
// distribution to the reference's random window start). Also reports
// (max_x + 1, max_y + 1) over the kept rows for per-sample logical extents.
// Returns the number of valid rows written, or -1 on error.
int64_t memev_load_npy_sliced(const char* path, double slice_frac,
                              int64_t cap, float* out, int32_t* out_maxxy) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) return -1;
  NpyInfo info;
  if (!parse_npy_header(buf.data(), int64_t(buf.size()), &info)) return -1;
  const int64_t rows = info.rows;
  int64_t start = 0, take = rows;
  if (rows > cap) {
    start = int64_t(slice_frac * double(rows - cap + 1));
    if (start < 0) start = 0;
    if (start > rows - cap) start = rows - cap;
    take = cap;
  }
  const uint8_t* data = buf.data() + info.data_off;
  if (info.itemsize == 8) {
    const double* d = reinterpret_cast<const double*>(data) + start * 4;
    for (int64_t i = 0; i < take * 4; ++i) out[i] = float(d[i]);
  } else {
    std::memcpy(out, reinterpret_cast<const float*>(data) + start * 4,
                size_t(take) * 4 * sizeof(float));
  }
  for (int64_t i = take * 4; i < cap * 4; ++i) out[i] = 0.0f;
  float mx = -1.0f, my = -1.0f;
  for (int64_t i = 0; i < take; ++i) {
    if (out[i * 4 + 0] > mx) mx = out[i * 4 + 0];
    if (out[i * 4 + 1] > my) my = out[i * 4 + 1];
  }
  out_maxxy[0] = sat_i32(mx + 1.0f);
  out_maxxy[1] = sat_i32(my + 1.0f);
  return take;
}

// Compact-wire variant: load one .npy into int16 (cap, 3) [x, y, p] — the
// on-wire format the device pipeline consumes when the timestamp column is
// dead (data/pipeline.py compact_wire). Conversion happens inside the read
// loop, so the Python side ships the buffer with zero extra passes.
int64_t memev_load_npy_sliced_xyp(const char* path, double slice_frac,
                                  int64_t cap, int16_t* out,
                                  int32_t* out_maxxy) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) return -1;
  NpyInfo info;
  if (!parse_npy_header(buf.data(), int64_t(buf.size()), &info)) return -1;
  const int64_t rows = info.rows;
  int64_t start = 0, take = rows;
  if (rows > cap) {
    start = int64_t(slice_frac * double(rows - cap + 1));
    if (start < 0) start = 0;
    if (start > rows - cap) start = rows - cap;
    take = cap;
  }
  const uint8_t* data = buf.data() + info.data_off;
  float mx = -1.0f, my = -1.0f;
  if (info.itemsize == 8) {
    const double* d = reinterpret_cast<const double*>(data) + start * 4;
    for (int64_t i = 0; i < take; ++i) {
      const float x = float(d[i * 4 + 0]);
      const float y = float(d[i * 4 + 1]);
      out[i * 3 + 0] = sat_i16(x);
      out[i * 3 + 1] = sat_i16(y);
      out[i * 3 + 2] = sat_i16(float(d[i * 4 + 3]));
      if (x > mx) mx = x;
      if (y > my) my = y;
    }
  } else {
    const float* d = reinterpret_cast<const float*>(data) + start * 4;
    for (int64_t i = 0; i < take; ++i) {
      const float x = d[i * 4 + 0];
      const float y = d[i * 4 + 1];
      out[i * 3 + 0] = sat_i16(x);
      out[i * 3 + 1] = sat_i16(y);
      out[i * 3 + 2] = sat_i16(d[i * 4 + 3]);
      if (x > mx) mx = x;
      if (y > my) my = y;
    }
  }
  std::memset(out + take * 3, 0, size_t(cap - take) * 3 * sizeof(int16_t));
  out_maxxy[0] = sat_i32(mx + 1.0f);
  out_maxxy[1] = sat_i32(my + 1.0f);
  return take;
}

// DSEC segmentation sample: (N, 4) npy [x, y, t, p{0,1}] -> int16 (cap, 3)
// [x, y, 2p-1] with (1) y < seg_h crop, (2) SliceRandomMaxEvs window over
// the KEPT rows, (3) counting-sort by y (the host presort feeding the
// row-tiled Pallas histogram — order among equal y is unspecified on the
// python path too: np.argsort is introsort; histogram counts are
// order-invariant). Returns rows written or -1.
int64_t memev_load_npy_dsec(const char* path, double slice_frac, int64_t cap,
                            int64_t seg_h, int16_t* out) {
  std::vector<uint8_t> buf;
  if (!read_file(path, &buf)) return -1;
  NpyInfo info;
  if (!parse_npy_header(buf.data(), int64_t(buf.size()), &info)) return -1;
  const uint8_t* data = buf.data() + info.data_off;
  const int64_t rows = info.rows;

  auto col = [&](int64_t r, int c) -> double {
    if (info.itemsize == 8)
      return reinterpret_cast<const double*>(data)[r * 4 + c];
    return double(reinterpret_cast<const float*>(data)[r * 4 + c]);
  };

  // Crop predicate: keep rows whose f32-ROUNDED y lands inside [0, seg_h).
  // The compare runs on the f32 value (what the int16 wire carries), so a
  // double y in (seg_h-ulp, seg_h) cannot round up into an out-of-range
  // histogram row; negative or NaN y (corrupt data) is dropped instead of
  // indexing out of bounds. Deviation from the reference's bare `y < 440`
  // (dataset_folder.py:275-283 dsec_npy_loader), which keeps negative y
  // and relies on numpy negative-index wrapping; the python path
  // (data/seg_pipeline.py _load_one) applies the same predicate.
  auto keep_y = [&](int64_t r, float* yf) -> bool {
    const float y = float(col(r, 1));
    if (!(y >= 0.0f && y < float(seg_h))) return false;
    *yf = y;
    return true;
  };

  // pass 1: kept count
  int64_t n_keep = 0;
  float yf;
  for (int64_t r = 0; r < rows; ++r)
    if (keep_y(r, &yf)) ++n_keep;

  int64_t start = 0, take = n_keep;
  if (n_keep > cap) {
    start = int64_t(slice_frac * double(n_keep - cap + 1));
    if (start < 0) start = 0;
    if (start > n_keep - cap) start = n_keep - cap;
    take = cap;
  }

  // pass 2: y histogram over the kept window
  std::vector<int32_t> hist(size_t(seg_h) + 1, 0);
  int64_t k = 0;
  for (int64_t r = 0; r < rows && k < start + take; ++r) {
    if (!keep_y(r, &yf)) continue;
    if (k >= start) ++hist[size_t(int64_t(yf))];
    ++k;
  }
  int32_t acc = 0;
  for (auto& h : hist) {
    const int32_t c = h;
    h = acc;
    acc += c;
  }

  // pass 3: scatter sorted rows
  k = 0;
  for (int64_t r = 0; r < rows && k < start + take; ++r) {
    if (!keep_y(r, &yf)) continue;
    if (k >= start) {
      const int64_t pos = hist[size_t(int64_t(yf))]++;
      out[pos * 3 + 0] = sat_i16(float(col(r, 0)));
      out[pos * 3 + 1] = int16_t(yf);           // in [0, seg_h) by keep_y
      out[pos * 3 + 2] = sat_i16(float(2.0 * col(r, 3) - 1.0));
    }
    ++k;
  }
  std::memset(out + take * 3, 0, size_t(cap - take) * 3 * sizeof(int16_t));
  return take;
}

int64_t memev_load_batch_dsec(const char** paths, const double* slice_fracs,
                              int64_t batch, int64_t cap, int64_t seg_h,
                              int64_t num_threads, int16_t* out_events,
                              int32_t* out_nvalid) {
  std::atomic<int64_t> next(0), failed(0);
  auto worker = [&]() {
    for (;;) {
      const int64_t i = next.fetch_add(1);
      if (i >= batch) return;
      const int64_t n = memev_load_npy_dsec(
          paths[i], slice_fracs[i], cap, seg_h, out_events + i * cap * 3);
      if (n < 0) {
        int64_t expect = 0;
        failed.compare_exchange_strong(expect, i + 1);
        out_nvalid[i] = 0;
      } else {
        out_nvalid[i] = int32_t(n);
      }
    }
  };
  if (num_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int64_t t = 0; t < num_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return failed.load();
}

int64_t memev_load_batch_xyp(const char** paths, const double* slice_fracs,
                             int64_t batch, int64_t cap, int64_t num_threads,
                             int16_t* out_events, int32_t* out_nvalid,
                             int32_t* out_maxxy) {
  std::atomic<int64_t> next(0), failed(0);
  auto worker = [&]() {
    for (;;) {
      const int64_t i = next.fetch_add(1);
      if (i >= batch) return;
      const int64_t n = memev_load_npy_sliced_xyp(
          paths[i], slice_fracs[i], cap, out_events + i * cap * 3,
          out_maxxy + i * 2);
      if (n < 0) {
        int64_t expect = 0;
        failed.compare_exchange_strong(expect, i + 1);
        out_nvalid[i] = 0;
      } else {
        out_nvalid[i] = int32_t(n);
      }
    }
  };
  if (num_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int64_t t = 0; t < num_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return failed.load();
}

// Threaded batch assembly: B paths -> (B, cap, 4) float32 + n_valid[B] +
// per-sample (max_x+1, max_y+1) extents. slice_fracs holds host-sampled
// U[0,1) fractions for the SliceRandomMaxEvs windows.
// Returns 0 on success, else the 1-based index of the first failing item.
int64_t memev_load_batch(const char** paths, const double* slice_fracs,
                         int64_t batch, int64_t cap, int64_t num_threads,
                         float* out_events, int32_t* out_nvalid,
                         int32_t* out_maxxy) {
  std::atomic<int64_t> next(0), failed(0);
  auto worker = [&]() {
    for (;;) {
      const int64_t i = next.fetch_add(1);
      if (i >= batch) return;
      const int64_t n = memev_load_npy_sliced(
          paths[i], slice_fracs[i], cap, out_events + i * cap * 4,
          out_maxxy + i * 2);
      if (n < 0) {
        int64_t expect = 0;
        failed.compare_exchange_strong(expect, i + 1);
        out_nvalid[i] = 0;
      } else {
        out_nvalid[i] = int32_t(n);
      }
    }
  };
  if (num_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (int64_t t = 0; t < num_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return failed.load();
}

}  // extern "C"
