// volcodec: the host-side NIfTI decoder of brainfm_tpu_torch's subject
// ingest (a copy of the JAX package's runtime codec; the port keeps its own).
//
// A thread pool inflates .nii.gz payloads (zlib), parses the NIfTI-1
// header, converts the voxel dtype to float32 (with scl_slope/scl_inter in
// double, as the Python reader scales), and writes each volume zero-padded
// into a caller-owned float32 arena of one fixed shape.
//
// Build (brainfm_tpu_torch/runtime/loader.py does this at first use):
//   g++ -O3 -shared -fPIC volcodec.cpp -lz -lpthread -o libvolcodec.so
// Interface: C ABI, driven from Python via ctypes.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <vector>

#include <zlib.h>

namespace {

struct NiftiInfo {
  int64_t dim[3];
  int64_t nframes;  // product of dims beyond the first 3 (1 for plain 3-D)
  int datatype;
  int bitpix;
  int64_t vox_offset;
  float scl_slope, scl_inter;
  bool little_endian;
};

bool read_file(const char* path, std::vector<uint8_t>& out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  out.resize(n);
  size_t got = fread(out.data(), 1, n, f);
  fclose(f);
  return got == static_cast<size_t>(n);
}

bool gunzip(const std::vector<uint8_t>& in, std::vector<uint8_t>& out) {
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, 16 + MAX_WBITS) != Z_OK) return false;
  zs.next_in = const_cast<uint8_t*>(in.data());
  zs.avail_in = in.size();
  out.resize(in.size() * 4 + (1 << 20));
  int ret;
  size_t written = 0;
  do {
    if (written == out.size()) out.resize(out.size() * 2);
    zs.next_out = out.data() + written;
    zs.avail_out = out.size() - written;
    ret = inflate(&zs, Z_NO_FLUSH);
    if (ret != Z_OK && ret != Z_STREAM_END) {
      inflateEnd(&zs);
      return false;
    }
    written = zs.total_out;
  } while (ret != Z_STREAM_END);
  out.resize(written);
  inflateEnd(&zs);
  return true;
}

template <typename T>
T load_le(const uint8_t* p, bool little) {
  T v;
  memcpy(&v, p, sizeof(T));
  if (!little) {
    uint8_t* b = reinterpret_cast<uint8_t*>(&v);
    for (size_t i = 0; i < sizeof(T) / 2; ++i)
      std::swap(b[i], b[sizeof(T) - 1 - i]);
  }
  return v;
}

bool parse_header(const uint8_t* h, size_t n, NiftiInfo* info) {
  if (n < 348) return false;
  int32_t sz = load_le<int32_t>(h, true);
  info->little_endian = (sz == 348);
  if (!info->little_endian && load_le<int32_t>(h, false) != 348) return false;
  bool le = info->little_endian;
  int16_t ndim = load_le<int16_t>(h + 40, le);
  if (ndim < 3) return false;
  for (int d = 0; d < 3; ++d)
    info->dim[d] = load_le<int16_t>(h + 42 + 2 * d, le);
  info->nframes = 1;
  for (int d = 3; d < ndim && d < 7; ++d) {
    int16_t v = load_le<int16_t>(h + 42 + 2 * d, le);
    if (v > 1) info->nframes *= v;
  }
  info->datatype = load_le<int16_t>(h + 70, le);
  info->bitpix = load_le<int16_t>(h + 72, le);
  info->vox_offset = static_cast<int64_t>(load_le<float>(h + 108, le));
  info->scl_slope = load_le<float>(h + 112, le);
  info->scl_inter = load_le<float>(h + 116, le);
  // NaN/Inf slope or inter mean "no scaling" (nibabel convention; parity
  // with utils/nifti._read_nifti)
  if (!(info->scl_slope == info->scl_slope) ||
      info->scl_slope > 3.4e38f || info->scl_slope < -3.4e38f)
    info->scl_slope = 0.0f;
  if (!(info->scl_inter == info->scl_inter) ||
      info->scl_inter > 3.4e38f || info->scl_inter < -3.4e38f)
    info->scl_inter = 0.0f;
  return true;
}

template <typename SRC>
void convert_pad(const uint8_t* src, bool le, const int64_t in_dim[3],
                 float* dst, const int64_t out_dim[3], float slope,
                 float inter) {
  // NIfTI payload is Fortran order (x fastest); arena is C order (z fastest)
  const int64_t ix = in_dim[0], iy = in_dim[1], iz = in_dim[2];
  const int64_t ox = out_dim[0], oy = out_dim[1], oz = out_dim[2];
  const int64_t cx = ix < ox ? ix : ox;
  const int64_t cy = iy < oy ? iy : oy;
  const int64_t cz = iz < oz ? iz : oz;
  memset(dst, 0, sizeof(float) * ox * oy * oz);
  const bool scale = (slope != 0.0f && slope != 1.0f) || inter != 0.0f;
  const float s = slope == 0.0f ? 1.0f : slope;
  if (le) {
    // fast path: host is little-endian; direct typed reads vectorize.
    // The F-order -> C-order layout flip is a 3-D transpose: a naive
    // x-inner loop scatters every voxel at stride oy*oz (16 KB at 64^3)
    // and each write misses cache — measured 5x SLOWER than the numpy
    // reader. Tile the (z,x) transpose per y-plane so a 32x32 tile's
    // write lines stay resident (classic blocked transpose).
    const SRC* tsrc = reinterpret_cast<const SRC*>(src);
    const int64_t BT = 32;
    const int64_t ostride = oy * oz;
    for (int64_t y = 0; y < cy; ++y) {
      const SRC* plane = tsrc + y * ix;  // + z*iy*ix + x
      float* oplane = dst + y * oz;      // + x*oy*oz + z
      for (int64_t x0 = 0; x0 < cx; x0 += BT) {
        const int64_t x1 = x0 + BT < cx ? x0 + BT : cx;
        for (int64_t z0 = 0; z0 < cz; z0 += BT) {
          const int64_t z1 = z0 + BT < cz ? z0 + BT : cz;
          for (int64_t z = z0; z < z1; ++z) {
            const SRC* row = plane + z * iy * ix;
            float* ocol = oplane + z;
            if (scale) {
              // double math: the Python reader scales in float64 then
              // downcasts — bit-parity requires the same rounding here
              for (int64_t x = x0; x < x1; ++x)
                ocol[x * ostride] = static_cast<float>(
                    static_cast<double>(row[x]) * static_cast<double>(s) +
                    static_cast<double>(inter));
            } else {
              for (int64_t x = x0; x < x1; ++x)
                ocol[x * ostride] = static_cast<float>(row[x]);
            }
          }
        }
      }
    }
    return;
  }
  for (int64_t z = 0; z < cz; ++z) {
    for (int64_t y = 0; y < cy; ++y) {
      const uint8_t* row = src + sizeof(SRC) * (z * iy * ix + y * ix);
      for (int64_t x = 0; x < cx; ++x) {
        SRC v = load_le<SRC>(row + sizeof(SRC) * x, le);
        float fv = static_cast<float>(v);
        if (scale)
          fv = static_cast<float>(static_cast<double>(v) *
                                      static_cast<double>(s) +
                                  static_cast<double>(inter));
        dst[(x * oy + y) * oz + z] = fv;
      }
    }
  }
}

struct Pool {
  std::vector<std::thread> workers;
  std::queue<std::function<void()>> q;
  std::mutex m;
  std::condition_variable cv;
  std::atomic<int> pending{0};
  std::condition_variable done_cv;
  std::mutex done_m;
  bool stop = false;

  explicit Pool(int n) {
    for (int i = 0; i < n; ++i)
      workers.emplace_back([this] {
        for (;;) {
          std::function<void()> job;
          {
            std::unique_lock<std::mutex> lk(m);
            cv.wait(lk, [this] { return stop || !q.empty(); });
            if (stop && q.empty()) return;
            job = std::move(q.front());
            q.pop();
          }
          job();
          if (--pending == 0) {
            std::lock_guard<std::mutex> lk(done_m);
            done_cv.notify_all();
          }
        }
      });
  }
  ~Pool() {
    {
      std::lock_guard<std::mutex> lk(m);
      stop = true;
    }
    cv.notify_all();
    for (auto& w : workers) w.join();
  }
  void submit(std::function<void()> f) {
    ++pending;
    {
      std::lock_guard<std::mutex> lk(m);
      q.push(std::move(f));
    }
    cv.notify_one();
  }
  void wait() {
    std::unique_lock<std::mutex> lk(done_m);
    done_cv.wait(lk, [this] { return pending.load() == 0; });
  }
};

Pool* g_pool = nullptr;

int decode_one(const char* path, float* dst, const int64_t out_dim[3],
               int64_t* dims_out = nullptr) {
  std::vector<uint8_t> raw;
  if (!read_file(path, raw)) return -1;
  std::vector<uint8_t> buf;
  const uint8_t* data;
  size_t n;
  if (raw.size() >= 2 && raw[0] == 0x1f && raw[1] == 0x8b) {
    if (!gunzip(raw, buf)) return -2;
    data = buf.data();
    n = buf.size();
  } else {
    data = raw.data();
    n = raw.size();
  }
  NiftiInfo info;
  if (!parse_header(data, n, &info)) return -3;
  if (dims_out) {
    dims_out[0] = info.dim[0];
    dims_out[1] = info.dim[1];
    dims_out[2] = info.dim[2];
    dims_out[3] = info.nframes;
  }
  // multi-frame volumes keep their trailing dims on the Python path —
  // report and let the caller fall back rather than silently taking frame 0
  if (info.nframes > 1) return -6;
  const uint8_t* vox = data + info.vox_offset;
  size_t need = static_cast<size_t>(info.dim[0]) * info.dim[1] * info.dim[2] *
                (info.bitpix / 8);
  if (info.vox_offset + need > n) return -4;
  switch (info.datatype) {
    case 2:
      convert_pad<uint8_t>(vox, info.little_endian, info.dim, dst, out_dim,
                           info.scl_slope, info.scl_inter);
      break;
    case 4:
      convert_pad<int16_t>(vox, info.little_endian, info.dim, dst, out_dim,
                           info.scl_slope, info.scl_inter);
      break;
    case 8:
      convert_pad<int32_t>(vox, info.little_endian, info.dim, dst, out_dim,
                           info.scl_slope, info.scl_inter);
      break;
    case 16:
      convert_pad<float>(vox, info.little_endian, info.dim, dst, out_dim,
                         info.scl_slope, info.scl_inter);
      break;
    case 64:
      convert_pad<double>(vox, info.little_endian, info.dim, dst, out_dim,
                          info.scl_slope, info.scl_inter);
      break;
    case 512:
      convert_pad<uint16_t>(vox, info.little_endian, info.dim, dst, out_dim,
                            info.scl_slope, info.scl_inter);
      break;
    default:
      return -5;
  }
  return 0;
}

}  // namespace

extern "C" {

void volcodec_init(int n_threads) {
  if (!g_pool) g_pool = new Pool(n_threads > 0 ? n_threads : 4);
}

// Decode `count` NIfTI files in parallel into a float32 arena of
// shape (count, dx, dy, dz) (C-contiguous). Returns 0 on full success;
// per-file status written to `status`.
int volcodec_decode_batch(const char** paths, int count, float* arena,
                          int64_t dx, int64_t dy, int64_t dz, int* status) {
  if (!g_pool) volcodec_init(0);
  const int64_t out_dim[3] = {dx, dy, dz};
  const int64_t voxels = dx * dy * dz;
  for (int i = 0; i < count; ++i) {
    const char* p = paths[i];
    float* dst = arena + static_cast<int64_t>(i) * voxels;
    int* st = status + i;
    g_pool->submit([p, dst, out_dim, st] { *st = decode_one(p, dst, out_dim); });
  }
  g_pool->wait();
  for (int i = 0; i < count; ++i)
    if (status[i] != 0) return status[i];
  return 0;
}

int volcodec_decode_one(const char* path, float* dst, int64_t dx, int64_t dy,
                        int64_t dz) {
  const int64_t out_dim[3] = {dx, dy, dz};
  return decode_one(path, dst, out_dim);
}

// decode_batch + per-file native dims: dims is int64[count*4] receiving
// (dx, dy, dz, nframes) per file. Multi-frame files (nframes > 1) are NOT
// decoded — their status is -6 and the caller falls back to the Python
// reader, which preserves trailing dims. Unlike volcodec_decode_batch this
// never fails the whole batch: per-file status tells the caller which
// files need the fallback.
int volcodec_decode_batch_ex(const char** paths, int count, float* arena,
                             int64_t dx, int64_t dy, int64_t dz, int* status,
                             int64_t* dims) {
  if (!g_pool) volcodec_init(0);
  const int64_t out_dim[3] = {dx, dy, dz};
  const int64_t voxels = dx * dy * dz;
  for (int i = 0; i < count; ++i) {
    const char* p = paths[i];
    float* dst = arena + static_cast<int64_t>(i) * voxels;
    int* st = status + i;
    int64_t* dm = dims + static_cast<int64_t>(i) * 4;
    g_pool->submit(
        [p, dst, out_dim, st, dm] { *st = decode_one(p, dst, out_dim, dm); });
  }
  g_pool->wait();
  return 0;
}

}  // extern "C"
