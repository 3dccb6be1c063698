// Host-side .npz decoder: a pool of threads that read a zip archive, inflate
// its entries and hand back the raw .npy payloads, outside Python's GIL.
// C interface for ctypes (im23d_tpu_torch/data/fastloader.py, which builds
// this file with g++ at first use).  Replaces no TPU kernel: it is the
// port's copy of the JAX package's native npz decoder, for the GAN's host
// feed, where each item is one compressed per-image npz of the
// pseudo-ground-truth cache (a pickled `data` dict of float16 maps).
//
// Supported subset: zip entries stored (method 0) or deflated (method 8,
// raw deflate) whose central-directory sizes fit 32 bits, holding .npy
// files; Python parses each payload (numeric or pickled object arrays).
// Anything else fails the archive with a message that names the entry.

#include <zlib.h>

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Entry {
  std::string name;
  uint64_t comp_size = 0;
  uint64_t raw_size = 0;
  uint16_t method = 0;
  uint64_t offset = 0;  // file offset of the local header
};

bool read_file(const std::string& path, std::vector<uint8_t>& out) {
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return false;
  bool ok = fseek(f, 0, SEEK_END) == 0;
  long n = ok ? ftell(f) : -1;
  ok = n >= 0 && fseek(f, 0, SEEK_SET) == 0;
  if (ok) {
    out.resize(static_cast<size_t>(n));
    ok = fread(out.data(), 1, out.size(), f) == out.size();
  }
  fclose(f);
  return ok;
}

uint16_t rd16(const uint8_t* p) { return p[0] | (p[1] << 8); }
uint32_t rd32(const uint8_t* p) {
  return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24);
}

// The central directory's entries; an empty string, or why it failed.
std::string parse_zip(const std::vector<uint8_t>& file,
                      std::vector<Entry>& entries) {
  if (file.size() < 22) return "not a zip archive (too short)";
  // the end-of-central-directory record, within the last 64 KiB + 22 bytes
  size_t eocd = std::string::npos;
  size_t lo = file.size() >= 65558 ? file.size() - 65558 : 0;
  for (size_t i = file.size() - 22 + 1; i-- > lo;) {
    if (rd32(&file[i]) == 0x06054b50) {
      eocd = i;
      break;
    }
  }
  if (eocd == std::string::npos)
    return "not a zip archive (no end-of-central-directory record)";
  uint16_t n_entries = rd16(&file[eocd + 10]);
  uint32_t cd_offset = rd32(&file[eocd + 16]);
  if (n_entries == 0xffff || cd_offset == 0xffffffffu)
    return "zip64 archives are not supported";
  size_t p = cd_offset;
  for (int i = 0; i < n_entries; ++i) {
    if (p + 46 > file.size() || rd32(&file[p]) != 0x02014b50)
      return "corrupt central directory";
    Entry e;
    e.method = rd16(&file[p + 10]);
    e.comp_size = rd32(&file[p + 20]);
    e.raw_size = rd32(&file[p + 24]);
    uint16_t name_len = rd16(&file[p + 28]);
    uint16_t extra_len = rd16(&file[p + 30]);
    uint16_t comment_len = rd16(&file[p + 32]);
    e.offset = rd32(&file[p + 42]);
    if (p + 46 + name_len > file.size()) return "corrupt central directory";
    e.name.assign(reinterpret_cast<const char*>(&file[p + 46]), name_len);
    if (e.comp_size == 0xffffffffu || e.raw_size == 0xffffffffu ||
        e.offset == 0xffffffffu)
      return "entry '" + e.name + "': zip64 sizes are not supported";
    entries.push_back(std::move(e));
    p += 46 + name_len + extra_len + comment_len;
  }
  return "";
}

// One entry's raw bytes into out; an empty string, or why it failed.
std::string extract_entry(const std::vector<uint8_t>& file, const Entry& e,
                          std::vector<uint8_t>& out) {
  const std::string where = "entry '" + e.name + "': ";
  size_t p = e.offset;
  if (p + 30 > file.size() || rd32(&file[p]) != 0x04034b50)
    return where + "corrupt local header";
  uint16_t name_len = rd16(&file[p + 26]);
  uint16_t extra_len = rd16(&file[p + 28]);
  size_t data_off = p + 30 + name_len + extra_len;
  if (data_off + e.comp_size > file.size()) return where + "truncated data";
  if (e.method == 0) {
    if (e.raw_size != e.comp_size) return where + "stored sizes disagree";
    out.assign(file.begin() + data_off, file.begin() + data_off + e.raw_size);
    return "";
  }
  if (e.method != 8)
    return where + "compression method " + std::to_string(e.method) +
           " is not supported (stored or deflated only)";
  out.resize(e.raw_size);
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, -15) != Z_OK) return where + "inflateInit2 failed";
  zs.next_in = const_cast<Bytef*>(file.data() + data_off);
  zs.avail_in = static_cast<uInt>(e.comp_size);
  zs.next_out = out.data();
  zs.avail_out = static_cast<uInt>(out.size());
  int rc = inflate(&zs, Z_FINISH);
  uint64_t got = zs.total_out;
  inflateEnd(&zs);
  if (rc != Z_STREAM_END || got != e.raw_size)
    return where + "inflate failed (zlib " + std::to_string(rc) + ")";
  return "";
}

struct Job {
  int64_t ticket;
  std::string path;
};

struct Result {
  // the entries' raw payloads back to back, and an index of them
  std::vector<uint8_t> blob;
  std::string index;  // lines: name \t offset \t size \n
  std::string error;  // empty when the archive decoded
};

class Pool {
 public:
  explicit Pool(int n_threads) {
    for (int i = 0; i < n_threads; ++i)
      workers_.emplace_back([this] { worker(); });
  }
  ~Pool() {
    {
      std::lock_guard<std::mutex> g(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto& t : workers_) t.join();
    for (auto& kv : results_) delete kv.second;
  }

  int64_t submit(const char* path) {
    std::lock_guard<std::mutex> g(mu_);
    int64_t t = next_ticket_++;
    jobs_.push_back(Job{t, path});
    cv_.notify_one();
    return t;
  }

  Result* wait(int64_t ticket) {
    std::unique_lock<std::mutex> g(mu_);
    done_cv_.wait(g, [&] { return results_.count(ticket) > 0; });
    Result* r = results_[ticket];
    results_.erase(ticket);
    return r;
  }

 private:
  void worker() {
    for (;;) {
      Job job;
      {
        std::unique_lock<std::mutex> g(mu_);
        cv_.wait(g, [&] { return stop_ || !jobs_.empty(); });
        if (stop_ && jobs_.empty()) return;
        job = jobs_.front();
        jobs_.pop_front();
      }
      Result* r = new Result();
      process(job.path, *r);
      {
        std::lock_guard<std::mutex> g(mu_);
        results_[job.ticket] = r;
      }
      done_cv_.notify_all();
    }
  }

  static void process(const std::string& path, Result& r) {
    std::vector<uint8_t> file;
    if (!read_file(path, file)) {
      r.error = "cannot read the file";
      return;
    }
    std::vector<Entry> entries;
    r.error = parse_zip(file, entries);
    if (!r.error.empty()) return;
    std::vector<uint8_t> raw;
    for (const Entry& e : entries) {
      r.error = extract_entry(file, e, raw);
      if (!r.error.empty()) return;
      size_t off = r.blob.size();
      r.blob.insert(r.blob.end(), raw.begin(), raw.end());
      r.index += e.name + "\t" + std::to_string(off) + "\t" +
                 std::to_string(raw.size()) + "\n";
    }
  }

  std::mutex mu_;
  std::condition_variable cv_, done_cv_;
  std::deque<Job> jobs_;
  std::unordered_map<int64_t, Result*> results_;
  std::vector<std::thread> workers_;
  int64_t next_ticket_ = 0;
  bool stop_ = false;
};

}  // namespace

extern "C" {

void* fl_create_pool(int n_threads) { return new Pool(n_threads); }
void fl_destroy_pool(void* pool) { delete static_cast<Pool*>(pool); }

long long fl_submit(void* pool, const char* path) {
  return static_cast<Pool*>(pool)->submit(path);
}

// Wait for a ticket; the result, decoded or carrying its error, is the
// caller's to free with fl_free_result.
void* fl_wait(void* pool, long long ticket) {
  return static_cast<Pool*>(pool)->wait(ticket);
}

const char* fl_result_error(void* result) {
  return static_cast<Result*>(result)->error.c_str();
}
long long fl_result_blob_size(void* result) {
  return static_cast<Result*>(result)->blob.size();
}
const void* fl_result_blob(void* result) {
  return static_cast<Result*>(result)->blob.data();
}
const char* fl_result_index(void* result) {
  return static_cast<Result*>(result)->index.c_str();
}
void fl_free_result(void* result) { delete static_cast<Result*>(result); }

}  // extern "C"
