// rosbag v2.0 reader — native data-ingest layer.
//
// The reference consumes its datasets as rosbag files played through ROS
// (README.md:25-33 in the reference); its ingest path is roscpp +
// pcl::fromROSMsg (src/scanRegistration.cpp:211-228).  This is the
// standalone equivalent: a dependency-free C++ parser for the public
// rosbag 2.0 container format that extracts sensor_msgs/PointCloud2 and
// sensor_msgs/Imu messages into packed arrays for the JAX pipeline.
//
// Format summary (public spec, wiki.ros.org/Bags/Format/2.0):
//   file    := "#ROSBAG V2.0\n" record*
//   record  := u32 header_len, header, u32 data_len, data
//   header  := (u32 field_len, name '=' value)*
//   op=0x03 bag header; op=0x05 chunk (header: compression, size);
//   op=0x07 connection (data: topic/type/md5 header); op=0x02 message
//   data (header: conn, time); 0x04/0x06 index records (skipped).
// Chunks may be compressed with bz2 or lz4 — handled via dlopen of the
// system runtime libraries (no dev headers needed).
//
// Exposed C ABI (ctypes-friendly): loam_bag_open / _topics / _count /
// _read_cloud / _read_imu / _close.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <dlfcn.h>
#include <map>
#include <memory>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// decompression via dlopen (no dev headers in the image)
// ---------------------------------------------------------------------------

typedef int (*bz2_decompress_fn)(char* dest, unsigned* destLen,
                                 char* source, unsigned sourceLen,
                                 int small, int verbosity);
typedef int (*lz4_decompress_fn)(const char* src, char* dst,
                                 int compressedSize, int dstCapacity);

bz2_decompress_fn get_bz2() {
  static bz2_decompress_fn fn = [] {
    void* h = dlopen("libbz2.so.1.0", RTLD_NOW | RTLD_GLOBAL);
    if (!h) h = dlopen("libbz2.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (!h) h = dlopen("libbz2.so", RTLD_NOW | RTLD_GLOBAL);
    return h ? reinterpret_cast<bz2_decompress_fn>(
                   dlsym(h, "BZ2_bzBuffToBuffDecompress"))
             : nullptr;
  }();
  return fn;
}

lz4_decompress_fn get_lz4() {
  static lz4_decompress_fn fn = [] {
    void* h = dlopen("liblz4.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (!h) h = dlopen("liblz4.so", RTLD_NOW | RTLD_GLOBAL);
    return h ? reinterpret_cast<lz4_decompress_fn>(
                   dlsym(h, "LZ4_decompress_safe"))
             : nullptr;
  }();
  return fn;
}

// ---------------------------------------------------------------------------
// record / header parsing
// ---------------------------------------------------------------------------

struct Slice {
  const uint8_t* p = nullptr;
  size_t n = 0;
};

uint32_t rd_u32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;  // bags are little-endian; so are our targets
}

struct Header {
  std::map<std::string, Slice> fields;

  bool parse(const uint8_t* p, size_t n) {
    size_t off = 0;
    while (off + 4 <= n) {
      uint32_t flen = rd_u32(p + off);
      off += 4;
      if (off + flen > n) return false;
      const uint8_t* eq =
          static_cast<const uint8_t*>(std::memchr(p + off, '=', flen));
      if (!eq) return false;
      std::string name(reinterpret_cast<const char*>(p + off),
                       eq - (p + off));
      size_t name_len = static_cast<size_t>(eq - (p + off));
      fields[name] = Slice{eq + 1, flen - name_len - 1};
      off += flen;
    }
    return off == n;
  }

  int op() const {
    auto it = fields.find("op");
    return (it != fields.end() && it->second.n >= 1) ? it->second.p[0] : -1;
  }
  bool u32(const char* k, uint32_t* out) const {
    auto it = fields.find(k);
    if (it == fields.end() || it->second.n < 4) return false;
    *out = rd_u32(it->second.p);
    return true;
  }
  bool u64(const char* k, uint64_t* out) const {
    auto it = fields.find(k);
    if (it == fields.end() || it->second.n < 8) return false;
    std::memcpy(out, it->second.p, 8);
    return true;
  }
  bool str(const char* k, std::string* out) const {
    auto it = fields.find(k);
    if (it == fields.end()) return false;
    out->assign(reinterpret_cast<const char*>(it->second.p), it->second.n);
    return true;
  }
};

struct Connection {
  std::string topic;
  std::string type;
};

struct MessageRef {
  uint32_t conn;
  uint64_t time;      // ros time: secs in low 32 bits? no — (secs, nsecs)
  size_t buf;         // which decompressed buffer
  size_t off;         // offset of message payload
  size_t len;
};

struct Bag {
  std::vector<std::vector<uint8_t>> buffers;   // chunk payloads (+file tail)
  std::map<uint32_t, Connection> conns;
  std::vector<MessageRef> msgs;
  std::map<std::string, std::vector<size_t>> by_topic;
  std::string error;
};

// parse records inside one buffer (a decompressed chunk, or raw file)
bool parse_records(Bag* bag, size_t buf_idx, size_t begin, size_t end,
                   bool top_level);

bool handle_record(Bag* bag, size_t buf_idx, const Header& h,
                   size_t data_off, size_t data_len, bool top_level) {
  auto& buf = bag->buffers[buf_idx];
  switch (h.op()) {
    case 0x07: {  // connection: data = header dict with topic/type
      uint32_t conn = 0;
      h.u32("conn", &conn);
      Header ch;
      if (!ch.parse(buf.data() + data_off, data_len)) return false;
      Connection c;
      ch.str("topic", &c.topic);
      ch.str("type", &c.type);
      if (c.topic.empty()) h.str("topic", &c.topic);
      bag->conns[conn] = c;
      return true;
    }
    case 0x02: {  // message data
      uint32_t conn = 0;
      uint64_t t = 0;
      h.u32("conn", &conn);
      h.u64("time", &t);
      MessageRef m{conn, t, buf_idx, data_off, data_len};
      bag->msgs.push_back(m);
      return true;
    }
    case 0x05: {  // chunk
      if (!top_level) return false;  // chunks don't nest
      std::string comp;
      h.str("compression", &comp);
      uint32_t usize = 0;
      h.u32("size", &usize);
      if (comp == "none" || comp.empty()) {
        return parse_records(bag, buf_idx, data_off, data_off + data_len,
                             false);
      }
      std::vector<uint8_t> out(usize);
      if (comp == "bz2") {
        bz2_decompress_fn bz2 = get_bz2();
        if (!bz2) {
          bag->error = "libbz2 unavailable";
          return false;
        }
        unsigned dlen = usize;
        int rc = bz2(reinterpret_cast<char*>(out.data()), &dlen,
                     reinterpret_cast<char*>(buf.data() + data_off),
                     static_cast<unsigned>(data_len), 0, 0);
        if (rc != 0) {
          bag->error = "bz2 decompress failed";
          return false;
        }
        out.resize(dlen);
      } else if (comp == "lz4") {
        lz4_decompress_fn lz4 = get_lz4();
        if (!lz4) {
          bag->error = "liblz4 unavailable";
          return false;
        }
        int rc = lz4(reinterpret_cast<const char*>(buf.data() + data_off),
                     reinterpret_cast<char*>(out.data()),
                     static_cast<int>(data_len), static_cast<int>(usize));
        if (rc < 0) {
          bag->error = "lz4 decompress failed";
          return false;
        }
        out.resize(rc);
      } else {
        bag->error = "unknown compression: " + comp;
        return false;
      }
      bag->buffers.push_back(std::move(out));
      size_t nb = bag->buffers.size() - 1;
      return parse_records(bag, nb, 0, bag->buffers[nb].size(), false);
    }
    default:
      return true;  // bag header / index / chunk info — skip
  }
}

bool parse_records(Bag* bag, size_t buf_idx, size_t begin, size_t end,
                   bool top_level) {
  size_t off = begin;
  while (off + 8 <= end) {
    auto& buf = bag->buffers[buf_idx];  // re-deref: vector may reallocate
    uint32_t hlen = rd_u32(buf.data() + off);
    if (off + 4 + hlen + 4 > end) return false;
    Header h;
    if (!h.parse(buf.data() + off + 4, hlen)) return false;
    uint32_t dlen = rd_u32(buf.data() + off + 4 + hlen);
    size_t data_off = off + 8 + hlen;
    if (data_off + dlen > end) return false;
    if (!handle_record(bag, buf_idx, h, data_off, dlen, top_level))
      return false;
    off = data_off + dlen;
  }
  return true;
}

// ---------------------------------------------------------------------------
// message deserialization helpers
// ---------------------------------------------------------------------------

struct Cursor {
  const uint8_t* p;
  size_t n;
  size_t off = 0;
  bool ok = true;

  template <typename T>
  T get() {
    T v{};
    if (off + sizeof(T) > n) {
      ok = false;
      return v;
    }
    std::memcpy(&v, p + off, sizeof(T));
    off += sizeof(T);
    return v;
  }
  std::string str() {
    uint32_t len = get<uint32_t>();
    if (!ok || off + len > n) {
      ok = false;
      return "";
    }
    std::string s(reinterpret_cast<const char*>(p + off), len);
    off += len;
    return s;
  }
  void skip(size_t k) {
    if (off + k > n)
      ok = false;
    else
      off += k;
  }
};

double ros_stamp(Cursor* c) {
  uint32_t sec = c->get<uint32_t>();
  uint32_t nsec = c->get<uint32_t>();
  return double(sec) + double(nsec) * 1e-9;
}

void skip_std_header(Cursor* c, double* stamp) {
  c->get<uint32_t>();  // seq
  double t = ros_stamp(c);
  if (stamp) *stamp = t;
  c->str();  // frame_id
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

void* loam_bag_open(const char* path, char* err, int errlen) {
  auto bag = std::make_unique<Bag>();
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    std::snprintf(err, errlen, "cannot open %s", path);
    return nullptr;
  }
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> data(size);
  if (std::fread(data.data(), 1, size, f) != static_cast<size_t>(size)) {
    std::fclose(f);
    std::snprintf(err, errlen, "short read");
    return nullptr;
  }
  std::fclose(f);

  const char magic[] = "#ROSBAG V2.0\n";
  size_t maglen = sizeof(magic) - 1;
  if (data.size() < maglen ||
      std::memcmp(data.data(), magic, maglen) != 0) {
    std::snprintf(err, errlen, "not a rosbag 2.0 file");
    return nullptr;
  }
  bag->buffers.push_back(std::move(data));
  if (!parse_records(bag.get(), 0, maglen, bag->buffers[0].size(), true)) {
    std::snprintf(err, errlen, "parse error: %s",
                  bag->error.empty() ? "malformed record" : bag->error.c_str());
    return nullptr;
  }
  for (size_t i = 0; i < bag->msgs.size(); i++) {
    auto it = bag->conns.find(bag->msgs[i].conn);
    if (it != bag->conns.end())
      bag->by_topic[it->second.topic].push_back(i);
  }
  return bag.release();
}

void loam_bag_close(void* h) { delete static_cast<Bag*>(h); }

// newline-joined "topic\ttype" listing; returns bytes written
int loam_bag_topics(void* h, char* out, int outlen) {
  Bag* bag = static_cast<Bag*>(h);
  std::string s;
  for (auto& kv : bag->conns)
    s += kv.second.topic + "\t" + kv.second.type + "\n";
  int n = std::min<int>(outlen - 1, s.size());
  std::memcpy(out, s.data(), n);
  out[n] = 0;
  return n;
}

long loam_bag_count(void* h, const char* topic) {
  Bag* bag = static_cast<Bag*>(h);
  auto it = bag->by_topic.find(topic);
  return it == bag->by_topic.end() ? 0 : it->second.size();
}

// Read one PointCloud2: fills xyz (cap*3 floats), optional ring
// (cap int32, -1 if absent) and rel_time (cap floats, NaN if absent).
// Returns point count (clipped to cap) or -1.  stamp <- header stamp.
long loam_bag_read_cloud(void* h, const char* topic, long index,
                         float* xyz, int32_t* ring, float* rel,
                         long cap, double* stamp) {
  Bag* bag = static_cast<Bag*>(h);
  auto it = bag->by_topic.find(topic);
  if (it == bag->by_topic.end() || index < 0 ||
      static_cast<size_t>(index) >= it->second.size())
    return -1;
  const MessageRef& m = bag->msgs[it->second[index]];
  Cursor c{bag->buffers[m.buf].data() + m.off, m.len};

  skip_std_header(&c, stamp);
  uint32_t height = c.get<uint32_t>();
  uint32_t width = c.get<uint32_t>();
  uint32_t nfields = c.get<uint32_t>();
  struct Field {
    std::string name;
    uint32_t offset;
    uint8_t datatype;
    uint32_t count;
  };
  std::vector<Field> fields(nfields);
  for (auto& fl : fields) {
    fl.name = c.str();
    fl.offset = c.get<uint32_t>();
    fl.datatype = c.get<uint8_t>();
    fl.count = c.get<uint32_t>();
  }
  c.get<uint8_t>();  // is_bigendian
  uint32_t point_step = c.get<uint32_t>();
  c.get<uint32_t>();  // row_step
  uint32_t datalen = c.get<uint32_t>();
  if (!c.ok || c.off + datalen > c.n) return -1;
  const uint8_t* pts = c.p + c.off;

  long n = std::min<long>(static_cast<long>(height) * width, cap);
  int xo = -1, yo = -1, zo = -1, ro = -1, to = -1;
  uint8_t rtype = 0, ttype = 0;
  for (auto& fl : fields) {
    if (fl.name == "x") xo = fl.offset;
    else if (fl.name == "y") yo = fl.offset;
    else if (fl.name == "z") zo = fl.offset;
    else if (fl.name == "ring") { ro = fl.offset; rtype = fl.datatype; }
    else if (fl.name == "time" || fl.name == "t" ||
             fl.name == "timestamp") { to = fl.offset; ttype = fl.datatype; }
  }
  if (xo < 0 || yo < 0 || zo < 0) return -1;
  for (long i = 0; i < n; i++) {
    const uint8_t* p = pts + i * point_step;
    std::memcpy(xyz + 3 * i + 0, p + xo, 4);
    std::memcpy(xyz + 3 * i + 1, p + yo, 4);
    std::memcpy(xyz + 3 * i + 2, p + zo, 4);
    if (ring) {
      int32_t rv = -1;
      if (ro >= 0) {
        if (rtype == 2) rv = p[ro];                       // UINT8
        else if (rtype == 4) {                            // UINT16
          uint16_t u; std::memcpy(&u, p + ro, 2); rv = u;
        } else if (rtype == 6) {                          // UINT32
          uint32_t u; std::memcpy(&u, p + ro, 4); rv = static_cast<int32_t>(u);
        }
      }
      ring[i] = rv;
    }
    if (rel) {
      float tv = nanf("");
      if (to >= 0) {
        if (ttype == 7) std::memcpy(&tv, p + to, 4);      // FLOAT32
        else if (ttype == 8) {                            // FLOAT64
          double d; std::memcpy(&d, p + to, 8); tv = static_cast<float>(d);
        }
      }
      rel[i] = tv;
    }
  }
  return n;
}

// Read all Imu messages on a topic: t (cap), quat xyzw (cap*4),
// ang_vel (cap*3), lin_acc (cap*3).  Returns count (clipped).
long loam_bag_read_imu(void* h, const char* topic, double* t,
                       double* quat, double* ang_vel, double* lin_acc,
                       long cap) {
  Bag* bag = static_cast<Bag*>(h);
  auto it = bag->by_topic.find(topic);
  if (it == bag->by_topic.end()) return 0;
  long n = std::min<long>(it->second.size(), cap);
  for (long i = 0; i < n; i++) {
    const MessageRef& m = bag->msgs[it->second[i]];
    Cursor c{bag->buffers[m.buf].data() + m.off, m.len};
    double stamp = 0;
    skip_std_header(&c, &stamp);
    t[i] = stamp;
    for (int k = 0; k < 4; k++) quat[4 * i + k] = c.get<double>();
    c.skip(9 * 8);
    for (int k = 0; k < 3; k++) ang_vel[3 * i + k] = c.get<double>();
    c.skip(9 * 8);
    for (int k = 0; k < 3; k++) lin_acc[3 * i + k] = c.get<double>();
    if (!c.ok) return i;
  }
  return n;
}

}  // extern "C"
