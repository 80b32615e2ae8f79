// Checkpoint record log: framed, checksummed, append-only binary streams
// of per-world simulation checkpoints (the port's copy of the JAX
// package's native/ckptlog.cpp, the file format byte for byte, so a log
// written by either package reads in the other).
//
// Exposed as a C ABI for Python ctypes (marl_hideandseek_torch/utils/
// ckptlog.py), built with the host C++ compiler at first use
// (ops/build.py::load_host).
//
// File layout:
//   [Header]                         32 bytes
//   repeat: [FrameHeader][payload]   payload = num_worlds * frame_bytes
//
// All integers little-endian. Each frame header holds the CRC32C
// (Castagnoli) of its payload. A header's frame count is written on close;
// readers index the frames by scanning, so a log whose writer never
// closed (count 0) still reads.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0x4b434c48;  // "HLCK"
constexpr uint32_t kVersion = 1;

struct Header {
  uint32_t magic;
  uint32_t version;
  uint32_t num_worlds;
  uint32_t frame_bytes;   // bytes per world per frame
  uint64_t reserved;
  uint64_t num_frames;    // updated on close; 0 = unknown (scan)
};
static_assert(sizeof(Header) == 32, "header size");

struct FrameHeader {
  uint64_t frame_index;
  uint32_t payload_crc;
  uint32_t flags;
};
static_assert(sizeof(FrameHeader) == 16, "frame header size");

// CRC32C (Castagnoli), slice-by-1 table; fast enough for checkpoint sizes.
uint32_t crc_table[256];
bool crc_init_done = false;

void crc_init() {
  if (crc_init_done) return;
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++) {
      c = (c & 1) ? (0x82F63B78u ^ (c >> 1)) : (c >> 1);
    }
    crc_table[i] = c;
  }
  crc_init_done = true;
}

uint32_t crc32c(const uint8_t* data, size_t n) {
  crc_init();
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < n; i++) {
    c = crc_table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  }
  return c ^ 0xFFFFFFFFu;
}

struct Writer {
  FILE* f = nullptr;
  Header hdr{};
  uint64_t frames = 0;
};

struct Reader {
  FILE* f = nullptr;
  Header hdr{};
  uint64_t frames = 0;
  std::vector<uint64_t> offsets;  // frame index -> file offset of payload
};

}  // namespace

extern "C" {

// ---- writer ---------------------------------------------------------------

void* ckptlog_create(const char* path, uint32_t num_worlds,
                     uint32_t frame_bytes) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return nullptr;
  auto* w = new Writer();
  w->f = f;
  w->hdr = Header{kMagic, kVersion, num_worlds, frame_bytes, 0, 0};
  if (std::fwrite(&w->hdr, sizeof(Header), 1, f) != 1) {
    std::fclose(f);
    delete w;
    return nullptr;
  }
  return w;
}

// Append one frame: data is num_worlds * frame_bytes bytes.
int ckptlog_append(void* handle, const uint8_t* data) {
  auto* w = static_cast<Writer*>(handle);
  if (!w || !w->f) return -1;
  size_t n = size_t(w->hdr.num_worlds) * w->hdr.frame_bytes;
  FrameHeader fh{w->frames, crc32c(data, n), 0};
  if (std::fwrite(&fh, sizeof(fh), 1, w->f) != 1) return -2;
  if (std::fwrite(data, 1, n, w->f) != n) return -3;
  w->frames++;
  return 0;
}

int ckptlog_close_writer(void* handle) {
  auto* w = static_cast<Writer*>(handle);
  if (!w) return -1;
  // Patch the frame count into the header.
  w->hdr.num_frames = w->frames;
  std::fseek(w->f, 0, SEEK_SET);
  std::fwrite(&w->hdr, sizeof(Header), 1, w->f);
  std::fclose(w->f);
  delete w;
  return 0;
}

// ---- reader ---------------------------------------------------------------

void* ckptlog_open(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  auto* r = new Reader();
  r->f = f;
  if (std::fread(&r->hdr, sizeof(Header), 1, f) != 1 ||
      r->hdr.magic != kMagic || r->hdr.version != kVersion) {
    std::fclose(f);
    delete r;
    return nullptr;
  }
  // Index the frames (streamed logs may lack a trailing count).
  size_t payload = size_t(r->hdr.num_worlds) * r->hdr.frame_bytes;
  long off = sizeof(Header);
  for (;;) {
    FrameHeader fh;
    if (std::fseek(f, off, SEEK_SET) != 0) break;
    if (std::fread(&fh, sizeof(fh), 1, f) != 1) break;
    r->offsets.push_back(uint64_t(off) + sizeof(fh));
    off += long(sizeof(fh) + payload);
  }
  r->frames = r->offsets.size();
  return r;
}

uint64_t ckptlog_num_frames(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  return r ? r->frames : 0;
}

uint32_t ckptlog_num_worlds(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  return r ? r->hdr.num_worlds : 0;
}

uint32_t ckptlog_frame_bytes(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  return r ? r->hdr.frame_bytes : 0;
}

// Read frame `idx` into out (num_worlds * frame_bytes bytes).
// Returns 0 on success, -2 on CRC mismatch.
int ckptlog_read(void* handle, uint64_t idx, uint8_t* out) {
  auto* r = static_cast<Reader*>(handle);
  if (!r || idx >= r->frames) return -1;
  size_t n = size_t(r->hdr.num_worlds) * r->hdr.frame_bytes;
  FrameHeader fh;
  std::fseek(r->f, long(r->offsets[idx] - sizeof(FrameHeader)), SEEK_SET);
  if (std::fread(&fh, sizeof(fh), 1, r->f) != 1) return -1;
  if (std::fread(out, 1, n, r->f) != n) return -1;
  if (crc32c(out, n) != fh.payload_crc) return -2;
  return 0;
}

// CRC32C of n bytes (the frames' checksum).
uint32_t ckptlog_crc32c(const uint8_t* data, uint64_t n) {
  return crc32c(data, size_t(n));
}

int ckptlog_close_reader(void* handle) {
  auto* r = static_cast<Reader*>(handle);
  if (!r) return -1;
  std::fclose(r->f);
  delete r;
  return 0;
}

}  // extern "C"
