// The record engine of mxnet_tpu_torch.recordio: packed record files in
// dmlc-core's RecordIO framing, behind a plain C interface (ctypes).
//
// A frame is the magic 0xced7230a, a little-endian word holding a
// continuation flag in its top 3 bits and the payload length in the low
// 29, then the payload padded with zeros to a multiple of 4 bytes.  A
// record longer than 2^29 - 1 bytes spans frames flagged 1 (first), 2
// (middle) and 3 (last); a record of one frame is flagged 0.  The reader
// joins the frames of a record and refuses a file that breaks the
// framing (a truncated header or payload, a wrong magic, a continuation
// flag out of order) with -1, leaving the caller to resynchronize.
//
// Build: g++ -O2 -fPIC -std=c++17 -Wall -shared -o librecordio.so
// recordio.cc (mxnet_tpu_torch/_build.py:build_recordio does it at first
// use).
#include <sys/stat.h>

#include <cstdint>
#include <cstdio>
#include <string>
#include <vector>

namespace {

constexpr uint32_t kMagic = 0xced7230aU;
constexpr uint32_t kLenMask = (1U << 29) - 1;
constexpr size_t kBufferBytes = 1 << 20;

void PutWord(unsigned char* out, uint32_t v) {
  out[0] = static_cast<unsigned char>(v);
  out[1] = static_cast<unsigned char>(v >> 8);
  out[2] = static_cast<unsigned char>(v >> 16);
  out[3] = static_cast<unsigned char>(v >> 24);
}

uint32_t GetWord(const unsigned char* in) {
  return static_cast<uint32_t>(in[0]) | (static_cast<uint32_t>(in[1]) << 8) |
         (static_cast<uint32_t>(in[2]) << 16) |
         (static_cast<uint32_t>(in[3]) << 24);
}

struct Writer {
  FILE* fp = nullptr;
  std::vector<char> buffer;
  long pos = 0;  // bytes written: the offset of the next record

  bool Put(const void* data, size_t n) {
    if (n == 0) return true;
    if (std::fwrite(data, 1, n, fp) != n) return false;
    pos += static_cast<long>(n);
    return true;
  }
};

struct Reader {
  FILE* fp = nullptr;
  std::vector<char> buffer;
  std::string record;  // the last record read; valid until the next read
  long pos = 0;        // the offset of the next byte to read
  long size = 0;       // the file's size when last looked at

  size_t Get(void* out, size_t n) {
    const size_t got = std::fread(out, 1, n, fp);
    pos += static_cast<long>(got);
    return got;
  }

  // Whether n more bytes follow the current position (a corrupt length
  // must not allocate half a gigabyte); the size is looked up again
  // before saying no, for a file that grew.
  bool Holds(size_t n) {
    if (pos <= size && static_cast<size_t>(size - pos) >= n) return true;
    struct stat st;
    if (fstat(fileno(fp), &st) != 0) return false;
    size = static_cast<long>(st.st_size);
    return pos <= size && static_cast<size_t>(size - pos) >= n;
  }
};

}  // namespace

extern "C" {

void* MXTRecordIOWriterCreate(const char* uri) {
  FILE* fp = std::fopen(uri, "wb");
  if (fp == nullptr) return nullptr;
  Writer* w = new Writer();
  w->fp = fp;
  w->buffer.resize(kBufferBytes);
  std::setvbuf(fp, w->buffer.data(), _IOFBF, w->buffer.size());
  return w;
}

// Frames one record; 0 on success, -1 on a write error.
int MXTRecordIOWriterWriteRecord(void* handle, const char* buf,
                                 size_t size) {
  Writer* w = static_cast<Writer*>(handle);
  static const char kZeros[4] = {0, 0, 0, 0};
  size_t off = 0;
  bool first = true;
  while (true) {
    size_t chunk = size - off;
    const bool last = chunk <= kLenMask;
    if (!last) chunk = kLenMask;
    const uint32_t cflag = first ? (last ? 0U : 1U) : (last ? 3U : 2U);
    unsigned char head[8];
    PutWord(head, kMagic);
    PutWord(head + 4, (cflag << 29) | static_cast<uint32_t>(chunk));
    if (!w->Put(head, sizeof(head)) || !w->Put(buf + off, chunk)) return -1;
    const size_t pad = (4 - (chunk & 3)) & 3;
    if (!w->Put(kZeros, pad)) return -1;
    off += chunk;
    first = false;
    if (off >= size) return 0;
  }
}

long MXTRecordIOWriterTell(void* handle) {
  return static_cast<Writer*>(handle)->pos;
}

void MXTRecordIOWriterFree(void* handle) {
  Writer* w = static_cast<Writer*>(handle);
  if (w == nullptr) return;
  std::fclose(w->fp);
  delete w;
}

void* MXTRecordIOReaderCreate(const char* uri) {
  FILE* fp = std::fopen(uri, "rb");
  if (fp == nullptr) return nullptr;
  Reader* r = new Reader();
  r->fp = fp;
  r->buffer.resize(kBufferBytes);
  std::setvbuf(fp, r->buffer.data(), _IOFBF, r->buffer.size());
  return r;
}

// The next record: 0 with *out/*size set (the bytes stay valid until the
// next call), 1 at a clean end of file, -1 on a framing error.
int MXTRecordIOReaderReadRecord(void* handle, const char** out,
                                size_t* size) {
  Reader* r = static_cast<Reader*>(handle);
  r->record.clear();
  bool in_multi = false;
  while (true) {
    unsigned char head[8];
    const size_t got = r->Get(head, sizeof(head));
    if (got == 0 && !in_multi) return 1;
    if (got != sizeof(head)) return -1;
    if (GetWord(head) != kMagic) return -1;
    const uint32_t lrec = GetWord(head + 4);
    const uint32_t cflag = lrec >> 29;
    const size_t length = lrec & kLenMask;
    if (!r->Holds(length)) return -1;
    const size_t start = r->record.size();
    r->record.resize(start + length);
    if (length != 0 && r->Get(&r->record[start], length) != length) {
      return -1;
    }
    const size_t pad = (4 - (length & 3)) & 3;
    if (pad != 0) {
      char skip[4];
      // a file may end inside the padding of its last frame
      r->Get(skip, pad);
    }
    if (cflag == 0 && !in_multi) break;
    if (cflag == 1 && !in_multi) {
      in_multi = true;
      continue;
    }
    if (cflag == 2 && in_multi) continue;
    if (cflag == 3 && in_multi) break;
    return -1;
  }
  *out = r->record.data();
  *size = r->record.size();
  return 0;
}

int MXTRecordIOReaderSeek(void* handle, long pos) {
  Reader* r = static_cast<Reader*>(handle);
  if (pos < 0 || std::fseek(r->fp, pos, SEEK_SET) != 0) return -1;
  r->pos = pos;
  return 0;
}

long MXTRecordIOReaderTell(void* handle) {
  return static_cast<Reader*>(handle)->pos;
}

void MXTRecordIOReaderFree(void* handle) {
  Reader* r = static_cast<Reader*>(handle);
  if (r == nullptr) return;
  std::fclose(r->fp);
  delete r;
}

}  // extern "C"
