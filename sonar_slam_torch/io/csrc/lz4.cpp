// LZ4 block and frame decoding and XXH32 for the host, from the public format
// specifications (LZ4 Block Format, LZ4 Frame Format v1.6, xxHash). Built at
// first use with the host C++ compiler and loaded with ctypes by
// sonar_slam_torch/io/lz4_lib.py; the pure-Python codec in io/lz4.py is the
// plain version these are held against. ROS bags recorded with
// `rosbag record --lz4` store every chunk as one LZ4 frame, and a survey's
// bag holds a gigabyte or more of pings, which Python decodes at a few MB/s.
//
// Every read and write is bounds-checked: a malformed block, a block that
// would write past its capacity, or a frame that ends early returns a
// negative code, never reads or writes out of range.

#include <cstdint>
#include <cstring>

namespace {

constexpr uint32_t FRAME_MAGIC = 0x184D2204u;
constexpr uint32_t LEGACY_MAGIC = 0x184C2102u;
constexpr int64_t LEGACY_BLOCK = int64_t(8) << 20;

// error codes returned by the frame functions (negative)
constexpr int64_t E_MALFORMED = -1;  // corrupt or truncated input
constexpr int64_t E_MAGIC = -2;      // not an LZ4 frame
constexpr int64_t E_VERSION = -3;    // frame version other than 1
constexpr int64_t E_CHECKSUM = -4;   // content checksum mismatch

uint32_t read32(const uint8_t* p) {
  // little-endian by the format; the hosts this runs on are little-endian
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

// Copies a match of ml bytes from `offset` back. When the source overlaps
// the destination (offset < ml) the bytes repeat with period `offset`: a run
// of one byte is a memset, a longer period is copied in non-overlapping
// pieces of whole periods, each as long as all that is written before it.
void copy_match(uint8_t* dst, int64_t offset, int64_t ml) {
  if (offset >= ml) {
    std::memcpy(dst, dst - offset, static_cast<size_t>(ml));
  } else if (offset == 1) {
    std::memset(dst, dst[-1], static_cast<size_t>(ml));
  } else {
    int64_t done = 0;
    while (done < ml) {
      const int64_t span = (done / offset + 1) * offset;
      const int64_t len = ml - done < span ? ml - done : span;
      std::memcpy(dst + done, dst + done - span, static_cast<size_t>(len));
      done += len;
    }
  }
}

}  // namespace

extern "C" {

// One raw LZ4 block: src[0, n) into dst[0, cap). Returns the bytes written,
// or -1 for a malformed block or an output longer than cap.
int64_t lz4_block_decode(const uint8_t* src, int64_t n, uint8_t* dst,
                         int64_t cap) {
  int64_t i = 0, o = 0;
  while (i < n) {
    const uint8_t token = src[i++];
    int64_t lit = token >> 4;
    if (lit == 15) {
      uint8_t b;
      do {
        if (i >= n) return E_MALFORMED;
        b = src[i++];
        lit += b;
      } while (b == 255);
    }
    if (lit > n - i || lit > cap - o) return E_MALFORMED;
    // short runs are copied as 16 fixed bytes where input and output have
    // room (bytes past the run are overwritten by what follows)
    if (lit <= 16 && n - i >= 16 && cap - o >= 16)
      std::memcpy(dst + o, src + i, 16);
    else
      std::memcpy(dst + o, src + i, static_cast<size_t>(lit));
    i += lit;
    o += lit;
    if (i >= n) break;  // the last sequence has literals only
    if (n - i < 2) return E_MALFORMED;
    const int64_t offset = src[i] | (static_cast<int64_t>(src[i + 1]) << 8);
    i += 2;
    if (offset == 0 || offset > o) return E_MALFORMED;
    int64_t ml = (token & 15) + 4;
    if ((token & 15) == 15) {
      uint8_t b;
      do {
        if (i >= n) return E_MALFORMED;
        b = src[i++];
        ml += b;
      } while (b == 255);
    }
    if (ml > cap - o) return E_MALFORMED;
    if (offset >= 16 && ml <= 32 && cap - o >= 32) {
      std::memcpy(dst + o, dst + o - offset, 16);
      std::memcpy(dst + o + 16, dst + o + 16 - offset, 16);
    } else {
      copy_match(dst + o, offset, ml);
    }
    o += ml;
  }
  return o;
}

// XXH32 of p[0, n) with `seed`.
uint32_t lz4_xxh32(const uint8_t* p, int64_t n, uint32_t seed) {
  const uint32_t P1 = 2654435761u, P2 = 2246822519u, P3 = 3266489917u,
                 P4 = 668265263u, P5 = 374761393u;
  const uint8_t* end = p + n;
  uint32_t h;
  if (n >= 16) {
    uint32_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
    const uint8_t* limit = end - 16;
    do {
      v1 = rotl(v1 + read32(p) * P2, 13) * P1;
      v2 = rotl(v2 + read32(p + 4) * P2, 13) * P1;
      v3 = rotl(v3 + read32(p + 8) * P2, 13) * P1;
      v4 = rotl(v4 + read32(p + 12) * P2, 13) * P1;
      p += 16;
    } while (p <= limit);
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
  } else {
    h = seed + P5;
  }
  h += static_cast<uint32_t>(n);
  while (end - p >= 4) {
    h = rotl(h + read32(p) * P3, 17) * P4;
    p += 4;
  }
  while (p < end) {
    h = rotl(h + (*p) * P5, 11) * P1;
    ++p;
  }
  h ^= h >> 15;
  h *= P2;
  h ^= h >> 13;
  h *= P3;
  h ^= h >> 16;
  return h;
}

// Decodes the LZ4 frame (or legacy frame) at src[0, n), as io/lz4.py's
// decompress_frame_plain does: the frame's blocks, each compressed block
// bounded by the descriptor's block size (8 MB in a legacy frame), block
// checksums skipped, the content checksum verified. Bytes after the frame
// are ignored. With dst null nothing is decoded and the return value is an
// upper bound of the output's size; otherwise the output goes to dst[0, cap)
// and the return value is its size. A negative return is an error code.
int64_t lz4_frame_decode(const uint8_t* src, int64_t n, uint8_t* dst,
                         int64_t cap) {
  if (n < 4) return E_MALFORMED;
  const uint32_t magic = read32(src);
  int64_t pos = 4, o = 0;
  // a compressed block of m bytes decodes to at most 255 m + 19 bytes
  auto block_bound = [](int64_t m, int64_t block_max) {
    const int64_t most = 255 * m + 19;
    return most < block_max ? most : block_max;
  };
  if (magic == LEGACY_MAGIC) {
    while (n - pos >= 4) {
      const uint32_t bsize = read32(src + pos);
      if (bsize == FRAME_MAGIC || bsize == LEGACY_MAGIC) break;
      pos += 4;
      if (bsize > n - pos) return E_MALFORMED;
      if (dst == nullptr) {
        o += block_bound(bsize, LEGACY_BLOCK);
      } else {
        const int64_t room = cap - o < LEGACY_BLOCK ? cap - o : LEGACY_BLOCK;
        const int64_t got = lz4_block_decode(src + pos, bsize, dst + o, room);
        if (got < 0) return E_MALFORMED;
        o += got;
      }
      pos += bsize;
    }
    return o;
  }
  if (magic != FRAME_MAGIC) return E_MAGIC;
  if (n - pos < 3) return E_MALFORMED;
  const uint8_t flg = src[pos];
  const uint8_t bd = src[pos + 1];
  pos += 2;
  if ((flg >> 6) != 1) return E_VERSION;
  const int bs_code = (bd >> 4) & 7;
  const int64_t block_max = int64_t(1) << (8 + 2 * (bs_code > 4 ? bs_code : 4));
  const bool block_checksum = (flg >> 4) & 1;
  const bool content_checksum = (flg >> 2) & 1;
  if ((flg >> 3) & 1) pos += 8;  // content size
  if (flg & 1) pos += 4;         // dictionary id
  pos += 1;                      // header checksum
  while (true) {
    if (n - pos < 4) return E_MALFORMED;
    uint32_t bsize = read32(src + pos);
    pos += 4;
    if (bsize == 0) break;  // end mark
    const bool raw = bsize >> 31;
    bsize &= 0x7FFFFFFFu;
    if (bsize > n - pos) return E_MALFORMED;
    if (dst == nullptr) {
      o += raw ? bsize : block_bound(bsize, block_max);
    } else if (raw) {
      if (bsize > cap - o) return E_MALFORMED;
      std::memcpy(dst + o, src + pos, bsize);
      o += bsize;
    } else {
      const int64_t room = cap - o < block_max ? cap - o : block_max;
      const int64_t got = lz4_block_decode(src + pos, bsize, dst + o, room);
      if (got < 0) return E_MALFORMED;
      o += got;
    }
    pos += bsize;
    if (block_checksum) pos += 4;
  }
  if (content_checksum) {
    if (n - pos < 4) return E_MALFORMED;
    if (dst != nullptr && lz4_xxh32(dst, o, 0) != read32(src + pos))
      return E_CHECKSUM;
  }
  return o;
}

}  // extern "C"
