// modelx_io: the native IO engine of modelx_tpu_torch (host C++, not a
// CUDA kernel). The port's own copy of modelx_tpu/native/modelx_io.cc: the
// byte-moving hot loops of the registry -> card path, each callable with
// the GIL released so the loader's fetch threads, the pusher's hashing and
// the host quantizer stop contending with the thread that issues the
// host-to-device copies:
//
//   - mx_pread_fd / mx_pread_scatter : positional file reads into caller
//                                      buffers (scatter: parallel)
//   - mx_sha256_file / mx_sha256_buf : streaming sha256 (libcrypto EVP via
//                                      dlopen when available; portable
//                                      fallback otherwise)
//   - mx_http_*                      : raw-socket HTTP/1.1 ranged GETs with
//                                      keep-alive, the body read straight
//                                      into the caller's buffer
//   - mx_quantize_rows               : rowwise int8 quantization (absmax ->
//                                      scale -> round half to even),
//                                      threaded; f32, bf16 and f16 rows
//
// Bound with ctypes by modelx_tpu_torch/native/__init__.py, which builds it
// on first use: g++ -O3 -shared -fPIC -pthread -o libmodelx_io.so
// modelx_io.cc -ldl

#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <dlfcn.h>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <string>
#include <sys/socket.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

extern "C" {

typedef struct {
  int64_t offset;
  int64_t length;
  void *buf;
} MxRange;

// ---------------------------------------------------------------------------
// parallel positional file reads
// ---------------------------------------------------------------------------

// Single positional read on an already-open fd (no thread, no open()).
// Returns 0 on success, -errno / -EIO on short file.
int mx_pread_fd(int fd, int64_t offset, int64_t length, void *buf) {
  int64_t done = 0;
  while (done < length) {
    ssize_t got = pread(fd, (char *)buf + done, (size_t)(length - done),
                        (off_t)(offset + done));
    if (got < 0) {
      if (errno == EINTR) continue;
      return -errno;
    }
    if (got == 0) return -EIO;  // short file
    done += got;
  }
  return 0;
}

// Reads every range of `path` into its buffer using `threads` workers.
// Returns 0 on success, -errno on the first failure.
int mx_pread_scatter(const char *path, const MxRange *ranges, int n,
                     int threads) {
  if (n <= 0) return 0;
  if (threads < 1) threads = 1;
  if (threads > n) threads = n;
  std::vector<std::thread> pool;
  std::vector<int> errs(threads, 0);
  for (int t = 0; t < threads; t++) {
    pool.emplace_back([&, t]() {
      int fd = open(path, O_RDONLY);
      if (fd < 0) {
        errs[t] = -errno;
        return;
      }
      for (int i = t; i < n; i += threads) {
        int64_t done = 0;
        while (done < ranges[i].length) {
          ssize_t got = pread(fd, (char *)ranges[i].buf + done,
                              (size_t)(ranges[i].length - done),
                              (off_t)(ranges[i].offset + done));
          if (got < 0) {
            if (errno == EINTR) continue;
            errs[t] = -errno;
            close(fd);
            return;
          }
          if (got == 0) {
            errs[t] = -EIO;  // short file
            close(fd);
            return;
          }
          done += got;
        }
      }
      close(fd);
    });
  }
  for (auto &th : pool) th.join();
  for (int e : errs)
    if (e) return e;
  return 0;
}

// ---------------------------------------------------------------------------
// sha256: libcrypto EVP via dlopen, portable fallback
// ---------------------------------------------------------------------------

namespace {

// portable scalar sha256 (FIPS 180-4), used only when libcrypto is absent
struct Sha256 {
  uint32_t h[8];
  uint64_t len = 0;
  uint8_t block[64];
  size_t fill = 0;

  Sha256() {
    static const uint32_t init[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372,
                                     0xa54ff53a, 0x510e527f, 0x9b05688c,
                                     0x1f83d9ab, 0x5be0cd19};
    memcpy(h, init, sizeof(h));
  }

  static uint32_t rotr(uint32_t x, int n) { return (x >> n) | (x << (32 - n)); }

  void compress(const uint8_t *p) {
    static const uint32_t K[64] = {
        0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
        0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
        0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
        0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
        0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
        0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
        0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
        0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
        0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
        0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
        0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};
    uint32_t w[64];
    for (int i = 0; i < 16; i++)
      w[i] = (uint32_t)p[4 * i] << 24 | (uint32_t)p[4 * i + 1] << 16 |
             (uint32_t)p[4 * i + 2] << 8 | p[4 * i + 3];
    for (int i = 16; i < 64; i++) {
      uint32_t s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
      uint32_t s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
      w[i] = w[i - 16] + s0 + w[i - 7] + s1;
    }
    uint32_t a = h[0], b = h[1], c = h[2], d = h[3], e = h[4], f = h[5],
             g = h[6], hh = h[7];
    for (int i = 0; i < 64; i++) {
      uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
      uint32_t ch = (e & f) ^ (~e & g);
      uint32_t t1 = hh + S1 + ch + K[i] + w[i];
      uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
      uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
      uint32_t t2 = S0 + maj;
      hh = g;
      g = f;
      f = e;
      e = d + t1;
      d = c;
      c = b;
      b = a;
      a = t1 + t2;
    }
    h[0] += a;
    h[1] += b;
    h[2] += c;
    h[3] += d;
    h[4] += e;
    h[5] += f;
    h[6] += g;
    h[7] += hh;
  }

  void update(const uint8_t *p, size_t n) {
    len += n;
    if (fill) {
      size_t take = 64 - fill < n ? 64 - fill : n;
      memcpy(block + fill, p, take);
      fill += take;
      p += take;
      n -= take;
      if (fill == 64) {
        compress(block);
        fill = 0;
      }
    }
    while (n >= 64) {
      compress(p);
      p += 64;
      n -= 64;
    }
    if (n) {
      memcpy(block, p, n);
      fill = n;
    }
  }

  void final(uint8_t out[32]) {
    uint64_t bits = len * 8;
    uint8_t pad = 0x80;
    update(&pad, 1);
    uint8_t zero = 0;
    while (fill != 56) update(&zero, 1);
    uint8_t lenb[8];
    for (int i = 0; i < 8; i++) lenb[i] = (uint8_t)(bits >> (56 - 8 * i));
    update(lenb, 8);
    for (int i = 0; i < 8; i++) {
      out[4 * i] = (uint8_t)(h[i] >> 24);
      out[4 * i + 1] = (uint8_t)(h[i] >> 16);
      out[4 * i + 2] = (uint8_t)(h[i] >> 8);
      out[4 * i + 3] = (uint8_t)h[i];
    }
  }
};

// libcrypto EVP, loaded lazily; all pointers null if unavailable
struct Evp {
  void *(*MD_CTX_new)();
  void (*MD_CTX_free)(void *);
  const void *(*sha256)();
  int (*DigestInit_ex)(void *, const void *, void *);
  int (*DigestUpdate)(void *, const void *, size_t);
  int (*DigestFinal_ex)(void *, unsigned char *, unsigned int *);
  bool ok = false;
};

Evp *evp() {
  static Evp e;
  static bool tried = false;
  if (!tried) {
    tried = true;
    const char *names[] = {"libcrypto.so.3", "libcrypto.so.1.1", "libcrypto.so"};
    void *lib = nullptr;
    for (const char *n : names)
      if ((lib = dlopen(n, RTLD_NOW | RTLD_GLOBAL))) break;
    if (lib) {
      e.MD_CTX_new = (void *(*)())dlsym(lib, "EVP_MD_CTX_new");
      e.MD_CTX_free = (void (*)(void *))dlsym(lib, "EVP_MD_CTX_free");
      e.sha256 = (const void *(*)())dlsym(lib, "EVP_sha256");
      e.DigestInit_ex =
          (int (*)(void *, const void *, void *))dlsym(lib, "EVP_DigestInit_ex");
      e.DigestUpdate =
          (int (*)(void *, const void *, size_t))dlsym(lib, "EVP_DigestUpdate");
      e.DigestFinal_ex = (int (*)(void *, unsigned char *, unsigned int *))dlsym(
          lib, "EVP_DigestFinal_ex");
      e.ok = e.MD_CTX_new && e.MD_CTX_free && e.sha256 && e.DigestInit_ex &&
             e.DigestUpdate && e.DigestFinal_ex;
    }
  }
  return &e;
}

void to_hex(const uint8_t d[32], char out[65]) {
  static const char *hex = "0123456789abcdef";
  for (int i = 0; i < 32; i++) {
    out[2 * i] = hex[d[i] >> 4];
    out[2 * i + 1] = hex[d[i] & 0xf];
  }
  out[64] = 0;
}

}  // namespace

// Streaming sha256 of a whole file. Returns 0 and writes 64 hex chars +
// NUL into out_hex, or -errno.
int mx_sha256_file(const char *path, char *out_hex) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -errno;
  posix_fadvise(fd, 0, 0, POSIX_FADV_SEQUENTIAL);
  const size_t CH = 4 << 20;
  std::vector<uint8_t> buf(CH);
  uint8_t digest[32];
  Evp *e = evp();
  if (e->ok) {
    void *ctx = e->MD_CTX_new();
    e->DigestInit_ex(ctx, e->sha256(), nullptr);
    ssize_t got;
    while ((got = read(fd, buf.data(), CH)) > 0)
      e->DigestUpdate(ctx, buf.data(), (size_t)got);
    unsigned int dlen = 32;
    e->DigestFinal_ex(ctx, digest, &dlen);
    e->MD_CTX_free(ctx);
    if (got < 0) {
      int err = errno;  // close() may clobber errno
      close(fd);
      return -err;
    }
  } else {
    Sha256 s;
    ssize_t got;
    while ((got = read(fd, buf.data(), CH)) > 0) s.update(buf.data(), (size_t)got);
    if (got < 0) {
      int err = errno;
      close(fd);
      return -err;
    }
    s.final(digest);
  }
  close(fd);
  to_hex(digest, out_hex);
  return 0;
}

// sha256 of a memory buffer (used for in-memory manifests/blobs).
int mx_sha256_buf(const void *data, int64_t n, char *out_hex) {
  uint8_t digest[32];
  Evp *e = evp();
  if (e->ok) {
    void *ctx = e->MD_CTX_new();
    e->DigestInit_ex(ctx, e->sha256(), nullptr);
    e->DigestUpdate(ctx, data, (size_t)n);
    unsigned int dlen = 32;
    e->DigestFinal_ex(ctx, digest, &dlen);
    e->MD_CTX_free(ctx);
  } else {
    Sha256 s;
    s.update((const uint8_t *)data, (size_t)n);
    s.final(digest);
  }
  to_hex(digest, out_hex);
  return 0;
}

// ---------------------------------------------------------------------------
// raw-socket HTTP/1.1 ranged GET with keep-alive
// ---------------------------------------------------------------------------

struct MxConn {
  int fd = -1;
  std::string host;  // for reconnects
  int port = 0;
  int timeout_ms = 0;
};

namespace {

int dial(const char *host, int port, int timeout_ms) {
  struct addrinfo hints, *res = nullptr;
  memset(&hints, 0, sizeof(hints));
  hints.ai_family = AF_UNSPEC;
  hints.ai_socktype = SOCK_STREAM;
  char portstr[16];
  snprintf(portstr, sizeof(portstr), "%d", port);
  if (getaddrinfo(host, portstr, &hints, &res) != 0 || !res) return -1;
  int fd = -1;
  for (struct addrinfo *ai = res; ai; ai = ai->ai_next) {
    fd = socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
    if (fd < 0) continue;
    struct timeval tv;
    tv.tv_sec = timeout_ms / 1000;
    tv.tv_usec = (timeout_ms % 1000) * 1000;
    setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
    int one = 1;
    setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    if (connect(fd, ai->ai_addr, ai->ai_addrlen) == 0) break;
    close(fd);
    fd = -1;
  }
  freeaddrinfo(res);
  return fd;
}

int send_all(int fd, const char *p, size_t n) {
  while (n) {
    ssize_t s = send(fd, p, n, MSG_NOSIGNAL);
    if (s < 0) {
      if (errno == EINTR) continue;
      return -1;
    }
    p += s;
    n -= (size_t)s;
  }
  return 0;
}

}  // namespace

MxConn *mx_http_connect(const char *host, int port, int timeout_ms) {
  int fd = dial(host, port, timeout_ms);
  if (fd < 0) return nullptr;
  MxConn *c = new MxConn();
  c->fd = fd;
  c->host = host;
  c->port = port;
  c->timeout_ms = timeout_ms;
  return c;
}

void mx_http_close(MxConn *c) {
  if (!c) return;
  if (c->fd >= 0) close(c->fd);
  delete c;
}

// GET `path` with Range: bytes=offset..offset+length-1; body lands in buf.
// `headers` is a preformatted "K: v\r\n..." block (may be empty/NULL).
// Returns HTTP status (200/206 on success with exactly `length` body bytes),
// or a negative error: -1 connect/send, -2 malformed response, -3 short
// body, -4 status parsed but body length mismatch, -5 response body larger
// than buffer. Reconnects once on a stale keep-alive socket.
int mx_http_get_range(MxConn *c, const char *host_hdr, const char *path,
                      const char *headers, int64_t offset, int64_t length,
                      void *buf) {
  if (!c) return -1;
  if (c->fd < 0) {
    // previous request left the connection unreusable; redial
    c->fd = dial(c->host.c_str(), c->port, c->timeout_ms);
    if (c->fd < 0) return -1;
  }
  char req[8192];
  int rn = snprintf(req, sizeof(req),
                    "GET %s HTTP/1.1\r\nHost: %s\r\nRange: bytes=%lld-%lld\r\n"
                    "Connection: keep-alive\r\n%s\r\n",
                    path, host_hdr, (long long)offset,
                    (long long)(offset + length - 1), headers ? headers : "");
  if (rn <= 0 || rn >= (int)sizeof(req)) return -2;

  for (int attempt = 0; attempt < 2; attempt++) {
    if (attempt == 1) {
      // stale keep-alive: reconnect once
      close(c->fd);
      c->fd = dial(c->host.c_str(), c->port, c->timeout_ms);
      if (c->fd < 0) return -1;
    }
    if (send_all(c->fd, req, (size_t)rn) != 0) continue;

    // read the header block
    char hdr[16384];
    size_t hn = 0;
    char *body = nullptr;
    size_t body_in_hdr = 0;
    bool broken = false;
    while (hn < sizeof(hdr) - 1) {
      ssize_t got = recv(c->fd, hdr + hn, sizeof(hdr) - 1 - hn, 0);
      if (got <= 0) {
        broken = true;
        break;
      }
      hn += (size_t)got;
      hdr[hn] = 0;
      if ((body = strstr(hdr, "\r\n\r\n"))) {
        body += 4;
        body_in_hdr = hn - (size_t)(body - hdr);
        break;
      }
    }
    if (broken || !body) {
      if (attempt == 0) continue;  // retry once on a fresh connection
      return -2;
    }

    int status = 0;
    if (sscanf(hdr, "HTTP/%*d.%*d %d", &status) != 1) return -2;
    int64_t clen = -1;
    // case-insensitive Content-Length scan, anchored to line starts so a
    // header like X-Content-Length can't match
    for (char *p = strstr(hdr, "\r\n"); p && p < body - 4;
         p = strstr(p + 2, "\r\n")) {
      if (strncasecmp(p + 2, "content-length:", 15) == 0) {
        clen = atoll(p + 17);
        break;
      }
    }
    if (status != 200 && status != 206) {
      // drain the error body so keep-alive survives; if its length is
      // unknown (chunked) the connection can't be reused — drop it and let
      // the next call redial
      if (clen >= 0) {
        int64_t remain = clen - (int64_t)body_in_hdr;
        while (remain > 0) {
          ssize_t got = recv(c->fd, hdr, sizeof(hdr) < (size_t)remain
                                             ? sizeof(hdr)
                                             : (size_t)remain, 0);
          if (got <= 0) {
            close(c->fd);
            c->fd = -1;
            break;
          }
          remain -= got;
        }
      } else {
        close(c->fd);
        c->fd = -1;
      }
      return status;
    }
    if (clen != length) return status == 200 ? -5 : -4;

    // body: copy what already arrived, then read the rest straight into buf
    if (body_in_hdr > (size_t)length) return -5;
    memcpy(buf, body, body_in_hdr);
    int64_t done = (int64_t)body_in_hdr;
    while (done < length) {
      ssize_t got = recv(c->fd, (char *)buf + done, (size_t)(length - done), 0);
      if (got <= 0) return -3;
      done += got;
    }
    return status;
  }
  return -1;
}

// ---------------------------------------------------------------------------
// fused weight-only int8 quantization (rowwise symmetric)
// ---------------------------------------------------------------------------
//
// ops/quant.py's host rule (channel_scales + quantize_rows) as ONE fused
// pass per row: absmax -> scale -> round-to-int8, GIL-free and threaded,
// numerically identical to the numpy rule (f32 reciprocal, round half to
// even, scale computed in double like numpy's f64 divide + f32 cast).

namespace {

inline float bf16_to_f32(uint16_t h) {
  uint32_t bits = (uint32_t)h << 16;
  float f;
  memcpy(&f, &bits, 4);
  return f;
}

// Round-to-nearest-even for |v| <= 127 without libm (nearbyintf is an
// out-of-line call on baseline x86-64, which keeps the loop scalar): adding
// 1.5*2^23 pushes the value's fraction bits out of the f32 mantissa, so the
// hardware's default round-half-even does the rounding. Exactly matches
// np.rint on the clamped range.
inline float round_half_even_small(float v) {
  const float magic = 12582912.0f;  // 1.5 * 2^23
  return (v + magic) - magic;
}

// numpy-parity quantize of one f32 value: clip(rint(v), -127, 127). Clamp
// first (identical results on the clamped range, and safe for inf/huge).
inline int8_t quant1(float v) {
  v = v > 127.f ? 127.f : (v < -127.f ? -127.f : v);
  return (int8_t)round_half_even_small(v);
}

inline float f16_to_f32(uint16_t h) {
  uint32_t sign = (uint32_t)(h & 0x8000) << 16;
  uint32_t exp = (h >> 10) & 0x1f;
  uint32_t man = h & 0x3ff;
  uint32_t bits;
  if (exp == 0) {
    if (man == 0) {
      bits = sign;
    } else {  // subnormal: renormalize
      int shift = 0;
      while (!(man & 0x400)) {
        man <<= 1;
        shift++;
      }
      man &= 0x3ff;
      bits = sign | ((uint32_t)(113 - shift) << 23) | (man << 13);
    }
  } else if (exp == 0x1f) {  // inf/nan
    bits = sign | 0x7f800000 | (man << 13);
  } else {
    bits = sign | ((exp + 112) << 23) | (man << 13);
  }
  float f;
  memcpy(&f, &bits, 4);
  return f;
}

}  // namespace

// Rowwise symmetric int8 quantization over an [rows, cols] C-contiguous
// weight. dtype: 0 = float32, 1 = bfloat16, 2 = float16 (raw uint16 bits).
//
//   scales_in  != NULL: quantize with the caller's per-row scales
//                       (sharded loads whose scales span the full axis);
//   scales_in  == NULL: compute scales (absmax/127, 1.0 for all-zero rows)
//                       into scales_out (required in that case);
//   q_out      == NULL: scales-only pass (native channel_scales).
//
// Returns 0, or -EINVAL on bad arguments. Caller may invoke with the GIL
// released; `threads` workers split the rows.
int mx_quantize_rows(const void *in, int dtype, int64_t rows, int64_t cols,
                     const float *scales_in, float *scales_out, int8_t *q_out,
                     int threads) {
  if (dtype < 0 || dtype > 2 || rows < 0 || cols < 0) return -EINVAL;
  if (!scales_in && !scales_out) return -EINVAL;
  if (!in && rows * cols > 0) return -EINVAL;
  if (rows == 0 || cols == 0) return 0;
  if (threads < 1) threads = 1;
  if ((int64_t)threads > rows) threads = (int)rows;

  auto run_rows = [&](int64_t lo, int64_t hi) {
    const size_t elem = dtype == 0 ? 4 : 2;
    for (int64_t r = lo; r < hi; r++) {
      const char *rp = (const char *)in + (size_t)r * (size_t)cols * elem;
      float scale;
      if (scales_in) {
        scale = scales_in[r];
      } else {
        float amax = 0.f;
        if (dtype == 0) {
          const float *p = (const float *)rp;
          for (int64_t c = 0; c < cols; c++) {
            float a = fabsf(p[c]);
            if (a > amax) amax = a;
          }
        } else if (dtype == 1) {
          // |bf16| compares as its magnitude bits (sign-magnitude order)
          const uint16_t *p = (const uint16_t *)rp;
          uint16_t mbits = 0;
          for (int64_t c = 0; c < cols; c++) {
            uint16_t b = (uint16_t)(p[c] & 0x7fff);
            if (b > mbits) mbits = b;
          }
          amax = bf16_to_f32(mbits);
        } else {
          const uint16_t *p = (const uint16_t *)rp;
          for (int64_t c = 0; c < cols; c++) {
            float a = fabsf(f16_to_f32(p[c]));
            if (a > amax) amax = a;
          }
        }
        // numpy parity: f64 divide then f32 cast (quant.channel_scales)
        scale = (float)((double)amax / 127.0 + (amax == 0.f ? 1.0 : 0.0));
        scales_out[r] = scale;
      }
      if (!q_out) continue;
      int8_t *qp = q_out + (size_t)r * (size_t)cols;
      // multiply by the f32 reciprocal + round-half-even: bit-identical to
      // the numpy fallback (which computes the same f32 reciprocal), and
      // ~20% faster than a vectorized divide on the load path's critical
      // core. The branch-free helpers keep the loops vectorizable.
      float inv = 1.0f / scale;
      if (dtype == 0) {
        const float *p = (const float *)rp;
        for (int64_t c = 0; c < cols; c++) qp[c] = quant1(p[c] * inv);
      } else if (dtype == 1) {
        const uint16_t *p = (const uint16_t *)rp;
        for (int64_t c = 0; c < cols; c++)
          qp[c] = quant1(bf16_to_f32(p[c]) * inv);
      } else {
        const uint16_t *p = (const uint16_t *)rp;
        for (int64_t c = 0; c < cols; c++)
          qp[c] = quant1(f16_to_f32(p[c]) * inv);
      }
    }
  };

  if (threads == 1) {
    run_rows(0, rows);
    return 0;
  }
  std::vector<std::thread> pool;
  for (int t = 0; t < threads; t++) {
    int64_t lo = rows * t / threads;
    int64_t hi = rows * (t + 1) / threads;
    pool.emplace_back(run_rows, lo, hi);
  }
  for (auto &th : pool) th.join();
  return 0;
}

}  // extern "C"
