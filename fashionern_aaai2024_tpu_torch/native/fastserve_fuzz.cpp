// Adversarial drive for the port's HTTP front, native/fastserve.cpp
// (JAX counterpart: fashionern_aaai2024_tpu/native/fastserve_fuzz.cpp,
// kept as it is: the port's front has the same C interface).
//
// Embeds the real server (fs_create/fs_listen), runs the device-thread
// protocol stub (fs_next_batch -> synthetic top-k -> fs_complete_batch,
// with periodic fs_fail_batch), and attacks the socket with:
//   * a committed regression corpus (argv dirs of raw request files)
//   * generated hostile traffic: truncated requests/bodies, random
//     bytes, header floods, deep/degenerate JSON, invalid UTF-8 and
//     lone-surrogate captions, mismatched content-length, pipelining,
//     chunked encoding, slow byte-at-a-time writers, mid-request
//     disconnects
//   * an fs_set_names swap thread racing live queries (the /add
//     name-table race; the TSAN target)
//
// Exit 0 = the server answered a well-formed control query correctly
// after every attack wave and no sanitizer fired. Built with g++ and run
// by tests/test_torch_native_serve.py (ASAN+UBSAN and TSAN legs).
// It includes the port's fastserve.cpp, and through it the port's BPE
// core (fasttokenizer.cpp).
//
// Usage: fastserve_fuzz [iterations] [corpus_dir ...]

#include "fastserve.cpp"

#include <csignal>
#include <dirent.h>
#include <poll.h>

#include <cstdio>
#include <fstream>
#include <random>
#include <sstream>

namespace {

struct Rng {
  std::mt19937_64 g;
  explicit Rng(uint64_t seed) : g(seed) {}
  uint64_t u(uint64_t n) { return g() % n; }
  bool chance(double p) {
    return std::uniform_real_distribution<double>(0, 1)(g) < p;
  }
};

// ---------------------------------------------------------------- stub
// The Python device thread's protocol, minus the model: drain batches, return
// deterministic scores/indices. ~1% of batches fail (the dispatch-error
// path), exercising fs_fail_batch's group teardown under load.
void device_stub(void* h, int max_batch, int ctx, int k_max,
                 std::atomic<bool>* stop, std::atomic<long>* batches) {
  std::vector<int32_t> ids(static_cast<size_t>(max_batch) * static_cast<size_t>(ctx));
  std::vector<int32_t> rows(static_cast<size_t>(max_batch));
  std::vector<int32_t> ks(static_cast<size_t>(max_batch));
  std::vector<int8_t> fallback(static_cast<size_t>(max_batch));
  std::vector<char> capbuf(size_t(max_batch) * fserve::kMaxCaption);
  std::vector<int64_t> capoff(size_t(max_batch) + 1);
  std::vector<float> scores(size_t(max_batch) * size_t(k_max));
  std::vector<int32_t> idx(size_t(max_batch) * size_t(k_max));
  long n_done = 0;
  while (true) {
    int32_t n = 0;
    int64_t bid = fs_next_batch(h, ids.data(), rows.data(), ks.data(),
                                fallback.data(), capbuf.data(),
                                int64_t(capbuf.size()), capoff.data(), &n);
    if (bid == 0) break;  // shutdown
    if (++n_done % 97 == 0) {
      fs_fail_batch(h, bid, "synthetic dispatch failure");
    } else {
      for (int i = 0; i < n; i++)
        for (int j = 0; j < k_max; j++) {
          scores[size_t(i) * size_t(k_max) + size_t(j)] =
              1.0f - 0.01f * float(j);
          idx[size_t(i) * size_t(k_max) + size_t(j)] =
              (rows[size_t(i)] + j) % 7;  // gallery of 7 names
        }
      fs_complete_batch(h, bid, scores.data(), idx.data(), n, k_max);
    }
    batches->fetch_add(1);
    if (stop->load() && n == 0) break;
  }
}

// -------------------------------------------------------------- client
int dial(int port, int timeout_ms = 5000) {
  int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  timeval tv{timeout_ms / 1000, (timeout_ms % 1000) * 1000};
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof tv);
  setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof tv);
  sockaddr_in a{};
  a.sin_family = AF_INET;
  a.sin_port = htons(uint16_t(port));
  inet_pton(AF_INET, "127.0.0.1", &a.sin_addr);
  if (connect(fd, (sockaddr*)&a, sizeof a) < 0) {
    close(fd);
    return -1;
  }
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
  return fd;
}

bool send_all(int fd, const std::string& data) {
  size_t off = 0;
  while (off < data.size()) {
    ssize_t w = write(fd, data.data() + off, data.size() - off);
    if (w <= 0) return false;
    off += size_t(w);
  }
  return true;
}

// Read one HTTP response (headers + content-length body). Returns the
// status code, or -1 on timeout/disconnect.
int read_response(int fd, std::string* body_out = nullptr) {
  std::string buf;
  char tmp[8192];
  size_t hdr_end = std::string::npos;
  while ((hdr_end = buf.find("\r\n\r\n")) == std::string::npos) {
    ssize_t r = read(fd, tmp, sizeof tmp);
    if (r <= 0) return -1;
    buf.append(tmp, size_t(r));
    if (buf.size() > (8u << 20)) return -1;
  }
  int code = -1;
  sscanf(buf.c_str(), "HTTP/1.1 %d", &code);
  size_t clen = 0;
  size_t p = buf.find("Content-Length:");
  if (p != std::string::npos && p < hdr_end)
    clen = size_t(strtoull(buf.c_str() + p + 15, nullptr, 10));
  size_t body_start = hdr_end + 4;
  while (buf.size() < body_start + clen) {
    ssize_t r = read(fd, tmp, sizeof tmp);
    if (r <= 0) return -1;
    buf.append(tmp, size_t(r));
  }
  if (body_out) *body_out = buf.substr(body_start, clen);
  return code;
}

std::string post(const std::string& path, const std::string& body,
                 const std::string& extra_headers = "") {
  return "POST " + path + " HTTP/1.1\r\nHost: f\r\n" + extra_headers +
         "Content-Length: " + std::to_string(body.size()) + "\r\n\r\n" + body;
}

std::string valid_query(Rng& r) {
  std::ostringstream o;
  if (r.chance(0.3)) {  // client batch
    o << "{\"ref_names\": [\"img0\", \"img1\"], "
      << "\"captions\": [\"red dress\", \"blue shirt\"], \"k\": "
      << (1 + r.u(5)) << "}";
  } else {
    o << "{\"ref_name\": \"img" << r.u(7) << "\", \"caption\": \"cap "
      << r.u(1000) << "\", \"k\": " << (1 + r.u(5)) << "}";
  }
  return post("/query", o.str());
}

std::string hostile_request(Rng& r) {
  switch (r.u(14)) {
    case 0: {  // random garbage
      std::string g;
      size_t n = 1 + r.u(4096);
      for (size_t i = 0; i < n; i++) g += char(r.u(256));
      return g;
    }
    case 1: {  // deep JSON nesting (beyond the 24-depth cap)
      std::string b;
      int d = 20 + int(r.u(40));
      for (int i = 0; i < d; i++) b += "[";
      b += "1";
      for (int i = 0; i < d; i++) b += "]";
      return post("/query", "{\"ref_name\": " + b + ", \"caption\": \"x\"}");
    }
    case 2: {  // header flood
      std::string h;
      int n = int(r.u(200));
      for (int i = 0; i < n; i++)
        h += "X-Flood-" + std::to_string(i) + ": " +
             std::string(1 + r.u(300), 'a') + "\r\n";
      return post("/query", "{\"ref_name\": \"img0\", \"caption\": \"x\"}", h);
    }
    case 3: {  // invalid UTF-8 + raw control bytes in the caption
      std::string cap = "\xff\xfe\x80\x01evil\xc3";
      return post("/query",
                  "{\"ref_name\": \"img0\", \"caption\": \"" + cap + "\"}");
    }
    case 4:  // lone surrogate / bad escapes
      return post("/query",
                  r.chance(0.5)
                      ? "{\"ref_name\": \"img0\", \"caption\": \"\\ud800 x\"}"
                      : "{\"ref_name\": \"img0\", \"caption\": \"\\q\"}");
    case 5:  // content-length lies: larger than the body ever sent
      return "POST /query HTTP/1.1\r\nContent-Length: 999999\r\n\r\n{\"a\":";
    case 6:  // chunked
      return "POST /query HTTP/1.1\r\nTransfer-Encoding: chunked\r\n\r\n"
             "5\r\nhello\r\n0\r\n\r\n";
    case 7: {  // giant single header line
      return "GET /healthz HTTP/1.1\r\nX-A: " + std::string(100000, 'b') +
             "\r\n\r\n";
    }
    case 8:  // negative / overflowing content-length
      return "POST /query HTTP/1.1\r\nContent-Length: "
             "18446744073709551999\r\n\r\n{}";
    case 9: {  // huge JSON array (over the 4096 element cap)
      std::string b = "{\"ref_names\": [";
      for (int i = 0; i < 5000; i++) {
        if (i) b += ",";
        b += "\"x\"";
      }
      b += "], \"captions\": []}";
      return post("/query", b);
    }
    case 10:  // wrong types everywhere
      return post("/query",
                  "{\"ref_name\": 42, \"caption\": [1,2], \"k\": \"ten\"}");
    case 11:  // request line malformations
      return r.chance(0.5) ? "GARBAGE\r\n\r\n" : " / HTTP/1.1\r\n\r\n";
    case 12:  // null bytes inside headers
      return std::string("GET /stats HTTP/1.1\r\nX\0Y: z\r\n\r\n", 32);
    default: {  // number torture for k
      const char* ks[] = {"1e309", "-1e309", "NaN", "1e-320", "-0",
                          "184467440737095516150"};
      return post("/query", std::string("{\"ref_name\": \"img0\", "
                                        "\"caption\": \"x\", \"k\": ") +
                                ks[r.u(6)] + "}");
    }
  }
}

// One attack: send (possibly truncated / slow / pipelined), optionally
// read, disconnect. Server survival is checked by the caller's control
// queries, not per-attack.
void attack(int port, Rng& r, const std::string& payload) {
  // short read timeout: many hostile requests legitimately get no
  // response (server waits for more bytes); don't stall the drive
  int fd = dial(port, 250);
  if (fd < 0) return;
  std::string data = payload;
  if (r.chance(0.25) && data.size() > 2)
    data.resize(1 + r.u(data.size() - 1));  // truncate mid-request
  if (r.chance(0.15)) data += payload;      // pipeline a second copy
  if (r.chance(0.1)) {
    // slow writer: dribble the first 64 bytes
    size_t n = std::min<size_t>(64, data.size());
    for (size_t i = 0; i < n; i++) {
      if (write(fd, data.data() + i, 1) != 1) break;
      if (i % 16 == 0) usleep(1000);
    }
    send_all(fd, data.substr(n));
  } else {
    send_all(fd, data);
  }
  if (r.chance(0.5)) read_response(fd);  // half hang up without reading
  close(fd);
}

bool control_query_ok(int port) {
  int fd = dial(port);
  if (fd < 0) return false;
  if (!send_all(fd, post("/query", "{\"ref_name\": \"img0\", "
                                   "\"caption\": \"control\", \"k\": 3}"))) {
    close(fd);
    return false;
  }
  std::string body;
  int code = read_response(fd, &body);
  close(fd);
  // 500 is legal (the stub fails ~1% of batches); a parse-level
  // rejection or no answer is not.
  if (code == 500) return control_query_ok(port);
  return code == 200 && body.find("\"results\"") != std::string::npos &&
         body.find("img") != std::string::npos;
}

std::vector<std::string> load_corpus(const char* dir) {
  std::vector<std::string> out;
  DIR* d = opendir(dir);
  if (!d) return out;
  while (dirent* e = readdir(d)) {
    std::string name = e->d_name;
    if (name == "." || name == "..") continue;
    std::ifstream f(std::string(dir) + "/" + name, std::ios::binary);
    if (!f) continue;
    std::stringstream ss;
    ss << f.rdbuf();
    out.push_back(ss.str());
  }
  closedir(d);
  return out;
}

std::pair<std::string, std::vector<int64_t>> pack_names(
    const std::vector<std::string>& names) {
  std::string buf;
  std::vector<int64_t> off{0};
  for (auto& n : names) {
    buf += n;
    off.push_back(int64_t(buf.size()));
  }
  return {buf, off};
}

}  // namespace

int main(int argc, char** argv) {
  // in production the .so lives inside CPython, which ignores SIGPIPE;
  // match that here so client writes to reset connections return EPIPE
  signal(SIGPIPE, SIG_IGN);
  int iterations = argc > 1 ? atoi(argv[1]) : 2000;
  std::vector<std::string> corpus;
  for (int i = 2; i < argc; i++) {
    auto c = load_corpus(argv[i]);
    corpus.insert(corpus.end(), c.begin(), c.end());
  }

  std::vector<std::string> names;
  for (int i = 0; i < 7; i++) names.push_back("img" + std::to_string(i));
  auto [nbuf, noff] = pack_names(names);
  const int ctx = 16, max_batch = 8, k_max = 5;
  void* h = fs_create(nbuf.data(), noff.data(), int32_t(names.size()),
                      nullptr, 0, ctx, max_batch, k_max, 500);
  int port = fs_listen(h, "127.0.0.1", 0);
  if (port <= 0) {
    fprintf(stderr, "listen failed\n");
    return 2;
  }

  std::atomic<bool> stop{false};
  std::atomic<long> batches{0};
  std::thread dev(device_stub, h, max_batch, ctx, k_max, &stop, &batches);

  // name-table swap thread: the /add race drive (fs_set_names vs
  // concurrent handle_query row lookups + fs_complete_batch name reads)
  std::thread swapper([&] {
    Rng r(99);
    while (!stop.load()) {
      std::vector<std::string> nn;
      int n = 7 + int(r.u(5));  // always >= 7 so rows stay in range
      for (int i = 0; i < n; i++)
        nn.push_back((i < 7 ? "img" : "new") + std::to_string(i));
      auto [b, o] = pack_names(nn);
      fs_set_names(h, b.data(), o.data(), int32_t(nn.size()));
      usleep(500);
    }
  });

  if (!control_query_ok(port)) {
    fprintf(stderr, "control query failed before fuzzing\n");
    return 3;
  }

  Rng rng(4242);
  int failures = 0;
  for (size_t i = 0; i < corpus.size(); i++) {
    attack(port, rng, corpus[i]);
    if (i % 16 == 15 && !control_query_ok(port)) failures++;
  }
  for (int i = 0; i < iterations; i++) {
    std::string payload =
        rng.chance(0.3) ? valid_query(rng) : hostile_request(rng);
    attack(port, rng, payload);
    if (i % 64 == 63 && !control_query_ok(port)) failures++;
  }
  bool final_ok = control_query_ok(port);

  stop.store(true);
  fs_shutdown(h);
  dev.join();
  swapper.join();
  fs_destroy(h);

  fprintf(stderr,
          "fastserve_fuzz: %d generated + %zu corpus requests, "
          "%ld batches dispatched, control failures=%d, final_ok=%d\n",
          iterations, corpus.size(), batches.load(), failures,
          int(final_ok));
  return (failures == 0 && final_ok) ? 0 : 4;
}
