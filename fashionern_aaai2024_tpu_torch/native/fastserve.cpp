// Native serving front of `fashionern-torch serve` (Linux, epoll), the
// PyTorch port's copy of fashionern_aaai2024_tpu/native/fastserve.cpp.
//
// Why: under concurrent load the Python daemon's HTTP handler threads
// (BaseHTTPRequestHandler parse, json, per-request wakeups) take the
// interpreter lock from the device thread. This front moves everything
// but the serve program's call out of Python:
//
//   C++ IO thread (no GIL):  accept -> HTTP parse -> JSON parse ->
//                            BPE tokenize (the port's fasttokenizer.cpp,
//                            included below) -> name->row lookup -> batch
//                            queue
//   Python device thread:    fs_next_batch() [blocks GIL-free] ->
//                            one serve-program call (one CUDA graph
//                            replay on the card) -> fs_complete_batch()
//   C++ (from that call):    per-item top-k JSON formatting -> response
//                            write queue -> epoll writeback
//
// The tokenizer's fast path (ft_encode: FT_OK = 0, anything else flags
// the caption for the Python tokenizer) takes printable ASCII and ASCII
// whitespace; every other caption is re-tokenized in Python, so the ids
// are always the Python tokenizer's.
//
// Endpoints served natively: POST /query (single + client-batch),
// GET /healthz, GET /stats. Admin endpoints (/add, /reload) stay on the
// Python admin server: this front answers 501 for them.
//
// Protocol with Python (ctypes, see native/serve_frontend.py):
//   fs_create(names, merges?, ctx, max_batch, k_max, max_wait_us)
//   fs_listen(host, port) -> bound port
//   fs_next_batch(...)    -> batch_id + padded arrays (blocking)
//   fs_complete_batch(batch_id, scores, idx, n, k_used)
//   fs_fail_batch(batch_id, http_code, message)
//   fs_set_names(...)     -> live-add name-table swap
//   fs_shutdown / fs_destroy

#include "fasttokenizer.cpp"

#include <arpa/inet.h>
#include <fcntl.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/epoll.h>
#include <sys/eventfd.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <shared_mutex>
#include <thread>

namespace fserve {

using Clock = std::chrono::steady_clock;

// Per-caption byte cap: keeps fs_next_batch's fixed caption buffer
// (max_batch * kMaxCaption bytes, allocated once on the Python side)
// always large enough — no silent truncation path exists.
constexpr size_t kMaxCaption = 64 * 1024;

// ---------------------------------------------------------------- JSON
// Minimal, strict-enough JSON value parser (objects, arrays, strings
// with escapes incl. \uXXXX -> UTF-8, numbers, true/false/null). Depth-
// and size-bounded; anything else is a 400.
struct JV {
  enum Kind { Null, Bool, Num, Str, Arr, Obj } kind = Null;
  bool b = false;
  double num = 0;
  std::string str;
  std::vector<JV> arr;
  std::vector<std::pair<std::string, JV>> obj;  // few keys; linear find
  const JV* get(const char* key) const {
    if (kind != Obj) return nullptr;
    for (auto& kv : obj)
      if (kv.first == key) return &kv.second;
    return nullptr;
  }
};

struct JParser {
  const char* p;
  const char* end;
  int depth = 0;
  bool fail = false;

  void ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      ++p;
  }
  bool lit(const char* s) {
    size_t n = strlen(s);
    if (size_t(end - p) < n || memcmp(p, s, n) != 0) return false;
    p += n;
    return true;
  }
  static void utf8(std::string& out, unsigned cp) {
    if (cp < 0x80) {
      out += char(cp);
    } else if (cp < 0x800) {
      out += char(0xC0 | (cp >> 6));
      out += char(0x80 | (cp & 0x3F));
    } else if (cp < 0x10000) {
      out += char(0xE0 | (cp >> 12));
      out += char(0x80 | ((cp >> 6) & 0x3F));
      out += char(0x80 | (cp & 0x3F));
    } else {
      out += char(0xF0 | (cp >> 18));
      out += char(0x80 | ((cp >> 12) & 0x3F));
      out += char(0x80 | ((cp >> 6) & 0x3F));
      out += char(0x80 | (cp & 0x3F));
    }
  }
  bool hex4(unsigned& v) {
    if (end - p < 4) return false;
    v = 0;
    for (int i = 0; i < 4; i++) {
      char c = p[i];
      v <<= 4;
      if (c >= '0' && c <= '9') v |= unsigned(c - '0');
      else if (c >= 'a' && c <= 'f') v |= unsigned(c - 'a' + 10);
      else if (c >= 'A' && c <= 'F') v |= unsigned(c - 'A' + 10);
      else return false;
    }
    p += 4;
    return true;
  }
  bool string(std::string& out) {
    if (p >= end || *p != '"') return false;
    ++p;
    while (p < end) {
      unsigned char c = (unsigned char)*p;
      if (c == '"') {
        ++p;
        return true;
      }
      if (c == '\\') {
        ++p;
        if (p >= end) return false;
        char e = *p++;
        switch (e) {
          case '"': out += '"'; break;
          case '\\': out += '\\'; break;
          case '/': out += '/'; break;
          case 'b': out += '\b'; break;
          case 'f': out += '\f'; break;
          case 'n': out += '\n'; break;
          case 'r': out += '\r'; break;
          case 't': out += '\t'; break;
          case 'u': {
            unsigned v;
            if (!hex4(v)) return false;
            if (v >= 0xD800 && v <= 0xDBFF) {  // surrogate pair
              if (end - p < 6 || p[0] != '\\' || p[1] != 'u') return false;
              p += 2;
              unsigned lo;
              if (!hex4(lo) || lo < 0xDC00 || lo > 0xDFFF) return false;
              v = 0x10000 + ((v - 0xD800) << 10) + (lo - 0xDC00);
            }
            utf8(out, v);
            break;
          }
          default: return false;
        }
      } else if (c < 0x20) {
        return false;  // control chars must be escaped
      } else {
        out += char(c);
        ++p;
      }
      if (out.size() > (1u << 20)) return false;
    }
    return false;
  }
  JV value() {
    JV v;
    if (fail || ++depth > 24) {
      fail = true;
      return v;
    }
    ws();
    if (p >= end) {
      fail = true;
    } else if (*p == '{') {
      ++p;
      v.kind = JV::Obj;
      ws();
      if (p < end && *p == '}') {
        ++p;
      } else {
        while (true) {
          ws();
          std::string key;
          if (!string(key)) {
            fail = true;
            break;
          }
          ws();
          if (p >= end || *p++ != ':') {
            fail = true;
            break;
          }
          v.obj.emplace_back(std::move(key), value());
          if (fail) break;
          ws();
          if (p < end && *p == ',') {
            ++p;
            continue;
          }
          if (p < end && *p == '}') {
            ++p;
            break;
          }
          fail = true;
          break;
        }
      }
    } else if (*p == '[') {
      ++p;
      v.kind = JV::Arr;
      ws();
      if (p < end && *p == ']') {
        ++p;
      } else {
        while (true) {
          v.arr.push_back(value());
          if (fail || v.arr.size() > 4096) {
            fail = true;
            break;
          }
          ws();
          if (p < end && *p == ',') {
            ++p;
            continue;
          }
          if (p < end && *p == ']') {
            ++p;
            break;
          }
          fail = true;
          break;
        }
      }
    } else if (*p == '"') {
      v.kind = JV::Str;
      if (!string(v.str)) fail = true;
    } else if (lit("true")) {
      v.kind = JV::Bool;
      v.b = true;
    } else if (lit("false")) {
      v.kind = JV::Bool;
      v.b = false;
    } else if (lit("null")) {
      v.kind = JV::Null;
    } else {  // number
      char* numend = nullptr;
      v.num = strtod(p, &numend);
      if (numend == p || numend > end) {
        fail = true;
      } else {
        v.kind = JV::Num;
        p = numend;
      }
    }
    --depth;
    return v;
  }
};

bool parse_json(const char* buf, size_t len, JV& out) {
  JParser jp{buf, buf + len};
  out = jp.value();
  jp.ws();
  return !jp.fail && jp.p == jp.end;
}

void json_escape(std::string& out, const std::string& s) {
  for (unsigned char c : s) {
    switch (c) {
      case '"': out += "\\\""; break;
      case '\\': out += "\\\\"; break;
      case '\b': out += "\\b"; break;
      case '\f': out += "\\f"; break;
      case '\n': out += "\\n"; break;
      case '\r': out += "\\r"; break;
      case '\t': out += "\\t"; break;
      default:
        if (c < 0x20) {
          char tmp[8];
          snprintf(tmp, sizeof tmp, "\\u%04x", c);
          out += tmp;
        } else {
          out += char(c);  // UTF-8 passthrough
        }
    }
  }
}

// ------------------------------------------------------------- request
struct Item {
  uint64_t group = 0;
  int idx_in_group = 0;
  std::vector<int32_t> ids;  // [ctx], tokenized (unless fallback)
  int32_t row = 0;
  int32_t k = 10;
  bool fallback = false;  // Python must (join+)re-tokenize `caption`
  std::string caption;
};

struct Group {
  int fd = -1;
  uint64_t conn_gen = 0;
  int remaining = 0;
  bool is_batch = false;
  Clock::time_point t0;
  std::vector<std::string> results;  // per-item JSON fragments
  bool failed = false;
};

struct Conn {
  int fd = -1;
  uint64_t gen = 0;
  std::string in;
  std::deque<std::string> outq;
  size_t out_off = 0;
  bool want_close = false;
  bool busy = false;  // a /query in flight; responses stay ordered
};

struct Server {
  // config
  void* tok = nullptr;  // fasttokenizer handle (null -> always fallback)
  int ctx = 77, max_batch = 32, k_max = 50;
  long max_wait_us = 2000;
  size_t max_body = 4u << 20;

  // name table (live-add swappable)
  std::shared_mutex names_mu;
  std::vector<std::string> names;
  std::unordered_map<std::string, int32_t> rows;

  // pending item queue (IO thread -> device thread)
  std::mutex qmu;
  std::condition_variable qcv;
  std::deque<Item> queue;
  bool stop = false;

  // in-flight batches / groups
  std::mutex bmu;
  uint64_t next_batch = 1, next_group = 1;
  std::map<uint64_t, std::vector<Item>> batches;
  std::map<uint64_t, Group> groups;

  // completed responses headed back to the IO thread
  std::mutex outmu;
  std::vector<std::tuple<int, uint64_t, std::string>> out_pending;

  // IO
  int epfd = -1, lfd = -1, wakefd = -1;
  std::thread io;
  std::unordered_map<int, Conn> conns;
  uint64_t gen_counter = 1;
  std::atomic<int> bound_port{0};

  // stats
  std::mutex smu;
  uint64_t req_count = 0;
  uint64_t batches_run = 0, items_run = 0;
  std::vector<double> lat;  // seconds, capped ring
};

std::string http_response(int code, const std::string& body,
                          bool close_conn) {
  const char* reason = code == 200   ? "OK"
                       : code == 400 ? "Bad Request"
                       : code == 404 ? "Not Found"
                       : code == 413 ? "Payload Too Large"
                       : code == 500 ? "Internal Server Error"
                       : code == 501 ? "Not Implemented"
                                     : "Error";
  std::string r = "HTTP/1.1 " + std::to_string(code) + " " + reason +
                  "\r\nContent-Type: application/json\r\nContent-Length: " +
                  std::to_string(body.size()) + "\r\n";
  if (close_conn) r += "Connection: close\r\n";
  r += "\r\n";
  r += body;
  return r;
}

std::string err_body(const std::string& msg) {
  std::string b = "{\"error\": \"";
  json_escape(b, msg);
  b += "\"}";
  return b;
}

void set_nonblock(int fd) {
  int fl = fcntl(fd, F_GETFL, 0);
  fcntl(fd, F_SETFL, fl | O_NONBLOCK);
}

void epoll_mod(Server* s, int fd, uint32_t events) {
  epoll_event ev{};
  ev.events = events;
  ev.data.fd = fd;
  epoll_ctl(s->epfd, EPOLL_CTL_MOD, fd, &ev);
}

void conn_close(Server* s, Conn& c) {
  epoll_ctl(s->epfd, EPOLL_CTL_DEL, c.fd, nullptr);
  close(c.fd);
  s->conns.erase(c.fd);
}

void conn_send(Server* s, Conn& c, int code, const std::string& body,
               bool close_after = false) {
  c.outq.push_back(http_response(code, body, close_after));
  if (close_after) c.want_close = true;
  epoll_mod(s, c.fd, EPOLLIN | EPOLLOUT);
}

double now_seconds(Clock::time_point t0) {
  return std::chrono::duration<double>(Clock::now() - t0).count();
}

void record_latency(Server* s, double sec) {
  std::lock_guard<std::mutex> g(s->smu);
  s->req_count++;
  s->lat.push_back(sec);
  if (s->lat.size() > 10000) s->lat.erase(s->lat.begin(), s->lat.begin() + 5000);
}

std::string stats_body(Server* s) {
  uint64_t count, brun, irun;
  std::vector<double> lat;
  {
    std::lock_guard<std::mutex> g(s->smu);
    count = s->req_count;
    brun = s->batches_run;
    irun = s->items_run;
    lat = s->lat;
  }
  size_t gallery;
  {
    std::shared_lock<std::shared_mutex> g(s->names_mu);
    gallery = s->names.size();
  }
  std::sort(lat.begin(), lat.end());
  auto pct = [&](double p) -> std::string {
    if (lat.empty()) return "null";
    size_t i = std::min(lat.size() - 1, size_t(p * lat.size()));
    char tmp[32];
    snprintf(tmp, sizeof tmp, "%.2f", lat[i] * 1e3);
    return tmp;
  };
  return "{\"requests\": " + std::to_string(count) +
         ", \"gallery_size\": " + std::to_string(gallery) +
         ", \"native_frontend\": true" +
         ", \"latency_ms\": {\"p50\": " + pct(0.50) + ", \"p90\": " +
         pct(0.90) + ", \"p99\": " + pct(0.99) + "}" +
         ", \"dynamic_batching\": {\"batches\": " + std::to_string(brun) +
         ", \"items\": " + std::to_string(irun) +
         ", \"max_batch\": " + std::to_string(s->max_batch) + "}}";
}

// Tokenize one caption on the IO thread. Returns false -> Python path.
bool native_tokenize(Server* s, const std::string& cap,
                     std::vector<int32_t>& ids) {
  if (!s->tok) return false;
  ids.assign(size_t(s->ctx), 0);
  int rc = ft_encode(s->tok, cap.data(), int64_t(cap.size()), ids.data(),
                     s->ctx);
  return rc == 0;  // FT_OK
}

// Handle one parsed /query body. Returns true if items were enqueued
// (response deferred to batch completion).
bool handle_query(Server* s, Conn& c, const JV& req) {
  std::vector<std::string> refs, caps;
  bool is_batch = req.get("ref_names") != nullptr;
  if (is_batch) {
    const JV* rn = req.get("ref_names");
    const JV* cp = req.get("captions");
    if (!rn || !cp || rn->kind != JV::Arr || cp->kind != JV::Arr ||
        rn->arr.size() != cp->arr.size() || rn->arr.empty()) {
      conn_send(s, c, 400, err_body("ref_names/captions arrays required"));
      return false;
    }
    for (size_t i = 0; i < rn->arr.size(); i++) {
      if (rn->arr[i].kind != JV::Str || cp->arr[i].kind != JV::Str) {
        conn_send(s, c, 400, err_body("ref_names/captions must be strings"));
        return false;
      }
      refs.push_back(rn->arr[i].str);
      caps.push_back(cp->arr[i].str);
    }
  } else {
    const JV* rn = req.get("ref_name");
    const JV* cp = req.get("caption");
    if (!rn || !cp || rn->kind != JV::Str || cp->kind != JV::Str) {
      conn_send(s, c, 400, err_body("ref_name and caption required"));
      return false;
    }
    refs.push_back(rn->str);
    caps.push_back(cp->str);
  }
  for (auto& cap : caps) {
    if (cap.size() > kMaxCaption) {
      conn_send(s, c, 400, err_body("caption too long (64KiB max)"));
      return false;
    }
  }
  int k = 10;
  if (const JV* kv = req.get("k")) {
    if (kv->kind != JV::Num) {
      conn_send(s, c, 400, err_body("k must be a number"));
      return false;
    }
    k = int(kv->num);
  }
  if (k < 1) k = 1;
  if (k > s->k_max) {
    conn_send(s, c, 400,
              err_body("k exceeds this endpoint's k_max (" +
                       std::to_string(s->k_max) +
                       "); large-k queries go to the admin server"));
    return false;
  }
  if (int(refs.size()) > s->max_batch) {
    conn_send(s, c, 400,
              err_body("batch larger than max_batch (" +
                       std::to_string(s->max_batch) + "); split the request"));
    return false;
  }

  std::vector<int32_t> rowv(refs.size());
  {
    std::shared_lock<std::shared_mutex> g(s->names_mu);
    std::string unknown;
    for (size_t i = 0; i < refs.size(); i++) {
      auto it = s->rows.find(refs[i]);
      if (it == s->rows.end()) {
        if (!unknown.empty()) unknown += ", ";
        unknown += "'" + refs[i] + "'";
      } else {
        rowv[i] = it->second;
      }
    }
    if (!unknown.empty()) {
      conn_send(s, c, 404,
                err_body("unknown reference image(s): [" + unknown + "]"));
      return false;
    }
  }

  uint64_t gid;
  {
    std::lock_guard<std::mutex> g(s->bmu);
    gid = s->next_group++;
    Group& grp = s->groups[gid];
    grp.fd = c.fd;
    grp.conn_gen = c.gen;
    grp.remaining = int(refs.size());
    grp.is_batch = is_batch;
    grp.t0 = Clock::now();
    grp.results.resize(refs.size());
  }
  {
    std::lock_guard<std::mutex> g(s->qmu);
    for (size_t i = 0; i < refs.size(); i++) {
      Item it;
      it.group = gid;
      it.idx_in_group = int(i);
      it.row = rowv[i];
      it.k = k;
      it.caption = caps[i];
      it.fallback = !native_tokenize(s, caps[i], it.ids);
      if (it.fallback) it.ids.assign(size_t(s->ctx), 0);
      s->queue.push_back(std::move(it));
    }
  }
  s->qcv.notify_one();
  return true;
}

// Parse as many complete HTTP requests from c.in as possible.
void conn_parse(Server* s, Conn& c) {
  while (!c.busy && !c.want_close) {
    size_t hdr_end = c.in.find("\r\n\r\n");
    if (hdr_end == std::string::npos) {
      if (c.in.size() > 64 * 1024) {
        conn_send(s, c, 400, err_body("header too large"), true);
      }
      return;
    }
    // request line
    size_t line_end = c.in.find("\r\n");
    std::string line = c.in.substr(0, line_end);
    size_t sp1 = line.find(' ');
    size_t sp2 = line.rfind(' ');
    if (sp1 == std::string::npos || sp2 <= sp1) {
      conn_send(s, c, 400, err_body("malformed request line"), true);
      return;
    }
    std::string method = line.substr(0, sp1);
    std::string path = line.substr(sp1 + 1, sp2 - sp1 - 1);
    // headers: content-length, connection
    size_t clen = 0;
    bool close_after = false;
    bool chunked = false;
    size_t pos = line_end + 2;
    while (pos < hdr_end) {
      size_t eol = c.in.find("\r\n", pos);
      std::string h = c.in.substr(pos, eol - pos);
      pos = eol + 2;
      size_t colon = h.find(':');
      if (colon == std::string::npos) continue;
      std::string key = h.substr(0, colon);
      std::string val = h.substr(colon + 1);
      std::transform(key.begin(), key.end(), key.begin(), ::tolower);
      size_t vs = val.find_first_not_of(" \t");
      val = vs == std::string::npos ? "" : val.substr(vs);
      if (key == "content-length") clen = size_t(strtoull(val.c_str(), nullptr, 10));
      if (key == "transfer-encoding") chunked = true;
      if (key == "connection") {
        std::transform(val.begin(), val.end(), val.begin(), ::tolower);
        if (val.find("close") != std::string::npos) close_after = true;
      }
    }
    if (chunked) {
      conn_send(s, c, 400, err_body("chunked bodies unsupported"), true);
      return;
    }
    if (clen > s->max_body) {
      conn_send(s, c, 413, err_body("body too large"), true);
      return;
    }
    size_t body_start = hdr_end + 4;
    if (c.in.size() < body_start + clen) return;  // need more bytes
    std::string body = c.in.substr(body_start, clen);
    c.in.erase(0, body_start + clen);
    if (close_after) c.want_close = true;

    if (method == "GET" && path == "/healthz") {
      size_t gallery;
      {
        std::shared_lock<std::shared_mutex> g(s->names_mu);
        gallery = s->names.size();
      }
      conn_send(s, c, 200,
                "{\"status\": \"ok\", \"gallery_size\": " +
                    std::to_string(gallery) + "}",
                close_after);
    } else if (method == "GET" && path == "/stats") {
      conn_send(s, c, 200, stats_body(s), close_after);
    } else if (method == "POST" && path == "/query") {
      JV req;
      if (!parse_json(body.data(), body.size(), req) || req.kind != JV::Obj) {
        conn_send(s, c, 400, err_body("invalid JSON body"), close_after);
      } else if (handle_query(s, c, req)) {
        c.busy = true;  // response comes via fs_complete_batch
      }
    } else if (path == "/add" || path == "/reload") {
      conn_send(s, c, 501,
                err_body("admin endpoints live on the Python admin server"),
                close_after);
    } else {
      conn_send(s, c, 404, err_body("unknown path"), close_after);
    }
  }
}

void io_loop(Server* s) {
  epoll_event evs[64];
  while (true) {
    int n = epoll_wait(s->epfd, evs, 64, 200);
    {
      std::lock_guard<std::mutex> g(s->qmu);
      if (s->stop) break;
    }
    // drain completed responses first (they re-enable parsing)
    std::vector<std::tuple<int, uint64_t, std::string>> done;
    {
      std::lock_guard<std::mutex> g(s->outmu);
      done.swap(s->out_pending);
    }
    for (auto& [fd, gen, resp] : done) {
      auto it = s->conns.find(fd);
      if (it == s->conns.end() || it->second.gen != gen) continue;
      Conn& c = it->second;
      c.outq.push_back(std::move(resp));
      c.busy = false;
      epoll_mod(s, fd, EPOLLIN | EPOLLOUT);
      conn_parse(s, c);  // a pipelined request may be waiting
    }
    for (int i = 0; i < n; i++) {
      int fd = evs[i].data.fd;
      if (fd == s->wakefd) {
        uint64_t tmp;
        ssize_t r = read(s->wakefd, &tmp, 8);
        (void)r;
        continue;
      }
      if (fd == s->lfd) {
        while (true) {
          int cfd = accept4(s->lfd, nullptr, nullptr, SOCK_NONBLOCK);
          if (cfd < 0) break;
          int one = 1;
          setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
          Conn& c = s->conns[cfd];
          c.fd = cfd;
          c.gen = s->gen_counter++;
          epoll_event ev{};
          ev.events = EPOLLIN;
          ev.data.fd = cfd;
          epoll_ctl(s->epfd, EPOLL_CTL_ADD, cfd, &ev);
        }
        continue;
      }
      auto it = s->conns.find(fd);
      if (it == s->conns.end()) continue;
      Conn& c = it->second;
      if (evs[i].events & (EPOLLHUP | EPOLLERR)) {
        conn_close(s, c);
        continue;
      }
      if (evs[i].events & EPOLLIN) {
        char buf[16384];
        bool closed = false;
        while (true) {
          ssize_t r = read(fd, buf, sizeof buf);
          if (r > 0) {
            c.in.append(buf, size_t(r));
            if (c.in.size() > s->max_body + 64 * 1024) {
              conn_send(s, c, 413, err_body("request too large"), true);
              break;
            }
          } else if (r == 0) {
            closed = true;
            break;
          } else {
            break;  // EAGAIN
          }
        }
        if (closed && c.outq.empty() && !c.busy) {
          conn_close(s, c);
          continue;
        }
        conn_parse(s, c);
      }
      if (evs[i].events & EPOLLOUT) {
        while (!c.outq.empty()) {
          std::string& front = c.outq.front();
          ssize_t w = write(fd, front.data() + c.out_off,
                            front.size() - c.out_off);
          if (w < 0) break;  // EAGAIN
          c.out_off += size_t(w);
          if (c.out_off == front.size()) {
            c.outq.pop_front();
            c.out_off = 0;
          }
        }
        if (c.outq.empty()) {
          if (c.want_close) {
            conn_close(s, c);
            continue;
          }
          epoll_mod(s, fd, EPOLLIN);
        }
      }
    }
  }
  // shutdown: close everything
  for (auto& kv : s->conns) close(kv.second.fd);
  s->conns.clear();
}

void wake_io(Server* s) {
  uint64_t one = 1;
  ssize_t r = write(s->wakefd, &one, 8);
  (void)r;
}

void finish_group_item(Server* s, uint64_t gid, int idx, std::string frag,
                       bool failed,
                       std::vector<std::tuple<int, uint64_t, std::string>>& out) {
  std::lock_guard<std::mutex> g(s->bmu);
  auto it = s->groups.find(gid);
  if (it == s->groups.end()) return;
  Group& grp = it->second;
  grp.results[size_t(idx)] = std::move(frag);
  grp.failed = grp.failed || failed;
  if (--grp.remaining > 0) return;
  double lat = now_seconds(grp.t0);
  std::string body;
  int code = 200;
  if (grp.failed) {
    code = 500;
    // first non-empty failure fragment is the message
    std::string msg = "dispatch failed";
    for (auto& r : grp.results)
      if (!r.empty() && r[0] != '[') {
        msg = r;
        break;
      }
    body = err_body(msg);
  } else {
    char latbuf[32];
    snprintf(latbuf, sizeof latbuf, "%.2f", lat * 1e3);
    body = "{\"results\": ";
    if (grp.is_batch) {
      body += "[";
      for (size_t i = 0; i < grp.results.size(); i++) {
        if (i) body += ", ";
        body += grp.results[i];
      }
      body += "]";
    } else {
      body += grp.results[0];
    }
    body += ", \"latency_ms\": ";
    body += latbuf;
    body += "}";
  }
  out.emplace_back(grp.fd, grp.conn_gen,
                   http_response(code, body, false));
  s->groups.erase(it);
  record_latency(s, lat);
}

}  // namespace fserve

using namespace fserve;

extern "C" {

void* fs_create(const char* names_buf, const int64_t* name_offsets,
                int32_t n_names, const char* merges_blob, int64_t merges_len,
                int32_t ctx, int32_t max_batch, int32_t k_max,
                int64_t max_wait_us) {
  auto* s = new Server();
  s->ctx = ctx;
  s->max_batch = max_batch;
  s->k_max = k_max;
  s->max_wait_us = long(max_wait_us);
  if (merges_blob && merges_len > 0)
    s->tok = ft_create(merges_blob, merges_len);
  s->names.reserve(size_t(n_names));
  for (int32_t i = 0; i < n_names; i++) {
    s->names.emplace_back(names_buf + name_offsets[i],
                          size_t(name_offsets[i + 1] - name_offsets[i]));
    s->rows[s->names.back()] = i;  // last wins, like evaluate.last_wins_rows
  }
  return s;
}

void fs_set_names(void* h, const char* names_buf, const int64_t* name_offsets,
                  int32_t n_names) {
  auto* s = static_cast<Server*>(h);
  std::unique_lock<std::shared_mutex> g(s->names_mu);
  s->names.clear();
  s->rows.clear();
  s->names.reserve(size_t(n_names));
  for (int32_t i = 0; i < n_names; i++) {
    s->names.emplace_back(names_buf + name_offsets[i],
                          size_t(name_offsets[i + 1] - name_offsets[i]));
    s->rows[s->names.back()] = i;
  }
}

int32_t fs_listen(void* h, const char* host, int32_t port) {
  auto* s = static_cast<Server*>(h);
  s->lfd = socket(AF_INET, SOCK_STREAM | SOCK_NONBLOCK, 0);
  if (s->lfd < 0) return -1;
  int one = 1;
  setsockopt(s->lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(uint16_t(port));
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    close(s->lfd);
    return -1;
  }
  if (bind(s->lfd, (sockaddr*)&addr, sizeof addr) < 0 ||
      listen(s->lfd, 512) < 0) {
    close(s->lfd);
    return -1;
  }
  socklen_t alen = sizeof addr;
  getsockname(s->lfd, (sockaddr*)&addr, &alen);
  s->bound_port = int(ntohs(addr.sin_port));

  s->epfd = epoll_create1(0);
  s->wakefd = eventfd(0, EFD_NONBLOCK);
  epoll_event ev{};
  ev.events = EPOLLIN;
  ev.data.fd = s->lfd;
  epoll_ctl(s->epfd, EPOLL_CTL_ADD, s->lfd, &ev);
  ev.data.fd = s->wakefd;
  epoll_ctl(s->epfd, EPOLL_CTL_ADD, s->wakefd, &ev);
  s->io = std::thread(io_loop, s);
  return s->bound_port;
}

// Blocking (call via ctypes -> GIL released). Fills up to max_batch
// items. Returns batch_id > 0, or 0 on shutdown.
int64_t fs_next_batch(void* h, int32_t* ids, int32_t* rows, int32_t* ks,
                      int8_t* fallback, char* capbuf, int64_t capbuf_cap,
                      int64_t* capoff, int32_t* out_n) {
  auto* s = static_cast<Server*>(h);
  std::vector<Item> batch;
  {
    std::unique_lock<std::mutex> g(s->qmu);
    s->qcv.wait(g, [&] { return s->stop || !s->queue.empty(); });
    if (s->stop && s->queue.empty()) return 0;
    if (int(s->queue.size()) < s->max_batch && s->max_wait_us > 0) {
      s->qcv.wait_for(g, std::chrono::microseconds(s->max_wait_us), [&] {
        return s->stop || int(s->queue.size()) >= s->max_batch;
      });
    }
    int n = std::min<int>(s->max_batch, int(s->queue.size()));
    for (int i = 0; i < n; i++) {
      batch.push_back(std::move(s->queue.front()));
      s->queue.pop_front();
    }
  }
  int n = int(batch.size());
  int64_t off = 0;
  for (int i = 0; i < n; i++) {
    Item& it = batch[size_t(i)];
    if (!it.ids.empty())
      memcpy(ids + size_t(i) * size_t(s->ctx), it.ids.data(),
             sizeof(int32_t) * size_t(s->ctx));
    else
      memset(ids + size_t(i) * size_t(s->ctx), 0,
             sizeof(int32_t) * size_t(s->ctx));
    rows[i] = it.row;
    ks[i] = it.k;
    fallback[i] = it.fallback ? 1 : 0;
    capoff[i] = off;
    int64_t len = int64_t(it.caption.size());
    if (off + len <= capbuf_cap) {
      memcpy(capbuf + off, it.caption.data(), size_t(len));
      off += len;
    }
    capoff[i + 1] = off;
  }
  *out_n = n;
  uint64_t bid;
  {
    std::lock_guard<std::mutex> g(s->bmu);
    bid = s->next_batch++;
    s->batches[bid] = std::move(batch);
  }
  return int64_t(bid);
}

void fs_complete_batch(void* h, int64_t batch_id, const float* scores,
                       const int32_t* idx, int32_t n, int32_t k_used) {
  auto* s = static_cast<Server*>(h);
  std::vector<Item> batch;
  {
    std::lock_guard<std::mutex> g(s->bmu);
    auto it = s->batches.find(uint64_t(batch_id));
    if (it == s->batches.end()) return;
    batch = std::move(it->second);
    s->batches.erase(it);
  }
  {
    std::lock_guard<std::mutex> g(s->smu);
    s->batches_run++;
    s->items_run += uint64_t(n);
  }
  std::vector<std::tuple<int, uint64_t, std::string>> out;
  std::shared_lock<std::shared_mutex> names_g(s->names_mu);
  for (int i = 0; i < n && i < int(batch.size()); i++) {
    Item& it = batch[size_t(i)];
    int ki = std::min(it.k, k_used);
    std::string frag = "[";
    for (int j = 0; j < ki; j++) {
      int32_t row = idx[size_t(i) * size_t(k_used) + size_t(j)];
      float sc = scores[size_t(i) * size_t(k_used) + size_t(j)];
      if (j) frag += ", ";
      frag += "{\"name\": \"";
      if (row >= 0 && size_t(row) < s->names.size())
        json_escape(frag, s->names[size_t(row)]);
      frag += "\", \"score\": ";
      char tmp[32];
      snprintf(tmp, sizeof tmp, "%.6g", double(sc));
      frag += tmp;
      frag += "}";
    }
    frag += "]";
    finish_group_item(s, it.group, it.idx_in_group, std::move(frag), false,
                      out);
  }
  names_g.unlock();
  if (!out.empty()) {
    std::lock_guard<std::mutex> g(s->outmu);
    for (auto& o : out) s->out_pending.push_back(std::move(o));
  }
  wake_io(s);
}

void fs_fail_batch(void* h, int64_t batch_id, const char* message) {
  auto* s = static_cast<Server*>(h);
  std::vector<Item> batch;
  {
    std::lock_guard<std::mutex> g(s->bmu);
    auto it = s->batches.find(uint64_t(batch_id));
    if (it == s->batches.end()) return;
    batch = std::move(it->second);
    s->batches.erase(it);
  }
  std::vector<std::tuple<int, uint64_t, std::string>> out;
  for (Item& it : batch)
    finish_group_item(s, it.group, it.idx_in_group,
                      message ? std::string(message) : "dispatch failed",
                      true, out);
  if (!out.empty()) {
    std::lock_guard<std::mutex> g(s->outmu);
    for (auto& o : out) s->out_pending.push_back(std::move(o));
  }
  wake_io(s);
}

int32_t fs_port(void* h) { return static_cast<Server*>(h)->bound_port; }

void fs_shutdown(void* h) {
  auto* s = static_cast<Server*>(h);
  {
    std::lock_guard<std::mutex> g(s->qmu);
    s->stop = true;
  }
  s->qcv.notify_all();
  wake_io(s);
}

void fs_destroy(void* h) {
  auto* s = static_cast<Server*>(h);
  fs_shutdown(h);
  if (s->io.joinable()) s->io.join();
  if (s->lfd >= 0) close(s->lfd);
  if (s->wakefd >= 0) close(s->wakefd);
  if (s->epfd >= 0) close(s->epfd);
  if (s->tok) ft_destroy(s->tok);
  delete s;
}

}  // extern "C"
