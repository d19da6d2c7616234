// Carried unchanged from cluster/device-plugin/src/grpc.cc: the CUDA device
// plugin keeps its own copy of the transport, as the port does of every
// module it carries. Edit both copies together or neither.
#include "grpc.h"

#include <errno.h>
#include <poll.h>
#include <string.h>
#include <sys/socket.h>
#include <sys/un.h>
#include <unistd.h>

#include <algorithm>
#include <cstdio>

namespace kgct {
namespace {

std::string MessageFrame(const std::string& payload) {
  std::string out(5, '\0');
  uint32_t n = static_cast<uint32_t>(payload.size());
  out[0] = 0;  // uncompressed
  out[1] = char(n >> 24), out[2] = char(n >> 16);
  out[3] = char(n >> 8), out[4] = char(n);
  return out + payload;
}

// Extracts the first complete message from a DATA accumulation buffer.
// Returns false if incomplete. Throws GrpcError on a compressed message.
bool PopMessage(std::string* buf, std::string* msg) {
  if (buf->size() < 5) return false;
  const uint8_t* p = reinterpret_cast<const uint8_t*>(buf->data());
  if (p[0] != 0)
    throw GrpcError(kUnimplemented, "compressed grpc messages unsupported");
  uint32_t n = (uint32_t(p[1]) << 24) | (uint32_t(p[2]) << 16) |
               (uint32_t(p[3]) << 8) | uint32_t(p[4]);
  if (buf->size() < 5 + size_t(n)) return false;
  msg->assign(*buf, 5, n);
  buf->erase(0, 5 + size_t(n));
  return true;
}

int UnixConnect(const std::string& path) {
  int fd = ::socket(AF_UNIX, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  sockaddr_un addr{};
  addr.sun_family = AF_UNIX;
  if (path.size() >= sizeof(addr.sun_path)) {
    ::close(fd);
    errno = ENAMETOOLONG;
    return -1;
  }
  memcpy(addr.sun_path, path.c_str(), path.size() + 1);
  if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0) {
    ::close(fd);
    return -1;
  }
  return fd;
}

}  // namespace

// ---------------------------------------------------------------------------
// Server

struct GrpcServer::Conn {
  explicit Conn(int fd) : fd(fd) {}
  int fd;
  std::unique_ptr<Http2Conn> h2;
  struct Call {
    std::string path;
    std::string data;      // accumulated request DATA bytes
    bool headers_seen = false;
  };
  std::map<uint32_t, Call> calls;
  std::map<uint32_t, StreamPtr> live_streams;
  bool dead = false;
};

GrpcServer::GrpcServer() = default;

GrpcServer::~GrpcServer() {
  for (auto& c : conns_) {
    for (auto& [sid, sp] : c->live_streams) sp->alive = false;
    ::close(c->fd);
  }
  if (listen_fd_ >= 0) ::close(listen_fd_);
  if (!socket_path_.empty()) ::unlink(socket_path_.c_str());
}

void GrpcServer::AddUnary(const std::string& path, UnaryFn fn) {
  unary_[path] = std::move(fn);
}

void GrpcServer::AddServerStream(const std::string& path, StreamStartFn fn) {
  streams_[path] = std::move(fn);
}

void GrpcServer::Listen(const std::string& unix_path) {
  socket_path_ = unix_path;
  ::unlink(unix_path.c_str());
  listen_fd_ = ::socket(AF_UNIX, SOCK_STREAM, 0);
  if (listen_fd_ < 0) throw Http2Error("socket() failed");
  sockaddr_un addr{};
  addr.sun_family = AF_UNIX;
  if (unix_path.size() >= sizeof(addr.sun_path))
    throw Http2Error("socket path too long");
  memcpy(addr.sun_path, unix_path.c_str(), unix_path.size() + 1);
  if (::bind(listen_fd_, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0)
    throw Http2Error(std::string("bind: ") + strerror(errno));
  if (::listen(listen_fd_, 16) < 0)
    throw Http2Error(std::string("listen: ") + strerror(errno));
}

void GrpcServer::Accept() {
  int fd = ::accept(listen_fd_, nullptr, nullptr);
  if (fd < 0) return;
  auto conn = std::make_unique<Conn>(fd);
  Conn* c = conn.get();
  Http2Conn::Events ev;
  ev.on_headers = [this, c](uint32_t stream, std::vector<Header> hdrs,
                            bool end_stream) {
    auto& call = c->calls[stream];
    if (!call.headers_seen) {
      call.headers_seen = true;
      for (const auto& h : hdrs)
        if (h.name == ":path") call.path = h.value;
    }
    if (end_stream) Dispatch(c, stream);
  };
  ev.on_data = [this, c](uint32_t stream, const std::string& data,
                         bool end_stream) {
    auto it = c->calls.find(stream);
    if (it == c->calls.end()) return;
    it->second.data += data;
    if (end_stream) Dispatch(c, stream);
  };
  ev.on_rst_stream = [c](uint32_t stream) {
    auto it = c->live_streams.find(stream);
    if (it != c->live_streams.end()) {
      it->second->alive = false;
      c->live_streams.erase(it);
    }
    c->calls.erase(stream);
  };
  ev.on_goaway = [c]() { c->dead = true; };
  c->h2 = std::make_unique<Http2Conn>(fd, Http2Conn::Role::kServer, ev);
  c->h2->Handshake();
  conns_.push_back(std::move(conn));
}

void GrpcServer::Dispatch(Conn* c, uint32_t stream) {
  auto it = c->calls.find(stream);
  if (it == c->calls.end()) return;
  Conn::Call call = std::move(it->second);
  c->calls.erase(it);

  std::string req;
  int status = kOk;
  std::string message;
  try {
    PopMessage(&call.data, &req);  // empty request body is a valid Empty
  } catch (const GrpcError& e) {
    status = e.code;
    message = e.what();
  }

  if (status == kOk) {
    if (auto u = unary_.find(call.path); u != unary_.end()) {
      try {
        std::string resp = u->second(req);
        c->h2->SendHeaders(stream,
                           {{":status", "200"},
                            {"content-type", "application/grpc"}},
                           false);
        c->h2->SendData(stream, MessageFrame(resp), false);
        c->h2->SendHeaders(stream, {{"grpc-status", "0"}}, true);
        return;
      } catch (const GrpcError& e) {
        status = e.code;
        message = e.what();
      } catch (const std::exception& e) {
        status = kInternal;
        message = e.what();
      }
    } else if (auto s = streams_.find(call.path); s != streams_.end()) {
      auto handle = std::make_shared<StreamHandle>();
      handle->alive = true;
      handle->conn = c->h2.get();
      handle->stream = stream;
      c->live_streams[stream] = handle;
      c->h2->SendHeaders(stream,
                         {{":status", "200"},
                          {"content-type", "application/grpc"}},
                         false);
      try {
        s->second(req, handle);
        return;
      } catch (const std::exception& e) {
        c->live_streams.erase(stream);
        handle->alive = false;
        c->h2->SendHeaders(stream,
                           {{"grpc-status", std::to_string(kInternal)},
                            {"grpc-message", e.what()}},
                           true);
        return;
      }
    } else {
      status = kUnimplemented;
      message = "unknown method " + call.path;
    }
  }
  // Trailers-only error response.
  c->h2->SendHeaders(stream,
                     {{":status", "200"},
                      {"content-type", "application/grpc"},
                      {"grpc-status", std::to_string(status)},
                      {"grpc-message", message}},
                     true);
}

void GrpcServer::StreamSend(const StreamPtr& s, const std::string& message) {
  if (!s || !s->alive) return;
  s->conn->SendData(s->stream, MessageFrame(message), false);
}

void GrpcServer::StreamClose(const StreamPtr& s, int status,
                             const std::string& msg) {
  if (!s || !s->alive) return;
  s->alive = false;
  std::vector<Header> trailers = {{"grpc-status", std::to_string(status)}};
  if (!msg.empty()) trailers.push_back({"grpc-message", msg});
  s->conn->SendHeaders(s->stream, trailers, true);
}

void GrpcServer::CloseConn(Conn* c) {
  for (auto& [sid, sp] : c->live_streams) sp->alive = false;
  c->live_streams.clear();
  ::close(c->fd);
  c->fd = -1;
  c->dead = true;
}

void GrpcServer::PollOnce(int timeout_ms) {
  std::vector<pollfd> fds;
  fds.push_back({listen_fd_, POLLIN, 0});
  for (auto& c : conns_)
    if (!c->dead) fds.push_back({c->fd, POLLIN, 0});
  int n = ::poll(fds.data(), fds.size(), timeout_ms);
  if (n <= 0) return;
  if (fds[0].revents & POLLIN) Accept();
  size_t fi = 1;
  for (auto& c : conns_) {
    if (c->dead) continue;
    if (fi >= fds.size()) break;
    pollfd& pfd = fds[fi++];
    if (pfd.fd != c->fd) continue;  // conns_ mutated by Accept: resync next tick
    if (pfd.revents & (POLLIN | POLLHUP | POLLERR)) {
      try {
        if (!c->h2->OnReadable()) CloseConn(c.get());
      } catch (const std::exception& e) {
        fprintf(stderr, "[kgct-device-plugin] conn error: %s\n", e.what());
        CloseConn(c.get());
      }
    }
  }
  conns_.erase(std::remove_if(conns_.begin(), conns_.end(),
                              [](const std::unique_ptr<Conn>& c) {
                                return c->dead;
                              }),
               conns_.end());
}

// ---------------------------------------------------------------------------
// Client (registration)

int GrpcUnaryCall(const std::string& unix_path, const std::string& method_path,
                  const std::string& request, std::string* response,
                  std::string* error, int timeout_ms) {
  int fd = UnixConnect(unix_path);
  if (fd < 0) {
    *error = "connect " + unix_path + ": " + strerror(errno);
    return kUnavailable;
  }

  int grpc_status = -1;
  std::string grpc_message;
  std::string body;
  bool done = false;

  Http2Conn::Events ev;
  ev.on_headers = [&](uint32_t /*stream*/, std::vector<Header> hdrs,
                      bool end_stream) {
    for (const auto& h : hdrs) {
      if (h.name == "grpc-status") grpc_status = atoi(h.value.c_str());
      if (h.name == "grpc-message") grpc_message = h.value;
    }
    if (end_stream) done = true;
  };
  ev.on_data = [&](uint32_t /*stream*/, const std::string& data,
                   bool end_stream) {
    body += data;
    if (end_stream) done = true;
  };
  ev.on_rst_stream = [&](uint32_t) { done = true; };
  ev.on_goaway = [&]() { done = true; };

  try {
    Http2Conn h2(fd, Http2Conn::Role::kClient, ev);
    h2.Handshake();
    uint32_t stream = h2.NextStreamId();
    h2.SendHeaders(stream,
                   {{":method", "POST"},
                    {":scheme", "http"},
                    {":path", method_path},
                    {":authority", "localhost"},
                    {"content-type", "application/grpc"},
                    {"user-agent", "kgct-tpu-device-plugin/1.0"},
                    {"te", "trailers"}},
                   false);
    h2.SendData(stream, MessageFrame(request), true);

    pollfd pfd{fd, POLLIN, 0};
    int waited = 0;
    while (!done && waited < timeout_ms) {
      int r = ::poll(&pfd, 1, 100);
      waited += 100;
      if (r < 0 && errno != EINTR) break;
      if (r > 0 && !h2.OnReadable()) break;
    }
  } catch (const std::exception& e) {
    ::close(fd);
    *error = e.what();
    return kInternal;
  }
  ::close(fd);

  if (!done && grpc_status < 0) {
    *error = "timeout waiting for " + method_path;
    return kUnavailable;
  }
  if (grpc_status != 0) {
    *error = grpc_message.empty() ? "grpc status " + std::to_string(grpc_status)
                                  : grpc_message;
    return grpc_status < 0 ? kUnknown : grpc_status;
  }
  std::string msg;
  if (PopMessage(&body, &msg)) *response = msg;
  return kOk;
}

}  // namespace kgct
