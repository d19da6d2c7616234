// Carried unchanged from cluster/device-plugin/src/grpc.h: the CUDA device
// plugin keeps its own copy of the transport, as the port does of every
// module it carries. Edit both copies together or neither.
// gRPC-over-HTTP/2 on unix sockets: a poll-driven server (unary +
// server-streaming) and a blocking unary client — exactly the two roles a
// kubelet device plugin needs (serve v1beta1.DevicePlugin; dial
// v1beta1.Registration on kubelet.sock).
//
// Framing per the gRPC HTTP/2 spec: requests/responses are length-prefixed
// messages (1-byte compressed flag + u32 big-endian length) inside DATA
// frames; status travels in HTTP trailers (grpc-status/grpc-message);
// errors without a body use trailers-only responses. Compression is not
// supported and flagged messages are rejected (kubelet never compresses).
#pragma once

#include <cstdint>
#include <functional>
#include <map>
#include <memory>
#include <string>
#include <vector>

#include "http2.h"

namespace kgct {

// Canonical gRPC status codes (subset used here).
enum GrpcStatus : int {
  kOk = 0,
  kUnknown = 2,
  kNotFound = 5,
  kUnimplemented = 12,
  kInternal = 13,
  kUnavailable = 14,
};

struct GrpcError : std::runtime_error {
  GrpcError(int code, const std::string& msg)
      : std::runtime_error(msg), code(code) {}
  int code;
};

class GrpcServer {
 public:
  // Serialized request bytes in, serialized response bytes out. Throw
  // GrpcError to fail the call with a status.
  using UnaryFn = std::function<std::string(const std::string&)>;

  // Handle to a live server-stream; owned jointly by the server (which
  // invalidates it when the stream/connection dies) and the application
  // (which holds it to push messages later).
  struct StreamHandle {
    bool alive = false;
    Http2Conn* conn = nullptr;
    uint32_t stream = 0;
  };
  using StreamPtr = std::shared_ptr<StreamHandle>;
  using StreamStartFn =
      std::function<void(const std::string& request, StreamPtr)>;

  GrpcServer();  // out-of-line: Conn is incomplete here
  ~GrpcServer();

  void AddUnary(const std::string& path, UnaryFn fn);
  void AddServerStream(const std::string& path, StreamStartFn fn);

  // Binds + listens on a unix socket (unlinks any stale file first).
  void Listen(const std::string& unix_path);
  // Accepts/reads once with the given timeout; dispatches handlers inline.
  void PollOnce(int timeout_ms);

  void StreamSend(const StreamPtr& s, const std::string& message);
  void StreamClose(const StreamPtr& s, int status, const std::string& msg);

  int listen_fd() const { return listen_fd_; }

 private:
  struct Conn;
  void Accept();
  void Dispatch(Conn* c, uint32_t stream);
  void CloseConn(Conn* c);

  int listen_fd_ = -1;
  std::string socket_path_;
  std::map<std::string, UnaryFn> unary_;
  std::map<std::string, StreamStartFn> streams_;
  std::vector<std::unique_ptr<Conn>> conns_;
};

// Blocking unary call. Returns the gRPC status code (0 = OK); on success
// *response holds the serialized reply, otherwise *error the message.
int GrpcUnaryCall(const std::string& unix_path, const std::string& method_path,
                  const std::string& request, std::string* response,
                  std::string* error, int timeout_ms = 5000);

}  // namespace kgct
