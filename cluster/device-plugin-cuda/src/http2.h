// Carried unchanged from cluster/device-plugin/src/http2.h: the CUDA device
// plugin keeps its own copy of the transport, as the port does of every
// module it carries. Edit both copies together or neither.
// Minimal HTTP/2 (RFC 7540) connection — the subset gRPC-over-unix-socket
// needs, speaking to Go's net/http2 (kubelet) and gRPC C-core (tests).
//
// Covered: connection preface both roles, SETTINGS exchange + ack,
// HEADERS/CONTINUATION with padding + priority flags, DATA with padding,
// PING ack, RST_STREAM, GOAWAY, WINDOW_UPDATE with real send-side flow
// control (per-connection and per-stream windows; unsendable bytes queue and
// flush on window updates), receive-side window replenishment, and
// SETTINGS_MAX_FRAME_SIZE-bounded writes. Not covered (not needed, rejected
// or ignored): server push, priorities as scheduling input, TLS.
//
// Single-threaded: the owner runs a poll loop and calls OnReadable(); all
// callbacks fire on that thread. Writes are blocking (local unix sockets;
// peers are kubelet/CRI — they read promptly).
#pragma once

#include <cstdint>
#include <functional>
#include <map>
#include <string>
#include <vector>

#include "hpack.h"

namespace kgct {

struct Http2Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

class Http2Conn {
 public:
  struct Events {
    // end_stream: no DATA will follow (trailers-only or final frame).
    std::function<void(uint32_t stream, std::vector<Header>, bool end_stream)>
        on_headers;
    std::function<void(uint32_t stream, const std::string&, bool end_stream)>
        on_data;
    std::function<void(uint32_t stream)> on_rst_stream;
    std::function<void()> on_goaway;
  };

  enum class Role { kClient, kServer };

  Http2Conn(int fd, Role role, Events events);

  // Sends our preface/SETTINGS. Call once before the poll loop.
  void Handshake();

  // Feed incoming bytes from the socket. Returns false when the peer closed
  // the connection. Throws Http2Error on protocol violations (caller should
  // close). Callbacks fire from inside.
  bool OnReadable();

  void SendHeaders(uint32_t stream, const std::vector<Header>& headers,
                   bool end_stream);
  // Queues if flow-control windows are exhausted; flushed on WINDOW_UPDATE.
  void SendData(uint32_t stream, const std::string& payload, bool end_stream);
  void SendRstStream(uint32_t stream, uint32_t error_code);
  void SendGoAway(uint32_t error_code);

  // Client role: next available (odd) stream id.
  uint32_t NextStreamId();

  int fd() const { return fd_; }

 private:
  struct Stream {
    int64_t send_window = 65535;
    std::string pending;     // bytes waiting for window
    bool pending_end = false;
    bool closed_local = false;
  };

  Stream& GetStream(uint32_t id);
  void WriteAll(const void* p, size_t n);
  void WriteFrame(uint8_t type, uint8_t flags, uint32_t stream,
                  const std::string& payload);
  void HandleFrame(uint8_t type, uint8_t flags, uint32_t stream,
                   const uint8_t* p, size_t n);
  void HandleSettings(uint8_t flags, const uint8_t* p, size_t n);
  void FlushPending(uint32_t stream);
  void TrySend(uint32_t stream, Stream& st);

  int fd_;
  Role role_;
  Events events_;
  std::string inbuf_;
  bool preface_seen_ = false;  // server role: client preface
  HpackDecoder hpack_in_;

  // Header block accumulation across HEADERS + CONTINUATION frames.
  uint32_t continuation_stream_ = 0;
  std::string header_block_;
  bool header_end_stream_ = false;
  bool in_continuation_ = false;

  int64_t conn_send_window_ = 65535;
  uint32_t peer_max_frame_ = 16384;
  uint32_t peer_initial_window_ = 65535;
  std::map<uint32_t, Stream> streams_;
  uint32_t next_stream_id_ = 1;
};

}  // namespace kgct
