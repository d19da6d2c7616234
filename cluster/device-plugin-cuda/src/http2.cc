// Carried unchanged from cluster/device-plugin/src/http2.cc: the CUDA device
// plugin keeps its own copy of the transport, as the port does of every
// module it carries. Edit both copies together or neither.
#include "http2.h"

#include <errno.h>
#include <string.h>
#include <unistd.h>

#include <algorithm>

namespace kgct {
namespace {

constexpr char kPreface[] = "PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n";
constexpr size_t kPrefaceLen = 24;

enum FrameType : uint8_t {
  kData = 0x0,
  kHeaders = 0x1,
  kPriority = 0x2,
  kRstStream = 0x3,
  kSettings = 0x4,
  kPushPromise = 0x5,
  kPing = 0x6,
  kGoAway = 0x7,
  kWindowUpdate = 0x8,
  kContinuation = 0x9,
};

enum Flags : uint8_t {
  kEndStream = 0x1,
  kAck = 0x1,
  kEndHeaders = 0x4,
  kPadded = 0x8,
  kPriorityFlag = 0x20,
};

uint32_t U32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
         (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

}  // namespace

Http2Conn::Http2Conn(int fd, Role role, Events events)
    : fd_(fd), role_(role), events_(std::move(events)) {}

void Http2Conn::Handshake() {
  if (role_ == Role::kClient) WriteAll(kPreface, kPrefaceLen);
  WriteFrame(kSettings, 0, 0, "");  // defaults are fine for both roles
  // Open up the receive side: a large connection window so peers never stall
  // on us (we consume immediately).
  std::string wu(4, '\0');
  uint32_t inc = (1u << 30);
  wu[0] = char(inc >> 24), wu[1] = char(inc >> 16);
  wu[2] = char(inc >> 8), wu[3] = char(inc);
  WriteFrame(kWindowUpdate, 0, 0, wu);
}

Http2Conn::Stream& Http2Conn::GetStream(uint32_t id) {
  auto [it, inserted] = streams_.try_emplace(id);
  if (inserted) it->second.send_window = peer_initial_window_;
  return it->second;
}

uint32_t Http2Conn::NextStreamId() {
  uint32_t id = next_stream_id_;
  next_stream_id_ += 2;
  return id;
}

void Http2Conn::WriteAll(const void* p, size_t n) {
  const char* c = static_cast<const char*>(p);
  while (n > 0) {
    ssize_t w = ::write(fd_, c, n);
    if (w < 0) {
      if (errno == EINTR) continue;
      throw Http2Error(std::string("write: ") + strerror(errno));
    }
    c += w;
    n -= static_cast<size_t>(w);
  }
}

void Http2Conn::WriteFrame(uint8_t type, uint8_t flags, uint32_t stream,
                           const std::string& payload) {
  uint8_t hdr[9];
  size_t n = payload.size();
  hdr[0] = uint8_t(n >> 16), hdr[1] = uint8_t(n >> 8), hdr[2] = uint8_t(n);
  hdr[3] = type;
  hdr[4] = flags;
  hdr[5] = uint8_t(stream >> 24) & 0x7f;
  hdr[6] = uint8_t(stream >> 16);
  hdr[7] = uint8_t(stream >> 8);
  hdr[8] = uint8_t(stream);
  std::string buf(reinterpret_cast<char*>(hdr), 9);
  buf += payload;
  WriteAll(buf.data(), buf.size());
}

void Http2Conn::SendHeaders(uint32_t stream, const std::vector<Header>& headers,
                            bool end_stream) {
  std::string block = HpackEncode(headers);
  // Our header blocks are far below any MAX_FRAME_SIZE; one frame suffices.
  WriteFrame(kHeaders, kEndHeaders | (end_stream ? kEndStream : 0), stream,
             block);
  Stream& st = GetStream(stream);
  if (end_stream) st.closed_local = true;
}

void Http2Conn::SendData(uint32_t stream, const std::string& payload,
                         bool end_stream) {
  Stream& st = GetStream(stream);
  st.pending += payload;
  st.pending_end = st.pending_end || end_stream;
  TrySend(stream, st);
}

void Http2Conn::TrySend(uint32_t stream, Stream& st) {
  while (!st.pending.empty() || (st.pending_end && !st.closed_local)) {
    size_t budget = static_cast<size_t>(
        std::min<int64_t>(std::max<int64_t>(conn_send_window_, 0),
                          std::max<int64_t>(st.send_window, 0)));
    size_t n = std::min({st.pending.size(),
                         static_cast<size_t>(peer_max_frame_),
                         budget > 0 ? budget : 0});
    if (n == 0 && !st.pending.empty()) return;  // wait for WINDOW_UPDATE
    bool last = (n == st.pending.size()) && st.pending_end;
    WriteFrame(kData, last ? kEndStream : 0, stream, st.pending.substr(0, n));
    st.pending.erase(0, n);
    conn_send_window_ -= static_cast<int64_t>(n);
    st.send_window -= static_cast<int64_t>(n);
    if (last) {
      st.closed_local = true;
      return;
    }
    if (st.pending.empty()) return;
  }
}

void Http2Conn::SendRstStream(uint32_t stream, uint32_t error_code) {
  std::string p(4, '\0');
  p[0] = char(error_code >> 24), p[1] = char(error_code >> 16);
  p[2] = char(error_code >> 8), p[3] = char(error_code);
  WriteFrame(kRstStream, 0, stream, p);
  streams_.erase(stream);
}

void Http2Conn::SendGoAway(uint32_t error_code) {
  std::string p(8, '\0');
  // last stream id 2^31-1 (we processed everything we saw), then the code.
  p[0] = 0x7f, p[1] = char(0xff), p[2] = char(0xff), p[3] = char(0xff);
  p[4] = char(error_code >> 24), p[5] = char(error_code >> 16);
  p[6] = char(error_code >> 8), p[7] = char(error_code);
  WriteFrame(kGoAway, 0, 0, p);
}

bool Http2Conn::OnReadable() {
  char buf[65536];
  ssize_t r = ::read(fd_, buf, sizeof(buf));
  if (r < 0) {
    if (errno == EINTR || errno == EAGAIN) return true;
    throw Http2Error(std::string("read: ") + strerror(errno));
  }
  if (r == 0) return false;  // peer closed
  inbuf_.append(buf, static_cast<size_t>(r));

  if (role_ == Role::kServer && !preface_seen_) {
    if (inbuf_.size() < kPrefaceLen) return true;
    if (inbuf_.compare(0, kPrefaceLen, kPreface) != 0)
      throw Http2Error("bad client preface");
    inbuf_.erase(0, kPrefaceLen);
    preface_seen_ = true;
  }

  while (inbuf_.size() >= 9) {
    const uint8_t* h = reinterpret_cast<const uint8_t*>(inbuf_.data());
    size_t len = (size_t(h[0]) << 16) | (size_t(h[1]) << 8) | h[2];
    if (len > (1u << 24)) throw Http2Error("oversized frame");
    if (inbuf_.size() < 9 + len) break;
    uint8_t type = h[3], flags = h[4];
    uint32_t stream = U32(h + 5) & 0x7fffffff;
    HandleFrame(type, flags, stream, h + 9, len);
    inbuf_.erase(0, 9 + len);
  }
  return true;
}

void Http2Conn::HandleFrame(uint8_t type, uint8_t flags, uint32_t stream,
                            const uint8_t* p, size_t n) {
  if (in_continuation_ && type != kContinuation)
    throw Http2Error("expected CONTINUATION");
  switch (type) {
    case kSettings:
      HandleSettings(flags, p, n);
      break;
    case kPing:
      if (!(flags & kAck)) {
        if (n != 8) throw Http2Error("bad PING length");
        WriteFrame(kPing, kAck, 0,
                   std::string(reinterpret_cast<const char*>(p), n));
      }
      break;
    case kWindowUpdate: {
      if (n != 4) throw Http2Error("bad WINDOW_UPDATE length");
      uint32_t inc = U32(p) & 0x7fffffff;
      if (stream == 0) {
        conn_send_window_ += inc;
        for (auto& [sid, st] : streams_) TrySend(sid, st);
      } else {
        auto it = streams_.find(stream);
        if (it != streams_.end()) {
          it->second.send_window += inc;
          TrySend(stream, it->second);
        }
      }
      break;
    }
    case kHeaders: {
      if (stream == 0) throw Http2Error("HEADERS on stream 0");
      size_t off = 0, pad = 0;
      if (flags & kPadded) {
        if (n < 1) throw Http2Error("bad padding");
        pad = p[0];
        off = 1;
      }
      if (flags & kPriorityFlag) off += 5;
      if (off + pad > n) throw Http2Error("bad padding");
      header_block_.assign(reinterpret_cast<const char*>(p + off),
                           n - off - pad);
      header_end_stream_ = flags & kEndStream;
      continuation_stream_ = stream;
      if (flags & kEndHeaders) {
        auto hdrs = hpack_in_.Decode(
            reinterpret_cast<const uint8_t*>(header_block_.data()),
            header_block_.size());
        GetStream(stream);
        if (events_.on_headers)
          events_.on_headers(stream, std::move(hdrs), header_end_stream_);
      } else {
        in_continuation_ = true;
      }
      break;
    }
    case kContinuation: {
      if (!in_continuation_ || stream != continuation_stream_)
        throw Http2Error("unexpected CONTINUATION");
      header_block_.append(reinterpret_cast<const char*>(p), n);
      if (flags & kEndHeaders) {
        in_continuation_ = false;
        auto hdrs = hpack_in_.Decode(
            reinterpret_cast<const uint8_t*>(header_block_.data()),
            header_block_.size());
        GetStream(stream);
        if (events_.on_headers)
          events_.on_headers(stream, std::move(hdrs), header_end_stream_);
      }
      break;
    }
    case kData: {
      if (stream == 0) throw Http2Error("DATA on stream 0");
      size_t off = 0, pad = 0;
      if (flags & kPadded) {
        if (n < 1) throw Http2Error("bad padding");
        pad = p[0];
        off = 1;
      }
      if (off + pad > n) throw Http2Error("bad padding");
      std::string payload(reinterpret_cast<const char*>(p + off),
                          n - off - pad);
      // Replenish receive windows immediately — we consume everything.
      if (n > 0) {
        std::string wu(4, '\0');
        uint32_t inc = static_cast<uint32_t>(n);
        wu[0] = char(inc >> 24), wu[1] = char(inc >> 16);
        wu[2] = char(inc >> 8), wu[3] = char(inc);
        WriteFrame(kWindowUpdate, 0, 0, wu);
        if (!(flags & kEndStream)) WriteFrame(kWindowUpdate, 0, stream, wu);
      }
      if (events_.on_data)
        events_.on_data(stream, payload, flags & kEndStream);
      break;
    }
    case kRstStream:
      streams_.erase(stream);
      if (events_.on_rst_stream) events_.on_rst_stream(stream);
      break;
    case kGoAway:
      if (events_.on_goaway) events_.on_goaway();
      break;
    case kPriority:
      break;  // scheduling hint only; ignored
    case kPushPromise:
      throw Http2Error("unexpected PUSH_PROMISE");
    default:
      break;  // unknown frame types MUST be ignored (RFC 7540 §4.1)
  }
}

void Http2Conn::HandleSettings(uint8_t flags, const uint8_t* p, size_t n) {
  if (flags & kAck) return;
  if (n % 6 != 0) throw Http2Error("bad SETTINGS length");
  for (size_t i = 0; i < n; i += 6) {
    uint16_t id = (uint16_t(p[i]) << 8) | p[i + 1];
    uint32_t value = U32(p + i + 2);
    switch (id) {
      case 0x4: {  // INITIAL_WINDOW_SIZE: adjust all open stream windows
        int64_t delta =
            int64_t(value) - int64_t(peer_initial_window_);
        peer_initial_window_ = value;
        for (auto& [sid, st] : streams_) {
          st.send_window += delta;
          TrySend(sid, st);
        }
        break;
      }
      case 0x5:  // MAX_FRAME_SIZE
        peer_max_frame_ = value;
        break;
      default:
        break;  // HEADER_TABLE_SIZE (we never index), others: ignored
    }
  }
  WriteFrame(kSettings, kAck, 0, "");
}

}  // namespace kgct
