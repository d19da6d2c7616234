// Carried unchanged from cluster/device-plugin/src/hpack.h: the CUDA device
// plugin keeps its own copy of the transport, as the port does of every
// module it carries. Edit both copies together or neither.
// HPACK (RFC 7541) header codec — the subset a kubelet device plugin needs.
//
// Decoder: complete — indexed fields, all literal forms, dynamic-table
// inserts/evictions/size updates, and full static-Huffman string decoding
// (Go's and gRPC C-core's encoders Huffman-compress almost every literal, so
// a plugin cannot interop without it). Malformed input throws HpackError and
// the connection is torn down — never a silent mis-parse.
//
// Encoder: deliberately minimal and stateless — exact static-table matches
// are sent indexed, everything else as literal-without-indexing with raw
// (H=0) strings. Both are always legal; peers do not need our encoder to use
// the dynamic table or Huffman.
//
// TPU-native framework note: this file replaces the role the NVIDIA device
// plugin's vendored gRPC stack played in the reference's GPU enablement layer
// (reference gpu-crio-setup.sh:87-126, old_README.md:1206-1318).
#pragma once

#include <cstddef>
#include <cstdint>
#include <deque>
#include <stdexcept>
#include <string>
#include <vector>

namespace kgct {

struct Header {
  std::string name;
  std::string value;
};

struct HpackError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// Decodes one complete header block (HEADERS + CONTINUATIONs payload).
class HpackDecoder {
 public:
  std::vector<Header> Decode(const uint8_t* p, size_t n);

 private:
  const Header& Lookup(uint64_t index) const;
  void Insert(Header h);

  size_t max_size_ = 4096;  // peer may lower/raise via table-size updates
  size_t size_ = 0;
  std::deque<Header> dynamic_;  // front = most recent (index 62)
};

std::string HpackEncode(const std::vector<Header>& headers);

// Exposed for tests: RFC 7541 static Huffman decode of a complete string.
std::string HuffmanDecode(const uint8_t* p, size_t n);

}  // namespace kgct
