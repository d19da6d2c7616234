// Carried unchanged from cluster/device-plugin/src/pb.h: the CUDA device
// plugin keeps its own copy of the transport, as the port does of every
// module it carries. Edit both copies together or neither.
// Minimal protobuf wire-format codec (proto3 subset: varint, length-
// delimited). The kubelet device-plugin API v1beta1 uses only strings,
// bools, int64s, repeated messages, and map<string,string> — all expressible
// with these two wire types. Hand-rolled instead of linking libprotobuf so
// the plugin binary has zero dependencies beyond libc/libstdc++ (it runs in
// a scratch container on every node).
//
// Wire-format correctness is proven in tests/test_device_plugin.py: the fake
// kubelet serializes with the real libprotobuf (protoc-generated classes)
// and the plugin's responses are deserialized by it.
#pragma once

#include <cstdint>
#include <stdexcept>
#include <string>
#include <string_view>

namespace kgct {

struct PbError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

class PbWriter {
 public:
  void VarintField(int field, uint64_t v) {
    Key(field, 0);
    Varint(v);
  }
  void BoolField(int field, bool v) {
    if (v) VarintField(field, 1);  // proto3: default values are omitted
  }
  void StringField(int field, std::string_view s) {
    if (s.empty()) return;
    BytesField(field, s);
  }
  // Always emitted (submessages may be meaningfully empty).
  void MessageField(int field, std::string_view bytes) { BytesField(field, bytes); }

  const std::string& str() const { return out_; }

 private:
  void BytesField(int field, std::string_view s) {
    Key(field, 2);
    Varint(s.size());
    out_.append(s);
  }
  void Key(int field, int wire_type) {
    Varint((static_cast<uint64_t>(field) << 3) | wire_type);
  }
  void Varint(uint64_t v) {
    while (v >= 0x80) {
      out_.push_back(static_cast<char>(0x80 | (v & 0x7f)));
      v >>= 7;
    }
    out_.push_back(static_cast<char>(v));
  }
  std::string out_;
};

class PbReader {
 public:
  explicit PbReader(std::string_view data) : p_(data.data()), end_(p_ + data.size()) {}

  // Advances to the next field; false at end of message.
  bool Next() {
    if (p_ >= end_) return false;
    uint64_t key = Varint();
    field_ = static_cast<int>(key >> 3);
    wire_ = static_cast<int>(key & 7);
    return true;
  }
  int field() const { return field_; }

  uint64_t varint() {
    if (wire_ != 0) throw PbError("pb: expected varint");
    return Varint();
  }
  std::string_view bytes() {
    if (wire_ != 2) throw PbError("pb: expected length-delimited");
    uint64_t n = Varint();
    if (static_cast<uint64_t>(end_ - p_) < n) throw PbError("pb: truncated");
    std::string_view s(p_, n);
    p_ += n;
    return s;
  }
  void skip() {
    switch (wire_) {
      case 0: Varint(); break;
      case 1: Advance(8); break;
      case 2: bytes(); break;
      case 5: Advance(4); break;
      default: throw PbError("pb: unsupported wire type");
    }
  }

 private:
  void Advance(size_t n) {
    if (static_cast<size_t>(end_ - p_) < n) throw PbError("pb: truncated");
    p_ += n;
  }
  uint64_t Varint() {
    uint64_t v = 0;
    int shift = 0;
    while (p_ < end_) {
      uint8_t b = static_cast<uint8_t>(*p_++);
      v |= static_cast<uint64_t>(b & 0x7f) << shift;
      if (!(b & 0x80)) return v;
      shift += 7;
      if (shift >= 64) break;
    }
    throw PbError("pb: bad varint");
  }

  const char* p_;
  const char* end_;
  int field_ = 0;
  int wire_ = 0;
};

}  // namespace kgct
