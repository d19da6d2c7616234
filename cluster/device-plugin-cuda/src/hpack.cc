// Carried unchanged from cluster/device-plugin/src/hpack.cc: the CUDA device
// plugin keeps its own copy of the transport, as the port does of every
// module it carries. Edit both copies together or neither.
#include "hpack.h"

#include <array>
#include <memory>

#include "hpack_huffman_table.h"

namespace kgct {
namespace {

// RFC 7541 Appendix A: the 61-entry static table.
const std::array<Header, 62> kStatic = {{
    {"", ""},  // index 0 unused
    {":authority", ""},
    {":method", "GET"},
    {":method", "POST"},
    {":path", "/"},
    {":path", "/index.html"},
    {":scheme", "http"},
    {":scheme", "https"},
    {":status", "200"},
    {":status", "204"},
    {":status", "206"},
    {":status", "304"},
    {":status", "400"},
    {":status", "404"},
    {":status", "500"},
    {"accept-charset", ""},
    {"accept-encoding", "gzip, deflate"},
    {"accept-language", ""},
    {"accept-ranges", ""},
    {"accept", ""},
    {"access-control-allow-origin", ""},
    {"age", ""},
    {"allow", ""},
    {"authorization", ""},
    {"cache-control", ""},
    {"content-disposition", ""},
    {"content-encoding", ""},
    {"content-language", ""},
    {"content-length", ""},
    {"content-location", ""},
    {"content-range", ""},
    {"content-type", ""},
    {"cookie", ""},
    {"date", ""},
    {"etag", ""},
    {"expect", ""},
    {"expires", ""},
    {"from", ""},
    {"host", ""},
    {"if-match", ""},
    {"if-modified-since", ""},
    {"if-none-match", ""},
    {"if-range", ""},
    {"if-unmodified-since", ""},
    {"last-modified", ""},
    {"link", ""},
    {"location", ""},
    {"max-forwards", ""},
    {"proxy-authenticate", ""},
    {"proxy-authorization", ""},
    {"range", ""},
    {"referer", ""},
    {"refresh", ""},
    {"retry-after", ""},
    {"server", ""},
    {"set-cookie", ""},
    {"strict-transport-security", ""},
    {"transfer-encoding", ""},
    {"user-agent", ""},
    {"vary", ""},
    {"via", ""},
    {"www-authenticate", ""},
}};

// Binary trie for Huffman decode, built once. Node 0 is the root; children
// index further nodes; sym >= 0 marks a leaf.
struct HuffNode {
  int32_t child[2] = {-1, -1};
  int32_t sym = -1;
};

const std::vector<HuffNode>& HuffTrie() {
  static const std::vector<HuffNode>* trie = [] {
    auto* t = new std::vector<HuffNode>(1);
    for (int s = 0; s < 257; ++s) {
      uint32_t bits = kHuffSyms[s].bits;
      int len = kHuffSyms[s].len;
      size_t node = 0;
      for (int i = len - 1; i >= 0; --i) {
        int b = (bits >> i) & 1;
        if ((*t)[node].child[b] < 0) {
          (*t)[node].child[b] = static_cast<int32_t>(t->size());
          t->emplace_back();
        }
        node = (*t)[node].child[b];
      }
      (*t)[node].sym = s;
    }
    return t;
  }();
  return *trie;
}

class Reader {
 public:
  Reader(const uint8_t* p, size_t n) : p_(p), end_(p + n) {}
  bool Done() const { return p_ >= end_; }
  uint8_t Peek() const {
    if (Done()) throw HpackError("hpack: truncated block");
    return *p_;
  }
  uint8_t Next() {
    uint8_t b = Peek();
    ++p_;
    return b;
  }
  // RFC 7541 §5.1 integer with an N-bit prefix (prefix taken from Next()).
  uint64_t Int(int prefix_bits) {
    uint8_t mask = static_cast<uint8_t>((1u << prefix_bits) - 1);
    uint64_t v = Next() & mask;
    if (v < mask) return v;
    int shift = 0;
    while (true) {
      uint8_t b = Next();
      v += static_cast<uint64_t>(b & 0x7f) << shift;
      shift += 7;
      if (!(b & 0x80)) return v;
      if (shift > 56) throw HpackError("hpack: integer overflow");
    }
  }
  std::string String() {
    bool huffman = Peek() & 0x80;
    uint64_t len = Int(7);
    if (static_cast<size_t>(end_ - p_) < len)
      throw HpackError("hpack: truncated string");
    const uint8_t* s = p_;
    p_ += len;
    if (!huffman) return std::string(reinterpret_cast<const char*>(s), len);
    return HuffmanDecode(s, len);
  }

 private:
  const uint8_t* p_;
  const uint8_t* end_;
};

}  // namespace

std::string HuffmanDecode(const uint8_t* p, size_t n) {
  const auto& trie = HuffTrie();
  std::string out;
  size_t node = 0;
  int depth = 0;           // bits consumed since last symbol
  bool pad_ones = true;    // all such bits were 1s (valid EOS-prefix padding)
  for (size_t i = 0; i < n; ++i) {
    for (int bit = 7; bit >= 0; --bit) {
      int b = (p[i] >> bit) & 1;
      int32_t next = trie[node].child[b];
      if (next < 0) throw HpackError("hpack: invalid huffman code");
      node = static_cast<size_t>(next);
      ++depth;
      pad_ones = pad_ones && b == 1;
      if (trie[node].sym >= 0) {
        if (trie[node].sym == 256)
          throw HpackError("hpack: unexpected EOS symbol");
        out.push_back(static_cast<char>(trie[node].sym));
        node = 0;
        depth = 0;
        pad_ones = true;
      }
    }
  }
  // Remaining bits must be a strict prefix of EOS: fewer than 8 bits, all 1s.
  if (depth >= 8 || !pad_ones) throw HpackError("hpack: bad padding");
  return out;
}

const Header& HpackDecoder::Lookup(uint64_t index) const {
  if (index == 0) throw HpackError("hpack: index 0");
  if (index <= 61) return kStatic[index];
  size_t d = index - 62;
  if (d >= dynamic_.size()) throw HpackError("hpack: index out of range");
  return dynamic_[d];
}

void HpackDecoder::Insert(Header h) {
  size_t entry = h.name.size() + h.value.size() + 32;
  dynamic_.push_front(std::move(h));
  size_ += entry;
  while (size_ > max_size_ && !dynamic_.empty()) {
    size_ -= dynamic_.back().name.size() + dynamic_.back().value.size() + 32;
    dynamic_.pop_back();
  }
  if (size_ > max_size_) {  // single entry larger than the table: empty it
    dynamic_.clear();
    size_ = 0;
  }
}

std::vector<Header> HpackDecoder::Decode(const uint8_t* p, size_t n) {
  Reader r(p, n);
  std::vector<Header> out;
  while (!r.Done()) {
    uint8_t b = r.Peek();
    if (b & 0x80) {  // indexed field
      out.push_back(Lookup(r.Int(7)));
    } else if (b & 0x40) {  // literal, incremental indexing
      uint64_t idx = r.Int(6);
      Header h;
      h.name = idx ? Lookup(idx).name : r.String();
      h.value = r.String();
      out.push_back(h);
      Insert(std::move(h));
    } else if (b & 0x20) {  // dynamic table size update
      uint64_t sz = r.Int(5);
      // Peers may shrink below or (back) up to the SETTINGS value; we never
      // advertise a custom limit so cap at the default.
      if (sz > 4096) throw HpackError("hpack: size update above limit");
      max_size_ = sz;
      while (size_ > max_size_ && !dynamic_.empty()) {
        size_ -= dynamic_.back().name.size() +
                 dynamic_.back().value.size() + 32;
        dynamic_.pop_back();
      }
    } else {  // literal, no indexing (0000) / never indexed (0001)
      uint64_t idx = r.Int(4);
      Header h;
      h.name = idx ? Lookup(idx).name : r.String();
      h.value = r.String();
      out.push_back(std::move(h));
    }
  }
  return out;
}

namespace {

void EncodeInt(std::string* out, uint64_t v, int prefix_bits, uint8_t flags) {
  uint8_t mask = static_cast<uint8_t>((1u << prefix_bits) - 1);
  if (v < mask) {
    out->push_back(static_cast<char>(flags | v));
    return;
  }
  out->push_back(static_cast<char>(flags | mask));
  v -= mask;
  while (v >= 128) {
    out->push_back(static_cast<char>(0x80 | (v & 0x7f)));
    v >>= 7;
  }
  out->push_back(static_cast<char>(v));
}

void EncodeString(std::string* out, const std::string& s) {
  EncodeInt(out, s.size(), 7, 0x00);  // H=0: raw
  out->append(s);
}

}  // namespace

std::string HpackEncode(const std::vector<Header>& headers) {
  std::string out;
  for (const auto& h : headers) {
    int exact = -1, name_only = -1;
    for (int i = 1; i <= 61; ++i) {
      if (kStatic[i].name != h.name) continue;
      if (name_only < 0) name_only = i;
      if (kStatic[i].value == h.value) {
        exact = i;
        break;
      }
    }
    if (exact > 0) {
      EncodeInt(&out, static_cast<uint64_t>(exact), 7, 0x80);
    } else if (name_only > 0) {
      EncodeInt(&out, static_cast<uint64_t>(name_only), 4, 0x00);
      EncodeString(&out, h.value);
    } else {
      EncodeInt(&out, 0, 4, 0x00);
      EncodeString(&out, h.name);
      EncodeString(&out, h.value);
    }
  }
  return out;
}

}  // namespace kgct
