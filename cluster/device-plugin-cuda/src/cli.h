// What the plugin and its kubelet stand-in share outside the transport:
// reading a `--flag=value` argument and writing a JSON string literal.
#pragma once

#include <stdio.h>
#include <string.h>

#include <string>
#include <string_view>

namespace kgct {

// The value of `arg` if it is `flag=value` with a non-empty value, else
// nullptr. The pointer lies inside `arg`.
inline const char* FlagValue(const std::string& arg, const char* flag) {
  size_t n = strlen(flag);
  if (arg.rfind(flag, 0) == 0 && arg.size() > n && arg[n] == '=')
    return arg.c_str() + n + 1;
  return nullptr;
}

// `s` as a quoted JSON string: quotes and backslashes escaped, control
// characters as \u00XX.
inline std::string JsonStr(std::string_view s) {
  std::string out = "\"";
  for (char c : s) {
    if (c == '"' || c == '\\') out += '\\';
    if (static_cast<unsigned char>(c) < 0x20) {
      char buf[8];
      snprintf(buf, sizeof buf, "\\u%04x", c);
      out += buf;
      continue;
    }
    out += c;
  }
  return out + "\"";
}

}  // namespace kgct
