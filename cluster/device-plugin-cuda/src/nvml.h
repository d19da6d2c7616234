// NVML reached through dlopen, never linked: libnvidia-ml ships with the
// installed NVIDIA driver, so the plugin binary needs nothing at build time
// and loads the node's own copy at run time (from the host's root, mounted
// at --driver-root, when it runs in a container).
//
// Only the entry points the device plugin needs, each by its versioned
// name (`_v2` where NVML has one), every return code checked. Nothing here
// guesses: a library that does not load, a symbol that is missing or a
// call that fails throws NvmlError naming it.
#pragma once

#include <stdexcept>
#include <string>
#include <vector>

namespace kgct {

struct NvmlError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

struct Gpu {
  unsigned index = 0;
  unsigned minor = 0;  // /dev/nvidia<minor>; not assumed equal to index
  std::string uuid;    // "GPU-..."; the device ID the kubelet sees
  std::string name;
};

class Nvml {
 public:
  // Loads libnvidia-ml.so.1 (searched by the dynamic loader when
  // `driver_root` is "/", in the driver root's library directories
  // otherwise), resolves every entry point and calls nvmlInit_v2.
  explicit Nvml(const std::string& driver_root);
  ~Nvml();
  Nvml(const Nvml&) = delete;
  Nvml& operator=(const Nvml&) = delete;

  std::vector<Gpu> Devices() const;
  std::string DriverVersion() const;
  // True while nvmlDeviceGetHandleByUUID resolves `uuid`.
  bool Resolves(const std::string& uuid) const;
  // Where the loaded library lies, symlinks resolved (dlinfo).
  const std::string& path() const { return path_; }

 private:
  struct Api;
  void Check(int rc, const char* what) const;

  void* handle_ = nullptr;
  Api* api_ = nullptr;
  std::string path_;
};

}  // namespace kgct
