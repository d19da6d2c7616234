#include "nvml.h"

#include <dlfcn.h>
#include <limits.h>
#include <link.h>
#include <stdlib.h>
#include <sys/stat.h>

namespace kgct {
namespace {

// NVML's ABI, as its public header nvml.h declares it: nvmlReturn_t is an
// int-sized enum (0 = NVML_SUCCESS), nvmlDevice_t an opaque pointer.
using Device = void*;
constexpr int kSuccess = 0;
constexpr unsigned kUuidLen = 96;     // NVML_DEVICE_UUID_V2_BUFFER_SIZE
constexpr unsigned kNameLen = 96;     // NVML_DEVICE_NAME_V2_BUFFER_SIZE
constexpr unsigned kVersionLen = 80;  // NVML_SYSTEM_DRIVER_VERSION_BUFFER_SIZE

constexpr char kLib[] = "libnvidia-ml.so.1";

// Where a driver installs libnvidia-ml, below the driver root: the Debian/
// Ubuntu multiarch directories, the RPM ones, and the runfile default.
const char* const kLibDirs[] = {
    "/usr/lib/x86_64-linux-gnu", "/usr/lib/aarch64-linux-gnu",
    "/usr/lib64", "/usr/lib", "/lib/x86_64-linux-gnu", "/lib64", "/lib",
    "/usr/local/nvidia/lib64",
};

bool IsFile(const std::string& path) {
  struct stat st{};
  return stat(path.c_str(), &st) == 0 && S_ISREG(st.st_mode);
}

}  // namespace

struct Nvml::Api {
  int (*init)();
  int (*shutdown)();
  const char* (*error_string)(int);
  int (*count)(unsigned*);
  int (*by_index)(unsigned, Device*);
  int (*by_uuid)(const char*, Device*);
  int (*uuid)(Device, char*, unsigned);
  int (*minor)(Device, unsigned*);
  int (*name)(Device, char*, unsigned);
  int (*driver_version)(char*, unsigned);
};

Nvml::Nvml(const std::string& driver_root) {
  std::string target = kLib;
  if (!driver_root.empty() && driver_root != "/") {
    target.clear();
    for (const char* dir : kLibDirs) {
      std::string p = driver_root + dir + "/" + kLib;
      if (IsFile(p)) {
        target = p;
        break;
      }
    }
    if (target.empty())
      throw NvmlError(std::string("NVML library ") + kLib +
                      " not found under the driver root " + driver_root);
  }
  handle_ = dlopen(target.c_str(), RTLD_NOW | RTLD_LOCAL);
  if (handle_ == nullptr) {
    const char* e = dlerror();
    throw NvmlError("cannot load NVML " + target + ": " + (e ? e : "?"));
  }
  link_map* lm = nullptr;
  if (dlinfo(handle_, RTLD_DI_LINKMAP, &lm) != 0 || lm == nullptr ||
      lm->l_name == nullptr || lm->l_name[0] == '\0')
    throw NvmlError("cannot tell where NVML " + target + " was loaded from");
  char real[PATH_MAX];
  if (realpath(lm->l_name, real) == nullptr)
    throw NvmlError(std::string("cannot resolve NVML path ") + lm->l_name);
  path_ = real;

  api_ = new Api{};
  auto sym = [this](const char* name) {
    void* p = dlsym(handle_, name);
    if (p == nullptr)
      throw NvmlError(std::string("NVML ") + path_ + " lacks " + name);
    return p;
  };
  api_->init = reinterpret_cast<int (*)()>(sym("nvmlInit_v2"));
  api_->shutdown = reinterpret_cast<int (*)()>(sym("nvmlShutdown"));
  api_->error_string =
      reinterpret_cast<const char* (*)(int)>(sym("nvmlErrorString"));
  api_->count = reinterpret_cast<int (*)(unsigned*)>(
      sym("nvmlDeviceGetCount_v2"));
  api_->by_index = reinterpret_cast<int (*)(unsigned, Device*)>(
      sym("nvmlDeviceGetHandleByIndex_v2"));
  api_->by_uuid = reinterpret_cast<int (*)(const char*, Device*)>(
      sym("nvmlDeviceGetHandleByUUID"));
  api_->uuid = reinterpret_cast<int (*)(Device, char*, unsigned)>(
      sym("nvmlDeviceGetUUID"));
  api_->minor = reinterpret_cast<int (*)(Device, unsigned*)>(
      sym("nvmlDeviceGetMinorNumber"));
  api_->name = reinterpret_cast<int (*)(Device, char*, unsigned)>(
      sym("nvmlDeviceGetName"));
  api_->driver_version = reinterpret_cast<int (*)(char*, unsigned)>(
      sym("nvmlSystemGetDriverVersion"));
  Check(api_->init(), "nvmlInit_v2");
}

Nvml::~Nvml() {
  if (api_ != nullptr && api_->shutdown != nullptr) api_->shutdown();
  delete api_;
  if (handle_ != nullptr) dlclose(handle_);
}

void Nvml::Check(int rc, const char* what) const {
  if (rc == kSuccess) return;
  const char* msg = api_->error_string ? api_->error_string(rc) : nullptr;
  throw NvmlError(std::string(what) + " failed (" + std::to_string(rc) +
                  "): " + (msg ? msg : "?"));
}

std::vector<Gpu> Nvml::Devices() const {
  unsigned n = 0;
  Check(api_->count(&n), "nvmlDeviceGetCount_v2");
  std::vector<Gpu> gpus;
  for (unsigned i = 0; i < n; ++i) {
    Device d = nullptr;
    Check(api_->by_index(i, &d), "nvmlDeviceGetHandleByIndex_v2");
    Gpu g;
    g.index = i;
    char buf[kUuidLen > kNameLen ? kUuidLen : kNameLen] = {};
    Check(api_->uuid(d, buf, kUuidLen), "nvmlDeviceGetUUID");
    g.uuid = buf;
    Check(api_->minor(d, &g.minor), "nvmlDeviceGetMinorNumber");
    buf[0] = '\0';
    Check(api_->name(d, buf, kNameLen), "nvmlDeviceGetName");
    g.name = buf;
    if (g.uuid.empty())
      throw NvmlError("device " + std::to_string(i) + " has an empty UUID");
    gpus.push_back(std::move(g));
  }
  return gpus;
}

std::string Nvml::DriverVersion() const {
  char buf[kVersionLen] = {};
  Check(api_->driver_version(buf, kVersionLen), "nvmlSystemGetDriverVersion");
  if (buf[0] == '\0') throw NvmlError("NVML reports an empty driver version");
  return buf;
}

bool Nvml::Resolves(const std::string& uuid) const {
  Device d = nullptr;
  return api_->by_uuid(uuid.c_str(), &d) == kSuccess && d != nullptr;
}

}  // namespace kgct
