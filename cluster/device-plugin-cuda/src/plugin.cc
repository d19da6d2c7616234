// kgct-cuda-device-plugin: a kubelet device plugin advertising NVIDIA GPUs
// as `nvidia.com/gpu`, against the kubelet device-plugin gRPC API v1beta1,
// on the embedded gRPC/HTTP2/HPACK stack carried in this directory.
//
// Role: the node layer under the PyTorch/CUDA port's pods, the counterpart
// of the TPU plugin (cluster/device-plugin). The port's renderer asks for
// `nvidia.com/gpu`; this plugin advertises it and hands each container
// what the NVIDIA container toolkit would otherwise inject: the card's
// device node and the control nodes, and the driver's user-space libraries
// (compute and utility sets) bind-mounted read-only under
// /usr/local/nvidia, with nvidia-smi. No runtime hook is needed.
//
// Discovery is NVML's (nvml.h, loaded by dlopen from the node's driver):
// the device IDs are the UUIDs, each device's node is /dev/nvidia<minor>.
// Nothing is guessed: where NVML does not load or init, a device's node or
// a control node is missing, or the driver's libcuda cannot be found, the
// plugin exits non-zero with a message naming what is missing.
//
// Flow (v1beta1 contract, as the TPU plugin):
//   1. serve DevicePlugin on <plugin-dir>/kgct-cuda.sock
//   2. dial <plugin-dir>/kubelet.sock, Registration/Register(endpoint,
//      resource)
//   3. the kubelet connects back: ListAndWatch streams the devices and
//      their health (re-sent when it changes); Allocate returns device
//      specs, mounts and envs per container
//   4. if kubelet.sock is recreated (a kubelet restart, which clears the
//      directory, our socket with it), serve again and re-register
//
// Tests: tests/test_torch_device_plugin.py runs this binary against a
// grpcio kubelet and a stub NVML; chip_smoke.py phase 18 against the
// card's driver.

#include <elf.h>
#include <limits.h>
#include <signal.h>
#include <stdlib.h>
#include <string.h>
#include <sys/stat.h>
#include <time.h>
#include <unistd.h>

#include <algorithm>
#include <cstdio>
#include <map>
#include <memory>
#include <string>
#include <vector>

#include "cli.h"
#include "grpc.h"
#include "nvml.h"
#include "pb.h"

namespace kgct {
namespace {

constexpr char kTag[] = "[kgct-cuda-device-plugin]";
// Where the mounts land in the container (the toolkit's convention, which
// the port's image puts on LD_LIBRARY_PATH and PATH).
constexpr char kLibDir[] = "/usr/local/nvidia/lib64";
constexpr char kBinDir[] = "/usr/local/nvidia/bin";
// The NVIDIA container toolkit's compute and utility library sets; the
// first two are required.
const char* const kDriverLibs[] = {
    "cuda", "nvidia-ml", "nvidia-ptxjitcompiler", "nvidia-nvvm",
    "nvidia-gpucomp", "cudadebugger", "nvidia-cfg",
};
constexpr size_t kRequiredLibs = 2;
// Control nodes every CUDA container needs; nvidia-modeset where present.
const char* const kControlNodes[] = {"nvidiactl", "nvidia-uvm",
                                     "nvidia-uvm-tools"};
constexpr char kModeset[] = "nvidia-modeset";

struct Options {
  std::string plugin_dir = "/var/lib/kubelet/device-plugins";
  std::string endpoint = "kgct-cuda.sock";
  std::string resource = "nvidia.com/gpu";
  std::string dev_root = "/dev";
  std::string driver_root = "/";
  std::string cdi_spec_path;  // --write-cdi-spec=PATH: emit CDI json + exit
  int health_interval_s = 5;
  bool register_with_kubelet = true;
  bool oneshot = false;  // tests: exit after first ListAndWatch push + idle
};

struct Refused : std::runtime_error {
  using std::runtime_error::runtime_error;
};

volatile sig_atomic_t g_stop = 0;
void OnSignal(int) { g_stop = 1; }

bool Exists(const std::string& path) {
  struct stat st{};
  return stat(path.c_str(), &st) == 0;
}

bool IsFile(const std::string& path) {
  struct stat st{};
  return stat(path.c_str(), &st) == 0 && S_ISREG(st.st_mode);
}

// -- the driver's files -----------------------------------------------------

// DT_SONAME of a 64-bit ELF shared object, read from its dynamic section:
// the name the dynamic loader looks the library up by, so the name it is
// mounted under (libnvidia-nvvm.so.<ver> is libnvidia-nvvm.so.4,
// libnvidia-gpucomp.so.<ver> keeps its version). Empty if there is none.
std::string Soname(const std::string& path) {
  FILE* f = fopen(path.c_str(), "rb");
  if (f == nullptr) return "";
  auto read_at = [f](long off, void* buf, size_t n) {
    return fseek(f, off, SEEK_SET) == 0 && fread(buf, 1, n, f) == n;
  };
  std::string soname;
  Elf64_Ehdr eh{};
  if (read_at(0, &eh, sizeof eh) && memcmp(eh.e_ident, ELFMAG, SELFMAG) == 0 &&
      eh.e_ident[EI_CLASS] == ELFCLASS64 &&
      eh.e_phentsize == sizeof(Elf64_Phdr)) {
    std::vector<Elf64_Phdr> ph(eh.e_phnum);
    if (read_at(static_cast<long>(eh.e_phoff), ph.data(),
                ph.size() * sizeof(Elf64_Phdr))) {
      // A virtual address of a loaded segment -> its offset in the file.
      auto file_off = [&ph](Elf64_Addr va) -> long {
        for (const auto& p : ph)
          if (p.p_type == PT_LOAD && va >= p.p_vaddr &&
              va < p.p_vaddr + p.p_filesz)
            return static_cast<long>(va - p.p_vaddr + p.p_offset);
        return -1;
      };
      for (const auto& p : ph) {
        if (p.p_type != PT_DYNAMIC) continue;
        std::vector<Elf64_Dyn> dyn(p.p_filesz / sizeof(Elf64_Dyn));
        if (!read_at(static_cast<long>(p.p_offset), dyn.data(),
                     dyn.size() * sizeof(Elf64_Dyn)))
          break;
        Elf64_Addr strtab = 0;
        Elf64_Xword name = 0;
        bool has_name = false;
        for (const auto& d : dyn) {
          if (d.d_tag == DT_STRTAB) strtab = d.d_un.d_ptr;
          if (d.d_tag == DT_SONAME) {
            name = d.d_un.d_val;
            has_name = true;
          }
        }
        long off = has_name ? file_off(strtab) : -1;
        if (off >= 0 && fseek(f, off + static_cast<long>(name), SEEK_SET) == 0)
          for (int c; (c = fgetc(f)) > 0 && soname.size() < 256;)
            soname.push_back(static_cast<char>(c));
        break;
      }
    }
  }
  fclose(f);
  return soname;
}

struct Mount {
  std::string container_path;
  std::string host_path;
};

struct Inventory {
  std::vector<Gpu> gpus;
  std::map<std::string, std::string> node_of;  // uuid -> /dev/nvidia<minor>
  std::vector<std::string> control;            // control node names
  std::vector<Mount> mounts;
  std::string driver_version;
};

// A path seen under the driver root, as the host sees it (the kubelet
// resolves mount sources on the host).
std::string HostPath(const Options& opt, const std::string& file) {
  char real[PATH_MAX];
  if (realpath(file.c_str(), real) == nullptr)
    throw Refused("cannot resolve " + file);
  std::string path = real;
  if (opt.driver_root == "/" || opt.driver_root.empty()) return path;
  std::string root = realpath(opt.driver_root.c_str(), real) ? real
                                                             : opt.driver_root;
  if (path.compare(0, root.size(), root) != 0 ||
      (path.size() > root.size() && path[root.size()] != '/'))
    throw Refused(path + " lies outside the driver root " + opt.driver_root);
  return path.substr(root.size());
}

// Every check of the start: NVML's devices, their nodes, the control
// nodes and the driver's libraries. Throws Refused (or NvmlError) naming
// what is missing.
Inventory Discover(const Options& opt, const Nvml& nvml) {
  Inventory inv;
  inv.gpus = nvml.Devices();
  inv.driver_version = nvml.DriverVersion();
  if (inv.gpus.empty()) throw Refused("NVML reports no GPU");
  for (const auto& g : inv.gpus) {
    std::string node = "nvidia" + std::to_string(g.minor);
    if (!Exists(opt.dev_root + "/" + node))
      throw Refused("device " + g.uuid + " (index " + std::to_string(g.index) +
                    "): its node " + opt.dev_root + "/" + node + " is missing");
    if (!inv.node_of.emplace(g.uuid, node).second)
      throw Refused("NVML reports the UUID " + g.uuid + " twice");
  }
  for (const char* c : kControlNodes) {
    if (!Exists(opt.dev_root + "/" + c))
      throw Refused("control node " + opt.dev_root + "/" + c +
                    " is missing (nvidia-uvm appears once its module is "
                    "loaded: nvidia-modprobe -u -c=0)");
    inv.control.push_back(c);
  }
  if (Exists(opt.dev_root + "/" + kModeset)) inv.control.push_back(kModeset);

  // The driver's library directory is the one NVML was loaded from.
  std::string dir = nvml.path().substr(0, nvml.path().rfind('/'));
  for (size_t i = 0; i < sizeof kDriverLibs / sizeof *kDriverLibs; ++i) {
    std::string file = dir + "/lib" + kDriverLibs[i] + ".so." +
                       inv.driver_version;
    if (!IsFile(file)) {
      if (i < kRequiredLibs)
        throw Refused("the driver's lib" + std::string(kDriverLibs[i]) +
                      " is missing: no " + file);
      continue;
    }
    std::string soname = Soname(file);
    if (soname.empty()) throw Refused(file + " has no ELF SONAME");
    inv.mounts.push_back({std::string(kLibDir) + "/" + soname,
                          HostPath(opt, file)});
  }
  std::string root = opt.driver_root == "/" ? "" : opt.driver_root;
  std::string smi = root + "/usr/bin/nvidia-smi";
  if (IsFile(smi))
    inv.mounts.push_back({std::string(kBinDir) + "/nvidia-smi",
                          HostPath(opt, smi)});
  return inv;
}

// -- v1beta1 message encode (field numbers per the public k8s.io/kubelet
// device-plugin api.proto) ---------------------------------------------------

std::string EncodeListAndWatchResponse(
    const std::map<std::string, std::string>& devices) {
  PbWriter w;
  for (const auto& [id, health] : devices) {
    PbWriter d;
    d.StringField(1, id);      // Device.ID
    d.StringField(2, health);  // Device.health
    w.MessageField(1, d.str());
  }
  return w.str();
}

std::string EncodeRegisterRequest(const Options& opt) {
  PbWriter w;
  w.StringField(1, "v1beta1");     // version
  w.StringField(2, opt.endpoint);  // endpoint (basename, kubelet joins dir)
  w.StringField(3, opt.resource);  // resource_name
  w.MessageField(4, "");           // options: all defaults
  return w.str();
}

std::string EncodeMount(const Mount& m) {
  PbWriter w;
  w.StringField(1, m.container_path);
  w.StringField(2, m.host_path);
  w.BoolField(3, true);  // read_only
  return w.str();
}

std::string EncodeDeviceSpec(const std::string& container_path,
                             const std::string& host_path) {
  PbWriter w;
  w.StringField(1, container_path);
  w.StringField(2, host_path);
  w.StringField(3, "rw");
  return w.str();
}

std::string EncodeEnvEntry(const std::string& k, const std::string& v) {
  PbWriter w;  // map<string,string> entry: key=1, value=2.
  w.StringField(1, k);
  w.StringField(2, v);
  return w.str();
}

// -- CDI spec ---------------------------------------------------------------
// The same edits as Allocate, for CDI-enabled runtimes outside the kubelet:
// one device per UUID with its node; the control nodes, the mounts and the
// env common to all. The env cannot list the UUIDs a container gets (the
// spec is written before any request), so it says `void`: the NVIDIA
// toolkit's own word for "the devices were injected already".

std::string CdiNode(const Options& opt, const std::string& node) {
  return "{\"path\": " + JsonStr("/dev/" + node) + ", \"hostPath\": " +
         JsonStr(opt.dev_root + "/" + node) + ", \"permissions\": \"rw\"}";
}

int WriteCdiSpec(const Options& opt, const Inventory& inv,
                 const std::string& path) {
  FILE* f = fopen(path.c_str(), "w");
  if (f == nullptr) {
    fprintf(stderr, "%s cannot write %s\n", kTag, path.c_str());
    return 1;
  }
  fprintf(f, "{\n  \"cdiVersion\": \"0.6.0\",\n  \"kind\": %s,\n"
             "  \"devices\": [", JsonStr(opt.resource).c_str());
  const char* sep = "\n";
  for (const auto& g : inv.gpus) {
    fprintf(f, "%s    {\"name\": %s, \"containerEdits\": {\"deviceNodes\": "
               "[%s]}}", sep, JsonStr(g.uuid).c_str(),
            CdiNode(opt, inv.node_of.at(g.uuid)).c_str());
    sep = ",\n";
  }
  fprintf(f, "\n  ],\n  \"containerEdits\": {\n    \"env\": "
             "[\"NVIDIA_VISIBLE_DEVICES=void\"],\n    \"deviceNodes\": [");
  sep = "\n";
  for (const auto& c : inv.control) {
    fprintf(f, "%s      %s", sep, CdiNode(opt, c).c_str());
    sep = ",\n";
  }
  fprintf(f, "\n    ],\n    \"mounts\": [");
  sep = "\n";
  for (const auto& m : inv.mounts) {
    fprintf(f, "%s      {\"hostPath\": %s, \"containerPath\": %s, "
               "\"options\": [\"ro\", \"nosuid\", \"nodev\", \"bind\"]}",
            sep, JsonStr(m.host_path).c_str(),
            JsonStr(m.container_path).c_str());
    sep = ",\n";
  }
  fprintf(f, "\n    ]\n  }\n}\n");
  // A truncated spec (ENOSPC etc.) must not report success: the runtime
  // would stop injecting devices on a parse failure later.
  bool write_err = ferror(f) != 0;
  if (fclose(f) != 0 || write_err) {
    fprintf(stderr, "%s short write to %s\n", kTag, path.c_str());
    ::unlink(path.c_str());
    return 1;
  }
  fprintf(stderr, "%s wrote CDI spec (%zu devices) to %s\n", kTag,
          inv.gpus.size(), path.c_str());
  return 0;
}

// -- plugin service ---------------------------------------------------------

class Plugin {
 public:
  Plugin(Options opt, const Nvml& nvml, Inventory inv)
      : opt_(std::move(opt)), nvml_(nvml), inv_(std::move(inv)) {
    devices_ = Health();
  }

  std::string SocketPath() const { return opt_.plugin_dir + "/" + opt_.endpoint; }
  std::string KubeletSock() const { return opt_.plugin_dir + "/kubelet.sock"; }

  bool Register() {
    std::string resp, err;
    int status = GrpcUnaryCall(KubeletSock(), "/v1beta1.Registration/Register",
                               EncodeRegisterRequest(opt_), &resp, &err);
    if (status != kOk) {
      fprintf(stderr, "%s register failed (%d): %s\n", kTag, status,
              err.c_str());
      return false;
    }
    fprintf(stderr, "%s registered %s with kubelet (%zu devices)\n", kTag,
            opt_.resource.c_str(), devices_.size());
    return true;
  }

  void Run() {
    Serve();
    SockId kubelet_id = StatId(KubeletSock());
    if (opt_.register_with_kubelet) {
      // Kubelet may not be up yet (DaemonSet races kubelet restarts): retry.
      for (int i = 0; i < 60 && !Register() && !g_stop; ++i) sleep(2);
    }
    time_t last_scan = time(nullptr);
    while (!g_stop) {
      server_->PollOnce(500);
      time_t now = time(nullptr);
      if (now - last_scan >= opt_.health_interval_s) {
        last_scan = now;
        RescanAndNotify();
        // A restarted kubelet clears the plugin directory, our socket with
        // it, before it binds a new kubelet.sock: serve again, then
        // register, so that its dial back finds the socket.
        SockId id = StatId(KubeletSock());
        if (opt_.register_with_kubelet && id.ino != 0 &&
            (id != kubelet_id || StatId(SocketPath()) != socket_id_)) {
          fprintf(stderr, "%s kubelet restarted, serving again and "
                  "re-registering\n", kTag);
          Serve();
          if (Register()) kubelet_id = id;  // else again at the next scan
        }
      }
      if (opt_.oneshot && pushed_once_ && NoLiveWatchers()) break;
    }
  }

 private:
  // A fresh server on SocketPath(): the old one, if any, closes its
  // connections (their ListAndWatch streams end) and unlinks its socket.
  void Serve() {
    watchers_.clear();
    server_.reset();
    server_ = std::make_unique<GrpcServer>();
    server_->AddUnary(
        "/v1beta1.DevicePlugin/GetDevicePluginOptions",
        [](const std::string&) { return std::string(); });  // all defaults
    server_->AddUnary("/v1beta1.DevicePlugin/Allocate",
                      [this](const std::string& req) { return Allocate(req); });
    server_->AddUnary("/v1beta1.DevicePlugin/PreStartContainer",
                      [](const std::string&) { return std::string(); });
    server_->AddUnary(
        "/v1beta1.DevicePlugin/GetPreferredAllocation",
        [](const std::string&) -> std::string {
          throw GrpcError(kUnimplemented, "preferred allocation not offered");
        });
    server_->AddServerStream(
        "/v1beta1.DevicePlugin/ListAndWatch",
        [this](const std::string&, GrpcServer::StreamPtr s) {
          server_->StreamSend(s, EncodeListAndWatchResponse(devices_));
          watchers_.push_back(std::move(s));
          pushed_once_ = true;
        });
    server_->Listen(SocketPath());
    socket_id_ = StatId(SocketPath());
  }

  // A socket file by inode and change time: a restarted kubelet's new
  // socket may reuse the freed inode number, never its change time.
  struct SockId {
    ino_t ino = 0;
    long sec = 0, nsec = 0;
    bool operator!=(const SockId& o) const {
      return ino != o.ino || sec != o.sec || nsec != o.nsec;
    }
  };
  static SockId StatId(const std::string& path) {
    struct stat st{};
    if (stat(path.c_str(), &st) != 0) return {};
    return {st.st_ino, static_cast<long>(st.st_ctim.tv_sec),
            static_cast<long>(st.st_ctim.tv_nsec)};
  }

  // Healthy while NVML resolves the UUID and the device's node exists.
  std::map<std::string, std::string> Health() const {
    std::map<std::string, std::string> health;
    for (const auto& [uuid, node] : inv_.node_of)
      health[uuid] = nvml_.Resolves(uuid) && Exists(opt_.dev_root + "/" + node)
                         ? "Healthy"
                         : "Unhealthy";
    return health;
  }

  bool NoLiveWatchers() {
    Prune();
    return watchers_.empty();
  }

  void Prune() {
    watchers_.erase(std::remove_if(watchers_.begin(), watchers_.end(),
                                   [](const GrpcServer::StreamPtr& s) {
                                     return !s || !s->alive;
                                   }),
                    watchers_.end());
  }

  void RescanAndNotify() {
    auto fresh = Health();
    if (fresh == devices_) return;
    size_t healthy = std::count_if(fresh.begin(), fresh.end(), [](auto& kv) {
      return kv.second == "Healthy";
    });
    fprintf(stderr, "%s health changed: %zu of %zu devices healthy\n", kTag,
            healthy, fresh.size());
    devices_ = std::move(fresh);
    Prune();
    std::string msg = EncodeListAndWatchResponse(devices_);
    for (auto& s : watchers_) server_->StreamSend(s, msg);
  }

  std::string Allocate(const std::string& req) {
    // AllocateRequest{ repeated ContainerAllocateRequest{repeated string=1} }
    PbWriter resp;
    PbReader r(req);
    while (r.Next()) {
      if (r.field() != 1) {
        r.skip();
        continue;
      }
      PbReader creq(r.bytes());
      std::vector<std::string> ids;
      while (creq.Next()) {
        if (creq.field() == 1)
          ids.emplace_back(creq.bytes());
        else
          creq.skip();
      }
      PbWriter cresp;
      std::string visible;
      for (const auto& id : ids) {
        auto it = inv_.node_of.find(id);
        if (it == inv_.node_of.end())
          throw GrpcError(kNotFound, "unknown device " + id);
        cresp.MessageField(3, EncodeDeviceSpec("/dev/" + it->second,
                                               opt_.dev_root + "/" +
                                                   it->second));
        visible += (visible.empty() ? "" : ",") + id;
      }
      for (const auto& c : inv_.control)
        cresp.MessageField(3, EncodeDeviceSpec("/dev/" + c,
                                               opt_.dev_root + "/" + c));
      for (const auto& m : inv_.mounts) cresp.MessageField(2, EncodeMount(m));
      cresp.MessageField(1, EncodeEnvEntry("NVIDIA_VISIBLE_DEVICES", visible));
      resp.MessageField(1, cresp.str());
    }
    return resp.str();
  }

  Options opt_;
  const Nvml& nvml_;
  Inventory inv_;
  std::unique_ptr<GrpcServer> server_;
  SockId socket_id_;  // our socket file as Serve() bound it
  std::map<std::string, std::string> devices_;
  std::vector<GrpcServer::StreamPtr> watchers_;
  bool pushed_once_ = false;
};

int Main(int argc, char** argv) {
  Options opt;
  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    auto val = [&a](const char* flag) { return FlagValue(a, flag); };
    if (const char* v = val("--plugin-dir")) opt.plugin_dir = v;
    else if (const char* v = val("--endpoint")) opt.endpoint = v;
    else if (const char* v = val("--resource")) opt.resource = v;
    else if (const char* v = val("--dev-root")) opt.dev_root = v;
    else if (const char* v = val("--driver-root")) opt.driver_root = v;
    else if (const char* v = val("--health-interval-s"))
      opt.health_interval_s = atoi(v);
    else if (const char* v = val("--write-cdi-spec")) opt.cdi_spec_path = v;
    else if (a == "--no-register") opt.register_with_kubelet = false;
    else if (a == "--oneshot") opt.oneshot = true;
    else {
      fprintf(stderr,
              "usage: kgct-cuda-device-plugin [--plugin-dir=DIR] "
              "[--endpoint=NAME.sock] [--resource=NAME] [--dev-root=DIR] "
              "[--driver-root=DIR] [--health-interval-s=N] [--no-register] "
              "[--oneshot] [--write-cdi-spec=/etc/cdi/kgct-cuda.json]\n");
      return a == "--help" ? 0 : 2;
    }
  }
  try {
    Nvml nvml(opt.driver_root);
    Inventory inv = Discover(opt, nvml);
    fprintf(stderr, "%s driver %s (%s): %zu GPUs, %zu mounts\n", kTag,
            inv.driver_version.c_str(), nvml.path().c_str(), inv.gpus.size(),
            inv.mounts.size());
    if (!opt.cdi_spec_path.empty())
      return WriteCdiSpec(opt, inv, opt.cdi_spec_path);
    signal(SIGPIPE, SIG_IGN);
    signal(SIGTERM, OnSignal);
    signal(SIGINT, OnSignal);
    {
      Plugin plugin(opt, nvml, std::move(inv));
      plugin.Run();
    }  // the server unlinks its socket
    fprintf(stderr, "%s exiting\n", kTag);
    return 0;
  } catch (const std::exception& e) {  // NvmlError, Refused, a bind error
    fprintf(stderr, "%s refused: %s\n", kTag, e.what());
  }
  return 1;
}

}  // namespace
}  // namespace kgct

int main(int argc, char** argv) { return kgct::Main(argc, argv); }
