// kgct-cuda-plugin-probe: a kubelet stand-in for machines without grpcio
// (the card's), built on the same carried gRPC stack as the plugin.
//
//   kgct-cuda-plugin-probe --dir=DIR --ids=ID[,ID...] [--unknown=ID]
//                          [--timeout-s=N]
//
// Serves Registration/Register on DIR/kubelet.sock and records the request
// and when it came (CLOCK_MONOTONIC, the clock Python's time.monotonic_ns
// reads). Once the plugin has registered, calls its GetDevicePluginOptions,
// then Allocate once for each ID (one container, one device) and once for
// the unknown ID, on the endpoint the plugin registered, each call timed.
// Prints one JSON object and exits 0; exits 1 if no plugin registers in
// time. ListAndWatch needs a streaming client and is proven on the CPU with
// grpcio (tests/test_torch_device_plugin.py).

#include <signal.h>
#include <stdio.h>
#include <stdlib.h>
#include <time.h>

#include <string>
#include <vector>

#include "cli.h"
#include "grpc.h"
#include "pb.h"

namespace kgct {
namespace {

int64_t MonotonicNs() {
  timespec ts{};
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return int64_t(ts.tv_sec) * 1000000000 + ts.tv_nsec;
}

// DevicePluginOptions{pre_start_required=1, get_preferred_allocation_
// available=2} as JSON.
std::string Options(std::string_view msg) {
  bool pre_start = false, preferred = false;
  PbReader r(msg);
  while (r.Next()) {
    if (r.field() == 1) pre_start = r.varint() != 0;
    else if (r.field() == 2) preferred = r.varint() != 0;
    else r.skip();
  }
  return std::string("{\"pre_start_required\": ") +
         (pre_start ? "true" : "false") +
         ", \"get_preferred_allocation_available\": " +
         (preferred ? "true" : "false") + "}";
}

// ContainerAllocateResponse{envs=1 (map), mounts=2, devices=3} as JSON.
std::string Container(std::string_view msg) {
  std::string envs, mounts, devices;
  PbReader r(msg);
  while (r.Next()) {
    if (r.field() < 1 || r.field() > 3) {
      r.skip();
      continue;
    }
    int field = r.field();
    std::string f[3];
    bool read_only = false;
    PbReader sub(r.bytes());
    while (sub.Next()) {
      if (field == 2 && sub.field() == 3) read_only = sub.varint() != 0;
      else if (sub.field() >= 1 && sub.field() <= 3)
        f[sub.field() - 1] = std::string(sub.bytes());
      else sub.skip();
    }
    if (field == 1) {
      envs += (envs.empty() ? "" : ", ") + JsonStr(f[0]) + ": " + JsonStr(f[1]);
    } else if (field == 2) {
      mounts += std::string(mounts.empty() ? "" : ", ") +
                "{\"container_path\": " + JsonStr(f[0]) + ", \"host_path\": " +
                JsonStr(f[1]) + ", \"read_only\": " +
                (read_only ? "true" : "false") + "}";
    } else {
      devices += std::string(devices.empty() ? "" : ", ") +
                 "{\"container_path\": " + JsonStr(f[0]) + ", \"host_path\": " +
                 JsonStr(f[1]) + ", \"permissions\": " + JsonStr(f[2]) + "}";
    }
  }
  return "{\"envs\": {" + envs + "}, \"mounts\": [" + mounts +
         "], \"devices\": [" + devices + "]}";
}

// One Allocate of `id` in one container request, timed.
std::string Allocate(const std::string& sock, const std::string& id) {
  PbWriter creq, req;
  creq.StringField(1, id);
  req.MessageField(1, creq.str());
  std::string resp, err;
  int64_t t0 = MonotonicNs();
  int status = GrpcUnaryCall(sock, "/v1beta1.DevicePlugin/Allocate", req.str(),
                             &resp, &err);
  double us = double(MonotonicNs() - t0) / 1e3;
  std::string out = "{\"id\": " + JsonStr(id) + ", \"status\": " +
                    std::to_string(status) + ", \"us\": " +
                    std::to_string(us);
  if (status != kOk) return out + ", \"message\": " + JsonStr(err) + "}";
  std::string containers;
  PbReader r(resp);
  while (r.Next()) {
    if (r.field() != 1) {
      r.skip();
      continue;
    }
    containers += (containers.empty() ? "" : ", ") + Container(r.bytes());
  }
  return out + ", \"containers\": [" + containers + "]}";
}

int Main(int argc, char** argv) {
  std::string dir, unknown;
  std::vector<std::string> ids;
  int timeout_s = 60;
  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    auto val = [&a](const char* flag) { return FlagValue(a, flag); };
    if (const char* v = val("--dir")) {
      dir = v;
    } else if (const char* v = val("--ids")) {
      std::string s = v;
      for (size_t at = 0; at <= s.size();) {
        size_t end = s.find(',', at);
        if (end == std::string::npos) end = s.size();
        if (end > at) ids.push_back(s.substr(at, end - at));
        at = end + 1;
      }
    } else if (const char* v = val("--unknown")) {
      unknown = v;
    } else if (const char* v = val("--timeout-s")) {
      timeout_s = atoi(v);
    } else {
      fprintf(stderr,
              "usage: kgct-cuda-plugin-probe --dir=DIR --ids=ID[,ID...] "
              "[--unknown=ID] [--timeout-s=N]\n");
      return 2;
    }
  }
  if (dir.empty()) {
    fprintf(stderr, "kgct-cuda-plugin-probe: --dir is required\n");
    return 2;
  }
  signal(SIGPIPE, SIG_IGN);

  std::string version, endpoint, resource, options;
  int64_t registered_at = 0;
  // Lives to the end: closing it under the plugin's registering call
  // (whose last frames may still be on their way) would fail that call.
  GrpcServer kubelet;
  kubelet.AddUnary("/v1beta1.Registration/Register",
                   [&](const std::string& req) {
                     PbReader r(req);
                     while (r.Next()) {
                       switch (r.field()) {
                         case 1: version = r.bytes(); break;
                         case 2: endpoint = r.bytes(); break;
                         case 3: resource = r.bytes(); break;
                         case 4: options = r.bytes(); break;
                         default: r.skip();
                       }
                     }
                     registered_at = MonotonicNs();
                     return std::string();  // Empty
                   });
  kubelet.Listen(dir + "/kubelet.sock");
  int64_t deadline = MonotonicNs() + int64_t(timeout_s) * 1000000000;
  while (registered_at == 0 && MonotonicNs() < deadline) kubelet.PollOnce(50);
  if (registered_at == 0) {
    fprintf(stderr, "kgct-cuda-plugin-probe: no plugin registered within "
                    "%d s\n", timeout_s);
    return 1;
  }

  std::string sock = dir + "/" + endpoint;
  std::string resp, err;
  int status = GrpcUnaryCall(sock, "/v1beta1.DevicePlugin/GetDevicePluginOptions",
                             "", &resp, &err);
  std::string out = "{\"registered_at_ns\": " + std::to_string(registered_at) +
                    ", \"register\": {\"version\": " + JsonStr(version) +
                    ", \"endpoint\": " + JsonStr(endpoint) + ", \"resource\": " +
                    JsonStr(resource) + ", \"options\": " + Options(options) +
                    "}, \"options\": {\"status\": " + std::to_string(status) +
                    ", \"options\": " +
                    (status == kOk ? Options(resp) : JsonStr(err)) + "}";
  std::string allocs;
  for (const auto& id : ids)
    allocs += (allocs.empty() ? "" : ", ") + Allocate(sock, id);
  out += ", \"allocate\": [" + allocs + "]";
  if (!unknown.empty()) out += ", \"unknown\": " + Allocate(sock, unknown);
  printf("%s}\n", out.c_str());
  return 0;
}

}  // namespace
}  // namespace kgct

int main(int argc, char** argv) { return kgct::Main(argc, argv); }
