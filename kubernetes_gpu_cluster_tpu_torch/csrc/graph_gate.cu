// CUDA-graph conditional nodes for the captured step programs: the
// counterpart of the JAX programs' lax.cond stages.
//
// The JAX step programs skip their costly stages (logit bias, penalties,
// the sampled path, the filter tiers, top logprobs) with lax.cond on flags
// computed on the device. A captured CUDA graph replays every node it
// holds, so a stage that a flag switches off must sit inside a conditional
// node whose body graph runs only when the flag is set.
//
// kgct_gate_open, called while `stream` captures, appends to the graph
// under capture (or to the body graph that `stream` captures into, when
// gates nest): a one-thread kernel that reads the flag from device memory
// at every replay and sets the node's condition, then an IF conditional
// node after it. It then starts `child` capturing into the node's body
// graph, so every launch the caller makes on `child` until
// kgct_gate_close lands in the body. `stream`'s capture carries on after
// the node. The flag is a 1-byte (bool) or 4-byte (int32) value; `negate`
// runs the body when it is 0 (the else branch of an if/else pair, made
// from two IF nodes as CUDA before 12.8 has no else).
//
// The caller owns `child`: one stream per nesting depth, reused by every
// gate, so that the caching allocator can hand one body's freed blocks to
// the next body (its blocks are kept per stream). A body whose capture
// CUDA voids (a host read, say) leaves its node half built, and a graph
// holding it cannot be ended or destroyed safely: the caller first takes
// every branch once in a throwaway capture without nodes, where such a
// body fails as a plain capture does (engine/step_programs.py).
//
// Requires CUDA 12.4 (conditional nodes, cudaStreamBeginCaptureToGraph).
// Nothing here synchronizes or allocates device memory.

#include <cuda_runtime.h>

namespace {

__global__ void set_gate(cudaGraphConditionalHandle handle, const void* flag, int bytes,
                         int negate) {
  const unsigned v = bytes == 1 ? *static_cast<const unsigned char*>(flag)
                                : *static_cast<const unsigned*>(flag);
  cudaGraphSetConditional(handle, (v != 0) != (negate != 0) ? 1u : 0u);
}

}  // namespace

// Returns a CUDA status: cudaErrorStreamCaptureUnmatched when `stream` is
// not capturing.
extern "C" int kgct_gate_open(void* stream, const void* flag, int bytes, int negate,
                              void* child) {
  auto s = static_cast<cudaStream_t>(stream);
  if (flag == nullptr || (bytes != 1 && bytes != 4) || child == nullptr || child == stream)
    return cudaErrorInvalidValue;
  cudaStreamCaptureStatus status{};
  cudaGraph_t graph{};
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return cudaErrorStreamCaptureUnmatched;
  cudaGraphConditionalHandle handle{};
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_gate<<<1, 1, 0, s>>>(handle, flag, bytes, negate);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // The node depends on what the stream's capture ends in now: the
  // kernel just captured.
  err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params{};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node{};
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(child),
                                       params.conditional.phGraph_out[0], nullptr, nullptr, 0,
                                       cudaStreamCaptureModeThreadLocal);
}

// Ends `child`'s capture into the body graph that kgct_gate_open started.
extern "C" int kgct_gate_close(void* child) {
  cudaGraph_t body{};
  return cudaStreamEndCapture(static_cast<cudaStream_t>(child), &body);
}

extern "C" const char* kgct_graph_gate_error(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
