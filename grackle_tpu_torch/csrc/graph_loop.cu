// Loop control for the solve's device loops inside a CUDA graph: the
// condition kernel of a conditional WHILE node, the host calls that add
// such a node to the graph a stream is capturing, and a user object that
// tells the host when that graph is gone (its loop bodies' memory pool
// may then be freed).
//
// This kernel has no TPU counterpart.  It stands where the condition of
// XLA's while loop stands in the JAX package (lax.while_loop in
// grackle_tpu/ops/solver.py:559, grackle_tpu/ops/dust_temp.py:188/:251,
// grackle_tpu/ops/tabulated_temp.py:124): the JAX solve is one device
// program whose loops test their exit on the device, so a host code can
// compile it into its own step.  The port's eager loops read "some cell
// active" on the host instead (ops/device_loop.py); inside a capture they
// become WHILE nodes whose body ends with one launch of
// grackle_loop_cond_kernel, which
//   - advances the loop's step counter (a device int64) by the steps the
//     body ran,
//   - evaluates "some lane of the mask is set, and the counter is below
//     its cap", and
//   - sets the node's condition with cudaGraphSetConditional.
// Its plain version is the eager predicate, mask.any() & (step < cap),
// in PyTorch (ops/graph_loop.py plain_predicate).
//
// What bounds it on an H100: latency.  It reads the mask once (1 MB at
// the flagship's 1,048,576 cells) and writes 8 bytes, a third of a
// microsecond at 3.35 TB/s; the launch, one CTA's pass over the mask and
// the node's own turnaround are microseconds.  One CTA of 1,024 threads
// reads the mask 16 bytes a thread at a time where it is aligned, and a
// thread stops at its first set lane, so a mostly active mask costs one
// pass of loads.  The loop body it ends holds thousands of launches, so
// the kernel is not on any path's critical share (PERF.md).
//
// Build (ops/graph_loop.py does this at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -shared -Xcompiler -fPIC -o libgraph_loop.so graph_loop.cu
// Conditional nodes need CUDA 12.4 or later, in the runtime this library
// is built with and in the driver; grackle_loop_versions reports both.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

namespace {

constexpr int COND_THREADS = 1024;

// The ids of captures whose graphs (and every executable graph made from
// them) have been destroyed: the user object grackle_loop_retain gives a
// graph records its capture's id here when its last reference goes.  The
// CUDA driver may run that on a thread of its own, where no CUDA call is
// allowed, so it only records; grackle_loop_released hands the ids over.
std::mutex released_mutex;
std::vector<unsigned long long> released_ids;

void record_release(void* id) {
  std::lock_guard<std::mutex> lock(released_mutex);
  released_ids.push_back(
      static_cast<unsigned long long>(reinterpret_cast<uintptr_t>(id)));
}

// The capture that `stream` belongs to: its status, id and graph.
cudaError_t capture_info(cudaStream_t s, cudaStreamCaptureStatus* status,
                         unsigned long long* id, cudaGraph_t* graph) {
#if CUDART_VERSION >= 13000
  return cudaStreamGetCaptureInfo(s, status, id, graph, nullptr, nullptr,
                                  nullptr);
#else
  return cudaStreamGetCaptureInfo(s, status, id, graph, nullptr, nullptr);
#endif
}

__global__ void __launch_bounds__(COND_THREADS)
grackle_loop_cond_kernel(const uint8_t* __restrict__ mask, long long n,
                         long long* __restrict__ step, long long advance,
                         long long cap,
                         cudaGraphConditionalHandle handle, int set_handle,
                         int* __restrict__ value_out,
                         unsigned long long* __restrict__ launches) {
  int found = 0;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(mask);
  // bytes before the first 16-byte boundary, then 16-byte chunks, then
  // the tail
  long long head = (long long)((16 - (addr & 15)) & 15);
  if (head > n) head = n;
  for (long long i = threadIdx.x; i < head && !found; i += blockDim.x)
    found = mask[i] != 0;
  const long long chunks = (n - head) >> 4;
  const uint4* body = reinterpret_cast<const uint4*>(mask + head);
  for (long long c = threadIdx.x; c < chunks && !found; c += blockDim.x) {
    const uint4 v = __ldg(body + c);
    found = (v.x | v.y | v.z | v.w) != 0;
  }
  for (long long i = head + (chunks << 4) + threadIdx.x; i < n && !found;
       i += blockDim.x)
    found = mask[i] != 0;
  found = __syncthreads_or(found);
  if (threadIdx.x == 0) {
    const long long s = *step + advance;
    *step = s;
    const unsigned int value = (found && s < cap) ? 1u : 0u;
    if (set_handle) cudaGraphSetConditional(handle, value);
    if (value_out) *value_out = (int)value;
    if (launches) atomicAdd(launches, 1ull);
  }
}

}  // namespace

extern "C" {

// The CUDA runtime this library was built with and the driver's, as
// 1000 * major + 10 * minor.  Returns a CUDA error code.
int grackle_loop_versions(int* runtime, int* driver) {
  cudaError_t err = cudaRuntimeGetVersion(runtime);
  if (err == cudaSuccess) err = cudaDriverGetVersion(driver);
  return (int)err;
}

// A conditional handle in the graph that `stream` is capturing into.
// Returns a CUDA error code; cudaErrorIllegalState if the stream is not
// capturing.
int grackle_loop_handle(void* stream, unsigned long long* handle) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
  unsigned long long id = 0;
  cudaError_t err = capture_info(static_cast<cudaStream_t>(stream), &status,
                                 &id, &graph);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive || graph == nullptr)
    return (int)cudaErrorIllegalState;
  cudaGraphConditionalHandle h;
  // the condition kernel sets the value before the node runs, on every
  // launch of the graph
  err = cudaGraphConditionalHandleCreate(&h, graph, 0, 0);
  *handle = (unsigned long long)h;
  return (int)err;
}

// The id of the capture `stream` belongs to (unique in the process).
// Returns a CUDA error code; cudaErrorIllegalState if the stream is not
// capturing.
int grackle_loop_capture_id(void* stream, unsigned long long* id) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
  cudaError_t err = capture_info(static_cast<cudaStream_t>(stream), &status,
                                 id, &graph);
  if (err != cudaSuccess) return (int)err;
  return (int)(status == cudaStreamCaptureStatusActive
                   ? cudaSuccess : cudaErrorIllegalState);
}

// Give the graph that `stream` is capturing a user object that records
// the capture's id when the graph and every executable graph made from
// it are gone (grackle_loop_released).  Returns a CUDA error code.
int grackle_loop_retain(void* stream) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
  unsigned long long id = 0;
  cudaError_t err = capture_info(static_cast<cudaStream_t>(stream), &status,
                                 &id, &graph);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive || graph == nullptr)
    return (int)cudaErrorIllegalState;
  cudaUserObject_t object;
  err = cudaUserObjectCreate(
      &object, reinterpret_cast<void*>(static_cast<uintptr_t>(id)),
      record_release, 1, cudaUserObjectNoDestructorSync);
  if (err != cudaSuccess) return (int)err;
  // the graph takes over the one reference
  return (int)cudaGraphRetainUserObject(graph, object, 1,
                                        cudaGraphUserObjectMove);
}

// Move up to `cap` ids of released captures into `ids`; returns how
// many.
int grackle_loop_released(unsigned long long* ids, int cap) {
  std::lock_guard<std::mutex> lock(released_mutex);
  int n = 0;
  while (n < cap && !released_ids.empty()) {
    ids[n++] = released_ids.back();
    released_ids.pop_back();
  }
  return n;
}

// Add a WHILE node on `handle` after the work captured so far on
// `stream`, make the node the stream's only dependency, and start
// capturing `body_stream` into the node's body graph.  Returns a CUDA
// error code.
int grackle_loop_begin(void* stream, void* body_stream,
                       unsigned long long handle) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  unsigned long long id = 0;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, &id, &graph, &deps,
                                             nullptr, &n_deps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, &id, &graph, &deps,
                                             &n_deps);
#endif
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive)
    return (int)cudaErrorIllegalState;

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = (cudaGraphConditionalHandle)handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
#endif
  if (err != cudaSuccess) return (int)err;
  cudaGraph_t body = params.conditional.phGraph_out[0];
#if CUDART_VERSION >= 13000
  err = cudaStreamUpdateCaptureDependencies(
      s, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  err = cudaStreamUpdateCaptureDependencies(
      s, &node, 1, cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamBeginCaptureToGraph(
      static_cast<cudaStream_t>(body_stream), body, nullptr, nullptr, 0,
      cudaStreamCaptureModeThreadLocal);
}

// End the capture of a WHILE node's body; `nodes` receives the body
// graph's own node count (a nested node counts as one).  Returns a CUDA
// error code.
int grackle_loop_end(void* body_stream, unsigned long long* nodes) {
  cudaGraph_t body = nullptr;
  cudaError_t err = cudaStreamEndCapture(
      static_cast<cudaStream_t>(body_stream), &body);
  size_t n = 0;
  if (err == cudaSuccess) err = cudaGraphGetNodes(body, nullptr, &n);
  *nodes = n;
  return (int)err;
}

// One launch of the condition kernel on `stream`: step += advance, then
// value = any(mask[0:n]) && step < cap, set on `handle` when set_handle
// is not 0 and written to value_out when it is not null; launches, when
// not null, counts the launches on the device.  Returns
// cudaGetLastError() after the launch.
int grackle_loop_cond(const void* mask, long long n, void* step,
                      long long advance, long long cap,
                      unsigned long long handle, int set_handle,
                      void* value_out, void* launches, void* stream) {
  grackle_loop_cond_kernel<<<1, COND_THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), n, static_cast<long long*>(step),
      advance, cap, (cudaGraphConditionalHandle)handle, set_handle,
      static_cast<int*>(value_out),
      static_cast<unsigned long long*>(launches));
  return (int)cudaGetLastError();
}

// A graph's own node count (a conditional node counts as one).
// Returns a CUDA error code.
int grackle_graph_nodes(void* graph, unsigned long long* count) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(static_cast<cudaGraph_t>(graph),
                                      nullptr, &n);
  *count = n;
  return (int)err;
}

}  // extern "C"
