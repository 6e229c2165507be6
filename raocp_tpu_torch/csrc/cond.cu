// Conditional nodes of a CUDA graph captured from a stream: the port's
// counterpart of lax.cond inside a jitted while_loop (raocp_tpu/accel.py:219,
// :228, :386, :389, :393, :415; raocp_tpu/solver.py's loops), for NVIDIA
// Hopper (sm_90a) and CUDA 12.4 or later.
//
// raocp_if_begin, called while `stream` captures a graph, appends to that
// graph a kernel that sets a new conditional handle from a device flag
// (`*pred != 0`, or its negation), then an IF node on the handle, makes the
// node the stream's capture dependency, and starts capturing `body` (another
// stream) into the node's body graph. Everything enqueued on `body` until
// raocp_if_end runs in a replay only where the flag held when the set
// kernel ran. Bodies nest: `stream` may itself be capturing a body.
//
// What bounds it on this card: neither bytes nor operations. The set kernel
// reads one byte and writes the handle (one thread); a replay pays a kernel
// node and a conditional node per branch, a few microseconds of the graph's
// own scheduling.
//
// raocp_mark appends a one-thread kernel that writes the card's clock
// (%globaltimer, nanoseconds) into a device slot: the device loops put one
// at each end of a captured period, so that every replay stamps its own
// start and end on the card's clock.
//
// A plain C interface for ctypes: streams, graphs and flags are pointers;
// every function returns a cudaError_t (0 on success).

#include <cuda_runtime.h>

namespace {

__global__ void set_conditional(cudaGraphConditionalHandle handle,
                                const unsigned char* pred, int negate) {
  cudaGraphSetConditional(handle, (pred[0] != 0) != (negate != 0) ? 1u : 0u);
}

__global__ void mark_clock(unsigned long long* slot) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  *slot = now;
}

cudaError_t capture_info(cudaStream_t stream, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* count) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph,
                                             deps, nullptr, count);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph,
                                             deps, count);
#endif
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive
             ? cudaSuccess : cudaErrorStreamCaptureImplicit;
}

}  // namespace

extern "C" int raocp_if_begin(void* stream_ptr, const void* pred, int negate,
                              void* body_ptr, int mode) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaStream_t body = static_cast<cudaStream_t>(body_ptr);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t count;
  cudaError_t err = capture_info(stream, &graph, &deps, &count);
  if (err != cudaSuccess) return err;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_conditional<<<1, 1, 0, stream>>>(
      handle, static_cast<const unsigned char*>(pred), negate);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the set kernel is now the stream's dependency
  err = capture_info(stream, &graph, &deps, &count);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, count, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(stream, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaGraphAddNode(&node, graph, deps, count, &params);
  if (err != cudaSuccess) return err;
  err = cudaStreamUpdateCaptureDependencies(stream, &node, 1,
                                            cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return err;
  return cudaStreamBeginCaptureToGraph(
      body, params.conditional.phGraph_out[0], nullptr, nullptr, 0,
      static_cast<cudaStreamCaptureMode>(mode));
}

extern "C" int raocp_if_end(void* body_ptr) {
  cudaGraph_t graph;
  return cudaStreamEndCapture(static_cast<cudaStream_t>(body_ptr), &graph);
}

extern "C" int raocp_mark(void* stream_ptr, void* slot) {
  mark_clock<<<1, 1, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      static_cast<unsigned long long*>(slot));
  return cudaGetLastError();
}

// Initialises this library's CUDA runtime on the current device, outside
// any capture (its first call would otherwise fall inside one).
extern "C" int raocp_cond_init(void) { return cudaFree(nullptr); }

extern "C" const char* raocp_cond_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
