// Exact first-fit packing of FFD-sorted pods into a node table, for Hopper
// (sm_90a). One thread block per problem.
//
// Replaces: karpenter_tpu/solver/pallas_kernel.py::_pack_kernel (the TPU
// kernel behind pack_pallas). It computes the same recurrence as that kernel
// and as the plain version karpenter_tpu_torch/solver/kernel.py::pack_reference,
// assignment for assignment: per pod, the lowest-index open node whose
// signature joins the pod's core (join_table[sig, core] >= 0), whose hostname
// state admits the pod's hostname, and whose new f32 total fits some frontier
// row of the joined signature (frontiers[j], [F, R] contiguous) takes the pod;
// otherwise the pod opens node `count` when daemon + req fits a frontier row
// of its open signature and count < n_cap.
//
// What bounds it on this card: not bytes and not arithmetic. The inputs and
// outputs are a few hundred KB (microseconds at 3.35 TB/s) and the fit tests
// are a few flops per (pod, open node). The bound is the serial P-step chain:
// pod i+1 sees the node table pod i left behind.
//
// The previous design (PR 1) spent two block barriers per pod, one for the
// minimum and one after thread 0 or the winner updated a shared count and the
// node table in device memory, and walked a node's frontier rows one after
// another in one thread: 10.75-10.87 ms on the headline batch (10,240 pods,
// F = 1, about 1.06 us per pod) and 261-263 ms on the 400-row diverse batch
// (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//
// What the design does about it: the shared skeleton in first_fit.cuh. One
// barrier per pod (double-buffered warp minima, the open count carried by
// every thread), node state in shared memory when it fits, and a node's
// frontier rows split over a group of G lanes that the host sizes to F
// (G = 1 at F = 1, compiled without ballots). This file keeps only the pod
// staging, which also walks each pod's open-signature frontier for its
// fresh-node fit, in parallel, and the fit test over join_table and
// frontiers. Now: 7.96 ms on the headline batch (777 ns per pod step) and
// 20.9 ms on the diverse batch (same card; PERF.md, PR 3).

#include "first_fit.cuh"

namespace {

using first_fit::kHostInBase;
using first_fit::kOpenFits;
using first_fit::kValid;

struct Problem {
  const uint8_t* pod_valid;         // [P]
  const int32_t* pod_open_sig;      // [P]
  const int32_t* pod_core;          // [P]
  const int32_t* pod_host;          // [P]
  const uint8_t* pod_host_in_base;  // [P]
  const int32_t* pod_open_host;     // [P]
  const float* pod_req;             // [P, R]
  const int32_t* join_table;        // [S, C]
  const float* frontiers;           // [S, F, R]
  const float* daemon;              // [R]
  int C, F, R;

  __device__ void stage(int i, int t, const first_fit::Stage& s) const {
    int flags = pod_valid[i] ? kValid : 0;
    if (pod_host_in_base[i]) flags |= kHostInBase;
    const int open_sig = pod_open_sig[i];
    s.core[t] = pod_core[i];
    s.host[t] = pod_host[i];
    s.open_sig[t] = open_sig;
    s.open_host[t] = pod_open_host[i];
    for (int r = 0; r < R; ++r) {
      const float v = pod_req[(size_t)i * R + r];
      s.req[t * R + r] = v;
      s.open_req[t * R + r] = __ldg(&daemon[r]) + v;
    }
    const float* fr = frontiers + (size_t)open_sig * F * R;
    for (int f = 0; f < F; ++f) {
      bool all = true;
      for (int r = 0; r < R; ++r) {
        if (!(s.open_req[t * R + r] <= __ldg(&fr[f * R + r]))) {
          all = false;
          break;
        }
      }
      if (all) {
        flags |= kOpenFits;
        break;
      }
    }
    s.flags[t] = flags;
  }

  __device__ int key(int core, int sig) const {
    return __ldg(&join_table[(size_t)sig * C + core]);
  }
  __device__ const float* rows(int, int, int key) const {
    return frontiers + (size_t)key * F * R;
  }
  __device__ int joined(int core, int sig) const { return key(core, sig); }
};

template <bool kSmemNodes, bool kSplit>
__global__ void __launch_bounds__(first_fit::max_threads<kSplit>(), 1)
pack_first_fit_kernel(
    const uint8_t* __restrict__ pod_valid,         // [B, P]
    const int32_t* __restrict__ pod_open_sig,      // [B, P]
    const int32_t* __restrict__ pod_core,          // [B, P]
    const int32_t* __restrict__ pod_host,          // [B, P]
    const uint8_t* __restrict__ pod_host_in_base,  // [B, P]
    const int32_t* __restrict__ pod_open_host,     // [B, P]
    const float* __restrict__ pod_req,             // [B, P, R]
    const int32_t* __restrict__ join_table,        // [B, S, C]
    const float* __restrict__ frontiers,           // [B, S, F, R]
    const float* __restrict__ daemon,              // [B, R]
    int32_t* assignment,                           // [B, P] out
    int32_t* node_sig,                             // [B, N] out
    int32_t* node_host,                            // [B, N] out
    float* node_req,                               // [B, N, R] out
    int32_t* n_nodes,                              // [B] out
    int P, int S, int C, int F, int R, int n_cap, int G) {
  const size_t b = blockIdx.x;
  const Problem pb{
      pod_valid + b * P, pod_open_sig + b * P, pod_core + b * P, pod_host + b * P,
      pod_host_in_base + b * P, pod_open_host + b * P, pod_req + b * P * R,
      join_table + b * S * C, frontiers + b * S * F * R, daemon + b * R, C, F, R};
  const first_fit::Out out{assignment + b * P, node_sig + b * n_cap, node_host + b * n_cap,
                           node_req + b * n_cap * R, n_nodes + b};
  first_fit::run<Problem, kSmemNodes, kSplit>(pb, out, P, F, R, n_cap, G);
}

}  // namespace

// Launches B independent problems, one block each, on `stream`, with the
// host's launch plan (threads, G, node state in shared memory, dynamic shared
// bytes; pack_kernel.launch_plan). Returns cudaGetLastError() after the
// launch (0 on success), or cudaErrorInvalidValue for a plan that does not
// match this kernel's layout.
extern "C" int pack_first_fit_launch(
    const void* pod_valid, const void* pod_open_sig, const void* pod_core,
    const void* pod_host, const void* pod_host_in_base,
    const void* pod_open_host, const void* pod_req, const void* join_table,
    const void* frontiers, const void* daemon, void* assignment,
    void* node_sig, void* node_host, void* node_req, void* n_nodes, int B,
    int P, int S, int C, int F, int R, int n_cap, int threads, int G,
    int smem_nodes, int smem, void* stream) {
  auto kernel = smem_nodes ? (G > 1 ? pack_first_fit_kernel<true, true> : pack_first_fit_kernel<true, false>)
                          : (G > 1 ? pack_first_fit_kernel<false, true> : pack_first_fit_kernel<false, false>);
  return first_fit::launch(
      kernel, B, threads, G, smem_nodes != 0, smem, R, n_cap, (cudaStream_t)stream,
      (const uint8_t*)pod_valid, (const int32_t*)pod_open_sig,
      (const int32_t*)pod_core, (const int32_t*)pod_host,
      (const uint8_t*)pod_host_in_base, (const int32_t*)pod_open_host,
      (const float*)pod_req, (const int32_t*)join_table,
      (const float*)frontiers, (const float*)daemon, (int32_t*)assignment,
      (int32_t*)node_sig, (int32_t*)node_host, (float*)node_req,
      (int32_t*)n_nodes, P, S, C, F, R, n_cap, G);
}
