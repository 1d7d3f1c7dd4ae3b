// Exact first-fit packing of FFD-sorted pods into a node table, for Hopper
// (sm_90a). One thread block per problem.
//
// Replaces: karpenter_tpu/solver/pallas_kernel.py::_pack_kernel (the TPU
// kernel behind pack_pallas). It computes the same recurrence as that kernel
// and as the plain version karpenter_tpu_torch/solver/kernel.py::pack_reference,
// assignment for assignment: per pod, the lowest-index open node whose
// signature joins the pod's core, whose hostname state admits the pod's
// hostname, and whose new f32 total fits some frontier row of the joined
// signature takes the pod; otherwise the pod opens node `count` when
// daemon + req fits a frontier row of its open signature and count < n_cap.
//
// What bounds it on this card: not bytes and not arithmetic. The inputs and
// outputs are a few hundred KB (microseconds at 3.35 TB/s) and the fit tests
// are a few flops per (pod, open node). The bound is the serial P-step chain:
// pod i+1 sees the node table pod i left behind, so every pod costs one
// block-wide minimum and two block barriers, one after another, on one SM.
//
// What the design does about it: it keeps each step short rather than wide.
// - One block owns the whole recurrence (a leading batch axis gives each
//   independent problem its own block; one problem launches one block).
//   Thread t owns node slots t, t + blockDim, ... and scans only the slots
//   below the open count, so an idle table costs nothing.
// - Pod scalars and requests are staged into shared memory a chunk of
//   blockDim pods at a time, together with each pod's fresh-node request
//   (daemon + req) and whether it fits a frontier of its open signature, all
//   computed in parallel, so the serial loop reads only shared memory for
//   the pod side.
// - The lowest passing slot is found with __reduce_min_sync inside each warp
//   and one pass over the per-warp minima in shared memory; ties go to the
//   lowest index because each thread stops at its first passing slot and the
//   block takes the minimum.
// - The thread that owns the winning slot (or thread 0 when a node opens)
//   makes the update, so no value crosses threads beyond the minimum.
// - The node table (node_sig, node_host, node_req) lives in the output
//   tensors in device memory, where it stays resident in L2; one code path
//   serves the small table and the full-size retry alike. The join table and
//   frontiers are read through the read-only path. Nothing is unrolled over
//   signatures or frontier rows, so any S and F are served.
// Totals are f32 sums in pod order compared with <= against the exact
// milli-unit frontiers; nothing here contracts into an FMA, and the build
// does not use fast math, so the results are bit-exact with the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNone = 0x7fffffff;

// flag bits of a staged pod
constexpr int kValid = 1;
constexpr int kHostInBase = 2;
constexpr int kOpenFits = 4;

__global__ void __launch_bounds__(kThreads)
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
    int32_t* __restrict__ assignment,              // [B, P] out
    int32_t* node_sig,                             // [B, N] out, read back
    int32_t* node_host,                            // [B, N] out, read back
    float* node_req,                               // [B, N, R] out, read back
    int32_t* __restrict__ n_nodes,                 // [B] out
    int P, int S, int C, int F, int R, int n_cap) {
  extern __shared__ int32_t smem[];
  int32_t* s_core = smem;
  int32_t* s_host = s_core + kThreads;
  int32_t* s_open_sig = s_host + kThreads;
  int32_t* s_open_host = s_open_sig + kThreads;
  int32_t* s_flags = s_open_host + kThreads;
  float* s_req = reinterpret_cast<float*>(s_flags + kThreads);  // [kThreads, R]
  float* s_open_req = s_req + kThreads * R;                       // [kThreads, R]
  __shared__ int32_t s_warp_min[kWarps];
  __shared__ int32_t s_count;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  pod_valid += (size_t)b * P;
  pod_open_sig += (size_t)b * P;
  pod_core += (size_t)b * P;
  pod_host += (size_t)b * P;
  pod_host_in_base += (size_t)b * P;
  pod_open_host += (size_t)b * P;
  pod_req += (size_t)b * P * R;
  join_table += (size_t)b * S * C;
  frontiers += (size_t)b * S * F * R;
  daemon += (size_t)b * R;
  assignment += (size_t)b * P;
  node_sig += (size_t)b * n_cap;
  node_host += (size_t)b * n_cap;
  node_req += (size_t)b * n_cap * R;

  for (int n = tid; n < n_cap; n += kThreads) {
    node_sig[n] = -1;
    node_host[n] = -1;
    for (int r = 0; r < R; ++r) node_req[(size_t)n * R + r] = 0.0f;
  }
  if (tid == 0) s_count = 0;
  __syncthreads();

  for (int base = 0; base < P; base += kThreads) {
    // stage one chunk of pods: thread t loads pod base + t
    const int i = base + tid;
    if (i < P) {
      int flags = pod_valid[i] ? kValid : 0;
      if (pod_host_in_base[i]) flags |= kHostInBase;
      const int open_sig = pod_open_sig[i];
      s_core[tid] = pod_core[i];
      s_host[tid] = pod_host[i];
      s_open_sig[tid] = open_sig;
      s_open_host[tid] = pod_open_host[i];
      for (int r = 0; r < R; ++r) {
        const float v = pod_req[(size_t)i * R + r];
        s_req[tid * R + r] = v;
        s_open_req[tid * R + r] = __ldg(&daemon[r]) + v;
      }
      const float* fr = frontiers + (size_t)open_sig * F * R;
      for (int f = 0; f < F; ++f) {
        bool all = true;
        for (int r = 0; r < R; ++r) {
          if (!(s_open_req[tid * R + r] <= __ldg(&fr[f * R + r]))) {
            all = false;
            break;
          }
        }
        if (all) {
          flags |= kOpenFits;
          break;
        }
      }
      s_flags[tid] = flags;
    }
    __syncthreads();

    const int m = min(kThreads, P - base);
    for (int k = 0; k < m; ++k) {
      const int flags = s_flags[k];
      if (!(flags & kValid)) {  // uniform across the block: no barrier skipped unevenly
        if (tid == 0) assignment[base + k] = -1;
        continue;
      }
      const int count = s_count;
      const int core = s_core[k];
      const int host = s_host[k];
      const bool host_in_base = (flags & kHostInBase) != 0;
      const float* req = s_req + k * R;

      // 1. each thread's lowest passing slot among the open ones it owns
      int first = kNone;
      for (int n = tid; n < count; n += kThreads) {
        const int sig = node_sig[n];
        if (sig < 0) continue;
        const int j = __ldg(&join_table[(size_t)sig * C + core]);
        if (j < 0) continue;
        if (host >= 0) {
          const int nh = node_host[n];
          if (!((nh == -1 && host_in_base) || nh == host)) continue;
        }
        const float* nr = node_req + (size_t)n * R;
        const float* fr = frontiers + (size_t)j * F * R;
        bool fits = false;
        for (int f = 0; f < F && !fits; ++f) {
          bool all = true;
          for (int r = 0; r < R; ++r) {
            if (!(nr[r] + req[r] <= __ldg(&fr[f * R + r]))) {
              all = false;
              break;
            }
          }
          fits = all;
        }
        if (fits) {
          first = n;
          break;
        }
      }

      // 2. block-wide minimum: warp reduction, then the per-warp minima
      const int wmin = __reduce_min_sync(0xffffffffu, first);
      if (lane == 0) s_warp_min[warp] = wmin;
      __syncthreads();
      int best = s_warp_min[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) best = min(best, s_warp_min[w]);

      // 3. one thread decides and writes: the owner of the winning slot,
      //    or thread 0 when the pod opens a node or stays unscheduled
      const int decider = best != kNone ? best % kThreads : 0;
      if (tid == decider) {
        int target = -1;
        if (best != kNone) {
          target = best;
          const int j = __ldg(&join_table[(size_t)node_sig[best] * C + core]);
          node_sig[best] = j;
          if (host >= 0) node_host[best] = host;
          float* nr = node_req + (size_t)best * R;
          for (int r = 0; r < R; ++r) nr[r] = nr[r] + req[r];
        } else if ((flags & kOpenFits) && count < n_cap) {
          target = count;
          node_sig[count] = s_open_sig[k];
          node_host[count] = s_open_host[k];
          float* nr = node_req + (size_t)count * R;
          for (int r = 0; r < R; ++r) nr[r] = s_open_req[k * R + r];
          s_count = count + 1;
        }
        assignment[base + k] = target;
      }
      // 4. the next pod sees this pod's writes
      __syncthreads();
    }
    // the staged chunk is dead only once every thread has left the pod loop
    __syncthreads();
  }
  if (tid == 0) n_nodes[b] = s_count;
}

}  // namespace

extern "C" int pack_first_fit_smem_bytes(int R) {
  return (5 * kThreads + 2 * kThreads * R) * (int)sizeof(int32_t);
}

// Launches B independent problems, one block each, on `stream`. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int pack_first_fit_launch(
    const void* pod_valid, const void* pod_open_sig, const void* pod_core,
    const void* pod_host, const void* pod_host_in_base,
    const void* pod_open_host, const void* pod_req, const void* join_table,
    const void* frontiers, const void* daemon, void* assignment,
    void* node_sig, void* node_host, void* node_req, void* n_nodes, int B,
    int P, int S, int C, int F, int R, int n_cap, void* stream) {
  const int smem = pack_first_fit_smem_bytes(R);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pack_first_fit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  pack_first_fit_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)pod_valid, (const int32_t*)pod_open_sig,
      (const int32_t*)pod_core, (const int32_t*)pod_host,
      (const uint8_t*)pod_host_in_base, (const int32_t*)pod_open_host,
      (const float*)pod_req, (const int32_t*)join_table,
      (const float*)frontiers, (const float*)daemon, (int32_t*)assignment,
      (int32_t*)node_sig, (int32_t*)node_host, (float*)node_req,
      (int32_t*)n_nodes, P, S, C, F, R, n_cap);
  return (int)cudaGetLastError();
}
