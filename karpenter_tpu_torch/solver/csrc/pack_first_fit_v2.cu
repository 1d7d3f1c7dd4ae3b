// Exact first-fit packing of FFD-sorted pods into a node table, reading the
// per-core joined-frontier tables, for Hopper (sm_90a). One thread block per
// problem.
//
// Replaces: karpenter_tpu/solver/pallas_kernel_v2.py:63 (_pack_kernel_v2, the
// TPU kernel behind _pack_v2_call / pack_pallas_v2 / fused_solve_v2). It
// computes what that kernel computes, assignment for assignment, and what the
// plain version karpenter_tpu_torch/solver/kernel.py::pack_v2_reference
// computes: per pod, the lowest-index open node whose signature joins the
// pod's core (compat_j[core, 0, sig] > 0.5), whose hostname state admits the
// pod's hostname, and whose new f32 total fits some frontier row f < F of the
// joined signature (front_j[core, f*R + r, sig] for every r) takes the pod,
// and the node's signature becomes round(jvals[core, 0, sig]); otherwise the
// pod opens node `count` when open_fits says daemon + req fits a frontier row
// of its open signature and count < n_cap.
//
// The tables are the host precompute's (pack_kernel_v2._precompute):
//   front_j  [C, FRp, S_pad] f32, rows F*R..FRp-1 hold NEG and are never read;
//   compat_j [C, 8, S_pad]   f32, row 0 is 1.0 where join[s, c] >= 0;
//   jvals    [C, 8, S_pad]   f32, row 0 is join[s, c] as f32 (exact below 2^24).
//
// What the TPU kernel did, and what changes here: it kept each node's
// signature as a one-hot column of an [S_pad, N] f32 scratch and gathered the
// limits, the joinability and the joined id with three HIGHEST-precision MXU
// matmuls per pod, because VMEM has no cheap dynamic gather. Hopper has one:
// each node keeps its signature as an index, and a thread reads
// front_j[core, f*R + r, node_sig] straight from the table. The one-hot state
// and the matmuls are gone, and so is the VMEM budget they needed.
//
// What bounds it on this card: not bytes and not arithmetic. The node table
// and the pod side are a few hundred KB, and the fit tests are a few f32 adds
// and compares per (pod, open node, frontier row). The bound is the serial
// P-step chain, as in pack_first_fit: pod i+1 sees the node table pod i left
// behind, so every pod costs one block-wide minimum and two block barriers on
// one SM, plus, inside the step, the longest per-thread walk over frontier
// rows, whose loads are dependent on the previous row's outcome (the walk stops
// at the first row that fits) and come from L2: front_j for one problem at
// the 400-type catalog is 26.7 MB, which is far more than shared memory holds
// and fits the 50 MB L2. Nothing here assumes the tables fit on-chip.
//
// What the design does about it (pack_first_fit's skeleton):
// - One block owns the whole recurrence; a leading batch axis gives each
//   independent problem its own block (the multi-solve launches B blocks).
//   Thread t owns node slots t, t + blockDim, ... and scans only the slots
//   below the open count.
// - Pod scalars, requests (with daemon + req) and open_fits are staged into
//   shared memory a chunk of blockDim pods at a time, in parallel.
// - A warp's threads own neighbouring slots and, for one pod, read one table
//   row (the pod's core, frontier row f, axis r) at their nodes' signature
//   columns, so a warp's loads fall in one S_pad row.
// - jvals is read once, by the winning thread, at the winning slot.
// - The lowest passing slot is found with __reduce_min_sync inside each warp
//   and one pass over the per-warp minima in shared memory; ties go to the
//   lowest index because each thread stops at its first passing slot.
// - The thread that owns the winning slot (thread 0 when a node opens) makes
//   the update, so no value crosses threads beyond the minimum.
// Totals are f32 sums in pod order compared with <= against the tables' f32
// limits, the joined id is rounded to nearest and compatibility is > 0.5, as
// the TPU kernel converts them; nothing here contracts into an FMA and the
// build uses no fast math, so the results are bit-exact with the plain
// version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNone = 0x7fffffff;
constexpr int kTableRows = 8;  // rows of compat_j and jvals; row 0 is read

// rows of the [6, P] pod scalar table (the TPU kernel's order)
constexpr int kRowValid = 0;
constexpr int kRowOpenSig = 1;
constexpr int kRowCore = 2;
constexpr int kRowHost = 3;
constexpr int kRowHostInBase = 4;
constexpr int kRowOpenHost = 5;
constexpr int kScalRows = 6;

// flag bits of a staged pod
constexpr int kValid = 1;
constexpr int kHostInBase = 2;
constexpr int kOpenFits = 4;

__global__ void __launch_bounds__(kThreads)
pack_first_fit_v2_kernel(
    const int32_t* __restrict__ pod_scal,   // [B, 6, P]
    const float* __restrict__ pod_req,      // [B, R, P]
    const float* __restrict__ front_j,      // [B, C, FRp, S_pad]
    const float* __restrict__ compat_j,     // [B, C, 8, S_pad]
    const float* __restrict__ jvals,        // [B, C, 8, S_pad]
    const int32_t* __restrict__ open_fits,  // [B, 1, P]
    const float* __restrict__ daemon,       // [B, R, 1]
    int32_t* __restrict__ assignment,       // [B, P] out
    int32_t* node_sig,                      // [B, N] out, read back
    int32_t* node_host,                     // [B, N] out, read back
    float* node_req,                        // [B, N, R] out, read back
    int32_t* __restrict__ n_nodes,          // [B] out
    int P, int C, int FRp, int S_pad, int F, int R, int n_cap) {
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

  const size_t core_stride_front = (size_t)FRp * S_pad;
  const size_t core_stride_row = (size_t)kTableRows * S_pad;
  pod_scal += (size_t)b * kScalRows * P;
  pod_req += (size_t)b * R * P;
  front_j += (size_t)b * C * core_stride_front;
  compat_j += (size_t)b * C * core_stride_row;
  jvals += (size_t)b * C * core_stride_row;
  open_fits += (size_t)b * P;
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
      int flags = pod_scal[kRowValid * P + i] != 0 ? kValid : 0;
      if (pod_scal[kRowHostInBase * P + i] != 0) flags |= kHostInBase;
      if (open_fits[i] != 0) flags |= kOpenFits;
      s_core[tid] = pod_scal[kRowCore * P + i];
      s_host[tid] = pod_scal[kRowHost * P + i];
      s_open_sig[tid] = pod_scal[kRowOpenSig * P + i];
      s_open_host[tid] = pod_scal[kRowOpenHost * P + i];
      for (int r = 0; r < R; ++r) {
        const float v = pod_req[(size_t)r * P + i];
        s_req[tid * R + r] = v;
        s_open_req[tid * R + r] = __ldg(&daemon[r]) + v;
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
      const float* front_c = front_j + (size_t)core * core_stride_front;
      const float* compat_c = compat_j + (size_t)core * core_stride_row;  // row 0

      // 1. each thread's lowest passing slot among the open ones it owns
      int first = kNone;
      for (int n = tid; n < count; n += kThreads) {
        const int sig = node_sig[n];
        if (sig < 0) continue;
        if (!(__ldg(&compat_c[sig]) > 0.5f)) continue;
        if (host >= 0) {
          const int nh = node_host[n];
          if (!((nh == -1 && host_in_base) || nh == host)) continue;
        }
        const float* nr = node_req + (size_t)n * R;
        const float* col = front_c + sig;  // front_j[core, :, sig], stride S_pad
        bool fits = false;
        for (int f = 0; f < F && !fits; ++f) {
          bool all = true;
          for (int r = 0; r < R; ++r) {
            if (!(nr[r] + req[r] <= __ldg(&col[(size_t)(f * R + r) * S_pad]))) {
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
          const float* jv = jvals + (size_t)core * core_stride_row;  // row 0
          node_sig[best] = __float2int_rn(__ldg(&jv[node_sig[best]]));
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

// Launches B independent problems, one block each, on `stream`. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int pack_first_fit_v2_launch(
    const void* pod_scal, const void* pod_req, const void* front_j,
    const void* compat_j, const void* jvals, const void* open_fits,
    const void* daemon, void* assignment, void* node_sig, void* node_host,
    void* node_req, void* n_nodes, int B, int P, int C, int FRp, int S_pad,
    int F, int R, int n_cap, void* stream) {
  const int smem = (5 * kThreads + 2 * kThreads * R) * (int)sizeof(int32_t);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pack_first_fit_v2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return (int)e;
  }
  pack_first_fit_v2_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)pod_scal, (const float*)pod_req, (const float*)front_j,
      (const float*)compat_j, (const float*)jvals, (const int32_t*)open_fits,
      (const float*)daemon, (int32_t*)assignment, (int32_t*)node_sig,
      (int32_t*)node_host, (float*)node_req, (int32_t*)n_nodes, P, C, FRp,
      S_pad, F, R, n_cap);
  return (int)cudaGetLastError();
}
