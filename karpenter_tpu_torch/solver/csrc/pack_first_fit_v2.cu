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
// The walk reads a signature-major copy of front_j, front_s [C, S_pad, FRp]
// (pack_kernel_v2.signature_major, made once per closure), so the rows of one
// (core, signature) column are contiguous.
//
// What the TPU kernel did, and what changes here: it kept each node's
// signature as a one-hot column of an [S_pad, N] f32 scratch and gathered the
// limits, the joinability and the joined id with three HIGHEST-precision MXU
// matmuls per pod, because VMEM has no cheap dynamic gather. Hopper has one:
// each node keeps its signature as an index and the kernel reads the table at
// it. The one-hot state and the matmuls are gone.
//
// What bounds it on this card: not bytes and not arithmetic. The node table
// and the pod side are a few hundred KB, and the fit tests are a few f32 adds
// and compares per (pod, open node, frontier row). The bound is the serial
// P-step chain: pod i+1 sees the node table pod i left behind. On the
// 400-type team mix about 2,900 pods find their team's first node full and
// must walk all 400 frontier rows of it before the second node takes them;
// front_j for one problem there is 26.7 MB, which shared memory cannot hold,
// so those rows come from L2.
//
// The previous design (PR 2) walked those rows one after another in one
// thread, each load depending on the last, at a column stride of
// S_pad * 4 = 512 bytes, with two block barriers per pod: 539.8-548.4 ms on
// the full-width diverse batch (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
//
// What the design does about it: the shared skeleton in first_fit.cuh. A
// group of G = 32 lanes splits the walk, each lane two rows per ballot, 64
// independent loads from contiguous rows per ballot; one barrier per pod;
// node state in shared memory when it fits. jvals is read once, by the
// writing lane, at the winning slot. This file keeps only the pod staging and
// the fit test over compat_j, front_s and jvals. Now: 21.96 ms on the
// full-width diverse batch, 2,145 ns per pod step (same card; PERF.md, PR 3);
// reading front_j in place instead of the copy took 36.59 ms against
// 25.17 ms with it in the first measuring run.

#include "first_fit.cuh"

namespace {

using first_fit::kHostInBase;
using first_fit::kOpenFits;
using first_fit::kValid;

constexpr int kTableRows = 8;  // rows of compat_j and jvals; row 0 is read

// rows of the [6, P] pod scalar table (the TPU kernel's order)
constexpr int kRowValid = 0;
constexpr int kRowOpenSig = 1;
constexpr int kRowCore = 2;
constexpr int kRowHost = 3;
constexpr int kRowHostInBase = 4;
constexpr int kRowOpenHost = 5;
constexpr int kScalRows = 6;

struct Problem {
  const int32_t* pod_scal;   // [6, P]
  const float* pod_req;      // [R, P]
  const float* front_s;      // [C, S_pad, FRp]
  const float* compat_j;     // [C, 8, S_pad]
  const float* jvals;        // [C, 8, S_pad]
  const int32_t* open_fits;  // [1, P]
  const float* daemon;       // [R, 1]
  int P, S_pad, FRp, R;

  __device__ void stage(int i, int t, const first_fit::Stage& s) const {
    int flags = pod_scal[kRowValid * P + i] != 0 ? kValid : 0;
    if (pod_scal[kRowHostInBase * P + i] != 0) flags |= kHostInBase;
    if (open_fits[i] != 0) flags |= kOpenFits;
    s.core[t] = pod_scal[kRowCore * P + i];
    s.host[t] = pod_scal[kRowHost * P + i];
    s.open_sig[t] = pod_scal[kRowOpenSig * P + i];
    s.open_host[t] = pod_scal[kRowOpenHost * P + i];
    for (int r = 0; r < R; ++r) {
      const float v = pod_req[(size_t)r * P + i];
      s.req[t * R + r] = v;
      s.open_req[t * R + r] = __ldg(&daemon[r]) + v;
    }
    s.flags[t] = flags;
  }

  __device__ int key(int core, int sig) const {
    return __ldg(&compat_j[(size_t)core * kTableRows * S_pad + sig]) > 0.5f ? sig : -1;
  }
  __device__ const float* rows(int core, int sig, int) const {
    return front_s + ((size_t)core * S_pad + sig) * FRp;
  }
  __device__ int joined(int core, int sig) const {
    return __float2int_rn(__ldg(&jvals[(size_t)core * kTableRows * S_pad + sig]));
  }
};

template <bool kSmemNodes, bool kSplit>
__global__ void __launch_bounds__(first_fit::max_threads<kSplit>(), 1)
pack_first_fit_v2_kernel(
    const int32_t* __restrict__ pod_scal,   // [B, 6, P]
    const float* __restrict__ pod_req,      // [B, R, P]
    const float* __restrict__ front_s,      // [B, C, S_pad, FRp]
    const float* __restrict__ compat_j,     // [B, C, 8, S_pad]
    const float* __restrict__ jvals,        // [B, C, 8, S_pad]
    const int32_t* __restrict__ open_fits,  // [B, 1, P]
    const float* __restrict__ daemon,       // [B, R, 1]
    int32_t* assignment,                    // [B, P] out
    int32_t* node_sig,                      // [B, N] out
    int32_t* node_host,                     // [B, N] out
    float* node_req,                        // [B, N, R] out
    int32_t* n_nodes,                       // [B] out
    int P, int C, int FRp, int S_pad, int F, int R, int n_cap, int G) {
  const size_t b = blockIdx.x;
  const size_t table = (size_t)C * FRp * S_pad;
  const size_t rows8 = (size_t)C * kTableRows * S_pad;
  const Problem pb{
      pod_scal + b * kScalRows * P, pod_req + b * R * P, front_s + b * table,
      compat_j + b * rows8, jvals + b * rows8, open_fits + b * P, daemon + b * R,
      P, S_pad, FRp, R};
  const first_fit::Out out{assignment + b * P, node_sig + b * n_cap, node_host + b * n_cap,
                           node_req + b * n_cap * R, n_nodes + b};
  first_fit::run<Problem, kSmemNodes, kSplit>(pb, out, P, F, R, n_cap, G);
}

}  // namespace

// Launches B independent problems, one block each, on `stream`, with the
// host's launch plan (threads, G, node state in shared memory, dynamic shared
// bytes; pack_kernel.launch_plan). The walk reads front_s, the signature-major
// copy of front_j. Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for a plan that does not match this
// kernel's layout.
extern "C" int pack_first_fit_v2_launch(
    const void* pod_scal, const void* pod_req, const void* front_s,
    const void* compat_j, const void* jvals, const void* open_fits,
    const void* daemon, void* assignment, void* node_sig, void* node_host,
    void* node_req, void* n_nodes, int B, int P, int C, int FRp, int S_pad,
    int F, int R, int n_cap, int threads, int G, int smem_nodes,
    int smem, void* stream) {
  auto kernel = smem_nodes ? (G > 1 ? pack_first_fit_v2_kernel<true, true> : pack_first_fit_v2_kernel<true, false>)
                          : (G > 1 ? pack_first_fit_v2_kernel<false, true> : pack_first_fit_v2_kernel<false, false>);
  return first_fit::launch(
      kernel, B, threads, G, smem_nodes != 0, smem, R, n_cap, (cudaStream_t)stream,
      (const int32_t*)pod_scal, (const float*)pod_req, (const float*)front_s,
      (const float*)compat_j, (const float*)jvals, (const int32_t*)open_fits,
      (const float*)daemon, (int32_t*)assignment, (int32_t*)node_sig,
      (int32_t*)node_host, (float*)node_req, (int32_t*)n_nodes, P, C, FRp,
      S_pad, F, R, n_cap, G);
}
