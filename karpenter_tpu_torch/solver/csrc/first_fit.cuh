// The device-side skeleton both first-fit kernels share (pack_first_fit.cu and
// pack_first_fit_v2.cu), for Hopper (sm_90a). One thread block per problem
// runs the whole P-step recurrence; a kernel supplies only its pod staging
// and its fit test through a Problem type:
//
//   void stage(int i, int t, const Stage& s) const   stage pod i into slot t
//   int key(int core, int sig) const                  >= 0 when sig joins core
//   const float* rows(int core, int sig, int key) const
//                                                     frontier rows of the join:
//                                                     row f, axis r at [f*R + r]
//   int joined(int core, int sig) const               the joined signature id
//
// Per pod, the lowest-index open node that joins the pod's core, admits its
// hostname and whose new f32 total fits some frontier row takes the pod;
// otherwise the pod opens node `count` when its fresh-node fit holds and
// count < n_cap (kernel.py::pack_reference, the plain version).
//
// What bounds the kernels: the serial chain of P steps, not bytes and not
// arithmetic. Pod i+1 sees the node table pod i left behind. The design keeps
// each step to one block barrier and a few dependent loads:
// - A group of G lanes (G a power of two, 1..32, from the host's launch plan)
//   owns node slots grp, grp + n_groups, ... and scans the open ones in order.
//   The compat and hostname filter runs once per slot per group (the G lanes
//   load the same address). The group's lanes test frontier rows
//   f = lane, lane + G, ... of the joined signature at once: those loads do
//   not depend on each other and, with rows laid out contiguously, fall in one
//   or two 128-byte lines per stride. After each stride __ballot_sync over the
//   group decides "some row fits"; the group stops at its first slot that
//   fits. Each lane tests kStrides rows (f, f + G, ...) per ballot, so a
//   long walk pays one dependent round trip per kStrides * G rows. G = 1 is
//   thread-per-slot, compiled without ballots (kSplit false): a lane's walk
//   then stops at its first row that fits.
// - One block barrier per pod: each warp's minimum of its groups' first slots
//   goes to shared memory, double-buffered by barrier parity, so the barrier
//   that publishes pod k's minimum is the only one pod k needs. Every thread
//   then takes the block minimum (ties go to the lowest slot) and computes the
//   new open count itself; no shared count waits behind a second barrier.
// - Only the group that owns a slot reads or writes that node's state, and
//   the owner's lane 0 makes the update (opening a node included), so a
//   __syncwarp publishes it to the group's other lanes.
// - Node state (signature, hostname state, totals) lives in shared memory when
//   n_cap * (2 + R) * 4 bytes fit beside the staged pods, else in the output
//   tensors in device memory; the host chooses (kSmemNodes).
// - Pods are staged into shared memory a chunk of blockDim pods at a time, in
//   parallel: one barrier publishes a chunk and one retires it.
// Totals are f32 sums in pod order compared with <= against the exact limits;
// nothing contracts into an FMA and the build uses no fast math, so the
// results are bit-exact with the plain versions.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace first_fit {

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
// Block size bound of the thread-per-slot variant: more registers a thread.
constexpr int kMaxThreadsPerSlot = 512;
// Frontier rows each lane of a group tests per ballot (2 beat 1 and 4 on the
// 400-row diverse batch; PERF.md).
constexpr int kStrides = 2;

// The kernels declare __launch_bounds__(max_threads<kSplit>(), 1): one block
// per SM is all a problem needs, and without the second bound ptxas held the
// shared-memory variants to 32 registers and spilled.
constexpr int kNone = 0x7fffffff;

template <bool kSplit>
constexpr int max_threads() { return kSplit ? kMaxThreads : kMaxThreadsPerSlot; }

// flag bits of a staged pod
constexpr int kValid = 1;
constexpr int kHostInBase = 2;
constexpr int kOpenFits = 4;

// One chunk of staged pods in shared memory: blockDim slots.
struct Stage {
  int32_t* core;
  int32_t* host;
  int32_t* open_sig;
  int32_t* open_host;
  int32_t* flags;
  float* req;       // [blockDim, R]
  float* open_req;  // [blockDim, R] daemon + req
};

// The outputs of one problem, in device memory.
struct Out {
  int32_t* assignment;  // [P]
  int32_t* node_sig;    // [n_cap]
  int32_t* node_host;   // [n_cap]
  float* node_req;      // [n_cap, R]
  int32_t* n_nodes;     // [1]
};

// Dynamic shared memory of one block; pack_kernel.launch_plan mirrors it.
inline int stage_bytes(int threads, int R) { return (5 + 2 * R) * threads * 4; }
inline int node_bytes(int n_cap, int R) { return n_cap * (2 + R) * 4; }
inline int smem_bytes(int threads, int R, int n_cap, bool smem_nodes) {
  return stage_bytes(threads, R) + (smem_nodes ? node_bytes(n_cap, R) : 0);
}

inline bool pow2(int x) { return x > 0 && (x & (x - 1)) == 0; }

template <class Problem, bool kSmemNodes, bool kSplit>
__device__ __forceinline__ void run(const Problem& pb, const Out& out, int P, int F,
                                    int R, int n_cap, int G) {
  extern __shared__ int32_t smem[];
  __shared__ int32_t s_warp_min[2][kMaxWarps];

  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = T >> 5;
  const int grp = tid / G;
  const int gl = tid & (G - 1);  // lane within the group
  const int n_groups = T / G;
  const unsigned gmask =
      G == 32 ? 0xffffffffu : ((1u << G) - 1u) << (lane & ~(G - 1));

  Stage st;
  st.core = smem;
  st.host = st.core + T;
  st.open_sig = st.host + T;
  st.open_host = st.open_sig + T;
  st.flags = st.open_host + T;
  st.req = reinterpret_cast<float*>(st.flags + T);
  st.open_req = st.req + T * R;

  int32_t* nsig;
  int32_t* nhost;
  float* nreq;
  if (kSmemNodes) {
    nsig = reinterpret_cast<int32_t*>(st.open_req + T * R);
    nhost = nsig + n_cap;
    nreq = reinterpret_cast<float*>(nhost + n_cap);
  } else {
    nsig = out.node_sig;
    nhost = out.node_host;
    nreq = out.node_req;
  }
  for (int n = tid; n < n_cap; n += T) {
    nsig[n] = -1;
    nhost[n] = -1;
    for (int r = 0; r < R; ++r) nreq[(size_t)n * R + r] = 0.0f;
  }
  __syncthreads();

  int count = 0;  // open nodes; every thread carries the same value
  int phase = 0;  // which s_warp_min buffer this pod's barrier publishes
  for (int base = 0; base < P; base += T) {
    if (base + tid < P) pb.stage(base + tid, tid, st);
    __syncthreads();

    const int m = min(T, P - base);
    for (int k = 0; k < m; ++k) {
      const int flags = st.flags[k];
      if (!(flags & kValid)) {  // uniform across the block: no barrier skipped unevenly
        if (tid == 0) out.assignment[base + k] = -1;
        continue;
      }
      const int core = st.core[k];
      const int host = st.host[k];
      const bool host_in_base = (flags & kHostInBase) != 0;
      const float* req = st.req + k * R;

      // 1. the group's lowest passing slot among the open ones it owns
      int first = kNone;
      for (int n = grp; n < count; n += n_groups) {
        const int sig = nsig[n];
        if (sig < 0) continue;
        const int key = pb.key(core, sig);
        if (key < 0) continue;
        if (host >= 0) {
          const int nh = nhost[n];
          if (!((nh == -1 && host_in_base) || nh == host)) continue;
        }
        const float* nr = nreq + (size_t)n * R;
        const float* rows = pb.rows(core, sig, key);
        bool fits = false;
        if (!kSplit) {
          for (int f = 0; f < F && !fits; ++f) {
            bool ok = true;
            for (int r = 0; ok && r < R; ++r) {
              ok = nr[r] + req[r] <= __ldg(&rows[f * R + r]);
            }
            fits = ok;
          }
        } else {
          // the bound is the group's, so its lanes take every ballot together
          for (int f0 = 0; f0 < F; f0 += kStrides * G) {
            bool ok = false;
#pragma unroll
            for (int u = 0; u < kStrides; ++u) {
              const int f = f0 + u * G + gl;
              if (f < F) {
                bool row = true;
                for (int r = 0; r < R; ++r) {
                  row &= nr[r] + req[r] <= __ldg(&rows[f * R + r]);
                }
                ok |= row;
              }
            }
            if (__ballot_sync(gmask, ok)) {
              fits = true;
              break;
            }
          }
        }
        if (fits) {
          first = n;
          break;
        }
      }

      // 2. block-wide minimum behind this pod's one barrier
      const int wmin = __reduce_min_sync(0xffffffffu, first);
      if (lane == 0) s_warp_min[phase][warp] = wmin;
      __syncthreads();
      const int best =
          __reduce_min_sync(0xffffffffu, lane < n_warps ? s_warp_min[phase][lane] : kNone);
      phase ^= 1;

      // 3. every thread derives the target and the new count; the owning
      //    group's lane 0 writes the node
      int target = -1;
      if (best != kNone) {
        target = best;
      } else if ((flags & kOpenFits) && count < n_cap) {
        target = count;
      }
      if (target >= 0 && gl == 0 && (target & (n_groups - 1)) == grp) {
        float* nr = nreq + (size_t)target * R;
        if (best != kNone) {
          nsig[target] = pb.joined(core, nsig[target]);
          if (host >= 0) nhost[target] = host;
          for (int r = 0; r < R; ++r) nr[r] = nr[r] + req[r];
        } else {
          nsig[target] = st.open_sig[k];
          nhost[target] = st.open_host[k];
          for (int r = 0; r < R; ++r) nr[r] = st.open_req[k * R + r];
        }
      }
      if (best == kNone && target >= 0) ++count;
      if (tid == 0) out.assignment[base + k] = target;
      // 4. the group's other lanes see the owner's writes at the next pod
      __syncwarp();
    }
    // the staged chunk is dead only once every thread has left the pod loop
    __syncthreads();
  }
  if (kSmemNodes) {
    for (int n = tid; n < n_cap; n += T) {
      out.node_sig[n] = nsig[n];
      out.node_host[n] = nhost[n];
      for (int r = 0; r < R; ++r) out.node_req[(size_t)n * R + r] = nreq[(size_t)n * R + r];
    }
  }
  if (tid == 0) *out.n_nodes = count;
}

// Checks the host's launch plan against this layout and launches
// kernel<<<B, threads, smem>>>(args...), `kernel` the instantiation for
// (smem_nodes, G > 1). Returns a cudaError_t as an int.
template <class Kernel, class... Args>
inline int launch(Kernel kernel, int B, int threads, int G, bool smem_nodes,
                  int smem, int R, int n_cap, cudaStream_t stream, Args... args) {
  if (!pow2(threads) || threads < 32 || !pow2(G) || G > 32 ||
      threads > (G > 1 ? max_threads<true>() : max_threads<false>()) ||
      smem != smem_bytes(threads, R, n_cap, smem_nodes)) {
    return (int)cudaErrorInvalidValue;
  }
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<B, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace first_fit
