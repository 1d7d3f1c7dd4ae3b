// Native first-fit packer — the CPU contender of the port's cost router.
//
// Host C++, not a kernel: the same contract and assignment-exact semantics
// as the port's packing recurrence (kernel.py pack_reference, the CUDA
// kernels pack_first_fit / pack_first_fit_v2): pods arrive FFD-sorted and
// encoded (signature ids, interned hostname ids, fixed-axis f32 request
// vectors); each pod lands on the FIRST open node whose joined signature
// accepts it, whose hostname state is compatible, and where some
// pareto-frontier row still fits the new running total — else it opens a
// node when capacity and the node-table cap allow.
//
// The in-process packer of upstream Karpenter is the Go FFD loop
// (pkg/controllers/provisioning/scheduling/scheduler.go:64-137); this is its
// native equivalent operating on the dense tensor encoding. The router
// (router.py) weighs it against the card per shape class; on CPU tensors
// pack_best serves with it when it is built.
//
// Build (native.py, at first use): g++ -O3 -shared -fPIC -o libffd_pack.so ffd_pack.cpp
// ABI: plain C, called through ctypes.

#include <cstdint>
#include <cstring>

extern "C" {

// Returns the number of opened nodes. Arrays are caller-allocated:
//   assignment[P] (out), node_sig[n_max] (out), node_host[n_max] (out),
//   node_req[n_max*R] (out, row-major).
int32_t ffd_pack(
    const uint8_t* pod_valid,        // [P]
    const int32_t* pod_open_sig,     // [P]
    const int32_t* pod_core,         // [P]
    const int32_t* pod_host,         // [P] (-1 = unconstrained)
    const uint8_t* pod_host_in_base, // [P]
    const int32_t* pod_open_host,    // [P]
    const float* pod_req,            // [P*R] row-major
    const int32_t* join_table,       // [S*C] row-major
    const float* frontiers,          // [S*F*R] row-major
    const float* daemon,             // [R]
    int32_t P, int32_t R, int32_t S, int32_t C, int32_t F,
    int32_t n_max,
    int32_t* assignment,             // out [P]
    int32_t* node_sig,               // out [n_max]
    int32_t* node_host,              // out [n_max]
    float* node_req                  // out [n_max*R]
) {
    for (int32_t n = 0; n < n_max; ++n) {
        node_sig[n] = -1;
        node_host[n] = -1;
    }
    std::memset(node_req, 0, sizeof(float) * (size_t)n_max * (size_t)R);

    // scratch: candidate running total for the fit test
    float new_req[64];  // R is small (fixed resource axes); guard below
    if (R > 64) return -1;

    int32_t count = 0;
    for (int32_t i = 0; i < P; ++i) {
        assignment[i] = -1;
        if (!pod_valid[i]) continue;
        const float* req = pod_req + (size_t)i * R;
        const int32_t core = pod_core[i];
        const int32_t host = pod_host[i];

        int32_t target = -1;
        int32_t joined_sig = -1;
        // first-fit over open nodes
        for (int32_t n = 0; n < count; ++n) {
            const int32_t sig = node_sig[n];
            if (sig < 0) continue;
            const int32_t j = join_table[(size_t)sig * C + core];
            if (j < 0) continue;
            // hostname join (kernel.py step semantics)
            const int32_t nh = node_host[n];
            const bool ok_host =
                (host < 0) || (nh == -1 && pod_host_in_base[i]) || (nh == host);
            if (!ok_host) continue;
            const float* total = node_req + (size_t)n * R;
            for (int32_t r = 0; r < R; ++r) new_req[r] = total[r] + req[r];
            // ∃ frontier row of the JOINED signature that fits
            bool fits = false;
            const float* fr = frontiers + (size_t)j * F * R;
            for (int32_t f = 0; f < F && !fits; ++f) {
                bool row_ok = true;
                const float* row = fr + (size_t)f * R;
                for (int32_t r = 0; r < R; ++r) {
                    if (new_req[r] > row[r]) { row_ok = false; break; }
                }
                fits = row_ok;
            }
            if (fits) { target = n; joined_sig = j; break; }
        }

        if (target >= 0) {
            float* total = node_req + (size_t)target * R;
            for (int32_t r = 0; r < R; ++r) total[r] += req[r];
            node_sig[target] = joined_sig;
            if (host >= 0) node_host[target] = host;
            assignment[i] = target;
            continue;
        }

        // open a new node when the daemon+pod total fits its signature's
        // frontier and the table has room
        if (count >= n_max) continue;
        const int32_t open_sig = pod_open_sig[i];
        const float* fr = frontiers + (size_t)open_sig * F * R;
        for (int32_t r = 0; r < R; ++r) new_req[r] = daemon[r] + req[r];
        bool open_fits = false;
        for (int32_t f = 0; f < F && !open_fits; ++f) {
            bool row_ok = true;
            const float* row = fr + (size_t)f * R;
            for (int32_t r = 0; r < R; ++r) {
                if (new_req[r] > row[r]) { row_ok = false; break; }
            }
            open_fits = row_ok;
        }
        if (!open_fits) continue;
        node_sig[count] = open_sig;
        node_host[count] = pod_open_host[i];
        float* total = node_req + (size_t)count * R;
        for (int32_t r = 0; r < R; ++r) total[r] = new_req[r];
        assignment[i] = count;
        ++count;
    }
    return count;
}

}  // extern "C"
