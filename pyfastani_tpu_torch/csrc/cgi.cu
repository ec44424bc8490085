// The identity gate, the two CGI reductions and the identity fold for
// NVIDIA Hopper (sm_90a).
//
// Hand kernels of the port, not the counterparts of a TPU kernel: the JAX
// package computes both steps as XLA array code,
// pyfastani_tpu/parallel/sharded.py::_query_block_impl (the gate and CGI,
// :611-658) and the fold of ShardedSession's block_fn (:1219-1248).  The
// plain torch versions are pyfastani_tpu_torch/ops/cgi.py::
// cgi_bins_reference and fold_bins_reference.
//
// cgi_bins: fragment f of F owns the ivmax intervals [f * ivmax, (f + 1) *
// ivmax).  Interval i, with s = s_sizes[f], is mapped when valid[i],
// best[i] > 0 and best[i] >= gate[clamp(s)]; its identity is
// ident[clamp(s), clamp(best[i])] of the (smax + 1)^2 float32 table, its
// contig c = clamp(seq[i], 0, C - 1), its genome s2g[c] and its bin
// clamp(floor((floor((first + last) / 2) + cmw - 1) / l), 0, bin_max - 1).
// Step 1 keeps, per (fragment, genome), the mapped interval of the
// largest identity, the first one on a tie.  Step 2 writes each
// interval's slot: a kept one's flat bin frag_qg[f] * C * bin_max + c *
// bin_max + bin (int64) and its identity, every other one bin -1 and
// identity -inf.  Nothing dense is written.
//
// fold_bins: the kept slots of every data row of a shard and the shard's
// scratch, (q_count * C * bin_max,) float32 bins that hold -inf on entry.
// Launch A applies each slot's identity to its bin by an atomic max (the
// pmax over data rows and CGI's max per bin at once), zeroes the three
// (q_count, g_max) int64 outputs and writes the merged flags.  Launch B
// exchanges each kept slot's bin with -inf: the one slot that finds a
// value in it is the bin's first visitor and holds the bin's maximum v; if
// v > 0 it adds 1 and the high and low 12-bit limbs of round(v * 2^17)
// (half to even) into row q, column s2g[c] of the outputs.  So the counts
// and limb sums are the dense fold's over the bins b > 0 in any order, and
// the scratch is all -inf again when B ends.
//
// What bounds them on the card: bytes, and few of them.  A dense design
// fills 56.6 MB of bins a group at the all-vs-all's q 16, C 512,
// bin_max 1728, merges them through a second buffer and reads them again
// in the fold: some 340 MB a group.  Here cgi_bins reads each interval's
// best and flag, a mapped interval's three more words and two table
// entries, and writes 12 bytes a slot; fold_bins reads the slots and
// touches each occupied bin twice.
//
// What the design does about it:
//   * One warp a fragment, which looks up the fragment's gate once; an
//     interval reads its first, last and contig, and the identity and
//     genome tables, only when it is mapped.
//   * Step 1 compares the fragment's intervals with each other through
//     warp shuffles, 32 at a time (a loop past 32), so no segment table
//     exists; the tie rule reads interval indices, never an atomic's
//     order.
//   * Fixed slots, one an interval: no count, no compaction, no host sync.
//   * The bins are a scratch that persists across passes at -inf: A's
//     atomic max on the float itself (a non-negative value by atomicMax on
//     its int bits, a negative one by atomicMin on its unsigned bits, which
//     orders IEEE floats, -inf included) is exact in any order; B's
//     exchange both reads the maximum once per bin and restores -inf, so
//     no pass fills, merges or re-reads the dense bins.
//   * The flat bin index is 64-bit: a panel of many contigs passes 2^31
//     bins.
//   * The limbs add with 64-bit integer atomics, exact in any order.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kMaxBlocks = 4096;  // the fold's grid-stride launches

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ long long clamp64(long long x, long long lo, long long hi) {
    return min(max(x, lo), hi);
}

__device__ __forceinline__ long long floordiv(long long a, long long b) {
    const long long q = a / b;
    return (a % b != 0 && a < 0) ? q - 1 : q;
}

// One interval's gate, identity, genome and flat bin.
struct Mapping {
    bool mapped;
    int gid;
    float ident;
    long long bin;
};

__device__ __forceinline__ Mapping interval_mapping(
    long long i, long long s_iv, long long gate_v, long long qg, const long long* __restrict__ best,
    const long long* __restrict__ first, const long long* __restrict__ last,
    const bool* __restrict__ valid, const long long* __restrict__ seq,
    const float* __restrict__ ident, long long smax_tab, long long ident_stride,
    const int* __restrict__ s2g, long long C, long long cmw, long long l, long long bin_max) {
    Mapping m{false, 0, 0.0f, 0};
    const long long b = best[i];
    m.mapped = valid[i] && b > 0 && b >= gate_v;
    if (!m.mapped) return m;  // no lane reads an unmapped interval's rest
    const long long mean_pos = floordiv(first[i] + last[i], 2) + (cmw - 1);
    const long long rbin = clamp64(floordiv(mean_pos, l), 0, bin_max - 1);
    const long long seq_c = clamp64(seq[i], 0, C - 1);
    m.gid = s2g[seq_c];
    m.ident = ident[clamp64(s_iv, 0, smax_tab) * ident_stride + clamp64(b, 0, smax_tab)];
    m.bin = qg * (C * bin_max) + seq_c * bin_max + rbin;
    return m;
}

// max into a float in device memory, exact in any order
__device__ __forceinline__ void atomic_max_float(float* addr, float v) {
    if (__float_as_int(v) >= 0) {  // the sign bit clear
        atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
    } else {
        atomicMin(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
    }
}

__global__ void __launch_bounds__(kThreads)
cgi_bins_kernel(const long long* __restrict__ best, const long long* __restrict__ first,
                const long long* __restrict__ last, const bool* __restrict__ valid,
                const long long* __restrict__ seq, const int* __restrict__ s_sizes,
                const int* __restrict__ frag_qg, const int* __restrict__ gate, long long n_gate,
                const float* __restrict__ ident, long long smax_tab, long long ident_stride,
                const int* __restrict__ s2g, long long C, long long F, long long ivmax,
                long long cmw, long long l, long long bin_max, long long* __restrict__ slot_bin,
                float* __restrict__ slot_ident) {
    const int lane = threadIdx.x & 31;
    const long long f = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
    if (f >= F) return;  // the whole warp leaves together
    const long long s_iv = s_sizes[f];
    const long long gate_v = gate[clamp64(s_iv, 0, n_gate - 1)];
    const long long qg = frag_qg[f];
    const long long i0 = f * ivmax;
    for (long long base = 0; base < ivmax; base += 32) {
        const long long mine = base + lane;
        Mapping me{false, 0, 0.0f, 0};
        if (mine < ivmax)
            me = interval_mapping(i0 + mine, s_iv, gate_v, qg, best, first, last, valid, seq, ident,
                                  smax_tab, ident_stride, s2g, C, cmw, l, bin_max);
        bool keep = me.mapped;
        // a mapped interval of the same genome with a larger identity, or
        // an equal one and a smaller index, takes the fragment's place
        for (long long base2 = 0; base2 < ivmax; base2 += 32) {
            const long long other = base2 + lane;
            Mapping o{false, 0, 0.0f, 0};
            if (base2 == base) {
                o = me;
            } else if (other < ivmax) {
                o = interval_mapping(i0 + other, s_iv, gate_v, qg, best, first, last, valid, seq,
                                     ident, smax_tab, ident_stride, s2g, C, cmw, l, bin_max);
            }
            for (int src = 0; src < 32; ++src) {
                const bool o_mapped = __shfl_sync(kFull, static_cast<int>(o.mapped), src) != 0;
                const int o_gid = __shfl_sync(kFull, o.gid, src);
                const float o_ident = __shfl_sync(kFull, o.ident, src);
                const long long o_idx = base2 + src;
                if (o_mapped && o_gid == me.gid &&
                    (o_ident > me.ident || (o_ident == me.ident && o_idx < mine)))
                    keep = false;
            }
        }
        if (mine < ivmax) {
            slot_bin[i0 + mine] = keep ? me.bin : -1;
            slot_ident[i0 + mine] = keep ? me.ident : neg_inf();
        }
    }
}

__global__ void __launch_bounds__(kThreads)
fold_scatter_kernel(const long long* __restrict__ slot_bin, const float* __restrict__ slot_ident,
                    long long NS, float* __restrict__ scratch, long long G, long long limb_stride,
                    unsigned long long* __restrict__ out, const int* __restrict__ flags,
                    long long n_flag_rows, long long n_flags, long long* __restrict__ out_flags) {
    const long long step = static_cast<long long>(gridDim.x) * kThreads;
    const long long t0 = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    for (long long i = t0; i < NS; i += step) {
        const long long b = slot_bin[i];
        if (b >= 0) atomic_max_float(scratch + b, slot_ident[i]);
    }
    for (long long i = t0; i < 3 * G; i += step) out[(i / G) * limb_stride + i % G] = 0;
    if (t0 < n_flags) {
        long long m = 0;
        for (long long r = 0; r < n_flag_rows; ++r)
            m = max(m, static_cast<long long>(flags[r * n_flags + t0]));
        out_flags[t0] = m;
    }
}

__global__ void __launch_bounds__(kThreads)
fold_visit_kernel(const long long* __restrict__ slot_bin, long long NS, float* __restrict__ scratch,
                  const int* __restrict__ s2g, long long C, long long bin_max, long long g_max,
                  long long limb_stride, unsigned long long* __restrict__ out) {
    const long long step = static_cast<long long>(gridDim.x) * kThreads;
    for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; i < NS;
         i += step) {
        const long long b = slot_bin[i];
        if (b < 0) continue;
        // the bin's first visitor takes its maximum and leaves -inf behind
        const float v = atomicExch(scratch + b, neg_inf());
        if (!(v > 0.0f)) continue;
        const long long row = b / bin_max;  // q * C + c
        const long long key = (row / C) * g_max + s2g[row % C];
        const long long q17 = __float2ll_rn(v * 131072.0f);
        atomicAdd(out + key, 1ULL);
        atomicAdd(out + limb_stride + key, static_cast<unsigned long long>(q17 >> 12));
        atomicAdd(out + 2 * limb_stride + key, static_cast<unsigned long long>(q17 & 0xFFF));
    }
}

long long fold_grid(long long n) {
    return std::max(1LL, std::min((n + kThreads - 1) / kThreads, kMaxBlocks));
}

}  // namespace

extern "C" {

// The slots (F * ivmax,) int64 slot_bin and float32 slot_ident of the
// intervals of F fragments (see the top of the file), on `stream`.
// Returns cudaGetLastError().
int cgi_bins_launch(const void* best, const void* first, const void* last, const void* valid,
                    const void* seq, const void* s_sizes, const void* frag_qg, const void* gate,
                    long long n_gate, const void* ident, long long smax_tab,
                    long long ident_stride, const void* s2g, long long C, long long F,
                    long long ivmax, long long cmw, long long l, long long bin_max,
                    void* slot_bin, void* slot_ident, void* stream) {
    if (F <= 0 || ivmax <= 0) return 0;
    if (n_gate < 1 || smax_tab < 0 || C < 1 || l < 1 || bin_max < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long grid = (F + kWarps - 1) / kWarps;
    cgi_bins_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(best), static_cast<const long long*>(first),
        static_cast<const long long*>(last), static_cast<const bool*>(valid),
        static_cast<const long long*>(seq), static_cast<const int*>(s_sizes),
        static_cast<const int*>(frag_qg), static_cast<const int*>(gate), n_gate,
        static_cast<const float*>(ident), smax_tab, ident_stride, static_cast<const int*>(s2g), C,
        F, ivmax, cmw, l, bin_max, static_cast<long long*>(slot_bin),
        static_cast<float*>(slot_ident));
    return static_cast<int>(cudaGetLastError());
}

// The fold of NS slots (slot_bin, slot_ident) through `scratch` (-inf on
// entry and on return) into out, three rows of q_count * g_max int64,
// limb_stride apart, and the max of n_flag_rows rows of n_flags int32
// flags into out_flags (int64; none when n_flags is 0), on `stream`: two
// launches.  Returns cudaGetLastError().
int fold_bins_launch(const void* slot_bin, const void* slot_ident, long long NS, void* scratch,
                     const void* s2g, long long q_count, long long C, long long bin_max,
                     long long g_max, void* out, long long limb_stride, const void* flags,
                     long long n_flag_rows, long long n_flags, void* out_flags, void* stream) {
    if (C < 1 || bin_max < 1 || q_count < 0 || g_max < 0 || NS < 0 || n_flags > kThreads)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long G = q_count * g_max;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    const long long* bins = static_cast<const long long*>(slot_bin);
    if (NS > 0 || G > 0 || n_flags > 0) {
        fold_scatter_kernel<<<fold_grid(std::max({NS, 3 * G, n_flags})), kThreads, 0, st>>>(
            bins, static_cast<const float*>(slot_ident), NS, static_cast<float*>(scratch), G,
            limb_stride, static_cast<unsigned long long*>(out), static_cast<const int*>(flags),
            n_flag_rows, n_flags, static_cast<long long*>(out_flags));
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (NS > 0)
        fold_visit_kernel<<<fold_grid(NS), kThreads, 0, st>>>(
            bins, NS, static_cast<float*>(scratch), static_cast<const int*>(s2g), C, bin_max,
            g_max, limb_stride, static_cast<unsigned long long*>(out));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
