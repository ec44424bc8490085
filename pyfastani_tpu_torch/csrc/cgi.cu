// The L2 sweep's merge, the identity gate, the two CGI reductions and
// the identity fold for NVIDIA Hopper (sm_90a).
//
// Hand kernels of the port, not the counterparts of a TPU kernel: the JAX
// package computes these steps as XLA array code,
// pyfastani_tpu/parallel/sharded.py: the merge of _l2_interval_scan
// (:519-530), the gate and CGI of _query_block_impl (:611-658) and the
// fold of ShardedSession's block_fn (:1219-1248).  The plain torch
// versions are pyfastani_tpu_torch/ops/cgi.py::cgi_bins_reference (over
// ops/l2_sweep.py::l2_merge_reference) and fold_bins_reference.
//
// cgi_bins: fragment f of F owns the ivmax intervals [f * ivmax, (f + 1) *
// ivmax).  Interval i owns the chunk slots [ends[i - 1], ends[i]) (ends[-1]
// = 0) cut at ch_max; its merge is the largest chunk best b of them, and
// the smallest first and largest last among the chunks at b.  With s =
// s_sizes[f] it is mapped when valid[i], b > 0 and b >= gate[clamp(s)];
// its identity is ident[clamp(s), clamp(b)] of the (smax + 1)^2 float32
// table, its contig c = clamp(seq[i], 0, C - 1), its genome s2g[c] and
// its bin clamp(floor((floor((first + last) / 2) + cmw - 1) / l), 0,
// bin_max - 1).  Step 1 keeps, per (fragment, genome), the mapped
// interval of the largest identity, the first one on a tie.  Step 2
// writes each interval's slot: a kept one's flat bin frag_qg[f] * C *
// bin_max + c * bin_max + bin (int64; frag_qg in [0, q_count)) and its
// identity, every other one bin -1 and identity -inf.  Nothing dense is
// written.  The same launch writes the pass's flags row: each of 1 to
// kMaxFlags 0-d flags (bool or int32) as an int32.
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
// ends word and flag and its chunks' best, a mapped interval's chunk
// anchors at its best, its contig and two table entries, and writes 12
// bytes a slot; fold_bins reads the slots and touches each occupied bin
// twice.  A merge of its own (one thread an interval) wrote three int64
// an interval for cgi_bins to read back, and took a launch and a wrapper
// call a group: at the all-vs-all's first group 3.1 MB written and 1 MB
// re-read of a 9 MB tail.
//
// What the design does about it:
//   * One warp a fragment, which looks up the fragment's gate once; each
//     lane merges its interval's chunks in registers: the largest best of
//     its slots (independent loads), then, only when that maps, the first
//     and last anchors of the chunks at it (their best read again, from
//     L1), so an unmapped interval reads its chunks' best alone; an
//     interval reads its contig, and the identity and genome tables, only
//     when it is mapped.
//   * Step 1 compares the fragment's intervals with each other through
//     warp shuffles, 32 at a time, so no segment table exists; the tie
//     rule reads interval indices, never an atomic's order.  Up to 32
//     intervals a fragment every mapping stays in its lane's registers.
//     Past 32, each interval is still merged once: the warp writes every
//     slot as if kept, and step 1 reads the other groups' mappings back
//     from those slots (the genome from the flat bin), then sets the
//     losers to -1 and -inf.
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

constexpr int kMaxFlags = 8;
constexpr int kI32Min = -2147483647 - 1;
constexpr int kI32Max = 2147483647;

// The pass's flags: 1 to kMaxFlags 0-d tensors of 1 (bool) or 4 (int32)
// bytes, written as one int32 row.
struct FlagRow {
    const void* src[kMaxFlags];
    int bytes[kMaxFlags];
    int n;
};

// One interval's gate, identity, genome and flat bin.
struct Mapping {
    bool mapped;
    int gid;
    float ident;
    long long bin;
};

// Interval i's merge of its chunk slots, then its gate, identity, genome
// and flat bin.
__device__ __forceinline__ Mapping interval_mapping(
    long long i, long long s_iv, long long gate_v, long long qg, const int* __restrict__ cbest,
    const int* __restrict__ cfirst, const int* __restrict__ clast,
    const long long* __restrict__ ends, long long ch_max, const bool* __restrict__ valid,
    const long long* __restrict__ seq, const float* __restrict__ ident, long long smax_tab,
    long long ident_stride, const int* __restrict__ s2g, long long C, long long cmw, long long l,
    long long bin_max) {
    Mapping m{false, 0, 0.0f, 0};
    if (!valid[i]) return m;  // no lane reads an invalid interval's chunks
    const long long start = i > 0 ? max(ends[i - 1], 0LL) : 0;
    const long long end = min(ends[i], ch_max);
    int b = kI32Min;  // an interval without a slot keeps it: unmapped
    for (long long j = start; j < end; ++j) b = max(b, cbest[j]);
    m.mapped = b > 0 && b >= gate_v;
    if (!m.mapped) return m;  // no lane reads an unmapped interval's anchors or rest
    int first = kI32Max, last = kI32Min;
    for (long long j = start; j < end; ++j) {  // its chunks' best again, from L1
        if (cbest[j] == b) {
            first = min(first, cfirst[j]);
            last = max(last, clast[j]);
        }
    }
    const long long mean_pos =
        floordiv(static_cast<long long>(first) + last, 2) + (cmw - 1);
    const long long rbin = clamp64(floordiv(mean_pos, l), 0, bin_max - 1);
    const long long seq_c = clamp64(seq[i], 0, C - 1);
    m.gid = s2g[seq_c];
    m.ident = ident[clamp64(s_iv, 0, smax_tab) * ident_stride + clamp64(b, 0, smax_tab)];
    m.bin = qg * (C * bin_max) + seq_c * bin_max + rbin;
    return m;
}

// The mapping an interval's slot holds (past 32 intervals a fragment,
// before step 1 has cut it): mapped where the bin is set.
__device__ __forceinline__ Mapping slot_mapping(long long i, const long long* slot_bin,
                                                const float* slot_ident,
                                                const int* __restrict__ s2g, long long C,
                                                long long bin_max) {
    Mapping m{false, 0, 0.0f, slot_bin[i]};
    m.mapped = m.bin >= 0;
    if (m.mapped) {
        m.gid = s2g[(m.bin / bin_max) % C];
        m.ident = slot_ident[i];
    }
    return m;
}

// Whether one of the 32 mappings `o` (lane k holds interval base2 + k) of
// me's genome has a larger identity than me, or an equal one and a
// smaller index.  Every lane of the warp calls it.
__device__ __forceinline__ bool beaten(const Mapping& me, long long mine, const Mapping& o,
                                       long long base2) {
    bool out = false;
    for (int src = 0; src < 32; ++src) {
        const bool o_mapped = __shfl_sync(kFull, static_cast<int>(o.mapped), src) != 0;
        const int o_gid = __shfl_sync(kFull, o.gid, src);
        const float o_ident = __shfl_sync(kFull, o.ident, src);
        const long long o_idx = base2 + src;
        if (o_mapped && o_gid == me.gid &&
            (o_ident > me.ident || (o_ident == me.ident && o_idx < mine)))
            out = true;
    }
    return out;
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
cgi_bins_kernel(const int* __restrict__ cbest, const int* __restrict__ cfirst,
                const int* __restrict__ clast, const long long* __restrict__ ends,
                long long ch_max, const bool* __restrict__ valid,
                const long long* __restrict__ seq, const int* __restrict__ s_sizes,
                const int* __restrict__ frag_qg, const int* __restrict__ gate, long long n_gate,
                const float* __restrict__ ident, long long smax_tab, long long ident_stride,
                const int* __restrict__ s2g, long long C, long long F, long long ivmax,
                long long cmw, long long l, long long bin_max,
                const __grid_constant__ FlagRow flags, int* __restrict__ flag_row,
                long long* slot_bin, float* slot_ident) {
    // the flags read in parameter space (__grid_constant__: no thread copies them)
    const int t = threadIdx.x;
    if (blockIdx.x == 0 && t < flags.n) {
        const void* src = flags.src[t];
        flag_row[t] = flags.bytes[t] == 1 ? static_cast<int>(*static_cast<const bool*>(src))
                                          : *static_cast<const int*>(src);
    }
    const int lane = threadIdx.x & 31;
    const long long f = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
    if (f >= F) return;  // the whole warp leaves together
    const long long s_iv = s_sizes[f];
    const long long gate_v = gate[clamp64(s_iv, 0, n_gate - 1)];
    const long long qg = frag_qg[f];
    const long long i0 = f * ivmax;
    const bool one_group = ivmax <= 32;
    if (!one_group) {
        // each interval merged once: its slot as if kept
        for (long long mine = lane; mine < ivmax; mine += 32) {
            const Mapping me = interval_mapping(i0 + mine, s_iv, gate_v, qg, cbest, cfirst, clast,
                                                ends, ch_max, valid, seq, ident, smax_tab,
                                                ident_stride, s2g, C, cmw, l, bin_max);
            slot_bin[i0 + mine] = me.mapped ? me.bin : -1;
            slot_ident[i0 + mine] = me.mapped ? me.ident : neg_inf();
        }
        __syncwarp();  // the slots of every lane are visible to the warp
    }
    for (long long base = 0; base < ivmax; base += 32) {
        const long long mine = base + lane;
        Mapping me{false, 0, 0.0f, 0};
        if (mine < ivmax) {
            me = one_group ? interval_mapping(i0 + mine, s_iv, gate_v, qg, cbest, cfirst, clast,
                                              ends, ch_max, valid, seq, ident, smax_tab,
                                              ident_stride, s2g, C, cmw, l, bin_max)
                           : slot_mapping(i0 + mine, slot_bin, slot_ident, s2g, C, bin_max);
        }
        // a mapped interval of the same genome with a larger identity, or
        // an equal one and a smaller index, takes the fragment's place
        bool keep = me.mapped;
        for (long long base2 = 0; base2 < ivmax; base2 += 32) {
            const long long other = base2 + lane;
            Mapping o{false, 0, 0.0f, 0};
            if (base2 == base) {
                o = me;
            } else if (other < ivmax) {
                o = slot_mapping(i0 + other, slot_bin, slot_ident, s2g, C, bin_max);
            }
            if (beaten(me, mine, o, base2)) keep = false;
        }
        if (mine < ivmax && (one_group || (me.mapped && !keep))) {
            slot_bin[i0 + mine] = keep ? me.bin : -1;
            slot_ident[i0 + mine] = keep ? me.ident : neg_inf();
        }
        // the next group reads this one's losers as unmapped: an interval
        // kept is its genome's maximum, which no loser's removal changes
        if (!one_group) __syncwarp();
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
// intervals of F fragments from their chunks' results cbest, cfirst, clast
// (ch_max,) int32 and the plan's ends (F * ivmax,) int64 (see the top of
// the file), and the row flag_row (n_flags,) int32 of the flags flag_src
// (host arrays of n_flags device pointers and their sizes, 1 or 4 bytes),
// in one launch on `stream`.  Returns cudaGetLastError().
int cgi_bins_launch(const void* cbest, const void* cfirst, const void* clast, const void* ends,
                    long long ch_max, const void* valid, const void* seq, const void* s_sizes,
                    const void* frag_qg, const void* gate, long long n_gate, const void* ident,
                    long long smax_tab, long long ident_stride, const void* s2g, long long C,
                    long long F, long long ivmax, long long cmw, long long l, long long bin_max,
                    const void* const* flag_src, const int* flag_bytes, int n_flags,
                    void* flag_row, void* slot_bin, void* slot_ident, void* stream) {
    if (n_gate < 1 || smax_tab < 0 || C < 1 || l < 1 || bin_max < 1 || ch_max < 0 ||
        n_flags < 1 || n_flags > kMaxFlags)
        return static_cast<int>(cudaErrorInvalidValue);
    FlagRow flags{};
    for (int k = 0; k < n_flags; ++k) {
        if (flag_bytes[k] != 1 && flag_bytes[k] != 4)
            return static_cast<int>(cudaErrorInvalidValue);
        flags.src[k] = flag_src[k];
        flags.bytes[k] = flag_bytes[k];
    }
    flags.n = n_flags;
    if (F < 0 || ivmax < 0) return static_cast<int>(cudaErrorInvalidValue);
    const long long grid = std::max(1LL, (F + kWarps - 1) / kWarps);
    cgi_bins_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(cbest), static_cast<const int*>(cfirst),
        static_cast<const int*>(clast), static_cast<const long long*>(ends), ch_max,
        static_cast<const bool*>(valid), static_cast<const long long*>(seq),
        static_cast<const int*>(s_sizes), static_cast<const int*>(frag_qg),
        static_cast<const int*>(gate), n_gate, static_cast<const float*>(ident), smax_tab,
        ident_stride, static_cast<const int*>(s2g), C, F, ivmax, cmw, l, bin_max,
        flags, static_cast<int*>(flag_row), static_cast<long long*>(slot_bin),
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
