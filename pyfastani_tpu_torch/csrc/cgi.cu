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
// largest identity, the first one on a tie; step 2 writes into best_bin
// (q_count * C * bin_max float32, -inf where no interval lands) the
// largest kept identity per (query genome frag_qg[f], contig, bin).
//
// fold_bins: per (query genome q, contig c), over its bin_max bins b > 0:
// the count, and the sums of the high and low 12-bit limbs of
// round(b * 2^17) (half to even), added into row q, column s2g[c] of three
// (q_count, g_max) int64 outputs.
//
// What bounds them on the card: bytes.  cgi_bins reads each interval's
// best and flag, a mapped interval's three more words and two table
// entries, and writes best_bin once (56.6 MB at the
// all-vs-all's q 16, C 512, bin_max 1728: the fill dominates); fold_bins
// reads best_bin once.  The plain versions spent their time elsewhere:
// some 110 torch ops a group, each a launch, among them four segment
// reductions over tables of F * (g_max + 1) + g_max + 1 slots and the
// reductions of three (q, C, bin_max) int64 temporaries.
//
// What the design does about it:
//   * One warp a fragment, which looks up the fragment's gate once; an
//     interval reads its first, last and contig, and the identity and
//     genome tables, only when it is mapped.
//   * Step 1 compares the fragment's intervals with each other through
//     warp shuffles, 32 at a time (a loop past 32), so no segment table
//     exists; the tie rule reads interval indices, never an atomic's
//     order.
//   * Step 2 is one atomic max a kept interval on the float itself: a
//     non-negative value by atomicMax on its int bits, a negative one by
//     atomicMin on its unsigned bits, which orders IEEE floats (-inf
//     included).  A max is exact in any order.
//   * The flat bin index is 64-bit: a panel of many contigs passes 2^31
//     bins.
//   * fold_bins: one block a (query genome, contig) row reduces its bins
//     in registers and a warp shuffle, and adds its three sums with
//     integer atomics, exact in any order.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

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
                long long cmw, long long l, long long bin_max, float* __restrict__ best_bin) {
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
        if (keep) atomic_max_float(best_bin + me.bin, me.ident);
    }
}

__global__ void __launch_bounds__(kThreads)
fold_bins_kernel(const float* __restrict__ best_bin, const int* __restrict__ s2g, long long C,
                 long long bin_max, long long g_max, long long q_stride,
                 unsigned long long* __restrict__ out) {
    __shared__ long long part[3][kWarps];
    const long long row = blockIdx.x;  // q * C + c
    const long long q = row / C, c = row % C;
    const float* bins = best_bin + row * bin_max;
    long long n = 0, hi = 0, lo = 0;
    for (long long b = threadIdx.x; b < bin_max; b += kThreads) {
        const float v = bins[b];
        if (v > 0.0f) {
            const long long q17 = __float2ll_rn(v * 131072.0f);
            n += 1;
            hi += q17 >> 12;
            lo += q17 & 0xFFF;
        }
    }
    for (int o = 16; o > 0; o >>= 1) {
        n += __shfl_down_sync(kFull, n, o);
        hi += __shfl_down_sync(kFull, hi, o);
        lo += __shfl_down_sync(kFull, lo, o);
    }
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
        part[0][warp] = n;
        part[1][warp] = hi;
        part[2][warp] = lo;
    }
    __syncthreads();
    if (threadIdx.x < 3) {
        long long t = 0;
        for (int w = 0; w < kWarps; ++w) t += part[threadIdx.x][w];
        if (t != 0)
            atomicAdd(out + threadIdx.x * q_stride + q * g_max + s2g[c],
                      static_cast<unsigned long long>(t));
    }
}

}  // namespace

extern "C" {

// best_bin (q_count * C * bin_max,) float32, filled with -inf by the
// caller, from the intervals of F fragments (see the top of the file), on
// `stream`.  Returns cudaGetLastError().
int cgi_bins_launch(const void* best, const void* first, const void* last, const void* valid,
                    const void* seq, const void* s_sizes, const void* frag_qg, const void* gate,
                    long long n_gate, const void* ident, long long smax_tab,
                    long long ident_stride, const void* s2g, long long C, long long F,
                    long long ivmax, long long cmw, long long l, long long bin_max,
                    void* best_bin, void* stream) {
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
        F, ivmax, cmw, l, bin_max, static_cast<float*>(best_bin));
    return static_cast<int>(cudaGetLastError());
}

// out (3, q_count, g_max) int64, zeroed by the caller: the occupied-bin
// counts and the two limb sums of best_bin (q_count * C * bin_max,), on
// `stream`.  Returns cudaGetLastError().
int fold_bins_launch(const void* best_bin, const void* s2g, long long q_count, long long C,
                     long long bin_max, long long g_max, void* out, void* stream) {
    if (q_count <= 0 || C <= 0 || bin_max <= 0) return 0;
    if (q_count * C > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    fold_bins_kernel<<<static_cast<unsigned>(q_count * C), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(best_bin), static_cast<const int*>(s2g), C, bin_max, g_max,
        q_count * g_max, static_cast<unsigned long long*>(out));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
