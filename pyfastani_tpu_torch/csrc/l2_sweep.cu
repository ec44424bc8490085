// The L2 sweep's chunk plan and merge for NVIDIA Hopper (sm_90a).
//
// Hand kernels of the port, not the counterparts of a TPU kernel: the JAX
// package computes both steps as XLA array code around its one Pallas
// kernel, pyfastani_tpu/parallel/sharded.py::_l2_interval_scan (the plan
// :403-456, the merge :519-530).  The plain torch versions are
// pyfastani_tpu_torch/ops/l2_sweep.py::l2_plan_reference and
// l2_merge_reference.  Interval i of NI (the L1 stage's candidate
// intervals, flattened) spans window offsets [c0[i], c1[i]] of contig
// seq[i] when valid[i]:
//   * the plan cuts it into n_ch[i] = ceil(span / cmax) chunks, placed
//     back to back on a ch_max-slot axis (ends = cumsum(n_ch), total =
//     ends[NI - 1]); slot j < total belongs to the interval o whose
//     [ends[o] - n_ch[o], ends[o]) holds it.  Its chunk starts at c0[o] +
//     (j - start_o) * cmax, holds min(cmax, c1[o] - its start + 1)
//     offsets, and its range of the position-ordered minimizer store is
//     [lo, hi): two lower-bound searches of mini_gpos, `steps` rounds of a
//     binary search inside the prefix bucket of each key, clamped to the
//     contig's block [cof[seq], cof[seq + 1]).  rlen = max(hi - lo, 0);
//     flags[1] is raised when some rlen passes rcap, which then clamps
//     it, and flags[0] when total passes ch_max.  A slot at or past total
//     holds 0 in all five operands: nothing reads its range, and the
//     plain version's lo and frag there are left free by the contract;
//   * the merge takes interval i's chunk results in its own slots
//     [ends[i] - n_ch[i], ends[i]) cut at ch_max: the largest best, then
//     the smallest first and the largest last among the chunks at it
//     (I32_MIN, I32_MAX, I32_MIN without a slot); best = -1 unless
//     valid[i] and n_ch[i] > 0.
//
// What bounds it on the card: bytes.  The plan reads each interval's
// four words, writes 5 int32 a slot, and each live slot's two searches
// read some 2 * steps positions of a store of 10^8 int32 (450 MB at the
// all-vs-all's index), scattered: latency, not bandwidth, is what a
// thread waits on.  The merge reads each chunk's three results
// once.  The plain versions spent their time elsewhere: some 200 torch
// ops a group, each a launch over ch_max or NI elements, among them a
// scatter, a 1-D cummax that torch runs on one block, and three segment
// reductions over NI + 1 segments.
//
// What the design does about it:
//   * The plan is two launches and one torch.cumsum between them: one
//     thread an interval writes n_ch; one thread a slot finds its owner
//     by a binary search over `ends` (log2 NI reads, cached), then runs
//     its chunk's two searches.  A slot past total writes its zeros and
//     does nothing else.  The grid is sized by ch_max, never by total,
//     so nothing waits for the device.
//   * A search ends as soon as its bucket range is empty, and reads the
//     store only then: an empty store (M = 0) is never read.
//   * The merge is one thread an interval over its own contiguous slots:
//     no segment table, no atomics.
//   * Both flags are plain stores of true into bools the caller zeroed,
//     so the wrapper returns views of them.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kBig = 1LL << 30;  // the window-position pad
constexpr long long kI32Min = -(1LL << 31);
constexpr long long kI32Max = (1LL << 31) - 1;

// torch.clamp(x, lo, hi): min(max(x, lo), hi), also when lo > hi
__device__ __forceinline__ long long clamp64(long long x, long long lo, long long hi) {
    return min(max(x, lo), hi);
}

// floor division by a positive divisor, as torch's // on int64
__device__ __forceinline__ long long floordiv(long long a, long long b) {
    const long long q = a / b;
    return (a % b != 0 && a < 0) ? q - 1 : q;
}

// searchsorted(mini_gpos, key, 'left') through the prefix-bucket table,
// `steps` rounds at most, as the plain version's _bucketed_gpos_search
__device__ __forceinline__ long long bucketed_search(const int* __restrict__ gpos, long long M,
                                                     const int* __restrict__ bucket,
                                                     long long n_bucket, int shift, int steps,
                                                     long long key) {
    const long long b = clamp64(key >> shift, 0, n_bucket - 2);
    long long lo = bucket[b], hi = bucket[b + 1];
    for (int st = 0; st < steps && lo < hi && M > 0; ++st) {
        const long long mid = floordiv(lo + hi, 2);
        if (static_cast<long long>(gpos[clamp64(mid, 0, M - 1)]) < key) {
            lo = mid + 1;
        } else {
            hi = mid;
        }
    }
    return lo;
}

__global__ void __launch_bounds__(kThreads)
l2_plan_count_kernel(const long long* __restrict__ c0, const long long* __restrict__ c1,
                     const bool* __restrict__ valid, long long NI, long long cmax,
                     long long* __restrict__ n_ch) {
    const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    if (i >= NI) return;
    const long long span = valid[i] ? c1[i] - c0[i] + 1 : 0;
    n_ch[i] = floordiv(span + cmax - 1, cmax);
}

__global__ void __launch_bounds__(kThreads)
l2_plan_kernel(const long long* __restrict__ ends, long long NI, long long ch_max,
               const long long* __restrict__ seq, const long long* __restrict__ c0,
               const long long* __restrict__ c1, const long long* __restrict__ frag_of_iv,
               const int* __restrict__ coff, long long n_coff, const int* __restrict__ cof,
               const int* __restrict__ gpos, long long M, const int* __restrict__ bucket,
               long long n_bucket, int shift, int steps, long long cmw, long long cmax,
               long long rcap, int* __restrict__ lo_out, int* __restrict__ rlen_out,
               int* __restrict__ frag_out, int* __restrict__ c0_out, int* __restrict__ len_out,
               bool* __restrict__ flags) {
    const long long j = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    if (j >= ch_max) return;
    const long long total = ends[NI - 1];
    if (j == 0 && total > ch_max) flags[0] = true;
    if (j >= total) {  // no chunk: an empty range
        lo_out[j] = rlen_out[j] = frag_out[j] = c0_out[j] = len_out[j] = 0;
        return;
    }
    // the owner: the first interval whose end passes j
    long long a = 0, b = NI - 1;
    while (a < b) {
        const long long m = (a + b) >> 1;
        if (ends[m] > j) {
            b = m;
        } else {
            a = m + 1;
        }
    }
    const long long o = a;
    const long long start = o > 0 ? ends[o - 1] : 0;
    const long long ch_c0 = c0[o] + (j - start) * cmax;
    const long long ch_len = clamp64(c1[o] - ch_c0 + 1, 0, cmax);
    const long long seq_c = clamp64(seq[o], 0, n_coff - 2);
    const long long base = coff[seq_c];
    const long long key_lo = base + ch_c0;
    const long long key_hi = base + min(ch_c0 + ch_len - 1 + cmw, kBig);
    long long lo = bucketed_search(gpos, M, bucket, n_bucket, shift, steps, key_lo);
    long long hi = bucketed_search(gpos, M, bucket, n_bucket, shift, steps, key_hi);
    lo = max(lo, static_cast<long long>(cof[seq_c]));
    hi = min(hi, static_cast<long long>(cof[seq_c + 1]));
    long long rlen = max(hi - lo, 0LL);
    if (rlen > rcap) flags[1] = true;
    rlen = clamp64(rlen, 0, rcap);
    lo_out[j] = static_cast<int>(lo);
    rlen_out[j] = static_cast<int>(rlen);
    frag_out[j] = static_cast<int>(frag_of_iv[o]);
    c0_out[j] = static_cast<int>(ch_c0);
    len_out[j] = static_cast<int>(ch_len);
}

__global__ void __launch_bounds__(kThreads)
l2_merge_kernel(const int* __restrict__ cbest, const int* __restrict__ cfirst,
                const int* __restrict__ clast, const long long* __restrict__ ends,
                const bool* __restrict__ valid, long long NI, long long ch_max,
                long long* __restrict__ best, long long* __restrict__ first,
                long long* __restrict__ last) {
    const long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    if (i >= NI) return;
    const long long start = i > 0 ? ends[i - 1] : 0;
    const long long end = ends[i];
    long long b = kI32Min, f = kI32Max, l = kI32Min;
    for (long long j = max(start, 0LL); j < min(end, ch_max); ++j) {
        const long long v = cbest[j];
        if (v > b) {
            b = v;
            f = cfirst[j];
            l = clast[j];
        } else if (v == b) {
            f = min(f, static_cast<long long>(cfirst[j]));
            l = max(l, static_cast<long long>(clast[j]));
        }
    }
    best[i] = (valid[i] && end - start > 0) ? b : -1;
    first[i] = f;
    last[i] = l;
}

inline long long blocks(long long n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

// n_ch (NI,) int64: each interval's chunk count, on `stream`.  Returns
// cudaGetLastError().
int l2_plan_count_launch(const void* c0, const void* c1, const void* valid, long long NI,
                         long long cmax, void* n_ch, void* stream) {
    if (NI <= 0) return 0;
    l2_plan_count_kernel<<<blocks(NI), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(c0), static_cast<const long long*>(c1),
        static_cast<const bool*>(valid), NI, cmax, static_cast<long long*>(n_ch));
    return static_cast<int>(cudaGetLastError());
}

// Every chunk slot of the plan (see the top of the file) from ends =
// cumsum(n_ch), on `stream`: lo, rlen, frag, c0, len (ch_max,) int32;
// flags two bools the caller zeroed (chunk overflow, range overflow).
// Returns cudaGetLastError().
int l2_plan_launch(const void* ends, long long NI, long long ch_max, const void* seq,
                   const void* c0, const void* c1, const void* frag_of_iv, const void* coff,
                   long long n_coff, const void* cof, const void* gpos, long long M,
                   const void* bucket, long long n_bucket, int shift, int steps, long long cmw,
                   long long cmax, long long rcap, void* lo, void* rlen, void* frag,
                   void* ch_c0, void* ch_len, void* flags, void* stream) {
    if (ch_max <= 0 || NI <= 0) return 0;
    if (n_bucket < 2 || n_coff < 1) return static_cast<int>(cudaErrorInvalidValue);
    l2_plan_kernel<<<blocks(ch_max), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(ends), NI, ch_max, static_cast<const long long*>(seq),
        static_cast<const long long*>(c0), static_cast<const long long*>(c1),
        static_cast<const long long*>(frag_of_iv), static_cast<const int*>(coff), n_coff,
        static_cast<const int*>(cof), static_cast<const int*>(gpos), M,
        static_cast<const int*>(bucket), n_bucket, shift, steps, cmw, cmax, rcap,
        static_cast<int*>(lo), static_cast<int*>(rlen), static_cast<int*>(frag),
        static_cast<int*>(ch_c0), static_cast<int*>(ch_len), static_cast<bool*>(flags));
    return static_cast<int>(cudaGetLastError());
}

// best, first, last (NI,) int64 per interval from the chunk results
// cbest, cfirst, clast (ch_max,) int32 and ends = cumsum(n_ch), on
// `stream`.  Returns cudaGetLastError().
int l2_merge_launch(const void* cbest, const void* cfirst, const void* clast, const void* ends,
                    const void* valid, long long NI, long long ch_max, void* best, void* first,
                    void* last, void* stream) {
    if (NI <= 0) return 0;
    l2_merge_kernel<<<blocks(NI), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(cbest), static_cast<const int*>(cfirst),
        static_cast<const int*>(clast), static_cast<const long long*>(ends),
        static_cast<const bool*>(valid), NI, ch_max, static_cast<long long*>(best),
        static_cast<long long*>(first), static_cast<long long*>(last));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
