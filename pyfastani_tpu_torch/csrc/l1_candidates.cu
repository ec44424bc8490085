// L1 candidate intervals for NVIDIA Hopper (sm_90a).
//
// A hand kernel of the port, not the counterpart of a TPU kernel: the JAX
// package computes this stage as an XLA program,
// pyfastani_tpu/ops/l1.py::l1_candidates_device (:106-305).  The plain
// torch version is pyfastani_tpu_torch/ops/l1.py::l1_candidates_reference.
// For every fragment f of F, with sketch q[f, :S] (int64 hashes,
// ascending) of size s[f]:
//   * probe i < min(s[f], S) finds its hash among the U sorted posting-row
//     hashes by a binary search of `steps` steps inside the hash-prefix
//     bucket [bucket[b], bucket[b + 1]), b = hash >> (32 - bits); a found
//     row shorter than the frequency threshold contributes its
//     row_len[r] postings, in order, to the fragment's hits;
//   * the fragments' hits fill one flat axis of T slots in fragment order
//     (fragment f owns [start_f, start_f + count_f), start_f the sum of
//     the earlier fragments' counts); the axis is cut at T, and
//     flags[0] = 1 when the total passes T;
//   * each fragment's hits h (global positions, int32) are sorted; with
//     m = max(min_hits[clamp(s[f], 0, min(S, table_len - 1))], 1), slot
//     j is a candidate when j + m - 1 < n, h[j] < GBIG and
//     h[j + m - 1] - h[j] < l, covering [h[j + m - 1] - l + 1, h[j]];
//   * a candidate opens an interval when it is the fragment's first or
//     its start passes the previous candidate's end; interval i's bounds
//     are the start of its first candidate and the end of its last.  The
//     first ivmax intervals are written with valid = 1, the other columns
//     with 0 and valid = 0, and flags[1] = 1 when a fragment has more
//     than ivmax.
//
// What bounds it on the card: bytes, at the all-vs-all's shapes: each
// probe's sketch hash (8 bytes) and its search's few 4-byte reads, each
// hit's posting (4 bytes), against some log2(n) operations a hit to sort
// a fragment's n hits.  Those reads are scattered over an index of ~1.4
// GB, far past the 50 MB L2: each 4-byte read costs a 32-byte sector (a
// 64-byte burst of the HBM), so the sectors, not the bytes, set the
// floor that a design can reach (tools/kernel_compare.py prints both).
// The first design spent 0.16 ms of the all-vs-all's 0.34 ms on the probe
// (a binary search of ~6 dependent reads in a bucket of ~49 hashes: the
// minimizers' hashes crowd the low buckets) and 0.17 ms on the intervals
// (a 55-66-stage bitonic sort in shared memory, a barrier each).
//
// What this design does about it:
//   * The probe (one block a fragment, one thread a sketch slot) reads
//     its bucket's bounds, guesses the hash's place by interpolation (a
//     bucket covers 2^(32 - bits) hash values, which its hashes fill
//     nearly evenly), and reads the 16 row hashes around the guess as four
//     independent 16-byte loads: one round trip to two or three
//     neighbouring sectors in place of ~6 dependent ones.  When the
//     window does not bracket the hash, a binary search finishes in the
//     part of the bucket it names; a bucket deeper than `steps` allows
//     takes the plain version's `steps`-step search, so that every input
//     gives the plain version's row.  The row's length and start load
//     together.
//   * The probe still writes each probe's row start and length, (F, S)
//     int32 each (12.6 MB at F 4096, S 384: about 8 us of the card's
//     memory rate, written and read once), and each fragment's count;
//     one torch.cumsum of the F counts places the fragments on the flat
//     axis.  A single pass with a decoupled look-back would save that
//     traffic and the cumsum (~3.5 us) at the cost of spinning blocks;
//     the sort was the larger cost.
//   * The intervals kernel (one block a fragment) scans the probe lengths
//     into shared memory once (cub::BlockScan, CUB's block-level scan),
//     then gathers each hit slot straight into registers, 1 to 8
//     consecutive slots a thread (one search over the probe ends, then a
//     step forward), with their postings' loads in flight together.
//   * A fragment of at most 2048 hits sorts in registers and shared
//     memory with cub::BlockMergeSort (CUB's block-level merge sort: each
//     thread sorts its keys, then log2(256) merge rounds), instead of the
//     55-66 barrier stages of a bitonic network.  A fragment with more
//     hits keeps the bitonic network in shared memory, or, past the
//     block's shared slots, in its own range of a (T,) global scratch
//     buffer that the wrapper allocates: every shape is served.
//   * The merge is one pass over the sorted hits, 256 a tile: each
//     candidate's predecessor comes from warp ballots, one summary a warp
//     and a carry between tiles; an interval's end is written by the
//     candidate that opens the next one (or, for the last, after the
//     pass), so each output is written once, with no atomics.
//   * Both flags are plain stores of 1 into ints the caller zeroed: no
//     host sync.

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cub/block/block_merge_sort.cuh>
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kProbeThreads = 512;  // a probe block: one thread a sketch slot, up to this many
constexpr int kWin = 16;            // row hashes read around the interpolated place
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kGbig = (1LL << 31) - (1LL << 20);  // the global-position pad
constexpr long long kMinSlots = 4096;  // shared hit slots a block, at least
constexpr int kSortSlots = 2048;       // hits the register merge sort takes, at most

__device__ __forceinline__ long long clamp64(long long x, long long lo, long long hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

// The first index in [lo, hi) whose row hash is not below h, or hi.
__device__ __forceinline__ long long lower_bound(const uint32_t* __restrict__ uniq, long long lo,
                                                 long long hi, uint32_t h) {
    while (lo < hi) {
        const long long mid = (lo + hi) >> 1;
        if (uniq[mid] < h) {
            lo = mid + 1;
        } else {
            hi = mid;
        }
    }
    return lo;
}

// The row of hash h (h < 2^32) as the plain version's search finds it:
// the lower bound of h in its bucket [lo, hi), or, for a bucket that
// `steps` halvings do not exhaust, where those `steps` halvings stop.
__device__ __forceinline__ long long find_row(const uint32_t* __restrict__ uniq, long long U,
                                              long long lo, long long hi, uint32_t h, int bits,
                                              int steps, bool vec) {
    if (lo >= hi) return lo;
    if (steps < 62 && ((hi - lo) >> steps) != 0) {  // the plain version's steps, as it takes them
        for (int st = 0; st < steps && lo < hi; ++st) {
            const long long mid = (lo + hi) >> 1;
            if (uniq[clamp64(mid, 0, U - 1)] < h) {
                lo = mid + 1;
            } else {
                hi = mid;
            }
        }
        return lo;
    }
    // the interpolated place of h among the bucket's hashes, and a window
    // of kWin entries from the 4-aligned index a few entries before it
    // (bucket bounds are int32: 32-bit indices from here on)
    const int sb = 32 - bits;
    const int ilo = static_cast<int>(lo), ihi = static_cast<int>(hi);
    const unsigned long long within = static_cast<unsigned long long>(h) & ((1ull << sb) - 1ull);
    const int g = ilo + static_cast<int>((within * static_cast<unsigned>(ihi - ilo)) >> sb);
    const int ws = max(ilo, min(g - 6, ihi - kWin));
    const int wa = max(ws, 0) & ~3;
    const int a = max(wa, ilo), e = min(wa + kWin, ihi);
    uint32_t x[kWin];
    if (vec) {
#pragma unroll
        for (int v = 0; v < kWin / 4; ++v) {
            uint4 four = make_uint4(0, 0, 0, 0);
            if (wa + 4 * v < e) four = *reinterpret_cast<const uint4*>(uniq + wa + 4 * v);
            x[4 * v] = four.x;
            x[4 * v + 1] = four.y;
            x[4 * v + 2] = four.z;
            x[4 * v + 3] = four.w;
        }
    } else {
#pragma unroll
        for (int j = 0; j < kWin; ++j) x[j] = wa + j < e && wa + j >= lo ? uniq[wa + j] : 0u;
    }
    int below = 0;
    uint32_t first = 0, last = 0;
#pragma unroll
    for (int j = 0; j < kWin; ++j) {
        const int i = wa + j;
        if (i >= a && i < e) {
            below += x[j] < h;
            if (i == a) first = x[j];
            last = x[j];
        }
    }
    if (a > lo && first >= h) return lower_bound(uniq, lo, a, h);
    if (e < hi && last < h) return lower_bound(uniq, e, hi, h);
    return a + below;
}

__global__ void __launch_bounds__(kProbeThreads)
l1_probe_kernel(const long long* __restrict__ q, long long q_stride,
                const int* __restrict__ s_sizes, int S,
                const uint32_t* __restrict__ uniq, const int* __restrict__ row_start,
                const int* __restrict__ row_len, long long U, const int* __restrict__ bucket,
                int bits, int steps, long long thr, int* __restrict__ probe_len,
                int* __restrict__ probe_start, long long* __restrict__ counts) {
    __shared__ long long warp_sum[kProbeThreads / 32];
    const int f = blockIdx.x, tid = threadIdx.x;
    const int s_f = s_sizes[f];
    const long long base = static_cast<long long>(f) * S;
    const bool vec = (reinterpret_cast<uintptr_t>(uniq) & 15) == 0;
    long long total = 0;
    for (int i = tid; i < S; i += blockDim.x) {
        int len = 0, start = 0;
        if (i < s_f && U > 0) {
            const long long h = q[f * q_stride + i];
            const long long b = h >> (32 - bits);
            const long long r = find_row(uniq, U, bucket[b], bucket[b + 1],
                                         static_cast<uint32_t>(h), bits, steps, vec);
            const long long rc = clamp64(r, 0, U - 1);
            if (r < U && static_cast<long long>(uniq[rc]) == h) {
                const int rl = row_len[rc], rs = row_start[rc];
                if (rl < thr) {
                    len = rl;
                    start = rs;
                }
            }
        }
        probe_len[base + i] = len;
        probe_start[base + i] = start;
        total += len;
    }
    for (int o = 16; o > 0; o >>= 1) total += __shfl_down_sync(kFull, total, o);
    if ((tid & 31) == 0) warp_sum[tid >> 5] = total;
    __syncthreads();
    if (tid == 0) {
        long long t = 0;
        for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) t += warp_sum[w];
        counts[f] = t;
    }
}

// Sorts v[0, n) ascending by the whole block.  Every comparator (i < j)
// puts the smaller value at i, so slots past n act as +infinity that no
// comparator moves, and the ones that would touch them are skipped.
template <typename I>
__device__ __forceinline__ void sort_ascending(int* v, I n, int tid) {
    I n2 = 1;
    while (n2 < n) n2 <<= 1;
    for (I span = 2; span <= n2; span <<= 1) {
        const I half = span >> 1;
        for (I t = tid; t < n2 / 2; t += kThreads) {  // mirror pairs inside each span
            const I off = t & (half - 1);
            const I i = 2 * t - off;
            const I j = i + span - 1 - 2 * off;
            if (j < n) {
                const int a = v[i], b = v[j];
                if (a > b) {
                    v[i] = b;
                    v[j] = a;
                }
            }
        }
        __syncthreads();
        for (I stride = half >> 1; stride > 0; stride >>= 1) {
            for (I t = tid; t < n2 / 2; t += kThreads) {
                const I i = 2 * t - (t & (stride - 1));
                const I j = i + stride;
                if (j < n) {
                    const int a = v[i], b = v[j];
                    if (a > b) {
                        v[i] = b;
                        v[j] = a;
                    }
                }
            }
            __syncthreads();
        }
    }
}

// The probe that owns hit slot sl: the first of the S probes whose
// inclusive end passes sl, searched from probe p.
__device__ __forceinline__ int owner(const long long* pend, int S, int p, long long sl) {
    int b = S - 1;
    while (p < b) {
        const int mid = (p + b) >> 1;
        if (pend[mid] > sl) {
            b = mid;
        } else {
            p = mid + 1;
        }
    }
    return p;
}

// The posting of hit slot sl (the pad when the index holds none).
__device__ __forceinline__ int posting(const int* __restrict__ post_gpos, long long M,
                                       const long long* pdelta, int p, long long sl) {
    return M > 0 ? post_gpos[clamp64(pdelta[p] + sl, 0, M - 1)] : static_cast<int>(kGbig);
}

struct Less {
    __device__ bool operator()(int a, int b) const { return a < b; }
};

// Gathers the fragment's n <= 256 * kItems hits into registers, kItems
// consecutive slots a thread, sorts them with cub::BlockMergeSort and
// stores them to hits[0, n).
template <int kItems, typename Temp>
__device__ __forceinline__ void gather_sort_registers(
    const int* __restrict__ post_gpos, long long M, const long long* pend,
    const long long* pdelta, int S, int n, int* hits, Temp& temp) {
    const int tid = threadIdx.x;
    int keys[kItems];
    const long long s0 = static_cast<long long>(tid) * kItems;
    int p = s0 < n ? owner(pend, S, 0, s0) : 0;
#pragma unroll
    for (int j = 0; j < kItems; ++j) {
        const long long sl = s0 + j;
        keys[j] = INT_MAX;
        if (sl < n) {
            while (pend[p] <= sl) ++p;
            keys[j] = posting(post_gpos, M, pdelta, p, sl);
        }
    }
    cub::BlockMergeSort<int, kThreads, kItems>(temp).Sort(keys, Less());
#pragma unroll
    for (int j = 0; j < kItems; ++j)
        if (s0 + j < n) hits[s0 + j] = keys[j];
    __syncthreads();
}

// One block a fragment; I indexes inside a fragment (int while T < 2^30).
// Dynamic shared memory: `cap` hit slots, then the S probe ends and
// deltas (8 bytes each).
template <typename I>
__global__ void __launch_bounds__(kThreads)
l1_intervals_kernel(const int* __restrict__ probe_len, const int* __restrict__ probe_start,
                    const long long* __restrict__ counts, const long long* __restrict__ ends,
                    int F, int S, const int* __restrict__ s_sizes,
                    const int* __restrict__ min_hits, int table_len,
                    const int* __restrict__ post_gpos, long long M, long long T, int ivmax,
                    int l, long long cap, int* __restrict__ iv_g0, int* __restrict__ iv_g1,
                    bool* __restrict__ iv_valid, int* __restrict__ flags, int* scratch) {
    extern __shared__ __align__(16) int smem[];
    using Scan = cub::BlockScan<long long, kThreads>;
    __shared__ union {
        typename Scan::TempStorage scan;
        typename cub::BlockMergeSort<int, kThreads, 1>::TempStorage sort1;
        typename cub::BlockMergeSort<int, kThreads, 2>::TempStorage sort2;
        typename cub::BlockMergeSort<int, kThreads, 4>::TempStorage sort4;
        typename cub::BlockMergeSort<int, kThreads, 8>::TempStorage sort8;
    } temp;
    __shared__ int w_has[2][kWarps], w_last[2][kWarps], w_count[2][kWarps];
    const int f = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const unsigned lt = (1u << lane) - 1u;
    long long* pend = reinterpret_cast<long long*>(smem + ((cap + 1) & ~1LL));
    long long* pdelta = pend + S;

    if (f == 0 && tid == 0 && ends[F - 1] > T) flags[0] = 1;
    const long long start = ends[f] - counts[f];
    const long long n64 = start >= T ? 0 : (counts[f] < T - start ? counts[f] : T - start);
    const I n = static_cast<I>(n64);
    const int s_f = s_sizes[f];
    const int m_raw = min_hits[clamp64(s_f, 0, S < table_len - 1 ? S : table_len - 1)];
    const int m = m_raw > 1 ? m_raw : 1;

    // 1. each probe's inclusive end on the fragment's slots, and its row
    //    start less its first slot
    const long long pbase = static_cast<long long>(f) * S;
    long long carry = 0;
    for (int p0 = 0; p0 < S; p0 += kThreads) {
        const int p = p0 + tid;
        const long long len = p < S ? probe_len[pbase + p] : 0;
        long long incl, tile;
        Scan(temp.scan).InclusiveSum(len, incl, tile);
        if (p < S) {
            pend[p] = carry + incl;
            pdelta[p] = probe_start[pbase + p] - (carry + incl - len);
        }
        carry += tile;
        __syncthreads();  // the next tile reuses the scan's storage
    }

    // 2. the hits, sorted: in registers up to kSortSlots, else gathered
    //    into shared memory (or the scratch range) and sorted there
    int* hits = n64 <= cap ? smem : scratch + start;
    if (n64 <= kThreads) {  // the merge sort's cost follows its capacity
        gather_sort_registers<1>(post_gpos, M, pend, pdelta, S, static_cast<int>(n), hits,
                                 temp.sort1);
    } else if (n64 <= kThreads * 2) {
        gather_sort_registers<2>(post_gpos, M, pend, pdelta, S, static_cast<int>(n), hits,
                                 temp.sort2);
    } else if (n64 <= kThreads * 4) {
        gather_sort_registers<4>(post_gpos, M, pend, pdelta, S, static_cast<int>(n), hits,
                                 temp.sort4);
    } else if (n64 <= kSortSlots) {
        gather_sort_registers<8>(post_gpos, M, pend, pdelta, S, static_cast<int>(n), hits,
                                 temp.sort8);
    } else {
        int p = 0;
        for (I sl = tid; sl < n; sl += kThreads) {
            p = owner(pend, S, 0, sl);
            hits[sl] = posting(post_gpos, M, pdelta, p, sl);
        }
        __syncthreads();
        sort_ascending<I>(hits, n, tid);
    }

    // 3. candidates and their merge, tile by tile
    const long long out = static_cast<long long>(f) * ivmax;
    bool c_has = false;  // carry: a candidate so far, the last one's end, intervals
    int c_last = 0;
    I c_count = 0;
    int par = 0;
    for (I t0 = 0; t0 < n; t0 += kThreads, par ^= 1) {
        const I j = t0 + tid;
        bool cand = false;
        int gend = 0;
        long long gstart = 0;
        if (j < n && static_cast<long long>(j) + m - 1 < n64) {
            const int a = hits[j];
            const int b = hits[j + (m - 1)];
            gend = a;
            gstart = static_cast<long long>(b) - l + 1;
            cand = a < kGbig && static_cast<long long>(b) - a < l;
        }
        const unsigned mc = __ballot_sync(kFull, cand);
        const unsigned below = mc & lt;
        const int prev_in_warp = __shfl_sync(kFull, gend, below ? 31 - __clz(below) : 0);
        const int warp_last = __shfl_sync(kFull, gend, mc ? 31 - __clz(mc) : 0);
        if (lane == 0) {
            w_has[par][warp] = mc != 0;
            w_last[par][warp] = warp_last;
        }
        __syncthreads();
        bool have = c_has;
        int prev = c_last;
        for (int w = 0; w < warp; ++w) {
            if (w_has[par][w]) {
                have = true;
                prev = w_last[par][w];
            }
        }
        if (below) {
            have = true;
            prev = prev_in_warp;
        }
        const bool boundary = cand && (!have || gstart > prev);
        const unsigned mb = __ballot_sync(kFull, boundary);
        if (lane == 0) w_count[par][warp] = __popc(mb);
        __syncthreads();
        I off = c_count;
        for (int w = 0; w < kWarps; ++w) {
            const int c = w_count[par][w];
            if (w < warp) off += c;
            c_count += c;
            if (w_has[par][w]) {
                c_has = true;
                c_last = w_last[par][w];
            }
        }
        if (boundary) {
            const I i = off + __popc(mb & lt);
            if (i < ivmax) iv_g0[out + i] = static_cast<int>(gstart);
            if (have && i - 1 < ivmax) iv_g1[out + i - 1] = prev;  // the previous interval ends
        }
    }

    // 4. the last interval's end, the flag and the other columns
    const I n_iv = c_count;
    if (tid == 0) {
        if (n_iv > 0 && n_iv - 1 < ivmax) iv_g1[out + n_iv - 1] = c_last;
        if (n_iv > ivmax) flags[1] = 1;
    }
    const long long nv = n_iv < ivmax ? n_iv : ivmax;
    for (int i = tid; i < ivmax; i += kThreads) {
        iv_valid[out + i] = i < nv;
        if (i >= nv) {
            iv_g0[out + i] = 0;
            iv_g1[out + i] = 0;
        }
    }
}

// Dynamic shared bytes of the intervals kernel at `cap` hit slots and S
// probes.
long long intervals_bytes(long long cap, int S) {
    return ((cap + 1) & ~1LL) * 4 + 16LL * S;
}

}  // namespace

extern "C" {

// Writes each probe's row length (0 when its hash is absent, past s[f] or
// at least `thr` long) and row start into probe_len / probe_start (F, S)
// int32, and each fragment's hit count into counts (F,) int64, on
// `stream`; q's rows are `q_stride` entries apart.  Returns
// cudaGetLastError().
int l1_probe_launch(const void* q, long long q_stride, const void* s_sizes, int F, int S,
                    const void* uniq_hash,
                    const void* row_start, const void* row_len, long long U,
                    const void* hash_bucket, int bits, int steps, long long thr, void* probe_len,
                    void* probe_start, void* counts, void* stream) {
    if (F <= 0) return 0;
    const int threads = std::min(kProbeThreads, std::max(32, (S + 31) / 32 * 32));
    l1_probe_kernel<<<F, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(q), q_stride, static_cast<const int*>(s_sizes), S,
        static_cast<const uint32_t*>(uniq_hash), static_cast<const int*>(row_start),
        static_cast<const int*>(row_len), U, static_cast<const int*>(hash_bucket), bits, steps,
        thr, static_cast<int*>(probe_len), static_cast<int*>(probe_start),
        static_cast<long long*>(counts));
    return static_cast<int>(cudaGetLastError());
}

// Hit slots of the intervals kernel's shared buffer on `device` at budget
// `hmax` for S probes a fragment: 2 * hmax rounded up to 1024, at least
// kMinSlots, at most what the opt-in shared memory holds beside the
// kernel's static arrays and the S probe ends and deltas; below 1 when
// even those do not fit.  Negative on a CUDA error.
long long l1_intervals_capacity(int device, long long hmax, int S) {
    int optin = 0;
    if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
        cudaSuccess)
        return -1;
    cudaFuncAttributes attr;
    if (cudaFuncGetAttributes(&attr, l1_intervals_kernel<long long>) != cudaSuccess) return -1;
    const long long most =
        (optin - static_cast<long long>(attr.sharedSizeBytes) - 16LL * S - 8) / 4;
    const long long want = std::max(kMinSlots, (2 * hmax + 1023) / 1024 * 1024);
    return std::max(0LL, std::min(want, most));
}

// The intervals of every fragment (see the top of the file) from the
// probe kernel's outputs and ends = cumsum(counts), on `stream`: iv_g0,
// iv_g1 (F, ivmax) int32, iv_valid (F, ivmax) bool, flags two ints the
// caller zeroed (hit overflow, interval overflow), scratch (T,) int32 for
// the fragments with more than `cap` hits (l1_intervals_capacity).
// Returns cudaGetLastError().
int l1_intervals_launch(const void* probe_len, const void* probe_start, const void* counts,
                        const void* ends, int F, int S, const void* s_sizes,
                        const void* min_hits_table, int table_len, const void* post_gpos,
                        long long M, long long T, int ivmax, int l, long long cap, void* iv_g0,
                        void* iv_g1, void* iv_valid, void* flags, void* scratch, void* stream) {
    if (F <= 0) return 0;
    if (cap < 1 || table_len < 1 || S < 0) return static_cast<int>(cudaErrorInvalidValue);
    const size_t bytes = static_cast<size_t>(intervals_bytes(cap, S));
    auto st = static_cast<cudaStream_t>(stream);
#define L1_INTERVALS_ARGS                                                                     \
    static_cast<const int*>(probe_len), static_cast<const int*>(probe_start),                 \
        static_cast<const long long*>(counts), static_cast<const long long*>(ends), F, S,     \
        static_cast<const int*>(s_sizes), static_cast<const int*>(min_hits_table), table_len, \
        static_cast<const int*>(post_gpos), M, T, ivmax, l, cap, static_cast<int*>(iv_g0),    \
        static_cast<int*>(iv_g1), static_cast<bool*>(iv_valid), static_cast<int*>(flags),     \
        static_cast<int*>(scratch)
    cudaError_t err;
    if (T < (1LL << 30)) {
        err = cudaFuncSetAttribute(l1_intervals_kernel<int>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(bytes));
        if (err != cudaSuccess) return static_cast<int>(err);
        l1_intervals_kernel<int><<<F, kThreads, bytes, st>>>(L1_INTERVALS_ARGS);
    } else {
        err = cudaFuncSetAttribute(l1_intervals_kernel<long long>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(bytes));
        if (err != cudaSuccess) return static_cast<int>(err);
        l1_intervals_kernel<long long><<<F, kThreads, bytes, st>>>(L1_INTERVALS_ARGS);
    }
#undef L1_INTERVALS_ARGS
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
