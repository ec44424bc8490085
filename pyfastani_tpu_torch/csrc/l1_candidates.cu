// L1 candidate intervals for NVIDIA Hopper (sm_90a).
//
// A hand kernel of the port, not the counterpart of a TPU kernel: the JAX
// package computes this stage as an XLA program,
// pyfastani_tpu/ops/l1.py::l1_candidates_device.  The plain torch version
// is pyfastani_tpu_torch/ops/l1.py::l1_candidates_reference.  For every
// fragment f of F, with sketch q[f, :S] (int64 hashes, ascending) of size
// s[f]:
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
// a fragment's n hits.  The plain torch version spends its time
// elsewhere: some 170 whole-array passes over the flat axis of int64
// slots, among them a sort of all T keys and two 1-D scans that torch
// runs on one block.
//
// What the design does about it:
//   * Two kernels and one torch.cumsum between them.  The probe kernel
//     (one block a fragment, one thread a sketch slot) writes each probe's
//     row start and length and the fragment's hit count; the cumsum of
//     the F counts places the fragments on the flat axis.
//   * The intervals kernel gives each fragment one block and keeps its
//     hits in shared memory: the gather (a block scan of the probe
//     lengths, 256 probes a tile, then each hit slot finds its probe by a
//     binary search over the tile's ends), the sort and the merge never
//     write an intermediate to device memory.  A fragment costs its
//     postings in and its ivmax intervals out.
//   * The sort is a bitonic network whose every comparator puts the
//     smaller value first, so the virtual padding to a power of two past
//     n never moves and needs no room.
//   * The merge is one pass over the sorted hits, 256 a tile: each
//     candidate's predecessor comes from warp ballots, one summary a warp
//     and a carry between tiles; an interval's end is written by the
//     candidate that opens the next one (or, for the last, after the
//     pass), so each output is written once, with no atomics.
//   * The shared buffer holds twice the average hits of a fragment
//     (2 * hmax slots, at least 4096, at most the card's opt-in shared
//     memory).  A fragment with more hits runs the same code on its own
//     slot range of a (T,) global scratch buffer that the wrapper
//     allocates: every shape is served.
//   * Both flags are plain stores of 1 into ints the caller zeroed: no
//     host sync.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr long long kGbig = (1LL << 31) - (1LL << 20);  // the global-position pad
constexpr long long kMinSlots = 4096;  // shared hit slots a block, at least

__device__ __forceinline__ long long clamp64(long long x, long long lo, long long hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

__global__ void __launch_bounds__(kThreads)
l1_probe_kernel(const long long* __restrict__ q, long long q_stride,
                const int* __restrict__ s_sizes, int S,
                const uint32_t* __restrict__ uniq, const int* __restrict__ row_start,
                const int* __restrict__ row_len, long long U, const int* __restrict__ bucket,
                int bits, int steps, long long thr, int* __restrict__ probe_len,
                int* __restrict__ probe_start, long long* __restrict__ counts) {
    __shared__ long long warp_sum[kWarps];
    const int f = blockIdx.x, tid = threadIdx.x;
    const int s_f = s_sizes[f];
    const long long base = static_cast<long long>(f) * S;
    long long total = 0;
    for (int i = tid; i < S; i += kThreads) {
        int len = 0, start = 0;
        if (i < s_f && U > 0) {
            const long long h = q[f * q_stride + i];
            const long long b = h >> (32 - bits);
            long long lo = bucket[b], hi = bucket[b + 1];
            for (int st = 0; st < steps && lo < hi; ++st) {
                const long long mid = (lo + hi) >> 1;  // floor, as the plain version's //
                const long long mc = clamp64(mid, 0, U - 1);
                if (static_cast<long long>(uniq[mc]) < h) {
                    lo = mid + 1;
                } else {
                    hi = mid;
                }
            }
            const long long r = clamp64(lo, 0, U - 1);
            if (lo < U && static_cast<long long>(uniq[r]) == h && row_len[r] < thr) {
                len = row_len[r];
                start = row_start[r];
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
        for (int w = 0; w < kWarps; ++w) t += warp_sum[w];
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

// One block a fragment; I indexes inside a fragment (int while T < 2^30).
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
    __shared__ long long tile_end[kThreads];    // inclusive end of each probe of a tile
    __shared__ long long tile_delta[kThreads];  // its row start less its first slot
    __shared__ long long warp_tot[kWarps];
    __shared__ int w_has[2][kWarps], w_last[2][kWarps], w_count[2][kWarps];
    const int f = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const unsigned lt = (1u << lane) - 1u;

    if (f == 0 && tid == 0 && ends[F - 1] > T) flags[0] = 1;
    const long long start = ends[f] - counts[f];
    const long long n64 = start >= T ? 0 : (counts[f] < T - start ? counts[f] : T - start);
    const I n = static_cast<I>(n64);
    int* hits = n64 <= cap ? smem : scratch + start;
    const int s_f = s_sizes[f];
    const int m_raw = min_hits[clamp64(s_f, 0, S < table_len - 1 ? S : table_len - 1)];
    const int m = m_raw > 1 ? m_raw : 1;

    // 1. gather: the fragment's postings in probe order, cut at n
    const long long pbase = static_cast<long long>(f) * S;
    long long carry = 0;
    for (int p0 = 0; p0 < S && carry < n64; p0 += kThreads) {
        const int p = p0 + tid;
        const long long len = p < S ? probe_len[pbase + p] : 0;
        const long long rs = p < S ? probe_start[pbase + p] : 0;
        long long x = len;
        for (int o = 1; o < 32; o <<= 1) {
            const long long y = __shfl_up_sync(kFull, x, o);
            if (lane >= o) x += y;
        }
        if (lane == 31) warp_tot[warp] = x;
        __syncthreads();
        long long before = carry, tile_total = 0;
        for (int w = 0; w < kWarps; ++w) {
            if (w < warp) before += warp_tot[w];
            tile_total += warp_tot[w];
        }
        const long long end = before + x;
        tile_end[tid] = end;
        tile_delta[tid] = rs - (end - len);
        __syncthreads();
        const long long hi = carry + tile_total < n64 ? carry + tile_total : n64;
        for (long long sl = carry + tid; sl < hi; sl += kThreads) {
            int a = 0, b = kThreads - 1;  // the first probe whose end passes the slot
            while (a < b) {
                const int mid = (a + b) >> 1;
                if (tile_end[mid] > sl) {
                    b = mid;
                } else {
                    a = mid + 1;
                }
            }
            const long long src = tile_delta[a] + sl;
            hits[sl] = M > 0 ? post_gpos[clamp64(src, 0, M - 1)]
                             : static_cast<int>(kGbig);
        }
        carry += tile_total;
        __syncthreads();  // the next tile rewrites the tile's arrays
    }

    // 2. sort the fragment's hits
    if (n > 1) sort_ascending<I>(hits, n, tid);

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
    l1_probe_kernel<<<F, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(q), q_stride, static_cast<const int*>(s_sizes), S,
        static_cast<const uint32_t*>(uniq_hash), static_cast<const int*>(row_start),
        static_cast<const int*>(row_len), U, static_cast<const int*>(hash_bucket), bits, steps,
        thr, static_cast<int*>(probe_len), static_cast<int*>(probe_start),
        static_cast<long long*>(counts));
    return static_cast<int>(cudaGetLastError());
}

// Hit slots of the intervals kernel's shared buffer on `device` at budget
// `hmax`: 2 * hmax rounded up to 1024, at least kMinSlots, at most what
// the opt-in shared memory holds beside the kernel's static arrays.
// Negative on a CUDA error.
long long l1_intervals_capacity(int device, long long hmax) {
    int optin = 0;
    if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
        cudaSuccess)
        return -1;
    cudaFuncAttributes attr;
    if (cudaFuncGetAttributes(&attr, l1_intervals_kernel<long long>) != cudaSuccess) return -1;
    const long long most = (optin - static_cast<long long>(attr.sharedSizeBytes)) / 4;
    const long long want = std::max(kMinSlots, (2 * hmax + 1023) / 1024 * 1024);
    return std::min(want, most);
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
    if (cap < 1 || table_len < 1) return static_cast<int>(cudaErrorInvalidValue);
    const size_t bytes = static_cast<size_t>(cap) * sizeof(int);
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
