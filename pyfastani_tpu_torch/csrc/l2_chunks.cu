// L2 chunk evaluator for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pyfastani_tpu/ops/l2_pallas.py::_kernel
// (launched by _l2_pallas_impl).  Semantics are those of
// pyfastani_tpu/ops/l2.py::l2_event_curve; the plain torch version is
// pyfastani_tpu_torch/ops/l2.py::l2_chunks_reference.  Per chunk i:
//   * every range entry j in [lo, lo + rlen) whose hash is in fragment
//     frag[i]'s sorted sketch (first min(s, S) entries) carries the
//     presence interval [start_j, p_j], start_j = max(p_j - cmw + 1,
//     prev_j + 1);
//   * every anchor a (an entry with c0 <= p_a < c0 + clen) counts
//     #{in-sketch j : start_j <= p_a} - #{in-sketch j : p_j < p_a};
//   * the chunk writes best = the largest count and first / last = the
//     lowest / highest anchor position reaching it, or (-1, c0, c0) when
//     it has no anchor.
// A chunk whose range leaves [0, M) or whose fragment row is not in
// [0, F) reads nothing: it writes (-1, c0, c0) and sets *range_bad to 1,
// which the caller reads with the pass's other flags (no host sync here).
// Positions ascend inside a range (ranges are clamped to one contig).
//
// What bounds it on the card: bytes, by a little, at the query path's
// inputs.  A chunk reads its range once (three 4-byte planes, a few
// hundred entries) and tests each entry's hash against the fragment's
// sketch; the in-sketch entries then need a sort and each anchor a few
// searches: a handful of integer operations per entry against 12 bytes.
// In practice the kernel is bound by the latency of its chain of
// shared-memory steps and block barriers per chunk, so the design cuts
// the steps of that chain and keeps many chunks in flight.
//
// What the design does about it:
//   * No walk and almost no sort.  An in-sketch entry whose start is
//     p_j - cmw + 1 (class A: no same-hash occurrence within cmw before
//     it) has starts ascending with positions, so compacting class A in
//     range order sorts it; only class B (start = prev_j + 1) is sorted,
//     with a bitonic sort in shared memory, by one warp up to 256 of them.
//     Each anchor then counts with binary searches:
//       #{A: p_j in [p_a, p_a + cmw - 1]} + #{B: start_j <= p_a}
//       - #{B: p_j < p_a},
//     searching positions, not indices, so equal positions stay exact.
//   * Compaction is one ballot pass that counts A and B per (tile, warp),
//     one warp scan of the counts, and one pass that writes: three block
//     barriers for the whole range.  Class A lands in place, in the hash
//     plane that membership no longer needs.
//   * Sketch membership is one or two probes of an open-addressing hash
//     set in shared memory instead of a ~9-step binary search.  The set is
//     rebuilt only when the fragment changes; the session lays the chunks
//     of one fragment out contiguously, and a block walks kSpan
//     consecutive slots.
//   * Many blocks in flight hide the latency of that chain: 32 registers
//     a thread and one range buffer (~26 KB at rmax 896) keep eight
//     256-thread blocks, the SM's 2048 threads, resident.  Each chunk's
//     range planes, and its sketch row when the fragment changes, load
//     with cp.async.  Double-buffering the next chunk's loads was measured
//     and dropped: it gained nothing, and its shared memory cost three of
//     the eight blocks (PERF.md).
//   * Warp 0 loads the metadata of the block's kSpan slots, writes every
//     empty or refused slot's output at once and lists the live ones, so
//     the padding slots of the chunk budget cost their metadata.  kSpan is
//     small, because the session compacts live chunks to the front of the
//     budget: a long span would leave them to a few blocks.
//   * Blocks are 256 threads, or 512 above 2048 range entries.
//   * Above the card's opt-in shared memory (rmax past ~11k entries at
//     S = 384: a second rmax escalation), a variant of the same kernel,
//     l2_chunks_scratch_kernel, keeps the range planes, class B and the
//     sort area in a global scratch buffer that the wrapper allocates;
//     the hash set stays in shared memory, filled straight from the
//     sketch row in global memory.  A persistent grid of resident blocks
//     loops over the spans, each block owning one slice of the scratch,
//     and compacts tile by tile with a running offset, so a range has no
//     length limit.  It is rare and simple, not tuned (PERF.md times it
//     against the shared-memory kernel on the path's own ranges).
// The block reduction of (best, first, last) is integer max/min, so the
// result does not depend on the order in which threads finish.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSpan = 4;   // chunk slots per block
constexpr int kMaxTiles = 32;  // range entries per thread: one bit each in a mask
constexpr int kBig = 1 << 30;
constexpr int kIntMax = 0x7fffffff;
constexpr uint32_t kEmpty = 0xffffffffu;
constexpr int kWideRange = 2048;  // above this rmax, 512-thread blocks

struct Best {
    int best;
    int first;
    int last;
};

__device__ __forceinline__ Best merge(Best a, Best b) {
    if (b.best > a.best) return b;
    if (b.best < a.best) return a;
    return Best{a.best, min(a.first, b.first), max(a.last, b.last)};
}

__host__ __device__ __forceinline__ int pow2_at_least(int n) {
    int p = 1;
    while (p < n) p <<= 1;
    return p;
}

// hash-set slots for a sketch width S: a power of two, at least 2S
__host__ __device__ __forceinline__ int table_slots(int S) {
    return pow2_at_least(max(2 * S, 64));
}

// dynamic shared memory, in 4-byte words: the hash set; the three range
// planes and a sketch row; class B's positions and its sort area
__host__ __device__ __forceinline__ long long smem_words(int S, int rmax) {
    return static_cast<long long>(table_slots(S)) + 3LL * rmax + S + rmax +
           pow2_at_least(max(rmax, 1));
}

__device__ __forceinline__ uint32_t slot_of(uint32_t h, int log_slots) {
    return (h * 2654435761u) >> (32 - log_slots);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// #{v[0, n) <= x} and #{v[0, n) < x} of an ascending shared array
__device__ __forceinline__ int count_le(const int* v, int n, int x) {
    int a = 0, b = n;
    while (a < b) {
        const int mid = (a + b) >> 1;
        if (v[mid] <= x) a = mid + 1; else b = mid;
    }
    return a;
}

__device__ __forceinline__ int count_lt(const int* v, int n, int x) {
    int a = 0, b = n;
    while (a < b) {
        const int mid = (a + b) >> 1;
        if (v[mid] < x) a = mid + 1; else b = mid;
    }
    return a;
}

// ascending bitonic sort of v[0, P), P a power of two, by threads
// [0, nthreads) of the block; `sync` orders the passes
template <typename Sync>
__device__ __forceinline__ void bitonic(int* v, int P, int t, int nthreads, Sync sync) {
    for (int k = 2; k <= P; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
            for (int u = t; u < (P >> 1); u += nthreads) {
                const int i = 2 * u - (u & (j - 1));
                const int x = v[i], y = v[i + j];
                if ((x > y) == ((i & k) == 0)) {
                    v[i] = y;
                    v[i + j] = x;
                }
            }
            sync();
        }
    }
}

// exclusive prefix sum of v[0, n) in place by one warp; returns the total
__device__ __forceinline__ int warp_exclusive_scan(int* v, int n, int lane) {
    const int per = (n + 31) / 32;
    const int a = min(lane * per, n), b = min(a + per, n);
    int sum = 0;
    for (int t = a; t < b; ++t) sum += v[t];
    int incl = sum;
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
    }
    int run = incl - sum;
    for (int t = a; t < b; ++t) {
        const int c = v[t];
        v[t] = run;
        run += c;
    }
    return __shfl_sync(0xffffffffu, incl, 31);
}

// cp.async one chunk's range planes (hash, wpos, prev rows of stride
// rmax) into `buf`, and `s_eff` sketch words after them when `row` is
// given; one commit group per thread
__device__ __forceinline__ void load_chunk(int* buf, int rmax,
                                           const uint32_t* __restrict__ mini_hash,
                                           const int* __restrict__ mini_wpos,
                                           const int* __restrict__ mini_prev,
                                           int64_t base, int n, const uint32_t* row,
                                           int s_eff, int tid, int nthreads) {
    for (int j = tid; j < n; j += nthreads) {
        cp_async4(buf + j, mini_hash + base + j);
        cp_async4(buf + rmax + j, mini_wpos + base + j);
        cp_async4(buf + 2 * rmax + j, mini_prev + base + j);
    }
    if (row != nullptr) {
        for (int t = tid; t < s_eff; t += nthreads) cp_async4(buf + 3 * rmax + t, row + t);
    }
    cp_async_commit();
}

// metadata of the kSpan slots from i0, by warp 0: writes the output of
// every empty or refused slot at once and lists the live ones in order
__device__ __forceinline__ void span_metadata(
    int i0, int lane, const int* __restrict__ s_sizes, int S,
    const int* __restrict__ lo_arr, const int* __restrict__ rlen_arr,
    const int* __restrict__ frag_arr, const int* __restrict__ c0_arr,
    const int* __restrict__ clen_arr, int N, int rmax, int M, int F,
    int* __restrict__ best_out, int* __restrict__ first_out, int* __restrict__ last_out,
    int* __restrict__ range_bad, int* m_lo, int* m_n, int* m_frag, int* m_c0, int* m_clen,
    int* m_seff, int* live_slot, int* n_live) {
    const int i = i0 + lane;
    bool live = false;
    if (lane < kSpan && i < N) {
        const int c0 = c0_arr[i];
        const int clen = clen_arr[i];
        const int n = min(rlen_arr[i], rmax);
        const int f = frag_arr[i];
        const int64_t base = lo_arr[i];
        const bool bad = base < 0 || base + max(n, 0) > M || f < 0 || f >= F;
        live = !bad && n > 0 && clen > 0;
        m_lo[lane] = static_cast<int>(base);
        m_n[lane] = n;
        m_frag[lane] = f;
        m_c0[lane] = c0;
        m_clen[lane] = clen;
        m_seff[lane] = live ? max(min(s_sizes[f], S), 0) : 0;
        if (!live) {
            best_out[i] = -1;
            first_out[i] = c0;
            last_out[i] = c0;
            if (bad) *range_bad = 1;  // every writer stores the same value
        }
    }
    const unsigned mask = __ballot_sync(0xffffffffu, live);
    if (live) live_slot[__popc(mask & ((1u << lane) - 1u))] = lane;
    if (lane == 0) *n_live = __popc(mask);
}

// the hash set of a sketch row: open addressing over T = 2^log_t slots;
// a key equal to the empty marker raises a flag instead
__device__ __forceinline__ void set_insert(uint32_t* table, int log_t, int T, uint32_t h,
                                           int* has_umax) {
    if (h == kEmpty) {
        *has_umax = 1;
        return;
    }
    uint32_t at = slot_of(h, log_t);
    while (true) {
        const uint32_t old = atomicCAS(table + at, kEmpty, h);
        if (old == kEmpty || old == h) return;
        at = (at + 1) & (T - 1);
    }
}

__device__ __forceinline__ bool set_contains(const uint32_t* table, int log_t, int T,
                                             uint32_t h, int has_umax) {
    if (h == kEmpty) return has_umax != 0;
    uint32_t at = slot_of(h, log_t);
    while (true) {
        const uint32_t e = table[at];
        if (e == h) return true;
        if (e == kEmpty) return false;
        at = (at + 1) & (T - 1);
    }
}

// one chunk's (best, first, last) from its compacted entries: each anchor
// in [c0, c_end) counts #{A: p_j in [p_a, p_a + cmw - 1]} +
// #{B: start_j <= p_a} - #{B: p_j < p_a}; reduced over the block into
// the output of chunk i by thread 0.  Ends with a barrier after which no
// thread reads the range buffer.
template <int kThreads>
__device__ __forceinline__ void score_anchors(const int* bp, int n, int c0, int64_t c_end,
                                              int cmw, const int* a_pos, int n_a,
                                              const int* b_pos, const int* b_st, int n_b,
                                              int tid, int lane, int warp, Best* warp_best,
                                              int i, int* __restrict__ best_out,
                                              int* __restrict__ first_out,
                                              int* __restrict__ last_out) {
    constexpr int kWarps = kThreads / 32;
    Best mine{-1, kBig, -kBig};
    for (int j = tid; j < n; j += kThreads) {
        const int pa = bp[j];
        if (pa < c0 || pa >= c_end) continue;
        const int reach = static_cast<int>(
            min(static_cast<int64_t>(pa) + (cmw - 1), static_cast<int64_t>(kIntMax)));
        const int count = count_le(a_pos, n_a, reach) - count_lt(a_pos, n_a, pa) +
                          count_le(b_st, n_b, pa) - count_lt(b_pos, n_b, pa);
        mine = merge(mine, Best{count, pa, pa});
    }
    for (int o = 16; o > 0; o >>= 1) {
        Best other{__shfl_down_sync(0xffffffffu, mine.best, o),
                   __shfl_down_sync(0xffffffffu, mine.first, o),
                   __shfl_down_sync(0xffffffffu, mine.last, o)};
        mine = merge(mine, other);
    }
    if (lane == 0) warp_best[warp] = mine;
    __syncthreads();  // also: every read of the range buffer is done
    if (tid == 0) {
        Best all = warp_best[0];
        for (int w = 1; w < kWarps; ++w) all = merge(all, warp_best[w]);
        const bool none = all.best < 0;
        best_out[i] = all.best;
        first_out[i] = none ? c0 : all.first;
        last_out[i] = none ? c0 : all.last;
    }
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads, kThreads <= 256 ? 8 : 2)
l2_chunks_kernel(const uint32_t* __restrict__ q, const int* __restrict__ s_sizes,
                 int S, const uint32_t* __restrict__ mini_hash,
                 const int* __restrict__ mini_wpos,
                 const int* __restrict__ mini_prev,
                 const int* __restrict__ lo_arr, const int* __restrict__ rlen_arr,
                 const int* __restrict__ frag_arr, const int* __restrict__ c0_arr,
                 const int* __restrict__ clen_arr, int N, int cmw, int rmax, int M,
                 int F, int* __restrict__ best_out,
                 int* __restrict__ first_out, int* __restrict__ last_out,
                 int* __restrict__ range_bad) {
    constexpr int kWarps = kThreads / 32;
    extern __shared__ int smem[];
    __shared__ int m_lo[kSpan], m_n[kSpan], m_frag[kSpan], m_c0[kSpan], m_clen[kSpan];
    __shared__ int m_seff[kSpan], live_slot[kSpan];
    __shared__ int n_live;
    __shared__ int counts[2][kMaxTiles * kWarps];  // class A, B per (tile, warp)
    __shared__ int totals[2];
    __shared__ Best warp_best[kWarps];
    __shared__ int has_umax;

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int i0 = blockIdx.x * kSpan;

    if (warp == 0) {
        span_metadata(i0, lane, s_sizes, S, lo_arr, rlen_arr, frag_arr, c0_arr, clen_arr, N,
                      rmax, M, F, best_out, first_out, last_out, range_bad, m_lo, m_n, m_frag,
                      m_c0, m_clen, m_seff, live_slot, &n_live);
    }
    __syncthreads();
    const int L = n_live;
    if (L == 0) return;

    const int T = table_slots(S);
    int log_t = 0;
    while ((1 << log_t) < T) ++log_t;
    uint32_t* table = reinterpret_cast<uint32_t*>(smem);
    int* buf = smem + T;            // hash, wpos, prev planes, sketch row
    int* b_pos = buf + 3 * rmax + S;  // class B positions, ascending
    int* b_st = b_pos + rmax;         // class B starts, then sorted

    // empty the hash set; the barrier that follows orders it before the
    // inserts of the next rebuild
    const auto clear_table = [&]() {
        for (int t = tid; t < T; t += kThreads) table[t] = kEmpty;
        if (tid == 0) has_umax = 0;
    };
    // start chunk k's loads, with its sketch row when its fragment
    // differs from chunk k - 1's
    const auto stage = [&](int k) {
        const int slot = live_slot[k];
        const int f = m_frag[slot];
        const bool new_row = k == 0 || f != m_frag[live_slot[k - 1]];
        load_chunk(buf, rmax, mini_hash, mini_wpos, mini_prev, m_lo[slot], m_n[slot],
                   new_row ? q + static_cast<int64_t>(f) * S : nullptr, m_seff[slot], tid,
                   kThreads);
    };

    int cur_frag = -1;
    clear_table();
    stage(0);
    for (int k = 0; k < L; ++k) {
        cp_async_wait_all();
        const int slot = live_slot[k];
        const int i = i0 + slot;
        const int n = m_n[slot];
        const int f = m_frag[slot];
        const int c0 = m_c0[slot];
        const int64_t c_end = static_cast<int64_t>(c0) + m_clen[slot];
        __syncthreads();  // chunk k's loads have landed

        // the fragment's sketch as a hash set, rebuilt when the fragment
        // changes (the set was emptied during the chunk before); a key equal
        // to the empty marker is a flag instead
        if (f != cur_frag) {
            const uint32_t* row = reinterpret_cast<const uint32_t*>(buf + 3 * rmax);
            for (int t = tid; t < m_seff[slot]; t += kThreads)
                set_insert(table, log_t, T, row[t], &has_umax);
            cur_frag = f;
            __syncthreads();
        }

        const uint32_t* bh = reinterpret_cast<const uint32_t*>(buf);
        const int* bp = buf + rmax;
        const int* bv = buf + 2 * rmax;
        int* a_pos = buf;  // class A positions, in place over the hashes

        // pass 1: membership and class, counted per (tile, warp)
        const int tiles = (n + kThreads - 1) / kThreads;
        uint32_t in_bits = 0, b_bits = 0;
        for (int t = 0; t < tiles; ++t) {
            const int j = t * kThreads + tid;
            bool in = false, cls_b = false;
            if (j < n) {
                in = set_contains(table, log_t, T, bh[j], has_umax);
                cls_b = in && static_cast<int64_t>(bv[j]) + 1 >
                                  static_cast<int64_t>(bp[j]) - (cmw - 1);
            }
            const unsigned ua = __ballot_sync(0xffffffffu, in && !cls_b);
            const unsigned ub = __ballot_sync(0xffffffffu, cls_b);
            if (lane == 0) {
                counts[0][t * kWarps + warp] = __popc(ua);
                counts[1][t * kWarps + warp] = __popc(ub);
            }
            in_bits |= static_cast<uint32_t>(in) << t;
            b_bits |= static_cast<uint32_t>(cls_b) << t;
        }
        __syncthreads();
        // the set is read no more for this chunk: empty it now when the
        // next chunk rebuilds it
        if (k + 1 < L && m_frag[live_slot[k + 1]] != f) clear_table();

        // exclusive prefix of the counts, by warp 0 in place
        const int cells = tiles * kWarps;
        if (warp == 0) {
            const int na = warp_exclusive_scan(counts[0], cells, lane);
            const int nb = warp_exclusive_scan(counts[1], cells, lane);
            if (lane == 0) {
                totals[0] = na;
                totals[1] = nb;
            }
        }
        __syncthreads();
        const int n_a = totals[0];
        const int n_b = totals[1];

        // pass 2: write class A in place, class B beside it
        const unsigned lt = (1u << lane) - 1u;
        for (int t = 0; t < tiles; ++t) {
            const int j = t * kThreads + tid;
            const int cell = t * kWarps + warp;
            const bool in = (in_bits >> t) & 1u, cls_b = (b_bits >> t) & 1u;
            const unsigned ua = __ballot_sync(0xffffffffu, in && !cls_b);
            const unsigned ub = __ballot_sync(0xffffffffu, cls_b);
            if (in && !cls_b) {
                a_pos[counts[0][cell] + __popc(ua & lt)] = bp[j];
            } else if (cls_b) {
                const int off = counts[1][cell] + __popc(ub & lt);
                b_pos[off] = bp[j];
                b_st[off] = bv[j] + 1;
            }
        }
        const int P = pow2_at_least(n_b);
        for (int t = n_b + tid; t < P; t += kThreads) b_st[t] = kIntMax;
        __syncthreads();

        // sort class B's starts
        if (P > 1) {
            if (P <= 256) {
                if (warp == 0) bitonic(b_st, P, lane, 32, []() { __syncwarp(); });
            } else {
                bitonic(b_st, P, tid, kThreads, []() { __syncthreads(); });
            }
            __syncthreads();
        }

        // each anchor: binary searches; the barrier at their end frees the
        // range buffer for the next chunk's loads
        score_anchors<kThreads>(bp, n, c0, c_end, cmw, a_pos, n_a, b_pos, b_st, n_b, tid, lane,
                                warp, warp_best, i, best_out, first_out, last_out);
        if (k + 1 < L) stage(k + 1);
    }
}

// The variant for ranges past the shared memory: a chunk's range planes,
// class B's positions and the sort area live in this block's slice of a
// global scratch buffer (scratch_words_per_block words); the hash set, the
// only dynamic shared memory, is filled from the sketch row in global
// memory.  A persistent grid: each resident
// block loops over the spans of kSpan slots.  Compaction goes tile by
// tile with a running offset, so a range may be of any length.  Global
// writes of one thread reach the others of its block at a barrier.
constexpr int kScratchThreads = 512;

__host__ __device__ __forceinline__ long long scratch_words_per_block(int rmax) {
    return 4LL * rmax + pow2_at_least(max(rmax, 1));
}

// the scratch variant's dynamic shared memory: the hash set
__host__ __device__ __forceinline__ int scratch_smem_bytes(int S) {
    return 4 * table_slots(S);
}

__global__ void __launch_bounds__(kScratchThreads, 2)
l2_chunks_scratch_kernel(const uint32_t* __restrict__ q, const int* __restrict__ s_sizes,
                         int S, const uint32_t* __restrict__ mini_hash,
                         const int* __restrict__ mini_wpos,
                         const int* __restrict__ mini_prev,
                         const int* __restrict__ lo_arr, const int* __restrict__ rlen_arr,
                         const int* __restrict__ frag_arr, const int* __restrict__ c0_arr,
                         const int* __restrict__ clen_arr, int N, int cmw, int rmax, int M,
                         int F, int* __restrict__ best_out,
                         int* __restrict__ first_out, int* __restrict__ last_out,
                         int* __restrict__ range_bad, int* __restrict__ scratch) {
    constexpr int kThreads = kScratchThreads;
    constexpr int kWarps = kThreads / 32;
    extern __shared__ int smem[];
    __shared__ int m_lo[kSpan], m_n[kSpan], m_frag[kSpan], m_c0[kSpan], m_clen[kSpan];
    __shared__ int m_seff[kSpan], live_slot[kSpan];
    __shared__ int n_live;
    __shared__ int counts[2][kWarps];  // class A, B per warp of one tile
    __shared__ Best warp_best[kWarps];
    __shared__ int has_umax;

    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const unsigned lt = (1u << lane) - 1u;
    const int T = table_slots(S);
    int log_t = 0;
    while ((1 << log_t) < T) ++log_t;
    uint32_t* table = reinterpret_cast<uint32_t*>(smem);
    int* buf = scratch + static_cast<int64_t>(blockIdx.x) * scratch_words_per_block(rmax);
    int* bh = buf;                  // hash plane, then class A positions in place
    int* bp = buf + rmax;           // wpos plane
    int* bv = buf + 2 * rmax;       // prev plane
    int* b_pos = buf + 3 * rmax;    // class B positions, ascending
    int* b_st = b_pos + rmax;       // class B starts, then sorted

    const int n_spans = (N + kSpan - 1) / kSpan;
    for (int span = blockIdx.x; span < n_spans; span += gridDim.x) {
        __syncthreads();  // the span before is done with the metadata
        if (warp == 0) {
            span_metadata(span * kSpan, lane, s_sizes, S, lo_arr, rlen_arr, frag_arr, c0_arr,
                          clen_arr, N, rmax, M, F, best_out, first_out, last_out, range_bad,
                          m_lo, m_n, m_frag, m_c0, m_clen, m_seff, live_slot, &n_live);
        }
        __syncthreads();
        const int L = n_live;
        int cur_frag = -1;
        for (int k = 0; k < L; ++k) {
            const int slot = live_slot[k];
            const int i = span * kSpan + slot;
            const int n = m_n[slot];
            const int f = m_frag[slot];
            const int c0 = m_c0[slot];
            const int64_t c_end = static_cast<int64_t>(c0) + m_clen[slot];
            const int64_t base = m_lo[slot];
            for (int j = tid; j < n; j += kThreads) {
                bh[j] = static_cast<int>(mini_hash[base + j]);
                bp[j] = mini_wpos[base + j];
                bv[j] = mini_prev[base + j];
            }
            if (f != cur_frag) {  // the fragment's hash set, from its sketch row
                for (int t = tid; t < T; t += kThreads) table[t] = kEmpty;
                if (tid == 0) has_umax = 0;
                __syncthreads();
                const uint32_t* row = q + static_cast<int64_t>(f) * S;
                for (int t = tid; t < m_seff[slot]; t += kThreads)
                    set_insert(table, log_t, T, row[t], &has_umax);
                cur_frag = f;
            }
            __syncthreads();  // the planes and the set are in place

            // membership and class, compacted tile by tile: class A in place
            // over the hash plane (its slot never passes the entry's), class
            // B beside it
            int n_a = 0, n_b = 0;
            for (int j0 = 0; j0 < n; j0 += kThreads) {
                const int j = j0 + tid;
                bool in = false, cls_b = false;
                int p = 0, v = 0;
                if (j < n) {
                    p = bp[j];
                    v = bv[j];
                    in = set_contains(table, log_t, T, static_cast<uint32_t>(bh[j]), has_umax);
                    cls_b = in && static_cast<int64_t>(v) + 1 >
                                      static_cast<int64_t>(p) - (cmw - 1);
                }
                const unsigned ua = __ballot_sync(0xffffffffu, in && !cls_b);
                const unsigned ub = __ballot_sync(0xffffffffu, cls_b);
                if (lane == 0) {
                    counts[0][warp] = __popc(ua);
                    counts[1][warp] = __popc(ub);
                }
                __syncthreads();  // every hash of this tile is read
                int off_a = n_a, off_b = n_b;
                for (int w = 0; w < kWarps; ++w) {
                    if (w < warp) {
                        off_a += counts[0][w];
                        off_b += counts[1][w];
                    }
                    n_a += counts[0][w];
                    n_b += counts[1][w];
                }
                if (in && !cls_b) {
                    bh[off_a + __popc(ua & lt)] = p;
                } else if (cls_b) {
                    const int off = off_b + __popc(ub & lt);
                    b_pos[off] = p;
                    b_st[off] = v + 1;
                }
                __syncthreads();  // the counts are read before the next tile
            }
            const int P = pow2_at_least(n_b);
            for (int t = n_b + tid; t < P; t += kThreads) b_st[t] = kIntMax;
            __syncthreads();
            if (P > 1) bitonic(b_st, P, tid, kThreads, []() { __syncthreads(); });

            score_anchors<kThreads>(bp, n, c0, c_end, cmw, bh, n_a, b_pos, b_st, n_b, tid, lane,
                                    warp, warp_best, i, best_out, first_out, last_out);
        }
    }
}

template <int kThreads>
cudaError_t launch(int grid, long long smem, cudaStream_t stream, const uint32_t* q,
                   const int* s_sizes, int S, const uint32_t* mini_hash,
                   const int* mini_wpos, const int* mini_prev, const int* lo,
                   const int* rlen, const int* frag, const int* c0, const int* clen,
                   int N, int cmw, int rmax, int M, int F, int* best,
                   int* first, int* last, int* range_bad) {
    if (rmax > kMaxTiles * kThreads) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(l2_chunks_kernel<kThreads>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    l2_chunks_kernel<kThreads><<<grid, kThreads, static_cast<size_t>(smem), stream>>>(
        q, s_sizes, S, mini_hash, mini_wpos, mini_prev, lo, rlen, frag, c0, clen, N, cmw,
        rmax, M, F, best, first, last, range_bad);
    return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* l2_chunks_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// 1 when the shared-memory kernel (l2_chunks_launch) serves a sketch
// width S and range capacity rmax on `device`, 0 when it does not (take
// l2_chunks_launch_scratch), negative on a CUDA error.
int l2_chunks_fits_shared(int device, int S, int rmax) {
    int optin = 0;
    if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
        cudaSuccess)
        return -1;
    const int threads = rmax > kWideRange ? 512 : 256;
    cudaFuncAttributes attr;
    const cudaError_t got = threads == 512
                                ? cudaFuncGetAttributes(&attr, l2_chunks_kernel<512>)
                                : cudaFuncGetAttributes(&attr, l2_chunks_kernel<256>);
    if (got != cudaSuccess) return -1;
    const long long smem = 4LL * smem_words(S, rmax);
    return rmax <= kMaxTiles * threads &&
           smem <= optin - static_cast<long long>(attr.sharedSizeBytes);
}

// The int32 words of global scratch that l2_chunks_launch_scratch needs
// for N chunk slots at range capacity rmax on `device`: one slice per
// resident block of the persistent grid.  Negative on a CUDA error.
long long l2_chunks_scratch_words(int device, int S, int rmax, int N) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
        return -1;
    const int dyn = scratch_smem_bytes(S);
    if (cudaFuncSetAttribute(l2_chunks_scratch_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, dyn) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, l2_chunks_scratch_kernel,
                                                      kScratchThreads, dyn) != cudaSuccess)
        return -1;
    const long long spans = (static_cast<long long>(N) + kSpan - 1) / kSpan;
    const long long grid = std::max(1LL, std::min(spans, static_cast<long long>(per_sm) * sms));
    return grid * scratch_words_per_block(rmax);
}

// Launches one block per kSpan chunk slots on `stream` (the shared-memory
// kernel); returns cudaGetLastError().  `range_bad` is one int the caller
// zeroed; M is the store length and F the number of sketch rows.
int l2_chunks_launch(const void* q, const void* s_sizes, int S,
                     const void* mini_hash, const void* mini_wpos,
                     const void* mini_prev, const void* lo,
                     const void* rlen, const void* frag, const void* c0,
                     const void* clen, int N, int cmw, int rmax, int M, int F,
                     void* best, void* first, void* last, void* range_bad,
                     void* stream) {
    if (N <= 0) return 0;
    const long long smem = 4LL * smem_words(S, rmax);
    const int grid = (N + kSpan - 1) / kSpan;
    auto* fn = rmax > kWideRange ? launch<512> : launch<256>;
    return static_cast<int>(fn(
        grid, smem, static_cast<cudaStream_t>(stream), static_cast<const uint32_t*>(q),
        static_cast<const int*>(s_sizes), S, static_cast<const uint32_t*>(mini_hash),
        static_cast<const int*>(mini_wpos), static_cast<const int*>(mini_prev),
        static_cast<const int*>(lo), static_cast<const int*>(rlen),
        static_cast<const int*>(frag), static_cast<const int*>(c0),
        static_cast<const int*>(clen), N, cmw, rmax, M, F, static_cast<int*>(best),
        static_cast<int*>(first), static_cast<int*>(last), static_cast<int*>(range_bad)));
}

// The same operands through the scratch variant, on a persistent grid of
// scratch_words / scratch_words_per_block(rmax) blocks; `scratch` holds
// `scratch_words` int32 words, as l2_chunks_scratch_words sized it.
int l2_chunks_launch_scratch(const void* q, const void* s_sizes, int S,
                             const void* mini_hash, const void* mini_wpos,
                             const void* mini_prev, const void* lo,
                             const void* rlen, const void* frag, const void* c0,
                             const void* clen, int N, int cmw, int rmax, int M, int F,
                             void* best, void* first, void* last, void* range_bad,
                             void* scratch, long long scratch_words, void* stream) {
    if (N <= 0) return 0;
    const long long grid = scratch_words / scratch_words_per_block(rmax);
    if (scratch == nullptr || grid < 1 || grid > 0x7fffffffLL) return cudaErrorInvalidValue;
    const int dyn = scratch_smem_bytes(S);
    cudaError_t err = cudaFuncSetAttribute(
        l2_chunks_scratch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    if (err != cudaSuccess) return static_cast<int>(err);
    l2_chunks_scratch_kernel<<<static_cast<int>(grid), kScratchThreads, dyn,
                               static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(q), static_cast<const int*>(s_sizes), S,
        static_cast<const uint32_t*>(mini_hash), static_cast<const int*>(mini_wpos),
        static_cast<const int*>(mini_prev), static_cast<const int*>(lo),
        static_cast<const int*>(rlen), static_cast<const int*>(frag),
        static_cast<const int*>(c0), static_cast<const int*>(clen), N, cmw, rmax, M, F,
        static_cast<int*>(best), static_cast<int*>(first), static_cast<int*>(last),
        static_cast<int*>(range_bad), static_cast<int*>(scratch));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
