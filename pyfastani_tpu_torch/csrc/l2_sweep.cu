// The L2 sweep's chunk plan for NVIDIA Hopper (sm_90a).
//
// Hand kernels of the port, not the counterparts of a TPU kernel: the JAX
// package computes both steps as XLA array code around its one Pallas
// kernel, pyfastani_tpu/parallel/sharded.py: the contig lookup of
// _query_block_impl (:576-594) and the plan of _l2_interval_scan
// (:403-456).  The plain torch version is
// pyfastani_tpu_torch/ops/l2_sweep.py::l2_plan_reference.  The sweep's
// merge (:519-530) runs in the gate + CGI kernel, csrc/cgi.cu, which reads
// `ends` and the chunk results.  The plan takes the L1 stage's candidate intervals
// as it returns them: interval i of NI = F * ivmax (fragment i / ivmax)
// spans global positions [g0[i], g1[i]] when valid[i]:
//   * the contig lookup: seq[i] = clamp(upper_bound(coff, g1[i]) - 1, 0,
//     C - 1) over the C + 1 contig offsets, on every interval, and with
//     base = coff[seq[i]], the contig-local window offsets c0 = max(g0,
//     base) - base and c1 = g1 - base;
//   * the plan cuts the interval into n_ch[i] = ceil(span / cmax) chunks
//     (span = c1 - c0 + 1 when valid, else 0), placed back to back on a
//     ch_max-slot axis (ends = cumsum(n_ch), total = ends[NI - 1]).
//     Chunk c of interval i sits in slot ends[i] - n_ch[i] + c when that
//     is below ch_max, starts at c0 + c * cmax, holds min(cmax, c1 - its
//     start + 1) offsets, and its range of the position-ordered minimizer
//     store is [lo, hi): two lower-bound searches of mini_gpos, `steps`
//     rounds of a binary search inside the prefix bucket of each key,
//     clamped to the contig's block [cof[seq], cof[seq + 1]).  rlen =
//     max(hi - lo, 0); flags[1] is raised when some rlen passes rcap,
//     which then clamps it, and flags[0] when total passes ch_max.  A
//     slot at or past total holds 0 in all five operands.
//
// What bounds it on the card: bytes.  The plan reads each interval's two
// bounds and flag, writes its contig (int64) and running chunk count,
// writes 5 int32 a slot, and each live slot's two searches read a bucket's
// bounds and a few positions of a store of 10^8 int32 (450 MB at the
// all-vs-all's index), scattered: latency, not bandwidth, is what a
// thread waits on.
//
// The first design ran the lookup as 16 torch ops (13 device kernels)
// before the plan, then a count pass, a torch.cumsum (CUB, two kernels), a
// fill of the flags and one thread a slot, which found its owner interval
// by a binary search over `ends` (17 dependent reads at NI 131,072) before
// its two searches of ~`steps` dependent reads each.
// What this design does about it:
//   * Two launches and no library call, tiled by kTile intervals, one a
//     thread.  Launch A looks up each interval's contig (a binary search
//     of the contig offsets, staged in shared memory when they fit in
//     kCoffShared entries, read through the cache past that), writes it,
//     and writes its tile's chunk total to a (n_tiles,) workspace; block 0
//     clears the range flag.  Launch B sums the tile totals before its own
//     (and all of them: the total), rescans its tile (cub::BlockScan),
//     writes `ends` and keeps the tile's running counts in shared memory.
//     The tile's chunks are then spread over the block's threads, one a
//     thread: a chunk finds its interval by a binary search of those
//     counts in shared memory (9 steps), not of `ends` in global memory,
//     and every lane of a busy warp has a chunk, where one thread an
//     interval left half the lanes idle and ran long intervals' chunks
//     one after another.  Every block then zeroes its share of the slots
//     in [total, ch_max) with a grid-stride loop.  Nothing reads the total
//     on the host, the grid is sized by NI and ch_max, and the workspace
//     is rewritten on every call: no memset, no wait for the device.
//   * A decoupled look-back would fold the two launches into one, but the
//     slots past the total, which must hold 0, are known only once the
//     last tile's prefix is: one block would zero them all, or every block
//     would wait on the last one.  So the two launches stay, as in the L1
//     kernels.
//   * Each search reads its bucket's bounds, interpolates the key's place
//     in the bucket (positions fill a bucket's 2^shift values nearly
//     evenly), and reads kWin positions around the guess as independent
//     16-byte loads.  When the window does not bracket the key, a binary
//     search finishes in the part of the bucket it names; a bucket that
//     `steps` halvings do not exhaust takes the plain version's `steps`
//     halvings: every lo and hi is the plain version's.  Searching a
//     chunk's two keys with their loads in flight together, 8-position
//     windows, and loading an interval's first buckets before the scan
//     measured no faster; 64 registers (two blocks an SM) did.
//   * An empty store (M = 0) is never read.

#include <cstdint>
#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 512;          // intervals a plan block, one a thread
constexpr int kCoffShared = 2048;   // contig offsets staged in shared memory, at most
constexpr int kWin = 16;            // store positions read around the interpolated place
constexpr int kChunkBlocksPerSM = 2;  // the chunk kernel's blocks an SM, at least (64 registers)
constexpr long long kBig = 1LL << 30;  // the window-position pad

// torch.clamp(x, lo, hi): min(max(x, lo), hi), also when lo > hi
__device__ __forceinline__ long long clamp64(long long x, long long lo, long long hi) {
    return min(max(x, lo), hi);
}

// floor division by a positive divisor, as torch's // on int64
__device__ __forceinline__ long long floordiv(long long a, long long b) {
    const long long q = a / b;
    return (a % b != 0 && a < 0) ? q - 1 : q;
}

// clamp(searchsorted(coff, g, 'right') - 1, 0, n_coff - 2): the contig of
// global position g
__device__ __forceinline__ long long contig_of(const int* coff, long long n_coff, long long g) {
    long long a = 0, b = n_coff;
    while (a < b) {
        const long long m = (a + b) >> 1;
        if (static_cast<long long>(coff[m]) <= g) {
            a = m + 1;
        } else {
            b = m;
        }
    }
    return clamp64(a - 1, 0, n_coff - 2);
}

// A valid interval's contig-local bounds and chunk count.
struct Interval {
    long long c0, c1, n_ch;
};

__device__ __forceinline__ Interval interval_of(long long g0, long long g1, long long base,
                                                long long cmax) {
    Interval iv;
    iv.c0 = max(g0, base) - base;
    iv.c1 = g1 - base;
    iv.n_ch = floordiv(iv.c1 - iv.c0 + cmax, cmax);  // ceil(span / cmax)
    return iv;
}

// The first index in [lo, hi) whose position is not below key, or hi.
__device__ __forceinline__ long long lower_bound(const int* __restrict__ gpos, long long lo,
                                                 long long hi, long long key) {
    while (lo < hi) {
        const long long mid = (lo + hi) >> 1;
        if (static_cast<long long>(gpos[mid]) < key) {
            lo = mid + 1;
        } else {
            hi = mid;
        }
    }
    return lo;
}

// The prefix bucket of `key`: its first position value, and [lo, hi) of
// the store.
__device__ __forceinline__ long long bucket_of(const int* __restrict__ bucket, long long n_bucket,
                                               int shift, long long key, int& lo, int& hi) {
    const long long b = clamp64(key >> shift, 0, n_bucket - 2);
    lo = bucket[b];
    hi = bucket[b + 1];
    return b << shift;
}

// searchsorted(mini_gpos, key, 'left') inside the key's bucket [lo, hi)
// (which starts at position value bstart) as the plain version's `steps`
// rounds find it (see the top of the file).
__device__ __forceinline__ long long search_key(const int* __restrict__ gpos, long long M,
                                                int shift, int steps, long long key,
                                                long long bstart, int lo, int hi) {
    if (M <= 0 || lo >= hi || (steps < 62 && ((hi - lo) >> steps) != 0)) {
        // an empty bucket or store, or a bucket too deep for `steps`: the
        // plain version's halvings
        long long l = lo, h = hi;
        for (int st = 0; st < steps && l < h && M > 0; ++st) {
            const long long mid = floordiv(l + h, 2);
            if (static_cast<long long>(gpos[clamp64(mid, 0, M - 1)]) < key) {
                l = mid + 1;
            } else {
                h = mid;
            }
        }
        return l;
    }
    // the interpolated place of the key among the bucket's positions, and
    // a window of kWin from the 4-aligned index a few before it
    const long long within = clamp64(key - bstart, 0, (1LL << shift) - 1);
    const int g = lo + static_cast<int>((within * (hi - lo)) >> shift);
    const int wa = max(lo, min(g - 6, hi - kWin)) & ~3;
    const int a = max(wa, lo), e = min(wa + kWin, hi);
    const bool vec = (reinterpret_cast<uintptr_t>(gpos) & 15) == 0;
    int x[kWin];
#pragma unroll
    for (int v = 0; v < kWin / 4; ++v) {
        const int i0 = wa + 4 * v;
        if (vec && i0 + 4 <= M && i0 < e && i0 + 4 > a) {
            const int4 four = *reinterpret_cast<const int4*>(gpos + i0);
            x[4 * v] = four.x;
            x[4 * v + 1] = four.y;
            x[4 * v + 2] = four.z;
            x[4 * v + 3] = four.w;
        } else {
#pragma unroll
            for (int u = 0; u < 4; ++u) x[4 * v + u] = i0 + u >= a && i0 + u < e ? gpos[i0 + u] : 0;
        }
    }
    int below = 0;
    long long first = 0, last = 0;
#pragma unroll
    for (int j = 0; j < kWin; ++j) {
        const int i = wa + j;
        if (i >= a && i < e) {
            below += static_cast<long long>(x[j]) < key;
            if (i == a) first = x[j];
            last = x[j];
        }
    }
    if (a > lo && first >= key) return lower_bound(gpos, lo, a, key);
    if (e < hi && last < key) return lower_bound(gpos, e, hi, key);
    return a + below;
}

// Launch A: one block a tile of kTile intervals.  Each interval's contig
// into seq_out; the tile's chunk total into tile_total[tile]; block 0
// clears the range flag.
__global__ void __launch_bounds__(kTile)
l2_plan_tiles_kernel(const int* __restrict__ g0, const int* __restrict__ g1,
                     const bool* __restrict__ valid, long long NI, const int* __restrict__ coff,
                     long long n_coff, long long cmax, long long* __restrict__ seq_out,
                     long long* __restrict__ tile_total, bool* __restrict__ flags) {
    using Reduce = cub::BlockReduce<long long, kTile>;
    __shared__ typename Reduce::TempStorage temp;
    __shared__ int s_coff[kCoffShared];
    const int tid = threadIdx.x;
    const long long i = static_cast<long long>(blockIdx.x) * kTile + tid;
    // the interval's loads in flight beside the staging of the table
    const bool live = i < NI && valid[i];
    const long long lo_g = live ? g0[i] : 0, hi_g = i < NI ? g1[i] : 0;
    const bool staged = n_coff <= kCoffShared;  // the same in every thread
    if (staged) {
        for (int k = tid; k < n_coff; k += kTile) s_coff[k] = coff[k];
        __syncthreads();
    }
    const int* table = staged ? s_coff : coff;
    long long n = 0;
    if (i < NI) {
        const long long seq = contig_of(table, n_coff, hi_g);
        seq_out[i] = seq;
        if (live) n = interval_of(lo_g, hi_g, table[seq], cmax).n_ch;
    }
    const long long total = Reduce(temp).Sum(n);
    if (tid == 0) {
        tile_total[blockIdx.x] = total;
        if (blockIdx.x == 0) flags[1] = false;
    }
}

// Launch B: block t < n_tiles plans tile t's intervals: their `ends`,
// then the tile's chunks spread over the block's threads, each finding its
// interval in the tile's running counts in shared memory.  Every block
// zeroes its share of the slots in [total, ch_max) and block 0 writes the
// chunk overflow flag.
__global__ void __launch_bounds__(kTile, kChunkBlocksPerSM)
l2_plan_chunks_kernel(const int* __restrict__ g0, const int* __restrict__ g1,
                      const bool* __restrict__ valid, const long long* __restrict__ seq_in,
                      long long NI, long long ivmax, long long n_tiles,
                      const long long* __restrict__ tile_total, const int* __restrict__ coff,
                      const int* __restrict__ cof, const int* __restrict__ gpos, long long M,
                      const int* __restrict__ bucket, long long n_bucket, int shift, int steps,
                      long long cmw, long long cmax, long long rcap, long long ch_max,
                      long long* __restrict__ ends, int* __restrict__ lo_out,
                      int* __restrict__ rlen_out, int* __restrict__ frag_out,
                      int* __restrict__ c0_out, int* __restrict__ len_out,
                      bool* __restrict__ flags) {
    using Scan = cub::BlockScan<long long, kTile>;
    using Reduce = cub::BlockReduce<long long, kTile>;
    __shared__ union {
        typename Scan::TempStorage scan;
        typename Reduce::TempStorage reduce;
    } temp;
    __shared__ long long s_sums[2];
    // the tile's intervals: running chunk count (inclusive, from the
    // tile's first chunk), first and last window offset, contig
    __shared__ long long s_end[kTile];
    __shared__ int s_c0[kTile], s_c1[kTile], s_seq[kTile];
    const int tid = threadIdx.x;
    const long long t = blockIdx.x;

    // this thread's interval: loads in flight beside the tile totals'
    const long long i = t * kTile + tid;
    const bool live = t < n_tiles && i < NI && valid[i];
    long long seq = 0;
    Interval iv{0, 0, 0};
    if (live) {
        seq = seq_in[i];
        iv = interval_of(g0[i], g1[i], coff[seq], cmax);
    }
    // the chunk totals of the tiles before this one, and of all of them
    long long before = 0, all = 0;
    for (long long k = tid; k < n_tiles; k += kTile) {
        const long long v = tile_total[k];
        all += v;
        if (k < t) before += v;
    }
    before = Reduce(temp.reduce).Sum(before);
    __syncthreads();
    all = Reduce(temp.reduce).Sum(all);
    if (tid == 0) {
        s_sums[0] = before;
        s_sums[1] = all;
    }
    __syncthreads();
    before = s_sums[0];
    const long long total = s_sums[1];

    if (t < n_tiles) {  // the same in every thread of the block
        long long incl, tile_chunks;
        Scan(temp.scan).InclusiveSum(iv.n_ch, incl, tile_chunks);
        if (i < NI) ends[i] = before + incl;
        // a valid interval's offsets lie in [0, 2^31): int32 from here on
        s_end[tid] = incl;
        s_c0[tid] = static_cast<int>(iv.c0);
        s_c1[tid] = static_cast<int>(iv.c1);
        s_seq[tid] = static_cast<int>(seq);
        __syncthreads();
        const long long n = min(tile_chunks, ch_max - before);  // the tile's slots below ch_max
        for (long long q = max(0LL, -before) + tid; q < n; q += kTile) {
            // the interval: the first whose running count passes q
            int a = 0, z = kTile - 1;
            while (a < z) {
                const int m = (a + z) >> 1;
                if (s_end[m] > q) {
                    z = m;
                } else {
                    a = m + 1;
                }
            }
            const long long c = q - (a > 0 ? s_end[a - 1] : 0);
            const long long j = before + q;
            const int cseq = s_seq[a];
            const long long cbase = coff[cseq];
            const long long ch_c0 = s_c0[a] + c * cmax;
            const long long ch_len = clamp64(s_c1[a] - ch_c0 + 1, 0, cmax);
            const long long key[2] = {cbase + ch_c0, cbase + min(ch_c0 + ch_len - 1 + cmw, kBig)};
            long long r[2];
#pragma unroll
            for (int k = 0; k < 2; ++k) {
                int lo, hi;
                const long long bstart = bucket_of(bucket, n_bucket, shift, key[k], lo, hi);
                r[k] = search_key(gpos, M, shift, steps, key[k], bstart, lo, hi);
            }
            const long long rlo = max(r[0], static_cast<long long>(cof[cseq]));
            const long long rhi = min(r[1], static_cast<long long>(cof[cseq + 1]));
            long long rlen = max(rhi - rlo, 0LL);
            if (rlen > rcap) flags[1] = true;
            rlen = clamp64(rlen, 0, rcap);
            lo_out[j] = static_cast<int>(rlo);
            rlen_out[j] = static_cast<int>(rlen);
            frag_out[j] = static_cast<int>((t * kTile + a) / ivmax);
            c0_out[j] = static_cast<int>(ch_c0);
            len_out[j] = static_cast<int>(ch_len);
        }
    }
    // no chunk: an empty range
    const long long stride = static_cast<long long>(gridDim.x) * kTile;
    for (long long j = max(total, 0LL) + t * kTile + tid; j < ch_max; j += stride) {
        lo_out[j] = rlen_out[j] = frag_out[j] = c0_out[j] = len_out[j] = 0;
    }
    if (t == 0 && tid == 0) flags[0] = total > ch_max;
}

inline long long blocks(long long n, long long per) { return (n + per - 1) / per; }

}  // namespace

extern "C" {

// The tiles a plan of NI intervals runs on: the length of its workspace.
long long l2_plan_tiles(long long NI) { return NI > 0 ? blocks(NI, kTile) : 0; }

// The plan (see the top of the file) of the intervals g0, g1 (NI,) int32
// and valid (NI,) bool, ivmax a fragment, on `stream`: seq and ends (NI,)
// int64; lo, rlen, frag, c0, len (ch_max,) int32; flags two bools (chunk
// overflow, range overflow); tile_total a workspace of l2_plan_tiles(NI)
// int64 that the call rewrites.  Returns cudaGetLastError().
int l2_plan_launch(const void* g0, const void* g1, const void* valid, long long NI,
                   long long ivmax, const void* coff, long long n_coff, const void* cof,
                   const void* gpos, long long M, const void* bucket, long long n_bucket,
                   int shift, int steps, long long cmw, long long cmax, long long rcap,
                   long long ch_max, void* tile_total, void* seq, void* ends, void* lo,
                   void* rlen, void* frag, void* ch_c0, void* ch_len, void* flags,
                   void* stream) {
    if (ch_max <= 0 || NI <= 0) return 0;
    if (n_bucket < 2 || n_coff < 2 || ivmax < 1 || cmax < 1 || shift < 0 || shift > 40) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const long long n_tiles = l2_plan_tiles(NI);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    l2_plan_tiles_kernel<<<n_tiles, kTile, 0, s>>>(
        static_cast<const int*>(g0), static_cast<const int*>(g1),
        static_cast<const bool*>(valid), NI, static_cast<const int*>(coff), n_coff, cmax,
        static_cast<long long*>(seq), static_cast<long long*>(tile_total),
        static_cast<bool*>(flags));
    const long long grid = max(n_tiles, min(blocks(ch_max, 4LL * kTile), 1024LL));
    l2_plan_chunks_kernel<<<grid, kTile, 0, s>>>(
        static_cast<const int*>(g0), static_cast<const int*>(g1),
        static_cast<const bool*>(valid), static_cast<const long long*>(seq), NI, ivmax,
        n_tiles, static_cast<const long long*>(tile_total), static_cast<const int*>(coff),
        static_cast<const int*>(cof), static_cast<const int*>(gpos), M,
        static_cast<const int*>(bucket), n_bucket, shift, steps, cmw, cmax, rcap, ch_max,
        static_cast<long long*>(ends), static_cast<int*>(lo), static_cast<int*>(rlen),
        static_cast<int*>(frag), static_cast<int*>(ch_c0), static_cast<int*>(ch_len),
        static_cast<bool*>(flags));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
