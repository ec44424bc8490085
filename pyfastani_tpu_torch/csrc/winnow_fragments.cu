// Fragment winnow and sketch for NVIDIA Hopper (sm_90a).
//
// A hand kernel of the port, not the counterpart of a TPU kernel: the JAX
// package computes this stage as an XLA program,
// pyfastani_tpu/ops/fragments.py::_winnow_fragments_impl (:33-66) over
// ops/winnow.py (nucl_canonical, prot_hashes, winnow) and ops/murmur3.py.
// The plain torch version is
// pyfastani_tpu_torch/ops/fragments.py::winnow_fragments_reference.
// For every fragment f (the first `length` bytes of row f, uppercased):
//   * each k-mer position i in [0, n_pos), n_pos = length - k + 1, hashes
//     with MurmurHash3_x86_32 (seed 42); for nucleotides also the reverse
//     complement of the k-mer (through the 256-entry complement table),
//     the canonical hash is the smaller, and a palindrome (both equal) is
//     invalid.  Protein hashes the forward strand only;
//   * window p in [0, P), P = n_pos - w + 1, chooses the (hash, position)
//     minimum of positions [p, p + w - 1]: the smaller hash wins, a tie
//     goes to the later position, an invalid position is (UMAX, 0);
//   * window p is evaluated when position p + w - 1 is valid, and records
//     its hash when it is the first evaluated window or its chosen
//     position differs from that of the previous evaluated window, except
//     (the reference's window-0 quirk) when window 0 is evaluated, p > 0
//     and every evaluated window up to p carried window 0's hash;
//   * the sketch is the sorted unique recorded hashes without UMAX: the
//     kernel writes its size s[f], its first `wout` entries as int64 with
//     UMAX padding, and sets *ovf when s[f] > kc.
//
// What bounds it on the card: integer operations.  A fragment of 3000
// bytes needs about 83 int32 operations a position (two Murmur3 hashes of
// 16 bytes, the canonical choice, the window minimum as prefix and suffix
// minima over blocks of w, the record test) against one byte in and a few
// bytes of sketch out.  The first design reached 20% of that bound: some 85
// block barriers a fragment with little work between them (a window
// minimum of log2(w) + 1 in-place passes over 8-byte keys in shared
// memory, a tile loop for the records, a 36-stage bitonic sort).
//
// What this design does about it (the tile route, every fragment whose
// k-mer positions fit one tile of 256 threads x 12 = 3072, the query
// path's 3000-byte fragments among them):
//   * One block a fragment; each thread owns 12 consecutive positions and
//     keeps their keys, hash << 32 | (UMAX - position) (a plain unsigned
//     minimum is the window rule with its tie), in registers.
//   * Staging is 16-byte vector loads of the row into shared memory, then
//     one pass that lays out the bytes as aligned words and their
//     complements as words shifted so that every k-mer of the reverse
//     strand starts at the same byte offset in its word as the forward
//     k-mer.  Each Murmur3 block is then one funnel shift of two words by
//     a shift fixed at compile time (plus a __byte_perm byte swap on the
//     reverse strand).  For k 16 (an instance of its own) a thread loads
//     the 14 words its 12 positions read into registers once; any other
//     k reads them from shared memory.
//   * The window minimum is van Herk / Gil-Werman: prefix minima over
//     blocks of w (kept in shared memory, the one 8-byte store a
//     position) and suffix minima (in the registers), each a sequential
//     pass over the thread's 12 keys plus a segmented block scan (warp
//     shuffles, one summary a warp; one barrier for the two); window p is
//     min(suffix[p], prefix[p + w - 1]), any w from 1 up.
//   * The records are a sequential pass over the thread's windows with a
//     carry (an evaluated window, its position, whether all carried window
//     0's hash) from a block scan, then a block scan of the counts; only
//     the records (~2P/(w + 1)) go to shared memory.
//   * Up to 512 records sort in registers: a bitonic network, two
//     records a thread, its strides below 64 by warp shuffles and only the
//     others through shared memory (w 24: at most 6 barriers).  More
//     records (small w) take a bitonic sort in shared memory.  One block
//     scan a tile of 256 drops duplicates and UMAX and writes the sketch.
//     The overflow flag is a plain store of 1: no host sync.
//   * About 12 block barriers a fragment at w 24 in all (~85 before); the
//     block scans are written here, no library's.
// A fragment past the tile (the long route) runs the first design: one
// block a fragment with its working store (about 11 bytes a position) in
// dynamic shared memory, or, past the card's opt-in shared memory, in a
// global scratch buffer that the wrapper allocates, on a persistent grid
// of blocks that each own one slice of it, with 64-bit indices: every
// fragment_length is served.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinItems = 8;  // keys a thread holds in one step of the long route's minimum
constexpr uint32_t kSeed = 42;
constexpr uint32_t kC1 = 0xcc9e2d51u;
constexpr uint32_t kC2 = 0x1b873593u;
constexpr uint32_t kUmax = 0xffffffffu;
constexpr unsigned kFull = 0xffffffffu;
// global scratch of the long route's persistent grid, at most (unless one
// block needs more)
constexpr long long kScratchBudget = 1LL << 30;

// the tile route
constexpr int kItems = 12;                // consecutive positions a thread owns
constexpr int kTile = kThreads * kItems;  // 3072 positions a fragment
constexpr int kTileBytes = kTile + 128;   // staged bytes a strand
constexpr int kTileWords = kTileBytes / 4;
constexpr int kSortRegs = 2 * kThreads;   // records the register sort takes
static_assert(kItems % 4 == 0, "a thread's first position is 4-byte aligned");

__host__ __device__ inline bool tile_route(long long length, int k, int w) {
    const long long n_pos = length - k + 1;
    return n_pos - w + 1 <= 0 || (n_pos <= kTile && length + 16 <= kTileBytes);
}

__host__ __device__ constexpr long long round16(long long x) { return (x + 15) & ~15LL; }

// Byte offsets of one block's working store: the keys (8 bytes a
// position; later the records and the sort), the bytes and their reverse
// complement (each padded with 8 zero bytes for the word reads), and one
// validity byte a position.  Empty when the fragment has no window.
struct Layout {
    long long data, crev, valid, total;
};

__host__ __device__ inline Layout layout(long long length, int k, int w) {
    const long long n_pos = length - k + 1;
    const bool any = n_pos - w + 1 > 0;
    const long long n = any ? n_pos : 0;
    const long long bytes = any ? round16(length + 8) : 0;
    Layout L;
    L.data = 8 * n;
    L.crev = L.data + bytes;
    L.valid = L.crev + bytes;
    L.total = round16(L.valid + n);
    return L;
}

// One summary a warp, double-buffered by tile parity so that one barrier
// separates a tile's writes from the next tile's.
struct WarpSums {
    uint32_t last[2][kWarps];  // chosen position of the warp's last evaluated window
    int flags[2][kWarps];      // 1: an evaluated window; 2: one whose hash is not h0
    int count[2][kWarps];      // records (or, in the unique pass, sketch hashes)
};

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) { return __funnelshift_l(x, x, r); }

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
    h ^= h >> 16;
    h *= 0x85ebca6bu;
    h ^= h >> 13;
    h *= 0xc2b2ae35u;
    return h ^ (h >> 16);
}

// MurmurHash3_x86_32 of bytes[off, off + k), seed 42.  `bytes` is 4-byte
// aligned and readable 8 bytes past the k-mer.
template <typename I>
__device__ __forceinline__ uint32_t murmur3(const uint8_t* bytes, I off, int k) {
    const uint32_t* words = reinterpret_cast<const uint32_t*>(bytes);
    const int shift = static_cast<int>(off & 3) * 8;
    I word = off >> 2;
    uint32_t h = kSeed;
    const int nb = k >> 2;
    for (int j = 0; j < nb; ++j, ++word) {
        uint32_t k1 = __funnelshift_r(words[word], words[word + 1], shift);
        k1 *= kC1;
        k1 = rotl32(k1, 15);
        k1 *= kC2;
        h ^= k1;
        h = rotl32(h, 13);
        h = h * 5 + 0xe6546b64u;
    }
    const int tail = k & 3;
    if (tail) {
        const I b = off + 4 * static_cast<I>(nb);
        uint32_t k1 = bytes[b];
        if (tail >= 2) k1 ^= static_cast<uint32_t>(bytes[b + 1]) << 8;
        if (tail >= 3) k1 ^= static_cast<uint32_t>(bytes[b + 2]) << 16;
        k1 *= kC1;
        k1 = rotl32(k1, 15);
        k1 *= kC2;
        h ^= k1;
    }
    return fmix32(h ^ static_cast<uint32_t>(k));
}

// keys[i] = min(keys[i], keys[i + d]) for every i (a key past the end is
// ~0), in place: chunks of kThreads * kMinItems keys in ascending order,
// each read whole before it is written, so every read sees the old keys.
template <typename I>
__device__ __forceinline__ void min_step(uint64_t* keys, I n_pos, I d, int tid) {
    const I n = n_pos - d;
    for (I c0 = 0; c0 < n; c0 += static_cast<I>(kThreads) * kMinItems) {
        uint64_t v[kMinItems];
#pragma unroll
        for (int e = 0; e < kMinItems; ++e) {
            const I i = c0 + static_cast<I>(e) * kThreads + tid;
            if (i < n) {
                const uint64_t a = keys[i], b = keys[i + d];
                v[e] = b < a ? b : a;
            }
        }
        __syncthreads();
#pragma unroll
        for (int e = 0; e < kMinItems; ++e) {
            const I i = c0 + static_cast<I>(e) * kThreads + tid;
            if (i < n) keys[i] = v[e];
        }
    }
    __syncthreads();
}

// ---- the long route (the first design) ----

// The sketch of one fragment (see the top of the file) by the whole
// block; `store` is the block's working store (shared or scratch), `comp`
// the complement table in shared memory.
template <typename I>
__device__ __forceinline__ void sketch_fragment(
    const uint8_t* __restrict__ row, I length, int k, int w, bool protein, int kc, I wout,
    const uint8_t* comp, uint8_t* store, const Layout& L, WarpSums& sums,
    long long* __restrict__ q_row, int* __restrict__ s_out, int* __restrict__ ovf) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const unsigned lt = (1u << lane) - 1u;
    const I n_pos = length - k + 1;
    const I P = n_pos - w + 1;
    if (P <= 0) {
        if (tid == 0) *s_out = 0;
        return;
    }
    uint64_t* keys = reinterpret_cast<uint64_t*>(store);
    uint8_t* data = store + L.data;
    uint8_t* crev = store + L.crev;
    uint8_t* valid = store + L.valid;

    // 1. the bytes, and their complement reversed: crev[length - 1 - j] =
    //    comp[data[j]], so the reverse complement of the k-mer at i is the
    //    forward k-mer of crev at length - k - i
    const I nbytes = static_cast<I>(L.crev - L.data);
    for (I j = tid; j < nbytes; j += kThreads) {
        const uint8_t b = j < length ? row[j] : 0;
        data[j] = b;
        if (j < length) {
            crev[length - 1 - j] = comp[b];
        } else {
            crev[j] = 0;
        }
    }
    __syncthreads();

    // 2. the canonical hash of every position, as a (hash, position) key
    for (I i = tid; i < n_pos; i += kThreads) {
        const uint32_t fwd = murmur3<I>(data, i, k);
        uint32_t canon = fwd;
        bool ok = true;
        if (!protein) {
            const uint32_t bwd = murmur3<I>(crev, length - k - i, k);
            ok = fwd != bwd;
            canon = bwd < fwd ? bwd : fwd;
        }
        valid[i] = ok;
        keys[i] = ok ? (static_cast<uint64_t>(canon) << 32 | (kUmax - static_cast<uint32_t>(i)))
                     : ~0ull;
    }
    __syncthreads();

    // 3. the w-wide minimum: after the doubling steps key i covers
    //    [i, i + size), and one more step of w - size covers the window
    I size = 1;
    while (2 * size <= w) {
        min_step<I>(keys, n_pos, size, tid);
        size *= 2;
    }
    if (w > size) min_step<I>(keys, n_pos, static_cast<I>(w) - size, tid);

    // 4. the record flags, tile by tile; records compact over the keys:
    //    the r-th record is written at 32-bit word r <= its window p, which
    //    no later tile reads
    const uint32_t h0 = static_cast<uint32_t>(keys[0] >> 32);
    const bool eval0 = valid[w - 1];
    uint32_t* rec = reinterpret_cast<uint32_t*>(keys);
    bool c_has = false, c_ok = true;
    uint32_t c_prev = 0;
    I c_count = 0;
    int par = 0;
    for (I t0 = 0; t0 < P; t0 += kThreads, par ^= 1) {
        const I p = t0 + tid;
        const bool act = p < P;
        const uint64_t key = act ? keys[p] : ~0ull;
        const uint32_t h = static_cast<uint32_t>(key >> 32);
        const uint32_t pos = kUmax - static_cast<uint32_t>(key);
        const bool ev = act && valid[p + w - 1];
        const unsigned m_ev = __ballot_sync(kFull, ev);
        const unsigned m_ns = __ballot_sync(kFull, ev && h != h0);
        const unsigned below = m_ev & lt;
        const uint32_t prev_in_warp = __shfl_sync(kFull, pos, below ? 31 - __clz(below) : 0);
        const uint32_t last = __shfl_sync(kFull, pos, m_ev ? 31 - __clz(m_ev) : 0);
        if (lane == 0) {
            sums.last[par][warp] = last;
            sums.flags[par][warp] = (m_ev ? 1 : 0) | (m_ns ? 2 : 0);
        }
        __syncthreads();
        bool have = c_has, ok = c_ok;
        uint32_t prev = c_prev;
        for (int j = 0; j < warp; ++j) {
            const int f = sums.flags[par][j];
            if (f & 1) {
                have = true;
                prev = sums.last[par][j];
            }
            if (f & 2) ok = false;
        }
        if (below) {
            have = true;
            prev = prev_in_warp;
        }
        ok = ok && (m_ns & (lt | (1u << lane))) == 0;
        const bool suppress = eval0 && p > 0 && ok;
        const bool record = ev && (!have || pos != prev) && !suppress;
        const unsigned m_rec = __ballot_sync(kFull, record);
        if (lane == 0) sums.count[par][warp] = __popc(m_rec);
        __syncthreads();
        I off = c_count;
        for (int j = 0; j < kWarps; ++j) {
            const int f = sums.flags[par][j];
            const int n = sums.count[par][j];
            if (j < warp) off += n;
            if (f & 1) {
                c_has = true;
                c_prev = sums.last[par][j];
            }
            if (f & 2) c_ok = false;
            c_count += n;
        }
        if (record) rec[off + __popc(m_rec & lt)] = h;
    }
    __syncthreads();

    // 5. sort the records: bitonic over the next power of two, UMAX pad
    //    (R <= n_pos, so 2R words fit the 2 * n_pos words of the keys)
    const I R = c_count;
    I n2 = 1;
    while (n2 < R) n2 <<= 1;
    for (I i = R + tid; i < n2; i += kThreads) rec[i] = kUmax;
    __syncthreads();
    for (I span = 2; span <= n2; span <<= 1) {
        for (I stride = span >> 1; stride > 0; stride >>= 1) {
            for (I t = tid; t < n2 / 2; t += kThreads) {
                const I i = 2 * t - (t & (stride - 1));
                const uint32_t a = rec[i], b = rec[i + stride];
                if ((a > b) == ((i & span) == 0)) {
                    rec[i] = b;
                    rec[i + stride] = a;
                }
            }
            __syncthreads();
        }
    }

    // 6. the first occurrence of each hash but UMAX, in order: the sketch
    I u = 0;
    for (I t0 = 0; t0 < R; t0 += kThreads, par ^= 1) {
        const I i = t0 + tid;
        const uint32_t v = i < R ? rec[i] : kUmax;
        const bool first = i < R && v != kUmax && (i == 0 || rec[i - 1] != v);
        const unsigned m = __ballot_sync(kFull, first);
        if (lane == 0) sums.count[par][warp] = __popc(m);
        __syncthreads();
        I off = u;
        for (int j = 0; j < kWarps; ++j) {
            const int n = sums.count[par][j];
            if (j < warp) off += n;
            u += n;
        }
        const I o = off + __popc(m & lt);
        if (first && o < wout) q_row[o] = v;
    }
    for (I j = u + tid; j < wout; j += kThreads) q_row[j] = kUmax;
    if (tid == 0) {
        *s_out = static_cast<int>(u);
        if (u > kc) *ovf = 1;
    }
    __syncthreads();  // the block's next fragment reuses the store
}

// kShared: the store in dynamic shared memory, one block a fragment.
// Otherwise each block owns `store_bytes` of `scratch` and walks the
// fragments blockIdx.x, blockIdx.x + gridDim.x, ...
template <typename I, bool kShared>
__global__ void __launch_bounds__(kThreads, 4)
winnow_fragments_long_kernel(const uint8_t* __restrict__ frags, long long stride, int F,
                        long long length, int k, int w, int protein, int kc, long long wout,
                        const uint8_t* __restrict__ comp_table, long long* __restrict__ q,
                        int* __restrict__ s, int* __restrict__ ovf, uint8_t* scratch,
                        long long store_bytes) {
    extern __shared__ __align__(16) uint8_t smem[];
    __shared__ uint8_t comp[256];
    __shared__ WarpSums sums;
    for (int i = threadIdx.x; i < 256; i += kThreads) comp[i] = comp_table[i];
    __syncthreads();
    uint8_t* store = kShared ? smem : scratch + static_cast<long long>(blockIdx.x) * store_bytes;
    const Layout L = layout(length, k, w);
    for (long long f = blockIdx.x; f < F; f += gridDim.x) {
        sketch_fragment<I>(frags + f * stride, static_cast<I>(length), k, w, protein != 0, kc,
                           static_cast<I>(wout), comp, store, L, sums, q + f * wout, s + f, ovf);
    }
}


// ---- the tile route ----

__device__ __forceinline__ uint32_t mix_block(uint32_t h, uint32_t k1) {
    k1 *= kC1;
    k1 = rotl32(k1, 15);
    k1 *= kC2;
    h ^= k1;
    h = rotl32(h, 13);
    return h * 5 + 0xe6546b64u;
}

__device__ __forceinline__ uint32_t mix_tail(uint32_t h, uint32_t k1) {
    k1 *= kC1;
    k1 = rotl32(k1, 15);
    k1 *= kC2;
    return h ^ k1;
}

// Murmur3 of the forward k-mer whose first byte is byte `sh / 8` of word
// `wi` of the aligned words `dw`.
__device__ __forceinline__ uint32_t hash_fwd(const uint32_t* dw, int wi, int sh, int k) {
    const int nb = k >> 2, t = k & 3;
    uint32_t h = kSeed;
#pragma unroll 4
    for (int b = 0; b < nb; ++b) h = mix_block(h, __funnelshift_r(dw[wi + b], dw[wi + b + 1], sh));
    if (t) {
        const uint32_t x = __funnelshift_r(dw[wi + nb], dw[wi + nb + 1], sh);
        h = mix_tail(h, x & ((1u << (8 * t)) - 1u));
    }
    return fmix32(h ^ static_cast<uint32_t>(k));
}

// Murmur3 of the reverse complement of the same k-mer, from the
// complemented words `rw` (shifted by (4 - k % 4) % 4 bytes, so that block
// b's four bytes start at byte `sh / 8` of word wi + (k + d) / 4 - 1 - b;
// byte-swapped, they are the block in reverse-complement order).
__device__ __forceinline__ uint32_t hash_rc(const uint32_t* rw, int wi, int sh, int k) {
    const int nb = k >> 2, t = k & 3, d = (4 - t) & 3;
    const int wr = wi + ((k + d - 4) >> 2);
    uint32_t h = kSeed;
#pragma unroll 4
    for (int b = 0; b < nb; ++b) {
        const uint32_t z = __funnelshift_r(rw[wr - b], rw[wr - b + 1], sh);
        h = mix_block(h, __byte_perm(z, 0, 0x0123));
    }
    if (t) {
        const uint32_t x = __funnelshift_r(rw[wi], rw[wi + 1], sh);
        h = mix_tail(h, __byte_perm(x, 0, 0x0123) & ((1u << (8 * t)) - 1u));
    }
    return fmix32(h ^ static_cast<uint32_t>(k));
}

// A segmented minimum: flag = the segment restarts inside.
struct SegMin {
    unsigned long long v;
    int flag;
};
struct SegMinOp {
    __device__ SegMin operator()(const SegMin& a, const SegMin& b) const {
        return b.flag ? b : SegMin{a.v < b.v ? a.v : b.v, a.flag};
    }
};
// The record carry: the last evaluated window's chosen position; bits 1:
// an evaluated window, 2: every evaluated window carried window 0's hash.
struct RecAgg {
    unsigned last;
    int bits;
};
struct RecAggOp {
    __device__ RecAgg operator()(const RecAgg& a, const RecAgg& b) const {
        return RecAgg{(b.bits & 1) ? b.last : a.last, ((a.bits | b.bits) & 1) | (a.bits & b.bits & 2)};
    }
};
struct SumOp {
    __device__ int operator()(int a, int b) const { return a + b; }
};

template <bool kDown>
__device__ __forceinline__ unsigned long long shfl(unsigned long long x, int d) {
    return kDown ? __shfl_down_sync(kFull, x, d) : __shfl_up_sync(kFull, x, d);
}
template <bool kDown>
__device__ __forceinline__ int shfl(int x, int d) {
    return kDown ? __shfl_down_sync(kFull, x, d) : __shfl_up_sync(kFull, x, d);
}
template <bool kDown>
__device__ __forceinline__ unsigned shfl(unsigned x, int d) {
    return kDown ? __shfl_down_sync(kFull, x, d) : __shfl_up_sync(kFull, x, d);
}
template <bool kDown>
__device__ __forceinline__ SegMin shfl(SegMin x, int d) {
    return SegMin{shfl<kDown>(x.v, d), shfl<kDown>(x.flag, d)};
}
template <bool kDown>
__device__ __forceinline__ RecAgg shfl(RecAgg x, int d) {
    return RecAgg{shfl<kDown>(x.last, d), shfl<kDown>(x.bits, d)};
}

// The warp half of a block scan of x under op (a before b), in thread
// order or, with kReverse, from the last thread down: the exclusive scan
// inside the warp, and the warp's summary into tot[warp] (kWarps
// summaries in shared memory that no other scan uses while this one
// runs).  A barrier, then block_scan_finish, completes it.
template <bool kReverse, typename V, typename Op>
__device__ __forceinline__ V block_scan_warp(V x, V identity, Op op, V* tot) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    V incl = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const V y = shfl<kReverse>(incl, o);
        if (kReverse ? lane + o < 32 : lane >= o) incl = op(y, incl);
    }
    V excl = shfl<kReverse>(incl, 1);
    if (lane == (kReverse ? 31 : 0)) excl = identity;
    if (lane == (kReverse ? 0 : 31)) tot[warp] = incl;
    return excl;
}

// The exclusive scan over the block from the warp half's result `excl`;
// *total, when given, gets the whole block's.
template <bool kReverse, typename V, typename Op>
__device__ __forceinline__ V block_scan_finish(V excl, V identity, Op op, const V* tot,
                                               V* total = nullptr) {
    const int warp = threadIdx.x >> 5;
    V before = identity, all = identity;
#pragma unroll
    for (int j = 0; j < kWarps; ++j) {
        const int jj = kReverse ? kWarps - 1 - j : j;
        if (kReverse ? jj > warp : jj < warp) before = op(before, tot[jj]);
        all = op(all, tot[jj]);
    }
    if (total) *total = all;
    return op(before, excl);
}

// Both halves, one barrier between them.
template <bool kReverse, typename V, typename Op>
__device__ __forceinline__ V block_scan(V x, V identity, Op op, V* tot, V* total = nullptr) {
    const V excl = block_scan_warp<kReverse>(x, identity, op, tot);
    __syncthreads();
    return block_scan_finish<kReverse>(excl, identity, op, tot, total);
}

// Sorts rec[0, R) ascending, R <= kSortRegs, n2 the next power of two:
// two records a thread in registers, a bitonic network whose strides under
// 64 are warp shuffles; `xch` is 2 * kSortRegs words past rec[R].
__device__ __forceinline__ void sort_registers(uint32_t* rec, int R, int n2, uint32_t* xch) {
    const int tid = threadIdx.x;
    uint32_t x0 = 2 * tid < R ? rec[2 * tid] : kUmax;
    uint32_t x1 = 2 * tid + 1 < R ? rec[2 * tid + 1] : kUmax;
    int par = 0;
    for (int kk = 2; kk <= n2; kk <<= 1) {
        const bool asc = ((2 * tid) & kk) == 0;
        for (int j = kk >> 1; j > 0; j >>= 1) {
            if (j == 1) {
                const uint32_t lo = min(x0, x1), hi = max(x0, x1);
                x0 = asc ? lo : hi;
                x1 = asc ? hi : lo;
                continue;
            }
            const int pt = j >> 1;  // the partner thread is tid ^ pt
            uint32_t y0, y1;
            if (pt < 32) {
                y0 = __shfl_xor_sync(kFull, x0, pt);
                y1 = __shfl_xor_sync(kFull, x1, pt);
            } else {
                uint32_t* b = xch + par * kSortRegs;  // double-buffered: one barrier a stage
                b[2 * tid] = x0;
                b[2 * tid + 1] = x1;
                __syncthreads();
                y0 = b[2 * (tid ^ pt)];
                y1 = b[2 * (tid ^ pt) + 1];
                par ^= 1;
            }
            const bool keep_min = ((tid & pt) == 0) == asc;
            x0 = keep_min ? min(x0, y0) : max(x0, y0);
            x1 = keep_min ? min(x1, y1) : max(x1, y1);
        }
    }
    if (2 * tid < R) rec[2 * tid] = x0;
    if (2 * tid + 1 < R) rec[2 * tid + 1] = x1;
    __syncthreads();
}

// Sorts rec[0, R) ascending by a bitonic network in shared memory over
// n2 words (UMAX pad).
__device__ __forceinline__ void sort_shared(uint32_t* rec, int R, int n2) {
    const int tid = threadIdx.x;
    for (int i = R + tid; i < n2; i += kThreads) rec[i] = kUmax;
    __syncthreads();
    for (int span = 2; span <= n2; span <<= 1) {
        for (int stride = span >> 1; stride > 0; stride >>= 1) {
            for (int t = tid; t < n2 / 2; t += kThreads) {
                const int i = 2 * t - (t & (stride - 1));
                const uint32_t a = rec[i], b = rec[i + stride];
                if ((a > b) == ((i & span) == 0)) {
                    rec[i] = b;
                    rec[i + stride] = a;
                }
            }
            __syncthreads();
        }
    }
}

__device__ __forceinline__ bool valid_at(const uint32_t* vmask, int q) {
    return (vmask[q / kItems] >> (q % kItems)) & 1u;
}

// One block a fragment whose n_pos <= kTile (see the top of the file).
template <int K>
__global__ void __launch_bounds__(kThreads, 4)
winnow_fragments_tile_kernel(const uint8_t* __restrict__ frags, long long stride, int length,
                             int k, int w, int protein, int kc, int wout,
                             const uint8_t* __restrict__ comp_table, long long* __restrict__ q,
                             int* __restrict__ s, int* __restrict__ ovf) {
    // the row's bytes, then the prefix minima, then the records
    __shared__ __align__(16) unsigned long long xbuf[kTile];
    __shared__ uint32_t dw[kTileWords], rw[kTileWords];
    __shared__ uint32_t vmask[kThreads];
    __shared__ uint8_t comp[256];
    __shared__ SegMin tot_f[kWarps], tot_r[kWarps];
    __shared__ RecAgg tot_a[kWarps];
    __shared__ int tot_n[3][kWarps];
    __shared__ unsigned long long w0key;

    const int tid = threadIdx.x;
    const long long f = blockIdx.x;
    const int n_pos = length - k + 1;
    const int P = n_pos - w + 1;
    if (P <= 0) {
        if (tid == 0) s[f] = 0;
        return;
    }

    // 1. stage: 16-byte loads of the row's aligned span, then the bytes as
    //    aligned words and their complements shifted by d bytes
    static_assert(kThreads == 256, "one complement entry a thread");
    comp[tid] = comp_table[tid];
    const uintptr_t a = reinterpret_cast<uintptr_t>(frags + f * stride);
    const uint4* src = reinterpret_cast<const uint4*>(a & ~static_cast<uintptr_t>(15));
    const int off = static_cast<int>(a & 15);
    const int nvec = (off + length + 15) >> 4;
    uint4* raw = reinterpret_cast<uint4*>(xbuf);
    for (int v = tid; v < nvec; v += kThreads) raw[v] = src[v];
    __syncthreads();
    const uint8_t* rb = reinterpret_cast<const uint8_t*>(xbuf) + off;
    const int d = (4 - (k & 3)) & 3;
    for (int m = tid; m < (length + 16) >> 2; m += kThreads) {
        uint32_t dv = 0, rv = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int y = 4 * m + j, x = y - d;
            if (y < length) dv |= static_cast<uint32_t>(rb[y]) << (8 * j);
            if (x >= 0 && x < length) rv |= static_cast<uint32_t>(comp[rb[x]]) << (8 * j);
        }
        dw[m] = dv;
        rw[m] = rv;
    }
    __syncthreads();

    // 2. the keys of the thread's positions c0 .. c0 + 11; with k known at
    //    compile time the words they read are loaded once, into registers
    const int c0 = tid * kItems;
    unsigned long long key[kItems];
    uint32_t vm = 0;
    if constexpr (K > 0) {
        constexpr int kT = K & 3, kD = (4 - kT) & 3, kNb = K >> 2;
        constexpr int kFw = kItems / 4 + kNb + 1 + (kT ? 1 : 0), kRw = kItems / 4 + (K + kD) / 4;
        static_assert(kTile / 4 + kFw <= kTileWords && kTile / 4 + kRw <= kTileWords, "words");
        uint32_t fw[kFw], rv[kRw];
#pragma unroll
        for (int j = 0; j < kFw; ++j) fw[j] = dw[(c0 >> 2) + j];
#pragma unroll
        for (int j = 0; j < kRw; ++j) rv[j] = rw[(c0 >> 2) + j];
#pragma unroll
        for (int e = 0; e < kItems; ++e) {
            const int g = e >> 2, sh = 8 * (e & 3), wr = g + (K + kD - 4) / 4;
            uint32_t fwd = kSeed, bwd = kSeed;
#pragma unroll
            for (int b = 0; b < kNb; ++b) {
                fwd = mix_block(fwd, __funnelshift_r(fw[g + b], fw[g + b + 1], sh));
                const uint32_t z = __funnelshift_r(rv[wr - b], rv[wr - b + 1], sh);
                bwd = mix_block(bwd, __byte_perm(z, 0, 0x0123));
            }
            if (kT) {
                const uint32_t mask = (1u << (8 * kT)) - 1u;
                fwd = mix_tail(fwd, __funnelshift_r(fw[g + kNb], fw[g + kNb + 1], sh) & mask);
                const uint32_t x = __funnelshift_r(rv[g], rv[g + 1], sh);
                bwd = mix_tail(bwd, __byte_perm(x, 0, 0x0123) & mask);
            }
            fwd = fmix32(fwd ^ static_cast<uint32_t>(K));
            bwd = fmix32(bwd ^ static_cast<uint32_t>(K));
            const int i = c0 + e;
            const bool ok = i < n_pos && (protein || fwd != bwd);
            const uint32_t canon = protein ? fwd : (bwd < fwd ? bwd : fwd);
            key[e] = ok ? static_cast<unsigned long long>(canon) << 32 |
                              (kUmax - static_cast<uint32_t>(i))
                        : ~0ull;
            vm |= ok ? 1u << e : 0u;
        }
    } else {
#pragma unroll
        for (int e = 0; e < kItems; ++e) {
            const int i = c0 + e;
            unsigned long long kk = ~0ull;
            if (i < n_pos) {
                const int wi = (c0 >> 2) + (e >> 2), sh = 8 * (e & 3);
                const uint32_t fwd = hash_fwd(dw, wi, sh, k);
                uint32_t canon = fwd;
                bool ok = true;
                if (!protein) {
                    const uint32_t bwd = hash_rc(rw, wi, sh, k);
                    ok = fwd != bwd;
                    canon = bwd < fwd ? bwd : fwd;
                }
                if (ok) {
                    kk = static_cast<unsigned long long>(canon) << 32 |
                         (kUmax - static_cast<uint32_t>(i));
                    vm |= 1u << e;
                }
            }
            key[e] = kk;
        }
    }
    vmask[tid] = vm;

    // 3. prefix minima over blocks of w into xbuf, suffix minima in place
    int r = c0 % w;
    unsigned long long run = ~0ull;
    int first_start = kItems;
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
        if (r == 0) {
            run = key[e];
            if (first_start == kItems) first_start = e;
        } else if (key[e] < run) {
            run = key[e];
        }
        xbuf[c0 + e] = run;  // every thread is past the staging's reads
        r = r + 1 == w ? 0 : r + 1;
    }
    const SegMin none{~0ull, 0};
    const SegMin ex_f = block_scan_warp<false>(SegMin{run, first_start < kItems}, none,
                                               SegMinOp(), tot_f);
    r = (c0 + kItems - 1) % w;
    run = ~0ull;
    int last_end = -1;
#pragma unroll
    for (int e = kItems - 1; e >= 0; --e) {
        if (r == w - 1) {
            run = key[e];
            if (last_end < 0) last_end = e;
        } else if (key[e] < run) {
            run = key[e];
        }
        key[e] = run;
        r = r == 0 ? w - 1 : r - 1;
    }
    const SegMin ex_r = block_scan_warp<true>(SegMin{run, last_end >= 0}, none, SegMinOp(), tot_r);
    __syncthreads();  // one barrier for both scans
    const SegMin in_f = block_scan_finish<false>(ex_f, none, SegMinOp(), tot_f);
    const SegMin in_r = block_scan_finish<true>(ex_r, none, SegMinOp(), tot_r);
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
        if (e < first_start && in_f.v < xbuf[c0 + e]) xbuf[c0 + e] = in_f.v;
        if (e > last_end && in_r.v < key[e]) key[e] = in_r.v;
    }
    if (tid == 0) w0key = key[0];  // suffix[0]: window 0's minimum
    __syncthreads();

    // 4. window p = c0 + e: min(suffix[p], prefix[p + w - 1])
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
        const int p = c0 + e;
        if (p < P) {
            const unsigned long long pm = xbuf[p + w - 1];
            if (pm < key[e]) key[e] = pm;
        }
    }
    const uint32_t h0 = static_cast<uint32_t>(w0key >> 32);
    const bool eval0 = valid_at(vmask, w - 1);
    uint32_t evm = 0;  // the thread's evaluated windows
#pragma unroll
    for (int e = 0; e < kItems; ++e)
        if (c0 + e < P && valid_at(vmask, c0 + e + w - 1)) evm |= 1u << e;

    // 5. the records: the carry from the windows before the thread's, then
    //    each record's slot
    RecAgg agg{0u, 2};
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
        if ((evm >> e) & 1u) {
            const bool same = static_cast<uint32_t>(key[e] >> 32) == h0;
            agg = RecAgg{kUmax - static_cast<uint32_t>(key[e]), 1 | ((agg.bits & 2) && same ? 2 : 0)};
        }
    }
    const RecAgg in_a = block_scan<false>(agg, RecAgg{0u, 2}, RecAggOp(), tot_a);
    bool have = in_a.bits & 1, ok = in_a.bits & 2;
    uint32_t prev = in_a.last, recm = 0;
    int cnt = 0;
#pragma unroll
    for (int e = 0; e < kItems; ++e) {
        const int p = c0 + e;
        const bool ev = (evm >> e) & 1u;
        const uint32_t h = static_cast<uint32_t>(key[e] >> 32);
        const uint32_t pos = kUmax - static_cast<uint32_t>(key[e]);
        if (ev && h != h0) ok = false;
        const bool rec = ev && (!have || pos != prev) && !(eval0 && p > 0 && ok);
        if (ev) {
            have = true;
            prev = pos;
        }
        if (rec) {
            recm |= 1u << e;
            ++cnt;
        }
    }
    int R;
    int o = block_scan<false>(cnt, 0, SumOp(), tot_n[2], &R);
    // every read of the prefix minima came before the last two barriers
    uint32_t* rec = reinterpret_cast<uint32_t*>(xbuf);
#pragma unroll
    for (int e = 0; e < kItems; ++e)
        if ((recm >> e) & 1u) rec[o++] = static_cast<uint32_t>(key[e] >> 32);
    __syncthreads();

    // 6. sort the records (R <= P <= kTile, so 2 * R words fit xbuf's)
    int n2 = 1;
    while (n2 < R) n2 <<= 1;
    if (R > 1) {
        if (n2 <= kSortRegs) {
            sort_registers(rec, R, n2, rec + kSortRegs);
        } else {
            sort_shared(rec, R, n2);
        }
    }

    // 7. the first occurrence of each hash but UMAX, in order: the sketch
    long long* q_row = q + f * wout;
    int u = 0, par = 0;
    for (int t0 = 0; t0 < R; t0 += kThreads, par ^= 1) {
        const int i = t0 + tid;
        const uint32_t v = i < R ? rec[i] : kUmax;
        const int first = i < R && v != kUmax && (i == 0 || rec[i - 1] != v);
        int tile;
        const int at = u + block_scan<false>(first, 0, SumOp(), tot_n[par], &tile);
        if (first && at < wout) q_row[at] = v;
        u += tile;
    }
    for (int j = u + tid; j < wout; j += kThreads) q_row[j] = kUmax;
    if (tid == 0) {
        s[f] = u;
        if (u > kc) *ovf = 1;
    }
}

}  // namespace

extern "C" {

// 1 when fragments of `length` bytes at (k, w) take the tile route, else 0.
int winnow_fragments_tile_route(long long length, int k, int w) {
    return tile_route(length, k, w) ? 1 : 0;
}

// The bytes of global scratch one block of winnow_fragments_launch's
// long route needs for fragments of `length` bytes at (k, w) on `device`:
// 0 when the tile route or the long route's shared-memory kernel serves
// them.  The wrapper sizes the persistent grid (blocks x these bytes).
// Negative on a CUDA error.
long long winnow_fragments_store_bytes(int device, long long length, int k, int w) {
    if (tile_route(length, k, w)) return 0;
    const Layout L = layout(length, k, w);
    int optin = 0;
    if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
        cudaSuccess)
        return -1;
    cudaFuncAttributes attr;
    if (cudaFuncGetAttributes(&attr, winnow_fragments_long_kernel<int, true>) != cudaSuccess)
        return -1;
    // the shared-memory kernel indexes with int
    if (L.total <= optin - static_cast<long long>(attr.sharedSizeBytes) && length < (1LL << 30))
        return 0;
    return L.total;
}

// Sketches the F rows of `frags` (uint8, row stride `stride` bytes) on
// `stream`: `q` is (F, wout) int64, `s` (F,) int32, `ovf` one int the
// caller zeroed, `comp` the 256-byte complement table on the card.  A
// fragment of at most 3072 k-mer positions takes the tile route; a longer
// one the long route, in shared memory when `scratch` is null, else with
// scratch_bytes / winnow_fragments_store_bytes blocks.  Returns
// cudaGetLastError().
int winnow_fragments_launch(const void* frags, long long stride, int F, long long length, int k,
                            int w, int protein, int kc, long long wout, const void* comp,
                            void* q, void* s, void* ovf, void* scratch, long long scratch_bytes,
                            void* stream) {
    if (F <= 0) return 0;
    const auto* in = static_cast<const uint8_t*>(frags);
    const auto* table = static_cast<const uint8_t*>(comp);
    auto* q_out = static_cast<long long*>(q);
    auto* s_out = static_cast<int*>(s);
    auto* flag = static_cast<int*>(ovf);
    auto st = static_cast<cudaStream_t>(stream);
    if (tile_route(length, k, w)) {
        const int len = static_cast<int>(length), wo = static_cast<int>(wout);
        if (k == 16) {
            winnow_fragments_tile_kernel<16><<<F, kThreads, 0, st>>>(
                in, stride, len, k, w, protein, kc, wo, table, q_out, s_out, flag);
        } else {
            winnow_fragments_tile_kernel<0><<<F, kThreads, 0, st>>>(
                in, stride, len, k, w, protein, kc, wo, table, q_out, s_out, flag);
        }
        return static_cast<int>(cudaGetLastError());
    }
    const Layout L = layout(length, k, w);
    if (scratch == nullptr) {
        cudaError_t err = cudaFuncSetAttribute(winnow_fragments_long_kernel<int, true>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(L.total));
        if (err != cudaSuccess) return static_cast<int>(err);
        winnow_fragments_long_kernel<int, true><<<F, kThreads, static_cast<size_t>(L.total), st>>>(
            in, stride, F, length, k, w, protein, kc, wout, table, q_out, s_out, flag, nullptr, 0);
    } else {
        const long long grid = L.total > 0 ? scratch_bytes / L.total : 0;
        if (grid < 1 || grid > F) return static_cast<int>(cudaErrorInvalidValue);
        winnow_fragments_long_kernel<long long, false><<<static_cast<int>(grid), kThreads, 0, st>>>(
            in, stride, F, length, k, w, protein, kc, wout, table, q_out, s_out, flag,
            static_cast<uint8_t*>(scratch), L.total);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
