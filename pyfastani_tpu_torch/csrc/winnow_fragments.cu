// Fragment winnow and sketch for NVIDIA Hopper (sm_90a).
//
// A hand kernel of the port, not the counterpart of a TPU kernel: the JAX
// package computes this stage as an XLA program,
// pyfastani_tpu/ops/fragments.py::_winnow_fragments_impl over
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
// bytes needs about 80 int32 operations per position (two Murmur3 hashes
// of 16 bytes, the canonical choice, the window minimum, the record test)
// against one byte in and at most a few bytes of sketch out.  The plain
// torch version spends its time elsewhere: some 380 elementwise int64
// passes over (F, P) arrays in device memory.
//
// What the design does about it:
//   * One block per fragment.  The block stages the fragment's bytes and
//     their reverse complement (reversed, so both strands hash with the
//     same forward code) in shared memory and never writes an
//     intermediate to device memory: a fragment costs its bytes in and
//     its sketch out.
//   * Hashes in native uint32 arithmetic, words read from the staged
//     bytes with one funnel shift.  Each position's (hash, position) pair
//     is one 64-bit key, hash << 32 | (UMAX - position), so the window
//     minimum with its tie rule is a plain unsigned minimum and an
//     invalid position is ~0.
//   * The w-wide minimum doubles in place, log2(w) + 1 steps of one
//     minimum per position (w = 24: five), each step a chunk of 8 keys a
//     thread read into registers, one barrier, then written back.
//   * The record flags are one pass over the windows, 256 a tile: the
//     previous evaluated window, the quirk's running AND and the records'
//     offsets come from warp ballots, one summary per warp in shared
//     memory and a carry between tiles, two barriers a tile.  Records
//     land compacted over the keys already read.
//   * The ~2P/(w+1) records sort with a bitonic sort in shared memory,
//     rounded up to a power of two (room for it is in the key array),
//     and one more ballot pass drops duplicates and UMAX and writes the
//     sketch.  The overflow flag is a plain store of 1: no host sync.
//   * A fragment whose working store (about 11 bytes a position) passes
//     the card's opt-in shared memory takes the same code with its store
//     in a global scratch buffer that the wrapper allocates, on a
//     persistent grid of blocks that each own one slice of it, with
//     64-bit indices: every fragment_length is served.

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinItems = 8;  // keys a thread holds in one step of the window minimum
constexpr uint32_t kSeed = 42;
constexpr uint32_t kC1 = 0xcc9e2d51u;
constexpr uint32_t kC2 = 0x1b873593u;
constexpr uint32_t kUmax = 0xffffffffu;
constexpr unsigned kFull = 0xffffffffu;
// global scratch of the persistent grid, at most (unless one block needs more)
constexpr long long kScratchBudget = 1LL << 30;

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
winnow_fragments_kernel(const uint8_t* __restrict__ frags, long long stride, int F,
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

}  // namespace

extern "C" {

// The bytes of global scratch that winnow_fragments_launch needs for F
// fragments of `length` bytes at (k, w) on `device`: 0 when one
// fragment's working store fits the card's opt-in shared memory (the
// shared-memory kernel), else one store per block of the persistent grid
// (at most two blocks an SM, within kScratchBudget when one store allows
// it).  Negative on a CUDA error.
long long winnow_fragments_scratch_bytes(int device, long long length, int k, int w, int F) {
    const Layout L = layout(length, k, w);
    int optin = 0, sms = 0;
    if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
        return -1;
    cudaFuncAttributes attr;
    if (cudaFuncGetAttributes(&attr, winnow_fragments_kernel<int, true>) != cudaSuccess) return -1;
    // the shared-memory kernel indexes with int
    if (L.total <= optin - static_cast<long long>(attr.sharedSizeBytes) && length < (1LL << 30))
        return 0;
    long long grid = std::min(static_cast<long long>(F), 2LL * sms);
    grid = std::max(1LL, std::min(grid, kScratchBudget / L.total));
    return grid * L.total;
}

// Sketches the F rows of `frags` (uint8, row stride `stride` bytes) on
// `stream`: `q` is (F, wout) int64, `s` (F,) int32, `ovf` one int the
// caller zeroed, `comp` the 256-byte complement table on the card.  With
// `scratch` null the shared-memory kernel runs one block a fragment;
// otherwise the scratch variant runs scratch_bytes / store bytes blocks,
// as winnow_fragments_scratch_bytes sized it.  Returns cudaGetLastError().
int winnow_fragments_launch(const void* frags, long long stride, int F, long long length, int k,
                            int w, int protein, int kc, long long wout, const void* comp,
                            void* q, void* s, void* ovf, void* scratch, long long scratch_bytes,
                            void* stream) {
    if (F <= 0) return 0;
    const Layout L = layout(length, k, w);
    const auto* in = static_cast<const uint8_t*>(frags);
    const auto* table = static_cast<const uint8_t*>(comp);
    auto* q_out = static_cast<long long*>(q);
    auto* s_out = static_cast<int*>(s);
    auto* flag = static_cast<int*>(ovf);
    auto st = static_cast<cudaStream_t>(stream);
    if (scratch == nullptr) {
        cudaError_t err = cudaFuncSetAttribute(winnow_fragments_kernel<int, true>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(L.total));
        if (err != cudaSuccess) return static_cast<int>(err);
        winnow_fragments_kernel<int, true><<<F, kThreads, static_cast<size_t>(L.total), st>>>(
            in, stride, F, length, k, w, protein, kc, wout, table, q_out, s_out, flag, nullptr, 0);
    } else {
        const long long grid = L.total > 0 ? scratch_bytes / L.total : 0;
        if (grid < 1 || grid > F) return static_cast<int>(cudaErrorInvalidValue);
        winnow_fragments_kernel<long long, false><<<static_cast<int>(grid), kThreads, 0, st>>>(
            in, stride, F, length, k, w, protein, kc, wout, table, q_out, s_out, flag,
            static_cast<uint8_t*>(scratch), L.total);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
