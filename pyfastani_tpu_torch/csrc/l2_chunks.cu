// L2 chunk evaluator for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pyfastani_tpu/ops/l2_pallas.py::_kernel
// (launched by _l2_pallas_impl).  Semantics are those of
// pyfastani_tpu/ops/l2.py::l2_event_curve; the plain torch version is
// pyfastani_tpu_torch/ops/l2.py::l2_chunks_reference.  Per chunk i:
//   * every range entry j in [lo, lo + rlen) whose hash is in fragment
//     frag[i]'s sorted sketch (first min(s, S) entries) carries the
//     presence interval [max(p_j - cmw + 1, prev_j + 1), p_j];
//   * every anchor a (an entry with c0 <= p_a < c0 + clen) counts the
//     intervals that contain p_a;
//   * the chunk writes best = the largest count and first / last = the
//     lowest / highest anchor position reaching it, or (-1, c0, c0) when
//     it has no anchor.
// A chunk whose range leaves [0, M) or whose fragment row is not in
// [0, F) reads nothing: it writes (-1, c0, c0) and sets *range_bad to 1,
// which the caller reads with the pass's other flags (no host sync here).
//
// What bounds it on the card: each chunk reads its range (three 4-byte
// planes, up to rmax entries) with scattered starts across the index, and
// then does shared-memory work per anchor: an anchor is stabbed only by
// entries within cmw positions after it, a few hundred entries at the
// default parameters, so the count is O(anchors x entries per window) of
// shared-memory reads.  Arithmetic is negligible.
//
// What the design does about it: one thread block per chunk.  The block
// stages the sketch row and then the range as (start or +BIG, p) pairs in
// dynamic shared memory, so the global range is read once, coalesced,
// and every later pass over it hits shared memory.  Positions ascend
// inside a range (ranges are clamped to one contig), so an anchor's count
// walks forward from the anchor and stops at the first entry with
// p_j >= p_a + cmw.  An empty chunk returns before touching memory, which
// makes the padding slots of the chunk budget almost free.  The block
// reduction of (best, first, last) is integer max/min, so the result does
// not depend on the order in which threads finish.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBig = 1 << 30;

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

__host__ __device__ __forceinline__ int sketch_words(int S) {
    return (S + 3) & ~3;  // keep the range planes 16-byte aligned
}

__global__ void __launch_bounds__(kThreads)
l2_chunks_kernel(const uint32_t* __restrict__ q, const int* __restrict__ s_sizes,
                 int S, const uint32_t* __restrict__ mini_hash,
                 const int* __restrict__ mini_wpos,
                 const int* __restrict__ mini_prev,
                 const int* __restrict__ lo_arr, const int* __restrict__ rlen_arr,
                 const int* __restrict__ frag_arr, const int* __restrict__ c0_arr,
                 const int* __restrict__ clen_arr, int cmw, int rmax, int M,
                 int F, int* __restrict__ best_out, int* __restrict__ first_out,
                 int* __restrict__ last_out, int* __restrict__ range_bad) {
    extern __shared__ int smem[];
    __shared__ Best warp_best[kWarps];

    const int i = blockIdx.x;
    const int tid = threadIdx.x;
    const int c0 = c0_arr[i];
    const int clen = clen_arr[i];
    const int n = min(rlen_arr[i], rmax);
    const int f = frag_arr[i];
    const int64_t base = lo_arr[i];
    const bool bad = base < 0 || base + max(n, 0) > M || f < 0 || f >= F;
    if (bad || n <= 0 || clen <= 0) {
        if (tid == 0) {
            best_out[i] = -1;
            first_out[i] = c0;
            last_out[i] = c0;
            if (bad) *range_bad = 1;  // every writer stores the same value
        }
        return;
    }

    uint32_t* qs = reinterpret_cast<uint32_t*>(smem);
    int* st = smem + sketch_words(S);  // interval start, +BIG if not in sketch
    int* pp = st + rmax;               // window position

    const int s_eff = min(s_sizes[f], S);
    const uint32_t* qrow = q + static_cast<int64_t>(f) * S;
    for (int t = tid; t < s_eff; t += kThreads) qs[t] = qrow[t];
    __syncthreads();

    for (int j = tid; j < n; j += kThreads) {
        const uint32_t h = mini_hash[base + j];
        const int p = mini_wpos[base + j];
        int a = 0, b = s_eff;  // lower bound of h in qs[0, s_eff)
        while (a < b) {
            const int mid = (a + b) >> 1;
            if (qs[mid] < h) a = mid + 1; else b = mid;
        }
        const bool in_sketch = a < s_eff && qs[a] == h;
        st[j] = in_sketch ? max(p - (cmw - 1), mini_prev[base + j] + 1) : kBig;
        pp[j] = p;
    }
    __syncthreads();

    Best mine{-1, kBig, -kBig};
    const int64_t c_end = static_cast<int64_t>(c0) + clen;
    for (int a = tid; a < n; a += kThreads) {
        const int pa = pp[a];
        if (pa < c0 || pa >= c_end) continue;
        const int64_t reach = static_cast<int64_t>(pa) + cmw;
        int count = 0;
        for (int j = a; j < n; ++j) {
            const int pj = pp[j];
            if (pj >= reach) break;  // start_j >= pj - cmw + 1 > pa from here on
            count += (st[j] <= pa) & (pj >= pa);
        }
        // equal positions before the anchor (never in a store whose
        // positions strictly ascend, kept so the count is exact anyway)
        for (int j = a - 1; j >= 0 && pp[j] >= pa; --j) count += st[j] <= pa;
        mine = merge(mine, Best{count, pa, pa});
    }

    for (int off = 16; off > 0; off >>= 1) {
        Best other{__shfl_down_sync(0xffffffffu, mine.best, off),
                   __shfl_down_sync(0xffffffffu, mine.first, off),
                   __shfl_down_sync(0xffffffffu, mine.last, off)};
        mine = merge(mine, other);
    }
    if ((tid & 31) == 0) warp_best[tid >> 5] = mine;
    __syncthreads();
    if (tid == 0) {
        Best all = warp_best[0];
        for (int w = 1; w < kWarps; ++w) all = merge(all, warp_best[w]);
        const bool none = all.best < 0;
        best_out[i] = all.best;
        first_out[i] = none ? c0 : all.first;
        last_out[i] = none ? c0 : all.last;
    }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs for a sketch width S and a range
// capacity rmax.
long long l2_chunks_smem_bytes(int S, int rmax) {
    return 4LL * (sketch_words(S) + 2LL * rmax);
}

// Largest dynamic shared memory a block of this kernel may opt into on
// `device` (the opt-in limit less the kernel's static shared memory).
long long l2_chunks_smem_limit(int device) {
    int v = 0;
    if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
        cudaSuccess)
        return 0;
    return v - static_cast<long long>(sizeof(Best)) * kWarps;
}

const char* l2_chunks_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launches one block per chunk on `stream`; returns cudaGetLastError().
// `range_bad` is one int the caller zeroed; M is the store length and F
// the number of sketch rows.
int l2_chunks_launch(const void* q, const void* s_sizes, int S,
                     const void* mini_hash, const void* mini_wpos,
                     const void* mini_prev, const void* lo,
                     const void* rlen, const void* frag, const void* c0,
                     const void* clen, int N, int cmw, int rmax, int M, int F,
                     void* best, void* first, void* last, void* range_bad,
                     void* stream) {
    if (N <= 0) return 0;
    const long long smem = l2_chunks_smem_bytes(S, rmax);
    cudaError_t err = cudaFuncSetAttribute(
        l2_chunks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    l2_chunks_kernel<<<N, kThreads, static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(q), static_cast<const int*>(s_sizes), S,
        static_cast<const uint32_t*>(mini_hash), static_cast<const int*>(mini_wpos),
        static_cast<const int*>(mini_prev), static_cast<const int*>(lo),
        static_cast<const int*>(rlen), static_cast<const int*>(frag),
        static_cast<const int*>(c0), static_cast<const int*>(clen), cmw, rmax, M, F,
        static_cast<int*>(best), static_cast<int*>(first), static_cast<int*>(last),
        static_cast<int*>(range_bad));
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
