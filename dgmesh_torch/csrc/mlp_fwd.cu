// Fused MLP trunk, forward — CUDA C++ for Hopper (sm_90a).
//
// Replaces the TPU kernel dgmesh_tpu/ops/mlp_pallas.py::_fwd_kernel
// (reached through fused_trunk / _trunk_fwd_impl).
//
// What it computes, for rows x (n, din) float32, din <= 256, read as if
// zero-padded to 256 lanes and rounded to bf16 (nearest even):
//   h_0 = x;  for layer i = 0..7:
//     y   = h_i · W[i]  (+ x · W[8] at layer 5, the skip's x-part)
//     h_{i+1} = bf16(relu(y + b[i]))
//   out = h_8 as float32, (n, 256).
// W[i] (in,out) per layer, read from the stage pack (the wrapper's
// stage_pack: W[i]ᵀ in 64-column stages, bf16); bpack (8,256) float32.  The products of bf16
// operands are exact and summed in float32 (tensor-core wgmma with float32
// accumulators); the bias add and ReLU are float32, then one rounding to
// bf16, as in the TPU kernel.  Only the order of the float32 sums differs
// from the plain twin, so an activation may round to the neighbouring bf16
// value now and then.
//
// What bounds it on the H100: operations.  A row costs 2·(7·256² + 2·din·256)
// flops (the padded lanes need none); at the main path's 479,974 rows and
// din 93 that is 0.49 TFLOP, 0.49 ms at the 989 TFLOP/s bf16 tensor-core
// peak, against 0.20 ms for the 670 MB of rows in and out at 3.35 TB/s.
//
// Design: one CTA of two warpgroups per 128 rows keeps the rows' bf16 input
// and activation in shared memory through all 8 layers, each warpgroup
// 64 rows x 256 columns of every product on wgmma m64n256k16, both operands
// read by descriptor from 128-byte-swizzled K-major tiles (mlp_wgmma.cuh).
// The only device-memory traffic is x in and the output; the weights
// stream from L2.  x's 64-lane blocks past din are zero, so layer 0 and the
// skip's x-part multiply only the kx = ceil(din/64) blocks that hold input
// lanes, and only their weight stages are streamed: 28 + 2·kx chunks a CTA
// (32 of 36 at din 93), and X holds kx blocks.  Skipping them is exact: the
// skipped products are zeros.  The last layer's epilogue writes float32
// rows < n straight from the accumulators: each 4 threads fill one 32-byte
// sector.
//
// Weights.  Every CTA multiplies the same sequence of [256][64] weight
// stages, so CTAs run in clusters of two that share it: each loads half of
// every stage and multicasts it into both CTAs' ring, which halves the L2
// stream a row (a CTA's share: 0.52 MB of the 1.05 MB at din 93).  The
// wrapper lays the stages out in device memory as they lie in shared memory
// (stage_pack: each one 32 KB, contiguous, already swizzled), so one thread
// copies a half with one bulk copy (cp.async.bulk, the TMA's plain form)
// and no thread spends instructions on addresses.  The ring, two chunks
// ahead: full[s] completes when both halves of a stage have landed (the
// bulk copies' byte counts); empty[s] when both CTAs are done with the
// chunk that last used it (each CTA's thread 0 arrives on its own and on
// the other CTA's, after the CTA-wide barrier that also publishes the
// epilogue's stores to wgmma).  Thread 0 waits for the other CTA and
// refills the stage while the next chunk's wgmmas run.  At din <= 128 the
// ring has four stages and each chunk's wgmmas are left running while the
// next chunk's are issued (waited for only before an epilogue), so the
// tensor cores do not drain at every chunk; at din > 128 X takes that
// room: three stages, each chunk waited for.  Every wait is bounded: a
// wait that gives up marks the CTA, which traps at its end, so that a
// pipeline that stops ends the launch with an error instead of hanging the
// card.

#include "mlp_common.cuh"
#include "mlp_wgmma.cuh"

namespace {

using namespace mlp;

constexpr int CLUSTER = 2;              // CTAs sharing each weight stage
constexpr uint32_t STAGE_BYTES = wg::STAGE * sizeof(bf16);
constexpr uint32_t HALF_BYTES = STAGE_BYTES / CLUSTER;

constexpr uint32_t MAX_POLLS = 1u << 22;   // a wait that gives up (seconds)

// H, a ring of `ring` stages, kx blocks of X, then the ring's mbarriers
// and the fault word; + room to align the tiles to 1 KB.  Four stages fit
// beside X when kx <= 2 (din <= 128, every trunk of the model), else three.
constexpr size_t smem_bytes(int ring, int kx) {
  return (size_t)(wg::TILE + ring * wg::STAGE + kx * wg::SUB) * sizeof(bf16) +
         (2 * ring + 1) * sizeof(uint64_t) + 1024;
}
constexpr int ring_for(int kx) { return kx <= 2 ? 4 : 3; }
static_assert(smem_bytes(4, 2) <= 232448 && smem_bytes(3, 4) <= 232448, "shared memory");

// The forward's chunk order when only the first kx 64-column blocks of x
// are multiplied: fwd_chunks(kx) chunks, the groups that read x, 0 (layer
// 0) and SKIP + 2 (the skip's x-part), kx each, the others 4.  fwd_chunk
// gives chunk c's group q (its matrix fwd_mat(q)) and its block k within
// the group, in the order of the kernel's loops.
__host__ __device__ constexpr int fwd_chunks(int kx) { return CHUNKS - 2 * (wg::KB - kx); }
__device__ __forceinline__ void fwd_chunk(int c, int kx, int& q, int& k) {
  const int a = c - kx, b = a - (SKIP + 1) * wg::KB, d = b - kx;
  if (a < 0) {
    q = 0, k = c;
  } else if (b < 0) {
    q = 1 + a / wg::KB, k = a % wg::KB;
  } else if (d < 0) {
    q = SKIP + 2, k = b;
  } else {
    q = SKIP + 3 + d / wg::KB, k = d % wg::KB;
  }
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Wait for the completion of bar's phase of this parity (cluster scope:
// the other CTA's arrivals are ordered before what follows); after
// MAX_POLLS polls give up and set *fault.  No trap here: wgmmas run on
// across these waits, and a trap on their path makes ptxas serialise them.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity, uint64_t* fault) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done && polls < MAX_POLLS; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
  if (!done) *reinterpret_cast<volatile uint64_t*>(fault) = 1;
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of both CTAs: all shared-memory writes and barrier inits
// before it are visible to the cluster after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The kernel's weight pipe: the ring of RING stages shared by the
// cluster's two CTAs, filled by bulk copies from the stage pack ws
// (stage_pack's layout: stage m·4 + k is rows n, columns 64k.. of W[m]ᵀ,
// swizzled).  With four stages one chunk's products run on into the next
// chunk (PENDING), so a stage is freed one chunk later (LAG); either way
// LEAD = 2 chunks are loading ahead of the one multiplied.
template <int RING>
struct ClusterRing {
  static constexpr int PENDING = RING - 3;
  static constexpr int LAG = PENDING + 1;     // chunk c frees the stage of chunk c - LAG
  static constexpr int LEAD = RING - LAG;
  static_assert(RING == 3 || RING == 4, "three or four stages");

  bf16* stages;
  uint64_t* full;               // [RING]: both halves of the stage landed
  uint64_t* empty;              // [RING]: both CTAs past the stage's chunk
  uint64_t* fault;              // set by a wait that gave up
  const bf16* ws;
  int total, kx;
  uint32_t rank;

  // Thread 0: this CTA's half of chunk c, into stage c % RING of both
  // CTAs, counted by each one's full barrier; this CTA's full barrier is
  // armed for the stage's two halves.
  __device__ __forceinline__ void issue(int c) const {
    int q, k;
    fwd_chunk(c, kx, q, k);
    const int s = c % RING;
    const char* src = reinterpret_cast<const char*>(ws + (size_t)(fwd_mat(q) * wg::KB + k) *
                                                             wg::STAGE) + rank * HALF_BYTES;
    const uint32_t dst = smem_addr(stages + s * wg::STAGE) + rank * HALF_BYTES;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(full + s)), "r"(STAGE_BYTES) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
        "[%0], [%1], %2, [%3], %4;\n"
        :: "r"(dst), "l"(src), "r"(HALF_BYTES), "r"(smem_addr(full + s)),
           "h"((uint16_t)((1u << CLUSTER) - 1))
        : "memory");
  }

  // Thread 0: chunks 0 .. LEAD - 1.
  __device__ __forceinline__ void start() const {
    if (threadIdx.x == 0)
      for (int c = 0; c < LEAD; ++c) issue(c);
  }

  // Wait for chunk c and publish this thread's shared-memory writes to
  // wgmma; then, every thread of this CTA being done with chunk c - LAG,
  // thread 0 frees that chunk's stage in both CTAs (its next chunk is
  // c + LEAD).  Returns chunk c's stage.
  __device__ __forceinline__ const bf16* next(int c) const {
    const int s = c % RING;
    mbar_wait(full + s, (c / RING) & 1, fault);
    wg::fence_proxy_async();
    __syncthreads();
    if (threadIdx.x == 0 && c >= LAG && c + LEAD < total) {   // its stage held c - LAG
      const uint32_t bar = smem_addr(empty + (c + LEAD) % RING);
      uint32_t peer;
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                   : "=r"(peer) : "r"(bar), "r"(rank ^ 1));
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
      asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
                   :: "r"(peer) : "memory");
    }
    return stages + s * wg::STAGE;
  }

  // While chunk c multiplies, thread 0 waits for the other CTA to free the
  // stage of chunk c - LAG too and refills it with chunk c + LEAD, so that
  // the wait between the two CTAs stays off the tensor cores' path.
  __device__ __forceinline__ void beside(int c) const {
    if (threadIdx.x == 0 && c + LEAD < total) {
      if (c >= LAG) mbar_wait(empty + (c + LEAD) % RING, ((c - LAG) / RING) & 1, fault);
      issue(c + LEAD);
    }
    __syncwarp();               // warp 0 whole again for wgmma.wait_group
  }
};

template <int RING>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 1)
mlp_fwd_kernel(const float* __restrict__ x, const bf16* __restrict__ ws,
               const float* __restrict__ b, float* __restrict__ out, int n, int din) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  bf16* H = reinterpret_cast<bf16*>(smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023));
  bf16* stages = H + wg::TILE;
  const int kx = (din + KC - 1) / KC;
  bf16* X = stages + RING * wg::STAGE;
  uint64_t* bars = reinterpret_cast<uint64_t*>(X + kx * wg::SUB);
  const int row0 = blockIdx.x * BM;
  const ClusterRing<RING> ring{stages, bars, bars + RING, bars + 2 * RING, ws,
                               fwd_chunks(kx), kx, cluster_rank()};

  if (threadIdx.x == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(ring.full + s, 1);
      mbar_init(ring.empty + s, CLUSTER);
    }
    *ring.fault = 0;
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();               // the barriers exist in both CTAs before any copy
  ring.start();
  wg::stage_x(X, x, n, din, row0, kx);

  // relu(acc + b) of this thread's elements, rounded to bf16: into H (each
  // warpgroup reads and writes only its own rows of it), or after the last
  // layer as float32 rows < n of out
  float acc[32][4];
  const auto epilogue = [&](int layer) {
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int col = wg::acc_col(j);
      const float b0 = b[layer * W + col], b1 = b[layer * W + col + 1];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = wg::acc_row(half);
        const bf162 h = __floats2bfloat162_rn(relu(acc[j][2 * half] + b0),
                                              relu(acc[j][2 * half + 1] + b1));
        if (layer < DEPTH - 1) {
          *reinterpret_cast<bf162*>(H + wg::tile_at(row, col)) = h;
        } else if (row0 + row < n) {
          *reinterpret_cast<float2*>(out + (size_t)(row0 + row) * W + col) =
              make_float2(__low2float(h), __high2float(h));
        }
      }
    }
  };
  // each layer: acc = h·W (+ x·W_x at layer SKIP + 1), x's products over its
  // kx blocks only; with PENDING a chunk's wgmmas run on while the next
  // chunk's are issued, and drain at the end of each chunk group, outside
  // any branch
  constexpr int PENDING = ClusterRing<RING>::PENDING;
  int c = 0;
  for (int q = 0; q <= DEPTH; ++q) {            // chunk groups, in fwd_mat's order
    const int mat = fwd_mat(q);
    const bool reads_x = q == 0 || mat == DEPTH;
    const int nk = reads_x ? kx : wg::KB;
    for (int k = 0; k < nk; ++k, ++c) {
      const bf16* st = ring.next(c);
      wg::mma_chunk<PENDING>(acc, (reads_x ? X : H) + k * wg::SUB, st, k == 0 && mat != DEPTH,
                             [&] { ring.beside(c); });
    }
    if (PENDING) wg::mma_wait_all(acc);
    if (mat != SKIP + 1) epilogue(mat == DEPTH ? SKIP + 1 : mat);
  }
  cluster_sync();               // no copy or arrival into a CTA that has left
  if (*reinterpret_cast<volatile uint64_t*>(ring.fault)) __trap();
}

}  // namespace

template <int RING>
static int launch(const float* x, const bf16* ws, const float* b, float* out, int n, int din,
                  int kx, cudaStream_t stream) {
  const size_t smem = smem_bytes(RING, kx);
  cudaError_t e = cudaFuncSetAttribute(mlp_fwd_kernel<RING>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n + BM - 1) / BM;
  mlp_fwd_kernel<RING><<<(blocks + CLUSTER - 1) / CLUSTER * CLUSTER, THREADS, smem, stream>>>(
      x, ws, b, out, n, din);
  return (int)cudaGetLastError();
}

// x (n,din) f32, wpacks (36,256,64) bf16 (stage_pack: the forward's
// weight stages as they lie in shared memory), bpack (8,256) f32 → out
// (n,256) f32; contiguous, on the device, wpacks 16-byte aligned.  Launches
// on `stream`, in clusters of two CTAs (a last CTA past n when the row
// blocks are odd); returns the launch's cudaError_t.
extern "C" int mlp_fwd_launch(const float* x, const void* wpacks, const float* bpack,
                              float* out, int n, int din, void* stream) {
  if (n <= 0) return 0;
  if (din <= 0 || din > W) return (int)cudaErrorInvalidValue;
  const int kx = (din + KC - 1) / KC;
  const bf16* ws = static_cast<const bf16*>(wpacks);
  return ring_for(kx) == 4 ? launch<4>(x, ws, bpack, out, n, din, kx, (cudaStream_t)stream)
                           : launch<3>(x, ws, bpack, out, n, din, kx, (cudaStream_t)stream);
}
