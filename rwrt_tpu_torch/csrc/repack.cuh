// Live lanes repacked into full warps, on a persistent grid: the whole-run
// dense kernel's schedule (dense_run.cu) and the whole-run exact kernel's
// with a float64 state (exact_run.cu), shared.
//
// A lane of an integrator kernel is a serial chain of loop iterations
// (trips and group changes), and lanes differ in their number. A warp
// issues every instruction for its 32 threads until its slowest lane
// leaves, so with one thread (or team of threads) a lane in launch order
// the issue slots of finished lanes are spent idle. Where a trip's
// arithmetic is what the SMs run out of (float64: the FP64 pipes), those
// slots are the launch's time. This is the card's form of the JAX
// package's peel and bucket schedulers (a vector of lanes there pays its
// slowest lane as a warp does here; both change no bit of a lane).
//
// run_lanes<B, I>(policy, R, queue, every, trigger): a persistent grid of
// the blocks the card keeps resident, each of B threads, B / I::kThreads
// lane slots (a team instance's lane is I::kThreads threads, ray_rhs.cuh),
// deals each block an even share of the R lanes; lanes beyond the slots
// wait in a queue (a global counter the wrapper zeroes). The block then
// alternates:
//   - a window: each live lane runs up to `every` iterations of its loop,
//     or until `trigger` lanes have left the block in the window (a team
//     takes that decision as one, from its first thread's read);
//   - a repack (two barriers): the block counts its live lanes
//     (__ballot_sync, __popc), moves each one's carry through shared memory
//     (the policy's Slots) into the slot of its rank, so that the live
//     lanes take the block's lowest threads in order and emptied warps
//     issue nothing, and fills the freed slots from the queue;
//   - with the policy's kPost, its post-pass over the lanes that left in
//     the window (the dense kernel's (ug, vg) rows), block-wide.
// A lane's arithmetic is the one-thread-a-lane loop's in its order; only
// the thread that runs it changes between windows, and where its carry
// sits meanwhile. A team instance moves whole teams: every thread of a
// team holds the same carry, its first thread saves it, every thread loads
// it.
//
// The policy P (a kernel's lane functions) provides:
//   Lane                        the carry in registers (with its lane
//                               index i);
//   Slots<N>                    N carries in shared memory;
//   start(i, L), finish(L)      a lane's entry and exit;
//   background(L), step(bg, L)  one loop iteration (true: the lane has
//                               closed its last group);
//   save(slots, k, L), load(slots, k, L);
//   kPost                       whether it has a post-pass,
//   post<B>(done, n, tid)       and the post-pass (with kPost only).
#pragma once

#include <cuda_runtime.h>

namespace rwrt {

template <int B, class I, class P>
__device__ __forceinline__ void run_lanes(const P& p, int R, int* queue,
                                          int every, int trigger) {
  constexpr int T = I::kThreads;
  constexpr int N = B / T;  // lane slots a block
  constexpr int kWarps = B / 32;
  static_assert(B % 32 == 0 && 32 % T == 0, "whole warps of whole teams");
  __shared__ typename P::template Slots<N> slots;
  // The lanes that left in a window, by the window's parity: the repack
  // after window w post-passes list w & 1 while window w + 1 fills the
  // other; where the policy has no post-pass, only counted.
  __shared__ int done[2][P::kPost ? N : 1];
  __shared__ int n_done[2];
  __shared__ int warp_live[kWarps];
  __shared__ int grab_base, grab_take;

  const int tid = threadIdx.x;
  const int slot = tid / T;  // this thread's team
  const int warp = tid >> 5;
  const unsigned below = (1u << (tid & 31)) - 1u;
  // The lanes dealt at the start: an even share of R for every block
  // where the grid holds them all, else N a block, the rest queued.
  const long long nblk = gridDim.x;
  const bool deal = R <= nblk * N;
  const long long queued0 = deal ? R : nblk * N;
  bool drained = deal;  // block-uniform: the queue is empty
  bool first = true;
  int parity = 0;  // the current window's done list
  if (tid < 2) n_done[tid] = 0;

  typename P::Lane L;
  bool have = false;  // team-uniform
  for (;;) {
    // Repack. Count the live lanes, warp by warp (whole teams).
    const unsigned live = __ballot_sync(0xffffffffu, have);
    if ((tid & 31) == 0) warp_live[warp] = __popc(live);
    __syncthreads();  // the window is over: carries, rows and lists final
    int n_live = 0, rank = __popc(live & below);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = warp_live[w];
      n_live += c;
      if (w < warp) rank += c;
    }
    n_live /= T;
    rank /= T;
    const int prev = parity;
    parity ^= 1;
    const int nd = n_done[prev];
    // Every live lane's carry into the slot of its rank: the live lanes
    // take the block's lowest threads, in order, and whole warps go idle.
    if (have && I::lead()) p.save(slots, rank, L);
    if (tid == 0) {
      // Refill the free slots: the block's share first, then the queue.
      int base = 0, take = 0;
      if (first) {
        const long long b = blockIdx.x;
        const long long lo = deal ? b * R / nblk : b * N;
        const long long hi = deal ? (b + 1) * R / nblk : (b + 1) * N;
        base = static_cast<int>(lo);
        take = static_cast<int>(hi - lo);
      } else if (!drained && n_live < N) {
        const long long b = queued0 + atomicAdd(queue, N - n_live);
        if (b < R) {
          base = static_cast<int>(b);
          take = static_cast<int>(R - b < N - n_live ? R - b : N - n_live);
        }
      }
      grab_base = base;
      grab_take = take;
      n_done[parity] = 0;
    }
    __syncthreads();  // slots, grab and the next list's count set
    const int base = grab_base, take = grab_take;
    if (!first && take < N - n_live) drained = true;
    first = false;
    if constexpr (P::kPost) p.template post<B>(done[prev], nd, tid);
    if (n_live + take == 0) break;
    have = slot < n_live + take;
    if (slot < n_live) {
      p.load(slots, slot, L);
    } else if (have) {
      p.start(base + slot - n_live, L);
    }
    // The window: up to `every` iterations of each live lane, ended early
    // once `trigger` lanes have left the block in it.
    if (have) {
      const auto& bg = p.background(L);
      const volatile int* left = &n_done[parity];
      for (int k = 0; k < every; ++k) {
        if (p.step(bg, L)) {
          p.finish(L);
          if (I::lead()) {
            const int d = atomicAdd(&n_done[parity], 1);
            if constexpr (P::kPost) done[parity][d] = L.i;
          }
          have = false;
          break;
        }
        if (I::uniform(*left >= trigger)) break;
      }
    }
  }
}

// The persistent grid of kernel `kernel` (blocks of B threads) on the
// current card: out[0] the blocks it keeps resident at once (blocks per SM
// x SMs), out[1] = B.
template <int B, typename K>
int persistent_grid(K* kernel, int* out) {
  int dev = 0, sms = 0, blocks = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, B, 0);
  }
  out[0] = blocks * sms;
  out[1] = B;
  return e;
}

}  // namespace rwrt
