// The emulation's globals: thread and block indices, the grid's size,
// the block's and its warps' barriers, the shuffles' slots, the SM count, the launch
// error, the cp.async mode and groups, and shared memory (the extern
// __shared__ arrays of the kernels, 227 KB each); and the scheduler that
// runs a block's CUDA threads as fibers of the calling OS thread.
#include <cuda_runtime.h>
#include <mma_tiles.cuh>

#include <cstdio>
#include <sys/mman.h>
#include <ucontext.h>

dim3 threadIdx;
dim3 blockIdx;
dim3 gridDim;
EmuBarrier* emu_barrier;
std::deque<EmuBarrier>* emu_warp_barriers;
uint64_t emu_shfl_slots[1024];
int emu_error;
extern "C" int emu_sm_count = 132;
extern "C" int emu_defer = 0;
std::vector<mma::Copy> mma::open_groups[1024];
std::deque<std::vector<mma::Copy>> mma::groups_of[1024];
alignas(16) float smem_f32[kEmuSharedBytes / sizeof(float)];
alignas(16) unsigned char smem_raw[kEmuSharedBytes];
std::function<void()>* emu_body;

namespace {

constexpr size_t kStack = 256 << 10;  // a fiber's stack

struct Fiber {
  ucontext_t ctx;
  EmuBarrier* wait_on;  // the barrier it waits at, or null
  unsigned wait_gen;    // that barrier's generation when it arrived
  bool done;
};
Fiber fibers[1024];
char* stacks;  // 1024 stacks, mapped once, touched as they grow
ucontext_t sched;
int current;
int order[1024];
uint64_t rng = 0x9e3779b97f4a7c15ull;  // the scheduler's shuffles

void fiber_main() {
  (*emu_body)();
  fibers[current].done = true;
}  // returns to `sched` through uc_link

}  // namespace

void emu_wait(EmuBarrier* b, unsigned gen) {
  Fiber& f = fibers[current];
  f.wait_on = b;
  f.wait_gen = gen;
  swapcontext(&f.ctx, &sched);
}

void emu_run_block(int threads) {
  if (!stacks) {
    void* p = mmap(nullptr, kStack * 1024, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
    if (p == MAP_FAILED) {
      std::fprintf(stderr, "emulation: no memory for the fibers' stacks\n");
      std::abort();
    }
    stacks = (char*)p;
  }
  for (int t = 0; t < threads; ++t) {
    Fiber& f = fibers[t];
    getcontext(&f.ctx);
    f.ctx.uc_stack.ss_sp = stacks + kStack * t;
    f.ctx.uc_stack.ss_size = kStack;
    f.ctx.uc_link = &sched;
    makecontext(&f.ctx, fiber_main, 0);
    f.wait_on = nullptr;
    f.done = false;
    mma::open_groups[t].clear();
    mma::groups_of[t].clear();
  }
  // passes over the fibers free to run (not done, and not waiting at a
  // barrier whose generation is still the one they arrived in), each pass
  // in an order shuffled by a generator of fixed seed
  for (int t = 0; t < threads; ++t) order[t] = t;
  for (int live = threads; live;) {
    bool ran = false;
    for (int k = threads - 1; k > 0; --k) {
      rng ^= rng << 13;
      rng ^= rng >> 7;
      rng ^= rng << 17;
      std::swap(order[k], order[rng % (k + 1)]);
    }
    for (int k = 0; k < threads; ++k) {
      const int t = order[k];
      Fiber& f = fibers[t];
      if (f.done || (f.wait_on && f.wait_on->gen == f.wait_gen)) continue;
      f.wait_on = nullptr;
      current = t;
      threadIdx = dim3(t);
      swapcontext(&sched, &f.ctx);
      ran = true;
      live -= f.done;
    }
    if (!ran) {
      std::fprintf(stderr, "emulation: block (%u, %u, %u) hangs: %d of %d "
                   "threads wait at a barrier the others never reach\n",
                   blockIdx.x, blockIdx.y, blockIdx.z, live, threads);
      std::abort();
    }
  }
}
