"""The EIrate and class-axis EIrate kernels' CUDA sources, run on the CPU.

A CUDA kernel has no CPU mode, so the card tests (``test_torch_cuda.py``)
are where ``csrc/ei_score.cu`` and ``csrc/ei_classes.cu`` are held to their
plain versions.  Their tile body (``ei_column.cuh``'s ``tile_totals``)
spreads each column's tenant sum over a block: warp ballots, a block-wide
scan, terms dealt out over the threads and one owner a column adding them
in ascending tenant order.  This file compiles the two sources with the
host's C++ compiler against a small emulation of the CUDA features they
use (one ``std::thread`` per CUDA thread, barriers for ``__syncthreads``,
ballots and shuffles) and holds every score bit-equal to the same
header's ``ei_total_column``, the one-thread sum in ascending order that
defines the result, with the same epilogues.  It runs each kernel over
membership layouts, sizes and row alignments that reach every branch of
the tile body; it skips where no C++20 compiler is found.
"""

import re
import shutil
import subprocess
from pathlib import Path

import pytest

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "kernels" / "csrc"

CUDA_RUNTIME = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>
using std::isfinite;
using std::max;
using std::min;
#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(x)
#define __restrict__
typedef void* cudaStream_t;
enum { cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return 0; }
struct uint4 { unsigned x, y, z, w; };
inline uint4 make_uint4(unsigned a, unsigned b, unsigned c, unsigned d) {
  return {a, b, c, d};
}
struct Dim { int x = 0; };
inline thread_local Dim threadIdx, blockIdx;
template <class T> inline T __ldg(const T* p) { return *p; }
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __ffs(unsigned v) { return __builtin_ffs(v); }
struct Block {
  std::unique_ptr<std::barrier<>> all;
  std::vector<std::unique_ptr<std::barrier<>>> warps;
  std::vector<unsigned> slot;
};
inline Block block;
inline void __syncthreads() { block.all->arrive_and_wait(); }
inline unsigned warp_exchange(unsigned v, int from) {
  const int t = threadIdx.x, w = t / 32;
  block.slot[t] = v;
  block.warps[w]->arrive_and_wait();
  const unsigned got = block.slot[w * 32 + from];
  block.warps[w]->arrive_and_wait();
  return got;
}
inline unsigned __ballot_sync(unsigned, unsigned pred) {
  const int t = threadIdx.x, w = t / 32;
  block.slot[t] = pred != 0;
  block.warps[w]->arrive_and_wait();
  unsigned b = 0;
  for (int l = 0; l < 32; ++l) b |= block.slot[w * 32 + l] << l;
  block.warps[w]->arrive_and_wait();
  return b;
}
inline int __shfl_up_sync(unsigned, int v, int d) {
  const int lane = threadIdx.x % 32;
  const int got = static_cast<int>(warp_exchange(v, lane >= d ? lane - d : lane));
  return lane >= d ? got : v;
}
template <class K, class... A>
void emu_launch(int blocks, int threads, K kernel, A... args) {
  for (int b = 0; b < blocks; ++b) {
    block.all = std::make_unique<std::barrier<>>(threads);
    block.warps.clear();
    for (int w = 0; w < threads / 32; ++w)
      block.warps.push_back(std::make_unique<std::barrier<>>(32));
    block.slot.assign(threads, 0u);
    std::vector<std::thread> ts;
    for (int t = 0; t < threads; ++t)
      ts.emplace_back([=] { threadIdx.x = t; blockIdx.x = b; kernel(args...); });
    for (auto& th : ts) th.join();
  }
}
"""

HARNESS = r"""
#include <cstdio>
#include <random>
#include "ei_column.cuh"
extern "C" int eirate_launch(const float*, const float*, const float*,
                             const unsigned char*, const float*,
                             const unsigned char*, float*, int, int, void*);
extern "C" int eirate_classes_launch(const float*, const float*, const float*,
                                     const unsigned char*, const float*,
                                     const unsigned char*, float*, int, int,
                                     int, void*);
enum Layout { kDense, kDisjoint, kAll, kOrder };
static int failed = 0;
static bool classes = false;   // run eirate_classes_launch, else eirate_launch
// N tenants, n models, membership at byte `offset` of its buffer, C classes
static void run(const char* name, int N, int n, Layout layout, int offset,
                int C, unsigned seed) {
  std::mt19937 g(seed);
  std::normal_distribution<float> nd;
  std::uniform_real_distribution<float> ud(0.f, 1.f);
  std::vector<float> mu(n), sg(n), best(N), cost(n), cm(size_t(C) * n);
  std::vector<unsigned char> sel(n), buf(size_t(N) * n + 32);
  unsigned char* mem = buf.data() + offset;
  for (int x = 0; x < n; ++x) {
    mu[x] = nd(g);
    sg[x] = ud(g) < 0.125f ? 0.f : std::fabs(nd(g));
    cost[x] = 0.3f + 2.7f * ud(g);
    sel[x] = ud(g) < 0.25f;
  }
  for (int i = 0; i < N; ++i)
    best[i] = layout == kOrder ? -std::ldexp(1.f, int(ud(g) * 40) - 20)
                               : 0.5f + 0.5f * nd(g);
  for (int i = 0; i < N; ++i)
    for (int x = 0; x < n; ++x) {
      const bool owner = long(x) * N / n == i;
      unsigned char v = layout == kDisjoint ? owner
                        : layout == kAll    ? 1
                                            : ud(g) < 0.4f;
      if (layout == kOrder && v) v = 2;          // any nonzero byte is a member
      mem[size_t(i) * n + x] = v;
    }
  for (int c = 0; c < C; ++c)
    for (int x = 0; x < n; ++x)
      cm[size_t(c) * n + x] = c == 1 && x % 5 == 0 ? INFINITY : cost[x] * (c + 1);
  std::vector<float> out(n), outc(size_t(C) * n);
  if (classes)
    eirate_classes_launch(mu.data(), sg.data(), best.data(), mem, cm.data(),
                          sel.data(), outc.data(), N, n, C, nullptr);
  else
    eirate_launch(mu.data(), sg.data(), best.data(), mem, cost.data(),
                  sel.data(), out.data(), N, n, nullptr);
  int bad = 0;
  for (int x = 0; x < n; ++x) {
    const float tot =
        ei::ei_total_column(mu.data(), sg.data(), best.data(), mem, N, n, x);
    const float want = sel[x] ? ei::kSelected : ei::ftz(tot / cost[x]);
    if (!classes) bad += std::memcmp(&want, &out[x], 4) != 0;
    for (int c = 0; classes && c < C; ++c) {
      const float cx = cm[size_t(c) * n + x];
      const float wc =
          sel[x] || !std::isfinite(cx) ? ei::kSelected : ei::ftz(tot / cx);
      bad += std::memcmp(&wc, &outc[size_t(c) * n + x], 4) != 0;
    }
  }
  std::printf("%s N=%d n=%d offset=%d C=%d: %s\n", name, N, n, offset, C,
              bad ? "FAIL" : "ok");
  failed += bad != 0;
}
int main(int argc, char** argv) {
  classes = argc > 1 && std::strcmp(argv[1], "classes") == 0;
  run("disjoint", 50, 600, kDisjoint, 0, 2, 1);       // 4-byte row loads
  run("dense", 50, 400, kDense, 0, 1, 2);             // 16-byte row loads
  run("tenant_blocks", 256, 512, kDisjoint, 0, 1, 3);
  run("one_tenant", 1, 100, kDense, 0, 1, 4);
  run("ragged_chunk", 33, 96, kDense, 0, 2, 5);
  run("two_slabs", 1000, 64, kDense, 0, 4, 6);
  run("two_slabs_disjoint", 1000, 160, kDisjoint, 0, 1, 7);
  run("below_a_tile", 3, 17, kDense, 0, 1, 8);        // byte row loads
  run("n513", 100, 513, kDense, 0, 3, 9);
  run("order", 40, 300, kOrder, 0, 2, 10);
  run("all_members", 50, 100, kAll, 0, 3, 11);
  run("base_plus_1", 20, 96, kDense, 1, 1, 12);
  run("base_plus_4", 20, 96, kDense, 4, 1, 13);
  run("many_slabs", 2100, 33, kOrder, 0, 2, 14);
  run("many_slabs_all", 777, 64, kAll, 0, 1, 15);
  std::printf(failed ? "FAILED %d\n" : "ALL OK\n", failed);
  return failed != 0;
}
"""


def _compiler():
    for cxx in ("g++", "clang++"):
        path = shutil.which(cxx)
        if path:
            return path
    pytest.skip("no C++ compiler on this machine")


@pytest.mark.parametrize("kernel", ["eirate", "classes"])
def test_tile_body_equals_ei_total_column_in_emulation(tmp_path, kernel):
    """The kernel, compiled for the CPU, scores every column bit-equal to
    ``ei_total_column`` and its epilogue."""
    cxx = _compiler()
    shutil.copy(CSRC / "ei_column.cuh", tmp_path / "ei_column.cuh")
    (tmp_path / "cuda_runtime.h").write_text(CUDA_RUNTIME)
    (tmp_path / "harness.cpp").write_text(HARNESS)
    sources = [tmp_path / "harness.cpp"]
    for name in ("ei_score", "ei_classes"):
        text = (CSRC / f"{name}.cu").read_text()

        def launch(m):
            grid, threads = m.group(2).split(", ")[:2]
            return f"emu_launch({grid}, {threads}, {m.group(1)}, "

        text, count = re.subn(r"(\w+<T::kVec>)\s*<<<(.*?)>>>\(",
                              launch, text, flags=re.S)
        assert count == 1, f"{name}.cu: expected one kernel launch"
        (tmp_path / f"{name}.cpp").write_text(text)
        sources.append(tmp_path / f"{name}.cpp")
    binary = tmp_path / "emu"
    build = subprocess.run([cxx, "-std=c++20", "-O1", "-pthread", "-I",
                            str(tmp_path), "-o", str(binary), *map(str, sources)],
                           capture_output=True, text=True, timeout=300)
    if build.returncode != 0 and "c++20" in build.stderr:
        pytest.skip(f"{cxx} does not take C++20")
    assert build.returncode == 0, build.stderr[-3000:]
    run = subprocess.run([str(binary), kernel], capture_output=True, text=True,
                         timeout=300)
    assert run.returncode == 0 and run.stdout.strip().endswith("ALL OK"), run.stdout
