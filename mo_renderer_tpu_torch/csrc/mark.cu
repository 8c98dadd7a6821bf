// Pass markers for the device trace of a captured frame.
//
// Replaces no TPU kernel.  A replayed frame is one cudaGraphLaunch, so a
// host range cannot split it by pass.  While the port's tracer is on,
// kernels/mark.py pass_span launches mo_mark_kernel<k> into the graph
// being captured where pass k of mark.PASSES starts, and where it ends the
// marker of the pass it returns to (k = mark.END after the program's last
// operation).  The kernel's name carries the pass, so in a profiler's
// device trace each replayed pass's operations lie between its marker and
// the next one.
//
// What bounds it: nothing but the launch; one thread does nothing.  With
// the tracer off nothing launches it.
#include <cuda_runtime.h>

#include <utility>

template <int K>
__global__ void mo_mark_kernel() {}

namespace {

// the markers: one a pass of kernels/mark.py PASSES, and END after them
constexpr int kMarks = 13;

template <int K>
void launch(cudaStream_t s) {
  mo_mark_kernel<K><<<1, 1, 0, s>>>();
}

using Launcher = void (*)(cudaStream_t);

template <int... Ks>
void launch_at(int k, cudaStream_t s, std::integer_sequence<int, Ks...>) {
  static constexpr Launcher at[] = {&launch<Ks>...};
  at[k](s);
}

}  // namespace

extern "C" int mo_mark(int k, void* stream) {
  if (k < 0 || k >= kMarks) return (int)cudaErrorInvalidValue;
  launch_at(k, (cudaStream_t)stream, std::make_integer_sequence<int, kMarks>{});
  return (int)cudaGetLastError();
}
