// Section markers: empty <<<1, 1>>> kernels that utils/profiling.py puts
// into a graph captured by capture.py, before and after a span's work, while
// tracing is on. A profiled replay lists them among the card's kernels, and
// the instance's name alone says which span (SECTION, the id that
// profiling.sections() maps to the span's name) and which end (END: 0 the
// begin, 1 the end). They do no work; each costs one graph node.
#include <cuda_runtime.h>

#include <utility>

constexpr int kSections = 32;  // utils/profiling.py: MAX_SECTIONS

template <int SECTION, int END>
__global__ void strided_section_marker() {}

namespace {

template <int... I>
const void* marker_at(int section, int end, std::integer_sequence<int, I...>) {
  static const void* const table[][2] = {
      {reinterpret_cast<const void*>(&strided_section_marker<I, 0>),
       reinterpret_cast<const void*>(&strided_section_marker<I, 1>)}...};
  return table[section][end];
}

}  // namespace

// Launches marker (section, end) on `stream`; returns the cudaError_t of the
// launch (0 on success).
extern "C" int strided_section_mark(int section, int end, void* stream) {
  if (section < 0 || section >= kSections || (end != 0 && end != 1)) return cudaErrorInvalidValue;
  const void* fn = marker_at(section, end, std::make_integer_sequence<int, kSections>{});
  return cudaLaunchKernel(fn, dim3(1), dim3(1), nullptr, 0, static_cast<cudaStream_t>(stream));
}
