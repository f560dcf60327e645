// Stage stamp: one thread writes the device's global timer into a ring.
//
// Not the port of a TPU kernel: it is the serving path's stage marker
// (synergynet_tpu_torch/core/profiling.py, StageSequence). A captured
// program launches one between each pair of its stages, so a replay leaves
// the device time at every stage boundary in memory, where the host reads it
// only when asked. In a profiled run each launch is a kernel named
// stage_stamp in the device trace, at the same boundaries.
//
// The ring is rows x n_slots int64 nanoseconds (%globaltimer), and *row is
// the number of rows completed so far: a stamp writes slot `slot` of row
// *row % rows, and the last stamp of a row (advance != 0) moves *row on. The
// launches of one row run in order on one stream, so no fence is needed
// beyond the kernel boundaries.

#include <cuda_runtime.h>

namespace {

__global__ void stage_stamp(long long* ring, long long* row, int slot,
                            int n_slots, int rows, int advance) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    const long long r = *row;
    ring[(r % rows) * n_slots + slot] = static_cast<long long>(t);
    if (advance) *row = r + 1;
}

}  // namespace

extern "C" int synergy_stage_stamp(void* ring, void* row, int slot,
                                   int n_slots, int rows, int advance,
                                   void* stream) {
    stage_stamp<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<long long*>(ring), static_cast<long long*>(row), slot,
        n_slots, rows, advance);
    return static_cast<int>(cudaGetLastError());
}
