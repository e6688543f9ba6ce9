// The int lane of the register file on Hopper: an ordered saturating
// scatter-add of already-quantized int32 values. Replaces
// kernels/sparse_addto.py:sparse_addto_pallas, whose single VMEM block
// applies the k updates one by one. It carries spill migrations, clear
// write-backs, CntFwd counters and every host segment's updates on the
// card. What bounds it, its two lanes and how the order is kept: see
// scatter.cuh.
#include "scatter.cuh"

// words and unsafe: the large lane's scratch, null on the cluster lane
extern "C" int repro_sparse_addto(int32_t* regs, int64_t n_slots,
                                  const int32_t* idx, const int32_t* vals,
                                  int64_t k, inc_u64* words, uint8_t* unsafe,
                                  void* stream) {
    return (int)inc_scatter(regs, n_slots, idx, IntVals{vals}, k, words,
                            unsafe, (cudaStream_t)stream);
}

// the lane limits (inc_scatter_limits), the same for fused_scatter
extern "C" int repro_scatter_limits(int64_t* out) {
    inc_scatter_limits(out);
    return 0;
}

// first use of the cluster lane on the current device: see inc_cluster_ready
extern "C" int repro_sparse_addto_ready(int* n_clusters) {
    return (int)inc_cluster_ready<IntVals>(n_clusters);
}
