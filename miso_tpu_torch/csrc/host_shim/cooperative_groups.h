// The cluster half of cooperative_groups that the port's kernel sources
// use, for running them on the CPU against cuda_runtime.h here: the
// running block's cluster, its rank, a peer's shared memory and the
// cluster barrier.
#pragma once
#include "cuda_runtime.h"

namespace {
namespace cooperative_groups {

struct cluster_group {
  unsigned block_rank() const { return shim_cluster_rank; }
  unsigned num_blocks() const {
    return (unsigned)shim_cluster_shared->size();
  }
  template <class T>
  T* map_shared_rank(T* addr, unsigned rank) const {
    return shim_map_shared_rank(addr, rank);
  }
  void sync() const {
    shim_cluster_arrive();
    shim_cluster_wait();
  }
};

inline cluster_group this_cluster() { return cluster_group{}; }

}  // namespace cooperative_groups
}  // namespace
