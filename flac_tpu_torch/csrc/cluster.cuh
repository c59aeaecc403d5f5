// Thread block cluster helpers shared by the kernels that launch clusters
// (csrc/assemble_fields.cu, csrc/frame_crc.cu): the CTA's rank and the
// cluster's size, the cluster barrier in its split and whole forms, and a
// store into another CTA's shared memory (mapa / st.shared::cluster).
// Included inside each source's anonymous namespace.  kernels.py's build
// hash covers csrc/*.cuh, so an edit here rebuilds both.

#pragma once

__device__ __forceinline__ int cluster_rank() {
    unsigned r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
    return (int)r;
}
__device__ __forceinline__ int cluster_size() {
    unsigned n;
    asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
    return (int)n;
}
// arrive early (relaxed), wait before the first store into another CTA's
// shared memory: every CTA of the cluster is running by then
__device__ __forceinline__ void cluster_arrive_relaxed() {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
// every thread of the cluster arrives; shared-memory stores before it,
// local or remote, are seen by every thread of the cluster after it
__device__ __forceinline__ void cluster_barrier() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n"
                 "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// store v at p's place in the shared memory of the cluster's CTA `rank`
__device__ __forceinline__ void store_remote(unsigned* p, int rank,
                                             unsigned v) {
    const unsigned local = (unsigned)__cvta_generic_to_shared(p);
    unsigned remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                 : "=r"(remote) : "r"(local), "r"(rank));
    asm volatile("st.shared::cluster.u32 [%0], %1;"
                 :: "r"(remote), "r"(v) : "memory");
}
