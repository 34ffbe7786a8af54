"""Hand-written CUDA kernels for the port's main path (sm_90a).

Each kernel <name>.py wraps a source in ``csrc/`` built by ``_build``
(nvcc -> one shared library, loaded with ctypes); ``ref.py`` holds the
plain PyTorch versions; ``ops.py`` the public entries the kernel planner
calls.

  * filter_reduce   — predicated single-pass merger (Listing 10 / TPC-H Q6)
  * segment_reduce  — vecmerger / dictmerger keyed sums, atomic-free
  * hash_table      — open-addressing hash-to-slot (hash-join builds)
  * hash_probe      — dict / group probes by binary search (join probes)
  * group_build     — slot histogram of the CSR group build (m:n joins)
  * tiled_matmul    — blocked matrix product (linalg matmul / matvec)
  * map_chain       — one generated kernel per fused elementwise body
  * flash_attention — online-softmax GQA attention (the LM's prefill)
"""
