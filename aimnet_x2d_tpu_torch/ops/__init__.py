"""Operators of the port.  ``bin_mp``, ``bin_attnpool``, ``bin_wpool`` and
``bin_inject`` (the binned layout; ``bin_mp`` also holds kernel 5, the
layer of halo graph shards), ``fused_edge`` (the flat layout's edge
aggregation) and ``pallas_segment`` (the windowed segment sum) launch
hand-written CUDA kernels (``csrc/``) on CUDA tensors and run their plain
PyTorch versions on CPU tensors; ``embed``, ``segment`` and ``halo`` (the
boundary exchange and the aggregation products around kernel 5) are plain
PyTorch."""
