"""Operators of the binned fast path.  ``bin_mp``, ``bin_attnpool`` and
``bin_wpool`` launch hand-written CUDA kernels (``csrc/``) on CUDA tensors
and run their plain PyTorch versions on CPU tensors; ``embed`` is plain
PyTorch."""
