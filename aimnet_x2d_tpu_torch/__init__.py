"""aimnet_x2d_tpu_torch — the PyTorch/CUDA port of ``aimnet_x2d_tpu``.

The port trains and serves the model on an NVIDIA Hopper card: SMILES are
featurized on the host, packed into 256-atom bins, and run through the
shell-convolution GNN, whose message-passing stack (forward and backward),
attention pooling (forward and backward) and weighted pools are
hand-written CUDA kernels (``csrc/``).  The JAX package next to it is the
reference each module is checked against; the port imports nothing from it.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``,
in which case every kernel is replaced by its plain PyTorch version.
"""

__version__ = "0.1.0"
