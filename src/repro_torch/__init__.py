"""PyTorch port of the ``repro`` package, for NVIDIA Hopper cards.

Mirrors ``repro``'s layout module by module; the JAX package stays the
reference the port is held against. Parameter trees are
``dict[str, Tensor]`` walked in sorted key order, randomness goes through
``repro_torch.random`` (threefry2x32, bit-exact with ``jax.random``), and
the kernels are hand-written CUDA (``kernels/csrc/``). Entry points run on the card unless the
caller passes ``device="cpu"``.
"""
