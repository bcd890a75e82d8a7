"""tdnet_tpu_torch: TDNet streaming inference in PyTorch, with the propagation
attention as a hand-written CUDA kernel for Hopper (sm_90a).

The JAX package ``tdnet_tpu`` is the reference this port is tested against;
the port never imports JAX.
"""

__version__ = "0.1.0"
