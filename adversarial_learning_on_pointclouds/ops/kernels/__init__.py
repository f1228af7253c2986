"""Hand-written kernels.

The reference's native surface is cuDNN conv1d + cuBLAS matmul reached
through ``torch.nn`` (SURVEY.md §2.9, "the reference contains zero
first-party native code"); here XLA reaches the same libraries from the
plain jnp path. One kernel remains where XLA's plain version moves far
more bytes than it has to:

* ``trunk_pool`` — the trunk exit ``max_n bn(h @ w + b)`` (Pallas through
  Triton), which never writes the ``[B, N, 1024]`` pre-pool tensor.

It runs compiled only on a GPU, chosen by ``ops/dispatch.py``; its CPU
tests run it in interpret mode.
"""
