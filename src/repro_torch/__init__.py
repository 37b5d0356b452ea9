"""PyTorch/CUDA port of the StreamTensor serving and training stack.

The JAX package ``repro`` is the reference; this package mirrors its module
layout (``configs``, ``kernels``, ``core.stream_plan``, ``models``,
``serving``, ``data``, ``distributed``, ``train``, ``launch``) so each
counterpart is found under the same name.  It imports
``torch`` and never ``jax`` or ``repro``: what it needs from the JAX-free
reference modules is kept here as its own copy.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.  The
kernels on the serving and training paths are hand-written CUDA C++ for
Hopper (``kernels/csrc``); on a CPU tensor each kernel wrapper runs its
plain PyTorch version instead.
"""
