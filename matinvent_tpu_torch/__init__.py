"""MatInvent on PyTorch and CUDA: the port of ``matinvent_tpu`` to an NVIDIA
Hopper card.

The package mirrors ``matinvent_tpu``'s module names, so each module here has
its counterpart there. It imports ``torch``, ``numpy`` and the standard
library only: nothing of JAX, flax, PyYAML or ``matinvent_tpu``. Where it
needs one of that package's host-side helpers, it keeps its own copy.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; with
no card and no explicit CPU request they raise (see ``device.resolve_device``).
The hand-written kernels are CUDA C++ sources under ``csrc/``, built with
``nvcc`` on first use: the sampler's fused edge branch
(``ops.fused_edge.fused_edge_chain``) and, for the fused-edge harnesses of
``experiments/``, its ablation modes, a precomputed-embedding mode and the
flat edge MLP.
"""

__version__ = "0.1.0"
